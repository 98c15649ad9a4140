"""Synthetic IQA data: procedural images, graded distortions, latent
quality labels, and whole datasets written in the real on-disk layouts.

Port of ``vtamiq_tpu/data/synth.py`` (numpy and scipy): ``make_base_image``
draws structured content, a bank of 12 distortion types applies a severity
in (0, 1], and ``severity_to_quality`` gives a quality label monotone in
severity with observer noise. The ``generate_*`` writers put TID2013,
KADID-10k, LIVE, CSIQ, PIPAL, PieAPP and KADIS-700k trees on disk in the
layouts the parsers of ``data/datasets.py`` read, with the same pixels and
file names as the JAX package's writers. Images are written as BMP, and PNG
through the standard library's ``zlib``, so writing needs no image library.

Label files are always written at the dataset's true cardinality; image
files can be restricted to the first ``image_refs`` reference images, and
callers then use splits confined to those refs. Each dataset directory gets
a ``.synth_done`` marker recording the parameters; a matching marker skips
regeneration. ``write_vit_npz`` writes random ImageNet-ViT weights in the
``ViT-B_16.npz`` key layout.

    python -m vtamiq_tpu_torch.data.synth --root /tmp/iqa --datasets tid2013,kadid10k
"""

from __future__ import annotations

import json
import math
import os
import struct
import zlib
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

__all__ = ["make_base_image", "apply_distortion", "severity_to_quality",
           "DISTORTION_BANK", "write_bmp", "write_png",
           "generate_tid2013", "generate_kadid10k", "generate_live", "generate_csiq",
           "generate_pipal", "generate_pieapp", "generate_kadis700k", "generate_all",
           "vit_npz_arrays", "write_vit_npz"]


# --------------------------------------------------------------------------
# procedural base images
# --------------------------------------------------------------------------

def make_base_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Structured content in [0,1]: smooth color gradients + soft shapes +
    high-frequency texture (so blur/noise/quantization distortions have
    visibly graded effects and diff/SSIM maps are non-trivial)."""
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):
        fy, fx = rng.uniform(0.5, 3.0, 2)
        py, px = rng.uniform(0.0, 2 * np.pi, 2)
        img[..., c] = 0.5 + 0.22 * np.sin(2 * np.pi * fy * yy + py) \
            * np.cos(2 * np.pi * fx * xx + px)

    # soft ellipses of random color (object-like regions)
    for _ in range(14):
        cy, cx = rng.uniform(0.0, 1.0, 2)
        ry, rx = rng.uniform(0.04, 0.22, 2)
        d2 = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
        soft = np.clip(1.0 - d2, 0.0, 1.0).astype(np.float32)[..., None]
        color = rng.uniform(0.05, 0.95, 3).astype(np.float32)
        img = img * (1.0 - 0.8 * soft) + 0.8 * soft * color

    # high-frequency texture (two oriented gratings + fine noise)
    for _ in range(2):
        f = rng.uniform(25.0, 60.0)
        th = rng.uniform(0.0, np.pi)
        grat = np.sin(2 * np.pi * f * (yy * np.cos(th) + xx * np.sin(th)))
        img += 0.04 * grat[..., None].astype(np.float32)
    img += rng.normal(0.0, 0.015, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def write_bmp(rgb: np.ndarray, path: str) -> None:
    """uint8 (h, w, 3) RGB -> 24-bit bottom-up BMP (BITMAPINFOHEADER)."""
    h, w, _ = rgb.shape
    row = (w * 3 + 3) & ~3
    pixels = np.zeros((h, row), np.uint8)
    pixels[:, :w * 3] = rgb[::-1, :, ::-1].reshape(h, w * 3)  # bottom-up, BGR
    data = pixels.tobytes()
    header = struct.pack("<2sIHHI", b"BM", 54 + len(data), 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(data), 2835, 2835, 0, 0)
    with open(path, "wb") as f:
        f.write(header + info + data)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(rgb: np.ndarray, path: str) -> None:
    """uint8 (h, w, 3) RGB -> 8-bit RGB PNG, every row unfiltered, deflated
    by ``zlib`` at level 1 (fast; the files are larger than PIL's)."""
    h, w, _ = rgb.shape
    rows = np.zeros((h, 1 + w * 3), np.uint8)  # filter byte 0 per row
    rows[:, 1:] = rgb.reshape(h, w * 3)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
                + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
                + _png_chunk(b"IEND", b""))


def _save(img01: np.ndarray, path: str) -> None:
    """[0,1] float image -> 8-bit file; the format follows the extension."""
    arr = np.clip(np.round(img01 * 255.0), 0, 255).astype(np.uint8)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".bmp":
        write_bmp(arr, path)
    elif ext == ".png":
        write_png(arr, path)
    else:
        raise ValueError(f"synth: no writer for [{ext}] files ({path})")


# --------------------------------------------------------------------------
# graded distortion bank
# --------------------------------------------------------------------------

def _box_blur(img: np.ndarray, radius: int) -> np.ndarray:
    from scipy import ndimage
    size = 2 * radius + 1
    return ndimage.uniform_filter(img, size=(size, size, 1), mode="nearest")


def _pixelate(img: np.ndarray, k: int) -> np.ndarray:
    h, w, c = img.shape
    hk, wk = (h // k) * k, (w // k) * k
    blocks = img[:hk, :wk].reshape(h // k, k, w // k, k, c).mean(axis=(1, 3))
    up = np.repeat(np.repeat(blocks, k, axis=0), k, axis=1)
    out = img.copy()
    out[:hk, :wk] = up
    return out


def _d_gauss_noise(rng, img, s):
    return img + rng.normal(0.0, 0.01 + 0.22 * s, img.shape)


def _d_impulse_noise(rng, img, s):
    out = img.copy()
    mask = rng.random(img.shape[:2]) < 0.12 * s
    out[mask] = rng.random((int(mask.sum()), 3))
    return out


def _d_blur(rng, img, s):
    return _box_blur(img, 1 + int(round(5 * s)))


def _d_pixelate(rng, img, s):
    return _pixelate(img, 2 + int(round(12 * s)))


def _d_quantize(rng, img, s):
    levels = max(2, int(round(2 + 36 * (1.0 - s))))
    return np.floor(img * levels) / levels


def _d_contrast(rng, img, s):
    c = 1.0 - 0.75 * s
    return img * c + 0.5 * (1.0 - c)


def _d_brighten(rng, img, s):
    return img + 0.45 * s


def _d_darken(rng, img, s):
    return img - 0.45 * s


def _d_color_shift(rng, img, s):
    shift = rng.uniform(-0.3, 0.3, 3) * s
    return img + shift[None, None, :]


def _d_desaturate(rng, img, s):
    gray = img.mean(axis=-1, keepdims=True)
    return img + (gray - img) * s


def _d_jpeg_blockiness(rng, img, s):
    return _d_quantize(rng, _pixelate(img, 8), 0.4 + 0.6 * s)


def _d_blur_noise(rng, img, s):
    return _d_gauss_noise(rng, _d_blur(rng, img, 0.7 * s), 0.5 * s)


DISTORTION_BANK = [
    _d_gauss_noise, _d_impulse_noise, _d_blur, _d_pixelate, _d_quantize,
    _d_contrast, _d_brighten, _d_darken, _d_color_shift, _d_desaturate,
    _d_jpeg_blockiness, _d_blur_noise,
]


def apply_distortion(rng: np.random.Generator, img: np.ndarray,
                     dist_type: int, level: int, num_levels: int,
                     type_gain: float) -> np.ndarray:
    """Distortion ``dist_type`` (0-based; cycles through the bank with a
    per-type gain so repeated bank entries still differ) at severity
    ``level`` in 1..num_levels."""
    s = min(1.0, (level / num_levels) * type_gain)
    fn = DISTORTION_BANK[dist_type % len(DISTORTION_BANK)]
    return np.clip(fn(rng, img, s), 0.0, 1.0)


def severity_to_quality(rng: np.random.Generator, level: int, num_levels: int,
                        type_gain: float, noise: float = 0.03) -> float:
    """Latent quality in [0,1] (1 = pristine), monotone-decreasing in level
    with observer noise — the shape real MOS studies produce."""
    s = (level / num_levels) * type_gain
    q = math.exp(-2.1 * s)
    return float(np.clip(q + rng.normal(0.0, noise), 0.0, 1.0))


def _type_gains(rng: np.random.Generator, num_types: int) -> np.ndarray:
    return rng.uniform(0.55, 1.35, num_types)


# --------------------------------------------------------------------------
# idempotence marker
# --------------------------------------------------------------------------

def _done(root: str, params: dict) -> bool:
    marker = os.path.join(root, ".synth_done")
    if os.path.isfile(marker):
        try:
            with open(marker) as f:
                return json.load(f) == params
        except Exception:
            return False
    return False


def _mark_done(root: str, params: dict) -> None:
    with open(os.path.join(root, ".synth_done"), "w") as f:
        json.dump(params, f)


def _want_images(ref_idx: int, image_refs: Optional[int]) -> bool:
    return image_refs is None or ref_idx < image_refs


# --------------------------------------------------------------------------
# TID2013 (reference: data/datasets/tid.py:5-89)
# --------------------------------------------------------------------------

def generate_tid2013(root: str, num_refs: int = 25, num_types: int = 24,
                     num_levels: int = 5, hw: Tuple[int, int] = (384, 512),
                     seed: int = 2013, image_refs: Optional[int] = None) -> str:
    """reference_images/iNN.bmp + distorted_images/iNN_TT_L.bmp +
    mos_with_names.txt ("MOS iNN_TT_L.bmp", MOS in [0,9], higher=better)."""
    params = dict(kind="tid2013", num_refs=num_refs, num_types=num_types,
                  num_levels=num_levels, hw=list(hw), seed=seed,
                  image_refs=image_refs)
    if _done(root, params):
        return root
    h, w = hw
    ref_dir = os.path.join(root, "reference_images")
    dist_dir = os.path.join(root, "distorted_images")
    os.makedirs(ref_dir, exist_ok=True)
    os.makedirs(dist_dir, exist_ok=True)

    master = np.random.default_rng(seed)
    gains = _type_gains(master, num_types)
    lines = []
    for r in range(num_refs):
        rng = np.random.default_rng(seed + 1000 + r)
        write = _want_images(r, image_refs)
        base = make_base_image(rng, h, w) if write else None
        if write:
            _save(base, os.path.join(ref_dir, f"i{r + 1:02d}.bmp"))
        for t in range(num_types):
            for lvl in range(1, num_levels + 1):
                name = f"i{r + 1:02d}_{t + 1:02d}_{lvl}.bmp"
                mos = 9.0 * severity_to_quality(rng, lvl, num_levels, gains[t])
                lines.append(f"{mos:.5f} {name}")
                if write:
                    dist = apply_distortion(rng, base, t, lvl, num_levels, gains[t])
                    _save(dist, os.path.join(dist_dir, name))
    with open(os.path.join(root, "mos_with_names.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    _mark_done(root, params)
    return root


# --------------------------------------------------------------------------
# KADID-10k (reference: data/datasets/kadid10k.py:4-34)
# --------------------------------------------------------------------------

def generate_kadid10k(root: str, num_refs: int = 81, num_types: int = 25,
                      num_levels: int = 5, hw: Tuple[int, int] = (384, 512),
                      seed: int = 10000, image_refs: Optional[int] = 12) -> str:
    """images/INN.png refs + images/INN_TT_LL.png dist + dmos.csv
    (header; dist_img,ref_img,dmos,var; dmos in [1,5], higher=better)."""
    params = dict(kind="kadid10k", num_refs=num_refs, num_types=num_types,
                  num_levels=num_levels, hw=list(hw), seed=seed,
                  image_refs=image_refs)
    if _done(root, params):
        return root
    h, w = hw
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)

    master = np.random.default_rng(seed)
    gains = _type_gains(master, num_types)
    rows = ["dist_img,ref_img,dmos,var"]
    for r in range(num_refs):
        rng = np.random.default_rng(seed + 1000 + r)
        write = _want_images(r, image_refs)
        base = make_base_image(rng, h, w) if write else None
        ref_name = f"I{r + 1:02d}.png"
        if write:
            _save(base, os.path.join(img_dir, ref_name))
        for t in range(num_types):
            for lvl in range(1, num_levels + 1):
                name = f"I{r + 1:02d}_{t + 1:02d}_{lvl:02d}.png"
                dmos = 1.0 + 4.0 * severity_to_quality(rng, lvl, num_levels, gains[t])
                rows.append(f"{name},{ref_name},{dmos:.4f},0.5")
                if write:
                    dist = apply_distortion(rng, base, t, lvl, num_levels, gains[t])
                    _save(dist, os.path.join(img_dir, name))
    with open(os.path.join(root, "dmos.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    _mark_done(root, params)
    return root


# --------------------------------------------------------------------------
# LIVE (reference: data/datasets/live.py:7-102)
# --------------------------------------------------------------------------

LIVE_DIR_COUNTS = [("jp2k", 227), ("jpeg", 233), ("wn", 174),
                   ("gblur", 174), ("fastfading", 174)]
LIVE_SIZES = [(480, 720), (512, 768), (768, 512), (620, 460), (432, 640),
              (634, 505), (480, 640)]


def generate_live(root: str, num_refs: int = 29, per_dir_real: int = 30,
                  seed: int = 1999) -> str:
    """dmos_realigned.mat (dmos_new, orgs) + refnames_all.mat + refimgs/ +
    one dir per distortion type. VARIABLE image sizes per reference — the
    bucketing/variable-size pipeline exerciser. Only ``per_dir_real``
    entries per distortion dir get image files; the rest are flagged
    pristine (orgs=1), which the parsers skip — total label arrays keep
    LIVE's true length (982)."""
    import scipy.io
    params = dict(kind="live", num_refs=num_refs, per_dir_real=per_dir_real,
                  seed=seed)
    if _done(root, params):
        return root
    os.makedirs(os.path.join(root, "refimgs"), exist_ok=True)
    for d, _ in LIVE_DIR_COUNTS:
        os.makedirs(os.path.join(root, d), exist_ok=True)

    master = np.random.default_rng(seed)
    ref_names = [f"ref{r + 1:02d}.bmp" for r in range(num_refs)]
    ref_sizes = [LIVE_SIZES[r % len(LIVE_SIZES)] for r in range(num_refs)]
    ref_imgs = {}
    for r, name in enumerate(ref_names):
        rng = np.random.default_rng(seed + 1000 + r)
        h, w = ref_sizes[r]
        ref_imgs[name] = make_base_image(rng, h, w)
        _save(ref_imgs[name], os.path.join(root, "refimgs", name))

    total = sum(c for _, c in LIVE_DIR_COUNTS)
    dmos = np.zeros(total)
    orgs = np.ones(total, dtype=np.int8)  # default: skipped ("pristine")
    refnames = [""] * total
    gains = _type_gains(master, len(LIVE_DIR_COUNTS))

    flat = 0
    next_ref = 0  # round-robin so all refs appear among real entries
    for d_idx, (d_name, count) in enumerate(LIVE_DIR_COUNTS):
        real_local = sorted(master.choice(count, size=min(per_dir_real, count),
                                          replace=False))
        for i_local in range(count):
            ref_name = ref_names[(flat + i_local) % num_refs]
            refnames[flat + i_local] = ref_name
            if i_local in real_local:
                ref_name = ref_names[next_ref % num_refs]
                next_ref += 1
                refnames[flat + i_local] = ref_name
                rng = np.random.default_rng(seed + 7777 + flat + i_local)
                lvl = int(rng.integers(1, 6))
                img = apply_distortion(rng, ref_imgs[ref_name], d_idx, lvl, 5,
                                       gains[d_idx])
                # live.py distortion_info: file index = 1 + min(i_local, count)
                _save(img, os.path.join(root, d_name, f"img{1 + i_local}.bmp"))
                orgs[flat + i_local] = 0
                # LIVE DMOS: 0 = perfect, higher = worse
                q = severity_to_quality(rng, lvl, 5, gains[d_idx])
                dmos[flat + i_local] = 100.0 * (1.0 - q)
        flat += count

    scipy.io.savemat(os.path.join(root, "dmos_realigned.mat"),
                     {"dmos_new": dmos[None, :], "orgs": orgs[None, :]})
    cells = np.empty((1, total), dtype=object)
    for i, name in enumerate(refnames):
        cells[0, i] = np.asarray([name])
    scipy.io.savemat(os.path.join(root, "refnames_all.mat"),
                     {"refnames_all": cells})
    _mark_done(root, params)
    return root


# --------------------------------------------------------------------------
# CSIQ (reference: data/datasets/csiq.py:6-87)
# --------------------------------------------------------------------------

CSIQ_TYPES = {1: "awgn", 2: "jpeg", 3: "jpeg2000", 4: "fnoise",
              5: "blur", 6: "contrast"}


def generate_csiq(root: str, num_refs: int = 30, num_levels: int = 4,
                  hw: Tuple[int, int] = (512, 512), seed: int = 2010,
                  image_refs: Optional[int] = None) -> str:
    """src_imgs/NAME.png + dst_imgs/TYPE/NAME.TYPE.LEV.png + DMOS.csv
    (header; name,type_idx,?,lev,?,dmos; dmos in [0,1], higher=worse)."""
    params = dict(kind="csiq", num_refs=num_refs, num_levels=num_levels,
                  hw=list(hw), seed=seed, image_refs=image_refs)
    if _done(root, params):
        return root
    h, w = hw
    os.makedirs(os.path.join(root, "src_imgs"), exist_ok=True)
    for d in CSIQ_TYPES.values():
        os.makedirs(os.path.join(root, "dst_imgs", d), exist_ok=True)

    master = np.random.default_rng(seed)
    gains = _type_gains(master, len(CSIQ_TYPES))
    rows = ["image,dst_type,dst_idx,dst_lev,orig,dmos"]
    for r in range(num_refs):
        rng = np.random.default_rng(seed + 1000 + r)
        write = _want_images(r, image_refs)
        name = f"img{r + 1:02d}"
        base = make_base_image(rng, h, w) if write else None
        if write:
            _save(base, os.path.join(root, "src_imgs", f"{name}.png"))
        for t_idx, t_name in CSIQ_TYPES.items():
            for lvl in range(1, num_levels + 1):
                q = severity_to_quality(rng, lvl, num_levels, gains[t_idx - 1])
                rows.append(f"{name},{t_idx},{t_idx},{lvl},0,{1.0 - q:.4f}")
                if write:
                    dist = apply_distortion(rng, base, t_idx - 1, lvl,
                                            num_levels, gains[t_idx - 1])
                    _save(dist, os.path.join(root, "dst_imgs", t_name,
                                             f"{name}.{t_name}.{lvl}.png"))
    with open(os.path.join(root, "DMOS.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    _mark_done(root, params)
    return root


# --------------------------------------------------------------------------
# PIPAL (reference: data/datasets/pipal.py:6-61)
# --------------------------------------------------------------------------

def generate_pipal(root: str, num_refs: int = 200, num_dist: int = 116,
                   hw: Tuple[int, int] = (288, 288), seed: int = 2020,
                   image_refs: Optional[int] = 6) -> str:
    """Train_Ref/ANNNN.bmp + Train_Dist/ANNNN_TT_LL.bmp + per-ref
    Train_Label/ANNNN.txt ("name,elo"; ELO ~ [900,1700], higher=better)."""
    params = dict(kind="pipal", num_refs=num_refs, num_dist=num_dist,
                  hw=list(hw), seed=seed, image_refs=image_refs)
    if _done(root, params):
        return root
    h, w = hw
    os.makedirs(os.path.join(root, "Train_Ref"), exist_ok=True)
    os.makedirs(os.path.join(root, "Train_Dist"), exist_ok=True)
    os.makedirs(os.path.join(root, "Train_Label"), exist_ok=True)

    num_types = max(1, num_dist // 5)
    master = np.random.default_rng(seed)
    gains = _type_gains(master, num_types)
    for r in range(num_refs):
        rng = np.random.default_rng(seed + 1000 + r)
        write = _want_images(r, image_refs)
        ref = f"A{r + 1:04d}"
        base = make_base_image(rng, h, w) if write else None
        if write:
            _save(base, os.path.join(root, "Train_Ref", f"{ref}.bmp"))
        lines = []
        for d in range(num_dist):
            t, lvl = d % num_types, 1 + (d // num_types) % 5
            name = f"{ref}_{t:02d}_{lvl:02d}.bmp"
            elo = 900.0 + 800.0 * severity_to_quality(rng, lvl, 5, gains[t])
            lines.append(f"{name},{elo:.4f}")
            if write:
                dist = apply_distortion(rng, base, t, lvl, 5, gains[t])
                _save(dist, os.path.join(root, "Train_Dist", name))
        with open(os.path.join(root, "Train_Label", f"{ref}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    _mark_done(root, params)
    return root


# --------------------------------------------------------------------------
# PieAPP (reference: data/datasets/pieapp_dataset.py:6-121)
# --------------------------------------------------------------------------

def generate_pieapp(root: str, train_refs: int = 140, pairs_per_ref: int = 483,
                    test_refs: int = 40, test_dist: int = 15,
                    hw: Tuple[int, int] = (256, 256), seed: int = 2018,
                    image_refs: Optional[int] = 4,
                    image_test_refs: Optional[int] = 4) -> str:
    """Pairwise train labels (ref, distA, distB, raw, pref prob) + per-image
    test scores, in the PieAPP directory layout."""
    params = dict(kind="pieapp", train_refs=train_refs,
                  pairs_per_ref=pairs_per_ref, test_refs=test_refs,
                  test_dist=test_dist, hw=list(hw), seed=seed,
                  image_refs=image_refs, image_test_refs=image_test_refs)
    if _done(root, params):
        return root
    h, w = hw
    for sub in ("labels/train", "labels/test", "reference_images/train",
                "reference_images/test", "distorted_images/train",
                "distorted_images/test"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)

    num_types = 10
    master = np.random.default_rng(seed)
    gains = _type_gains(master, num_types)

    # train: per-ref pairwise comparisons over a pool of distorted variants
    pool = 15  # distinct distorted images per ref; pairs reference the pool
    for r in range(train_refs):
        rng = np.random.default_rng(seed + 1000 + r)
        write = _want_images(r, image_refs)
        ref_name = f"ref{r + 1:03d}.png"
        stem = ref_name[:-4]
        base = make_base_image(rng, h, w) if write else None
        if write:
            _save(base, os.path.join(root, "reference_images/train", ref_name))
            os.makedirs(os.path.join(root, "distorted_images/train", stem),
                        exist_ok=True)
        qualities = []
        for d in range(pool):
            t, lvl = d % num_types, 1 + (d // num_types) % 5
            qualities.append(severity_to_quality(rng, lvl, 5, gains[t]))
            if write:
                img = apply_distortion(rng, base, t, lvl, 5, gains[t])
                _save(img, os.path.join(root, "distorted_images/train", stem,
                                        f"{stem}_d{d:02d}.png"))
        lines = ["ref,A,B,raw,processed"]
        for p in range(pairs_per_ref):
            a, b = rng.choice(pool, size=2, replace=False)
            # Bradley-Terry-ish preference for A over B from latent quality
            prob = 1.0 / (1.0 + math.exp(-8.0 * (qualities[a] - qualities[b])))
            lines.append(f"{ref_name},{stem}_d{a:02d}.png,{stem}_d{b:02d}.png,"
                         f"{prob:.4f},{prob:.4f}")
        with open(os.path.join(root, "labels/train", f"{stem}_pairwise.csv"), "w") as f:
            f.write("\n".join(lines) + "\n")

    # test: per-image scores
    test_names = []
    for r in range(test_refs):
        rng = np.random.default_rng(seed + 5000 + r)
        write = _want_images(r, image_test_refs)
        ref_name = f"tst{r + 1:03d}.png"
        stem = ref_name[:-4]
        test_names.append(ref_name)
        base = make_base_image(rng, h, w) if write else None
        if write:
            _save(base, os.path.join(root, "reference_images/test", ref_name))
            os.makedirs(os.path.join(root, "distorted_images/test", stem),
                        exist_ok=True)
        lines = ["ref,dist,score"]
        for d in range(test_dist):
            t, lvl = d % num_types, 1 + (d // num_types) % 5
            score = 1.0 - severity_to_quality(rng, lvl, 5, gains[t])
            name = f"{stem}_d{d:02d}.png"
            lines.append(f"{ref_name},{name},{score:.4f}")
            if write:
                img = apply_distortion(rng, base, t, lvl, 5, gains[t])
                _save(img, os.path.join(root, "distorted_images/test", stem, name))
        with open(os.path.join(root, "labels/test",
                               f"{stem}_per_image_score.csv"), "w") as f:
            f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "test_reference_list.txt"), "w") as f:
        f.write("\n".join(test_names) + "\n")
    _mark_done(root, params)
    return root


# --------------------------------------------------------------------------
# KADIS-700k (reference: data/datasets/kadis700k.py:7-147)
# --------------------------------------------------------------------------

# distortion-name token -> numeric code, as the score csv names them
# (kadis700k.py:17-43; "denoise"=15 exists in the csv but its images were
# never generated upstream — the parser skips those rows)
KADIS_TYPE_TOKENS = [
    ("gblur", 1), ("lblur", 2), ("mblur", 3), ("colordiffuse", 4),
    ("colorshift", 5), ("colorquantize", 6), ("colorsaturate", 7),
    ("jp2k", 9), ("jpeg", 10), ("noisegauss", 11), ("noisecolorcomp", 12),
    ("noiseimpulse", 13), ("noisemultiplicative", 14), ("denoise", 15),
    ("brighten", 16), ("darken", 17), ("meanshift", 18), ("jitter", 19),
    ("noneccentricity", 20), ("pixelate", 21), ("noisequantize", 22),
    ("colorblock", 23), ("sharpenHi", 24), ("contrastchange", 25),
]


def generate_kadis700k(root: str, num_refs: int = 120, num_levels: int = 5,
                       hw: Tuple[int, int] = (384, 512), seed: int = 70000,
                       image_refs: Optional[int] = None,
                       denoise_every: int = 24) -> str:
    """KADIS-700k weak-label layout (scaled down from 134,260 refs):
    ``kadis700k/ref_imgs/<ref>.bmp`` + ``kadis700k/dist_imgs/
    <ref>_<TT>_<LL>.bmp`` (numeric type codes) + the THREE score-file
    versions the parser accepts (kadis700k.py:80-88):
      kadis700k_friqa_no15.csv  11 columns, VSI at index 6 (version 0)
      kadis700k_vtamiq.csv      weak VTAMIQ label in the last column (v1)
      kadis700k_v2.csv          PU-relabeled variant, last column (v2)
    Each ref gets EXACTLY num_dist_images=5 valid rows (the real no15 csv is
    count-consistent: 671300/5 refs after excluding type 15); every
    ``denoise_every``-th ref additionally gets a csv-only "denoise" (type 15)
    row whose image is NOT written — exercising the parser's skip path
    without breaking the 5-per-ref count. Weak labels are quality-correlated
    (severity_to_quality), so pretraining on them genuinely teaches
    distortion ordering."""
    params = dict(kind="kadis700k", num_refs=num_refs, num_levels=num_levels,
                  hw=list(hw), seed=seed, image_refs=image_refs,
                  denoise_every=denoise_every)
    if _done(root, params):
        return root
    h, w = hw
    base_dir = os.path.join(root, "kadis700k")
    ref_dir = os.path.join(base_dir, "ref_imgs")
    dist_dir = os.path.join(base_dir, "dist_imgs")
    os.makedirs(ref_dir, exist_ok=True)
    os.makedirs(dist_dir, exist_ok=True)

    master = np.random.default_rng(seed)
    usable_tokens = [(n, c) for n, c in KADIS_TYPE_TOKENS if c != 15]
    gains = _type_gains(master, len(usable_tokens))
    header = ("dist_img,ref_img,ssim,ms_ssim,iw_ssim,mdsi,vsi,fsim,gmsd,"
              "sff,vtamiq")
    rows_v0, rows_v1, rows_v2 = [header], [header], [header]
    for r in range(num_refs):
        rng = np.random.default_rng(seed + 1000 + r)
        write = _want_images(r, image_refs)
        base = make_base_image(rng, h, w) if write else None
        ref_name = f"k{r:06d}.bmp"
        if write:
            _save(base, os.path.join(ref_dir, ref_name))
        n_rows = 5 + (1 if denoise_every and r % denoise_every == 0 else 0)
        for d in range(n_rows):
            if d == 5:  # the extra, parser-skipped row
                token, code = "denoise", 15
                ti = None
            else:
                ti = int(rng.integers(len(usable_tokens)))
                token, code = usable_tokens[ti]
            lvl = int(rng.integers(1, num_levels + 1))
            csv_dist = f"{ref_name[:-4]}_{token}_{lvl}.bmp"
            if code != 15:
                quality = severity_to_quality(rng, lvl, num_levels, gains[ti])
                disk_dist = f"{ref_name[:-4]}_{code:02d}_{lvl:02d}.bmp"
                if write:
                    # map the KADIS token onto one of the synthetic
                    # distortion families (deterministic per type code)
                    dist = apply_distortion(rng, base, ti, lvl, num_levels,
                                            gains[ti])
                    _save(dist, os.path.join(dist_dir, disk_dist))
            else:
                quality = 0.5
            # weak-label directions: VSI is a similarity (HIGHER=better,
            # version 0, served qs_reverse=False — the reference quirk);
            # vtamiq/v2 come from a VTAMIQ trained on KADID (qs_reverse=True)
            # so those predict distortion: HIGHER=worse, matching the
            # TID-convention targets the finetune datasets use
            vsi = quality + float(rng.normal(0, 0.01))
            vt = (1.0 - quality) + float(rng.normal(0, 0.01))
            v2 = (1.0 - quality) + float(rng.normal(0, 0.01))
            filler = ",".join(f"{quality:.3f}" for _ in range(4))
            rows_v0.append(f"{csv_dist},{ref_name},{filler},{vsi:.4f},"
                           f"0.9,0.05,0.8,{vt:.4f}")
            rows_v1.append(f"{csv_dist},{ref_name},{filler},{vsi:.4f},"
                           f"0.9,0.05,0.8,{vt:.4f}")
            rows_v2.append(f"{csv_dist},{ref_name},{filler},{vsi:.4f},"
                           f"0.9,0.05,0.8,{v2:.4f}")
    for fname, rows in [("kadis700k_friqa_no15.csv", rows_v0),
                        ("kadis700k_vtamiq.csv", rows_v1),
                        ("kadis700k_v2.csv", rows_v2)]:
        with open(os.path.join(root, fname), "w") as f:
            f.write("\n".join(rows) + "\n")
    _mark_done(root, params)
    return root


# --------------------------------------------------------------------------
# orchestrator + CLI
# --------------------------------------------------------------------------

def vit_npz_arrays(hidden: int = 768, heads: int = 12, mlp: int = 3072, layers: int = 12,
                   grid: int = 14, patch: int = 16, seed: int = 0) -> dict:
    """Random ImageNet-ViT weights in the key layout of the jax-format
    ``ViT-B_16.npz`` files (the defaults are B/16 at 224 pixels: 12 blocks,
    a 14x14 positional grid): dense kernels (in, out), attention kernels
    (H, heads, d) and (heads, d, H), the patch kernel HWIO. Weights are
    normal with std 0.02, LayerNorm scales near 1, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    d = hidden // heads

    def w(*shape, std=0.02, mean=0.0):
        return (mean + std * rng.standard_normal(shape)).astype(np.float32)

    out = {"embedding/kernel": w(patch, patch, 3, hidden), "embedding/bias": w(hidden),
           "cls": w(1, 1, hidden),
           "Transformer/posembed_input/pos_embedding": w(1, 1 + grid * grid, hidden),
           "Transformer/encoder_norm/scale": w(hidden, std=0.1, mean=1.0),
           "Transformer/encoder_norm/bias": w(hidden)}
    for i in range(layers):
        root = f"Transformer/encoderblock_{i}"
        attn = f"{root}/MultiHeadDotProductAttention_1"
        for name in ("query", "key", "value"):
            out[f"{attn}/{name}/kernel"] = w(hidden, heads, d)
            out[f"{attn}/{name}/bias"] = w(heads, d)
        out[f"{attn}/out/kernel"] = w(heads, d, hidden)
        out[f"{attn}/out/bias"] = w(hidden)
        out[f"{root}/MlpBlock_3/Dense_0/kernel"] = w(hidden, mlp)
        out[f"{root}/MlpBlock_3/Dense_0/bias"] = w(mlp)
        out[f"{root}/MlpBlock_3/Dense_1/kernel"] = w(mlp, hidden)
        out[f"{root}/MlpBlock_3/Dense_1/bias"] = w(hidden)
        for ln in ("LayerNorm_0", "LayerNorm_2"):
            out[f"{root}/{ln}/scale"] = w(hidden, std=0.1, mean=1.0)
            out[f"{root}/{ln}/bias"] = w(hidden)
    return out


def write_vit_npz(path: str, **kwargs) -> str:
    """``vit_npz_arrays(**kwargs)`` written as an uncompressed npz."""
    np.savez(path, **vit_npz_arrays(**kwargs))
    return path


def generate_all(root: str, datasets: Iterable[str] = ("tid2013",),
                 full: bool = False) -> dict:
    """Generate the requested datasets under ``root`` using the parser-
    expected subdirectory names. ``full=True`` writes every image file
    (TID2013 ~1.8 GB); default bounds image counts per dataset."""
    out = {}
    for name in datasets:
        if name == "tid2013":
            out[name] = generate_tid2013(
                os.path.join(root, "tid2013"),
                image_refs=None if full else 8)
        elif name == "kadid10k":
            out[name] = generate_kadid10k(
                os.path.join(root, "kadid10k"),
                image_refs=None if full else 12)
        elif name == "live":
            out[name] = generate_live(
                os.path.join(root, "LIVE"),
                per_dir_real=60 if full else 30)
        elif name == "csiq":
            out[name] = generate_csiq(
                os.path.join(root, "CSIQ"),
                image_refs=None if full else 10)
        elif name == "pipal":
            out[name] = generate_pipal(
                os.path.join(root, "PIPAL"),
                image_refs=None if full else 6)
        elif name == "pieapp":
            out[name] = generate_pieapp(
                os.path.join(root, "PieAPP_dataset"),
                image_refs=None if full else 4,
                image_test_refs=None if full else 4)
        elif name == "kadis700k":
            out[name] = generate_kadis700k(
                os.path.join(root, "kadis700k"),
                num_refs=120 if full else 12)
        else:
            raise ValueError(f"synth: unknown dataset [{name}]")
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse
    p = argparse.ArgumentParser(description="Write synthetic IQA datasets in their on-disk layouts.")
    p.add_argument("--root", required=True)
    p.add_argument("--datasets", default="tid2013",
                   help="comma-separated: tid2013,kadid10k,live,csiq,pipal,pieapp")
    p.add_argument("--full", action="store_true",
                   help="write every image file (full-scale; TID2013 ~1.8 GB)")
    args = p.parse_args(argv)
    roots = generate_all(args.root, args.datasets.split(","), full=args.full)
    print(json.dumps(roots))


if __name__ == "__main__":
    main()
