"""The port's native image decoder (``vtamiq_tpu_torch/csrc/image_io.cpp``
through ``data/native_io.py``) against the JAX package's decoder
(``vtamiq_tpu.data.native_io``) and PIL, and the port's BMP/PNG writers.

Tolerances: every format decodes to the same 8-bit pixels as PIL bit for
bit (BMP and PNG are lossless; JPEG goes through the same libjpeg), and to
the same floats as the JAX package's decoder bit for bit: both scale by
``x * float32(1/255)``, which is within one rounding (6e-8) of PIL's
``x / 255``. The fused normalization, ``x * (1/255/std) - mean/std`` in
fp32, may round once differently where a compiler contracts it into an FMA:
1e-6 against the JAX decoder and against numpy's ``(x/255 - mean) / std``.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from vtamiq_tpu.data import native_io as jnative
from vtamiq_tpu_torch import _build
from vtamiq_tpu_torch.data import imageio, native_io, synth

H, W = 33, 47  # odd width: BMP rows carry padding


def _pil(path):
    """PIL's pixels, scaled as the native decoders scale them."""
    return np.asarray(Image.open(path).convert("RGB"), np.float32) * np.float32(1.0 / 255.0)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    paths = {}
    for ext in ("bmp", "png", "jpg"):
        paths[ext] = str(tmp / f"img.{ext}")
        Image.fromarray(arr).save(paths[ext])
    paths["palette"] = str(tmp / "palette.bmp")
    Image.fromarray(arr).convert("P", palette=Image.ADAPTIVE).save(paths["palette"])
    # top-down 24-bit BMP: negative height in the header, rows stored first-first
    top_down = str(tmp / "topdown.bmp")
    synth.write_bmp(arr, top_down)
    with open(top_down, "rb") as f:
        data = bytearray(f.read())
    row = (W * 3 + 3) & ~3
    pixels = np.frombuffer(bytes(data[54:]), np.uint8).reshape(H, row)[::-1]
    data[22:26] = (-H).to_bytes(4, "little", signed=True)
    data[54:] = pixels.tobytes()
    with open(top_down, "wb") as f:
        f.write(bytes(data))
    paths["topdown"] = top_down
    paths["arr"] = arr
    return paths


def test_codecs_and_build():
    info = native_io.build_info()
    assert os.path.isfile(info.path) and info.path.startswith(_build.BUILD_DIR)
    assert native_io.codecs() == info.codecs == ["bmp", "jpeg", "png"]


@pytest.mark.parametrize("kind", ["bmp", "png", "jpg", "palette", "topdown"])
def test_decode_matches_jax_decoder_and_pil(images, kind):
    path = images[kind]
    got = native_io.decode_rgb(path)
    np.testing.assert_array_equal(got, _pil(path))
    if kind != "topdown":  # the JAX decoder reads it too; PIL is the reference here
        np.testing.assert_array_equal(got, jnative.decode_rgb(path))
    if kind == "topdown":
        np.testing.assert_array_equal(got, images["arr"] * np.float32(1.0 / 255.0))
    assert native_io.image_size(path) == (H, W)


@pytest.mark.parametrize("h_flip,v_flip", [(True, False), (False, True), (True, True)])
def test_fused_flip_and_normalization(images, h_flip, v_flip):
    path = images["png"]
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    got = native_io.decode_rgb(path, H, W, h_flip=h_flip, v_flip=v_flip,
                               norm_mean=mean, norm_std=std)
    want = jnative.decode_rgb(path, H, W, h_flip=h_flip, v_flip=v_flip,
                              norm_mean=mean, norm_std=std)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    ref = imageio.transform_img(_pil(path), None, h_flip, v_flip, mean, std)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_batch_decode_into_padded_slots(images):
    """decode_batch equals JAX's; decode_batch_into writes each image into
    the top-left corner of a larger slot and leaves the rest alone."""
    paths = [images["bmp"], images["png"], images["jpg"], images["palette"]]
    got = native_io.decode_batch(paths, [(H, W)] * 4, h_flips=[1, 0, 1, 0],
                                 v_flips=[0, 1, 1, 0], num_threads=3)
    want = jnative.decode_batch(paths, [(H, W)] * 4, h_flips=[1, 0, 1, 0],
                                v_flips=[0, 1, 1, 0], num_threads=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    out = torch.full((4, H + 3, W + 5, 3), -7.0)
    slot = (H + 3) * (W + 5) * 3 * 4
    native_io.decode_batch_into(paths, [(H, W)] * 4,
                                [out.data_ptr() + i * slot for i in range(4)],
                                [(W + 5) * 3] * 4, h_flips=[1, 0, 1, 0],
                                v_flips=[0, 1, 1, 0], num_threads=2)
    for i in range(4):
        np.testing.assert_array_equal(out[i, :H, :W].numpy(), want[i])
        assert torch.all(out[i, H:] == -7.0) and torch.all(out[i, :, W:] == -7.0)


def test_errors_name_the_file(images, tmp_path):
    with pytest.raises(IOError, match="cannot open"):
        native_io.decode_rgb("/nonexistent/file.bmp", 8, 8)
    with pytest.raises(IOError, match="unreadable"):
        native_io.decode_rgb(images["bmp"], 10, 10)
    bad = str(tmp_path / "bad.png")
    with open(bad, "wb") as f:
        f.write(b"not an image at all")
    with pytest.raises(IOError, match="bad.png"):
        native_io.image_size(bad)
    with pytest.raises(IOError, match="2/2 failed"):
        native_io.decode_batch([bad, images["bmp"] + ".missing"], [(H, W)] * 2)


def _use_build(monkeypatch, *defines):
    """Load a decoder built with ``defines`` in place of the default one."""
    info = _build.build_host(defines)
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_available", None)
    monkeypatch.setattr(native_io, "_info", None)
    monkeypatch.setattr(_build, "build_host", lambda defines=(): info)
    return info


def _pngs(tmp_path):
    """PNGs of every color type the zlib decoder takes, written by PIL (which
    picks a filter per row), plus 16-bit RGB written by hand."""
    rng = np.random.default_rng(3)
    arr = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    arr[:10] = arr[0]  # flat rows: PIL's filter choice varies over the image
    out = {}
    for mode in ("RGB", "RGBA", "L", "LA", "P"):
        im = Image.fromarray(arr)
        im = im.convert("P", palette=Image.ADAPTIVE) if mode == "P" else im.convert(mode)
        out[mode] = str(tmp_path / f"{mode}.png")
        im.save(out[mode])
    import struct
    import zlib
    wide = (arr.astype(">u2") * 256 + rng.integers(0, 256, arr.shape)).astype(">u2")
    rows = b"".join(b"\x00" + wide[y].tobytes() for y in range(H))
    chunk = lambda t, d: (struct.pack(">I", len(d)) + t + d
                          + struct.pack(">I", zlib.crc32(t + d) & 0xFFFFFFFF))
    out["RGB16"] = str(tmp_path / "RGB16.png")
    with open(out["RGB16"], "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 16, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))
    return out, arr


def test_zlib_png_decoder_matches_libpng(tmp_path, monkeypatch):
    """Where png.h is missing the build decodes PNG on zlib alone: every
    color type, PIL's per-row filters and 16-bit samples, bit for bit
    against the libpng build and PIL."""
    pngs, arr = _pngs(tmp_path)
    want = {k: native_io.decode_rgb(p) for k, p in pngs.items()}
    assert _use_build(monkeypatch, "-DVTAMIQ_WITHOUT_LIBPNG").codecs == ["bmp", "jpeg",
                                                                        "png-zlib"]
    assert native_io.codecs() == ["bmp", "jpeg", "png-zlib"] and native_io.decodes("png")
    for mode, path in pngs.items():
        got = native_io.decode_rgb(path)
        np.testing.assert_array_equal(got, want[mode], err_msg=mode)
        np.testing.assert_array_equal(got, _pil(path), err_msg=mode)
        assert native_io.image_size(path) == (H, W)
    np.testing.assert_array_equal(want["RGB16"], arr * np.float32(1.0 / 255.0))
    with pytest.raises(IOError, match="unreadable"):
        native_io.decode_rgb(pngs["RGB"], H, W + 1)


def test_build_without_codecs_raises_naming_the_library(images, monkeypatch):
    """A decoder built without libpng, zlib and libjpeg reads BMP, and
    raises on PNG or JPEG naming the library; imread then uses PIL, and
    without PIL raises with the path and the reason."""
    info = _use_build(monkeypatch, "-DVTAMIQ_WITHOUT_JPEG", "-DVTAMIQ_WITHOUT_PNG")
    assert info.codecs == ["bmp"]
    assert native_io.codecs() == ["bmp"] and not native_io.decodes("png")
    np.testing.assert_array_equal(native_io.decode_rgb(images["bmp"]), _pil(images["bmp"]))
    with pytest.raises(native_io.CodecUnavailableError, match=r"libpng \(png.h\) and zlib"):
        native_io.decode_rgb(images["png"])
    with pytest.raises(native_io.CodecUnavailableError, match="libjpeg"):
        native_io.image_size(images["jpg"])
    with pytest.raises(native_io.CodecUnavailableError, match="img.png"):
        native_io.decode_batch([images["bmp"], images["png"]], [(H, W)] * 2)
    # PIL's path scales as the native decoders do, by x * float32(1/255)
    np.testing.assert_array_equal(imageio.imread(images["png"]), _pil(images["png"]))

    import builtins
    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL here")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(IOError, match=r"img.png.*libpng.*PIL is not installed"):
        imageio.imread(images["png"])
    np.testing.assert_array_equal(imageio.imread(images["bmp"]), _pil(images["bmp"]))


def test_imread_reads_through_the_native_decoder(images, monkeypatch):
    monkeypatch.setattr(imageio, "_pil_read", lambda *a: pytest.fail("PIL was used"))
    for kind in ("bmp", "png", "jpg"):
        np.testing.assert_array_equal(imageio.imread(images[kind]), _pil(images[kind]))


@pytest.mark.parametrize("ext", ["bmp", "png"])
@pytest.mark.parametrize("shape", [(1, 1), (33, 47), (64, 96)])
def test_writers_read_back_through_pil(tmp_path, ext, shape):
    rng = np.random.default_rng(shape[1])
    arr = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    path = str(tmp_path / f"w.{ext}")
    (synth.write_bmp if ext == "bmp" else synth.write_png)(arr, path)
    np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")), arr)
    np.testing.assert_array_equal(native_io.decode_rgb(path), arr * np.float32(1.0 / 255.0))


def test_save_rounds_like_the_jax_writer(tmp_path):
    """synth._save quantizes [0,1] floats as the JAX writer does (round,
    clip, uint8) and picks the format by extension."""
    from vtamiq_tpu.data import synth as jsynth
    img = np.random.default_rng(2).uniform(-0.1, 1.1, (20, 30, 3)).astype(np.float32)
    for ext in ("bmp", "png"):
        synth._save(img, str(tmp_path / f"t.{ext}"))
        jsynth._save(img, str(tmp_path / f"j.{ext}"))
        np.testing.assert_array_equal(_pil(str(tmp_path / f"t.{ext}")),
                                      _pil(str(tmp_path / f"j.{ext}")))
    with pytest.raises(ValueError, match="jpg"):
        synth._save(img, str(tmp_path / "t.jpg"))


def test_pil_jpeg_is_bit_equal_to_the_jax_native_decoder(images, monkeypatch):
    """Where the port's build has no libjpeg (the card machine), a JPEG goes
    through PIL; it decodes to the floats of the JAX package's native
    decoder (libjpeg here) bit for bit, not to JAX's own PIL path's x / 255."""
    _use_build(monkeypatch, "-DVTAMIQ_WITHOUT_JPEG")
    assert "jpeg" not in native_io.codecs()
    got = imageio.imread(images["jpg"])
    want = jnative.decode_rgb(images["jpg"])
    assert got.dtype == np.float32 and got.shape == (H, W, 3)
    np.testing.assert_array_equal(got, want)
    u8 = np.asarray(Image.open(images["jpg"]).convert("RGB"), np.float32)
    assert np.any(u8 / np.float32(255.0) != want)  # x / 255 would not be equal
