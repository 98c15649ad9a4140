"""IQA dataset suite: metadata parsers, split machinery, Q preprocessing.

Port of ``vtamiq_tpu/data/datasets.py`` (numpy and scipy): the class ladder
ImageDataset -> IQADataset -> PatchFRIQADataset -> PairwiseFRIQAPatchDataset
and the readers of TID2013/2008, KADID-10k, LIVE, CSIQ, PIPAL and its
Val/Test variants, PieAPP train/test, KADIS-700k and KonIQ-10k. A dataset
parses its score files, builds ref-image splits, preprocesses its Q array
and decodes/flips images on the host; patch sampling and extraction run on
the compute device inside the steps (``train/steps.py``).
"""

from __future__ import annotations

import os
from collections import namedtuple
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops.values import process_qs as _process_qs
from ..utils import check_unused_kwargs
from ..utils.logging import log, log_warn
from .imageio import (
    imread, transform_img,
    DEFAULT_NORM_MEAN, DEFAULT_NORM_STD, IMAGENET_NORM_MEAN, IMAGENET_NORM_STD,
)

dataset_split = namedtuple("dataset_split", ["name", "indices"])

DATASETS_DEFAULT_PATH = os.environ.get("VTAMIQ_DATASETS_PATH", "datasets")
_IMPORT_TIME_DATASETS_PATH = DATASETS_DEFAULT_PATH


def resolve_datasets_root(explicit: Optional[str] = None) -> str:
    """Dataset root resolution: explicit kwarg > monkeypatched module
    attribute > live $VTAMIQ_DATASETS_PATH > import-time default.

    Reading the env var LIVE (not just at import) removes the trap where a
    script sets VTAMIQ_DATASETS_PATH after an incidental package import
    and silently reads the wrong root; tools that rebind
    DATASETS_DEFAULT_PATH directly (parity_run.point_frameworks_at) still
    take precedence because a rebound attribute differs from the
    import-time snapshot."""
    if explicit is not None:
        return explicit
    if DATASETS_DEFAULT_PATH != _IMPORT_TIME_DATASETS_PATH:
        return DATASETS_DEFAULT_PATH
    return os.environ.get("VTAMIQ_DATASETS_PATH", DATASETS_DEFAULT_PATH)

SPLIT_NAME_FULL = "FullDataset"


class ImageDataset:
    """Base: name/path + normalization policy (patch_datasets.py:18-85)."""

    img_dim: Optional[Tuple[int, int]] = None  # (H, W) when fixed for the
    # dataset. Loaders verify it against ONE probed item and then trust it
    # for the whole split (pipeline._fixed_size) — skipping per-item header
    # probes at startup; a contradicted declaration falls back to per-item
    # probing with a warning. Declare None (as LIVE/KADIS do) when sizes
    # can vary.

    def __init__(self, name: str, path: str, is_hdr: bool = False,
                 normalize: bool = True, normalize_imagenet: bool = False,
                 datasets_root: Optional[str] = None, **kwargs):
        check_unused_kwargs(f"ImageDataset({name})", **{
            k: v for k, v in kwargs.items() if k not in _KNOWN_UNUSED_KWARGS})
        self.name = name
        root = resolve_datasets_root(datasets_root)
        self.path = path if os.path.isabs(path) else f"{root}/{path}"
        self.is_hdr = is_hdr
        self.normalize = normalize and not is_hdr
        if normalize and is_hdr:
            log_warn(f"Dataset {name}: normalization disabled for HDR data.")
        self.normalize_imagenet = normalize_imagenet

    def get_norm_mean_std(self):
        if self.normalize:
            if self.normalize_imagenet:
                return IMAGENET_NORM_MEAN, IMAGENET_NORM_STD
            return DEFAULT_NORM_MEAN, DEFAULT_NORM_STD
        return None, None


# kwargs threaded by the config system that the dataset ladder consumes
# elsewhere (pipeline-level knobs kept for API parity with the reference)
_KNOWN_UNUSED_KWARGS = {
    "full_reference", "patch_dim", "patch_count", "patch_num_scales",
    "patch_sampler_config", "patch_sampling_num_scales_ratio",
    "allow_img_flip", "img_zero_error_q_prob", "use_aligned_patches",
    "use_ref_img_cache", "use_dist_img_cache", "num_repeats_data",
    "return_paths", "return_full_imgs",
}


class IQADataset(ImageDataset):
    """Adds Q processing + ref-image split machinery (patch_datasets.py:88-275)."""

    num_ref_images: int = -1
    num_dist_images: int = -1
    num_distortions: int = -1

    def __init__(self, name: str, path: str,
                 qs_normalize: bool = True, qs_reverse: bool = True,
                 qs_normalize_mean_std: bool = False, qs_linearize: bool = True,
                 **kwargs):
        super().__init__(name, path, **kwargs)
        self.qs_normalize = qs_normalize
        self.qs_reverse = qs_reverse
        self.qs_normalize_mean_std = qs_normalize_mean_std
        self.qs_linearize = qs_linearize

        self.splits_dict_ref: Dict[str, dataset_split] = {}
        self.splits_dict: Dict[str, dataset_split] = {}

        self.qs: Optional[np.ndarray] = None
        self.dist_images_per_image: Optional[np.ndarray] = None
        self.dist_images_before_image: Optional[np.ndarray] = None

        self.read_dataset()
        self.process_qs()

    # -- metadata -----------------------------------------------------------

    def read_dataset(self):
        raise NotImplementedError(f"IQADataset {self.name}: read_dataset() not implemented.")

    @staticmethod
    def compute_dist_images_before_image(dist_images_per_image):
        return np.cumsum(dist_images_per_image) - np.asarray(dist_images_per_image)

    def process_qs(self):
        qs = np.asarray(self.qs, float)
        log(f"Dataset {self.name}: Qs before processing (min/mean/max): "
            f"{qs.min():.4g}/{qs.mean():.4g}/{qs.max():.4g}")
        self.qs = _process_qs(
            qs, qs_normalize=self.qs_normalize, qs_reverse=self.qs_reverse,
            qs_normalize_mean_std=self.qs_normalize_mean_std,
            qs_linearize=self.qs_linearize, warn=log_warn)
        log(f"Dataset {self.name}: Qs after processing (min/mean/max): "
            f"{self.qs.min():.4g}/{self.qs.mean():.4g}/{self.qs.max():.4g}")

    # -- splits -------------------------------------------------------------

    def add_split(self, split: Optional[dataset_split] = None):
        """Register a split given REF-image indices; expands to ref/dist pair
        indices via the per-image distortion counts (patch_datasets.py:159-194)."""
        if split is None or split.indices is None:
            split = dataset_split(
                name=SPLIT_NAME_FULL if split is None else split.name,
                indices=list(range(self.num_ref_images)))

        if split.name in self.splits_dict:
            log_warn(f"Dataset {self.name}: overwriting existing split [{split.name}].")

        indices = [
            self.dist_images_before_image[i] + j
            for i in split.indices
            for j in range(self.dist_images_per_image[i])
        ]
        self.splits_dict_ref[split.name] = split
        self.splits_dict[split.name] = dataset_split(split.name, np.asarray(indices, int))

    def has_split(self, split_name: str) -> bool:
        return split_name in self.splits_dict

    def split_indices(self, split_name: str) -> np.ndarray:
        if split_name not in self.splits_dict:
            raise KeyError(f"Dataset {self.name} has no split [{split_name}].")
        return self.splits_dict[split_name].indices

    def split_len(self, split_name: str) -> int:
        return len(self.split_indices(split_name))


class PatchFRIQADataset(IQADataset):
    """Full-reference dataset: (q, ref image, distorted image) samples
    (patch_datasets.py:278-425). Patch extraction happens downstream on
    device; this class serves decoded + normalized images."""

    num_images_per_sample = 2  # (ref, dist)

    def __init__(self, name: str, path: str, allow_img_flip: bool = False,
                 use_ref_img_cache: bool = False, use_dist_img_cache: bool = False,
                 **kwargs):
        self.paths_ref: List[str] = []
        self.paths_dist: List[str] = []
        super().__init__(name, path, **kwargs)
        self.allow_img_flip = allow_img_flip
        self.use_ref_img_cache = use_ref_img_cache
        self.use_dist_img_cache = use_dist_img_cache
        self._img_cache: Optional[Dict[str, np.ndarray]] = (
            {} if (use_ref_img_cache or use_dist_img_cache) else None)

    def process_dataset_data(self, qs, paths_ref, paths_dist, dist_images_per_image):
        self.qs = np.asarray(qs, float)
        self.paths_ref = list(paths_ref)
        self.paths_dist = list(paths_dist)
        self.dist_images_per_image = np.asarray(dist_images_per_image, int)
        self.dist_images_before_image = self.compute_dist_images_before_image(
            dist_images_per_image)

    def __len__(self):
        return len(self.qs)

    def img_pretransform(self, img: np.ndarray) -> np.ndarray:
        """Subclass hook applied right after decode (reference
        patch_datasets.py:357-359; identity in the base class)."""
        return img

    def get_img(self, path: str, is_ref_img: bool = False) -> np.ndarray:
        use_cache = ((is_ref_img and self.use_ref_img_cache) or
                     (not is_ref_img and self.use_dist_img_cache))
        if use_cache and self._img_cache is not None and path in self._img_cache:
            return self._img_cache[path]
        img = self.img_pretransform(imread(path, self.is_hdr))
        if use_cache and self._img_cache is not None:
            self._img_cache[path] = img
        return img

    def sample_paths(self, index: int) -> Tuple[str, ...]:
        return (self.paths_ref[index], self.paths_dist[index])

    def get_sample(self, index: int, rng: Optional[np.random.Generator] = None,
                   allow_img_flip: Optional[bool] = None,
                   compute_norm: bool = True):
        """Load one (q, images) sample; images are float32 HWC.

        Returns (q, imgs_raw, imgs_norm) where imgs_raw are [0,1] (diff-map
        input) and imgs_norm are model-normalized; both lists share the same
        random h/v flip (reference: patch_datasets.py:373-377,398-403).
        The device pipeline fuses normalization on-chip; pass
        compute_norm=False to skip the host-side normalized copies
        (imgs_norm then mirrors imgs_raw).
        """
        flip = self.allow_img_flip if allow_img_flip is None else allow_img_flip
        h_flip = v_flip = False
        if flip and rng is not None:
            h_flip = bool(rng.random() < 0.5)
            v_flip = bool(rng.random() < 0.5)

        norm_mean, norm_std = self.get_norm_mean_std()
        q = float(self.qs[index])

        imgs_raw, imgs_norm = [], []
        for k, path in enumerate(self.sample_paths(index)):
            img = self.get_img(path, is_ref_img=(k == 0))
            raw = transform_img(img, None, h_flip, v_flip, None, None)
            imgs_raw.append(raw)
            if compute_norm and norm_mean is not None:
                imgs_norm.append((raw - np.asarray(norm_mean, np.float32))
                                 / np.asarray(norm_std, np.float32))
            else:
                imgs_norm.append(raw)
        return q, imgs_raw, imgs_norm

    @property
    def is_pairwise(self) -> bool:
        return False


class PairwiseFRIQAPatchDataset(PatchFRIQADataset):
    """Pairwise-preference dataset: (ref, distA, distB) with q = preference
    probability; Q preprocessing disabled (patch_datasets.py:428-486)."""

    num_images_per_sample = 3

    def __init__(self, name: str, **kwargs):
        self.paths_dist1: List[str] = []
        self.paths_dist2: List[str] = []
        super().__init__(name, **kwargs)

    def sample_paths(self, index: int) -> Tuple[str, ...]:
        return (self.paths_ref[index], self.paths_dist1[index], self.paths_dist2[index])

    def process_qs(self):
        log_warn(f"Dataset {self.name}: process_qs() disabled for pairwise preference data.")
        self.qs = np.asarray(self.qs, float)

    @property
    def is_pairwise(self) -> bool:
        return True


# ==========================================================================
# dataset readers
# ==========================================================================

class TID2013Dataset(PatchFRIQADataset):
    """TID2013: 25 ref x 120 dist, MOS (higher = better, reversed+linearized)
    (reference: data/datasets/tid.py:5-89)."""

    num_ref_images = 25
    num_dist_images = 120
    num_distortions = 24
    img_dim = (384, 512)

    def __init__(self, name="TID2013", path="tid2013", **kwargs):
        kwargs.setdefault("qs_reverse", True)
        kwargs.setdefault("qs_linearize", True)
        super().__init__(name=name, path=path, **kwargs)

    def read_dataset(self, reference_images_path="/reference_images",
                     distorted_images_path="/distorted_images",
                     q_file_name="mos_with_names.txt", split_char=" ",
                     q_ind=0, filename_ind=1, filename_ext="bmp", has_header=False):
        ref_dir = self.path + reference_images_path
        dist_dir = self.path + distorted_images_path
        paths_ref, paths_dist, qs = [], [], []
        with open(f"{self.path}/{q_file_name}", "r") as f:
            if has_header:
                next(f)
            for line in f:
                parts = line.strip().split(split_char)
                if len(parts) <= max(q_ind, filename_ind):
                    continue
                name = parts[filename_ind]
                paths_ref.append(f"{ref_dir}/{name[0:3]}.{filename_ext}")
                paths_dist.append(f"{dist_dir}/{name}")
                qs.append(float(parts[q_ind]))
        dist_per_image = [self.num_dist_images] * self.num_ref_images
        self.process_dataset_data(qs, paths_ref, paths_dist, dist_per_image)


class TID2008Dataset(TID2013Dataset):
    num_dist_images = 68
    num_distortions = 17

    def __init__(self, path="tid2008", **kwargs):
        super().__init__(name="TID2008", path=path, **kwargs)


class KADID10kDataset(TID2013Dataset):
    """KADID-10k: 81 ref x 125 dist, DMOS csv (reference: kadid10k.py:4-34)."""

    num_ref_images = 81
    num_dist_images = 125
    num_distortions = 25
    img_dim = (384, 512)

    def __init__(self, path="kadid10k", **kwargs):
        super().__init__(name="KADID10k", path=path, **kwargs)

    def read_dataset(self):
        super().read_dataset(
            reference_images_path="/images", distorted_images_path="/images",
            q_file_name="dmos.csv", split_char=",", q_ind=2, filename_ind=0,
            has_header=True, filename_ext="png")


class LIVEDataset(PatchFRIQADataset):
    """LIVE: 29 ref, variable dist counts, realigned DMOS .mat files
    (reference: live.py:7-102)."""

    num_ref_images = 29
    num_dist_images = -1
    num_distortions = 5
    img_dim = None  # varies

    distortions = [
        ("jp2k", 227), ("jpeg", 233), ("wn", 174), ("gblur", 174),
        ("fastfading", 174),
    ]

    def __init__(self, **kwargs):
        kwargs.setdefault("qs_reverse", False)  # DMOS: 0 = perfect already
        kwargs.setdefault("qs_linearize", True)
        super().__init__(name="LIVE", path="LIVE", **kwargs)

    def read_dataset(self):
        import scipy.io
        dmos_mat = scipy.io.loadmat(self.path + "/dmos_realigned.mat")
        refnames_mat = scipy.io.loadmat(self.path + "/refnames_all.mat")
        refnames = [item[0] for item in refnames_mat["refnames_all"].flatten()]
        dmos = dmos_mat["dmos_new"].flatten()
        orgs = dmos_mat["orgs"].flatten()

        def distortion_info(i):
            i = max(0, i)
            k = 0
            while k + 1 < len(self.distortions) and i - self.distortions[k][1] >= 0:
                i -= self.distortions[k][1]
                k += 1
            dist_type, count = self.distortions[k]
            return dist_type, 1 + min(i, count)

        per_image: Dict[str, list] = {}
        for i, q in enumerate(dmos):
            if orgs[i] == 1:
                continue  # skip pristine entries
            dist_type, i_dist = distortion_info(i)
            ref_name = refnames[i]
            per_image.setdefault(ref_name, []).append((
                f"{self.path}/refimgs/{ref_name}",
                f"{self.path}/{dist_type}/img{i_dist}.bmp",
                float(q)))

        paths_ref, paths_dist, qs, dist_per_image = [], [], [], []
        for ref_name in sorted(per_image.keys()):
            comparisons = per_image[ref_name]
            for pr, pd, q in comparisons:
                paths_ref.append(pr)
                paths_dist.append(pd)
                qs.append(q)
            dist_per_image.append(len(comparisons))
        self.process_dataset_data(qs, paths_ref, paths_dist, dist_per_image)


class CSIQDataset(PatchFRIQADataset):
    """CSIQ: 30 ref, DMOS csv with distortion-type directory layout
    (reference: csiq.py:6-87)."""

    num_ref_images = 30
    num_dist_images = -1
    num_distortions = 6
    img_dim = (512, 512)

    DISTORTIONS = {1: "awgn", 2: "jpeg", 3: "jpeg2000", 4: "fnoise",
                   5: "blur", 6: "contrast"}

    def __init__(self, name="CSIQ", path="CSIQ", **kwargs):
        kwargs.setdefault("qs_reverse", False)  # DMOS: larger = worse already
        super().__init__(name=name, path=path, **kwargs)

    def read_dataset(self):
        per_image: Dict[str, list] = {}
        with open(self.path + "/DMOS.csv", "r") as f:
            next(f)
            for line in f:
                parts = line.strip().split(",")
                if len(parts) < 6:
                    continue
                img_name = parts[0]
                dst_type = self.DISTORTIONS[int(parts[1])]
                dst_lev = parts[3]
                q = float(parts[5])
                per_image.setdefault(img_name, []).append((
                    f"{self.path}/src_imgs/{img_name}.png",
                    f"{self.path}/dst_imgs/{dst_type}/{img_name}.{dst_type}.{dst_lev}.png",
                    q))

        paths_ref, paths_dist, qs, dist_per_image = [], [], [], []
        for img_name in sorted(per_image.keys()):
            comparisons = per_image[img_name]
            for pr, pd, q in comparisons:
                paths_ref.append(pr)
                paths_dist.append(pd)
                qs.append(q)
            dist_per_image.append(len(comparisons))
        self.process_dataset_data(qs, paths_ref, paths_dist, dist_per_image)


class PIPAL(PatchFRIQADataset):
    """PIPAL train: 200 ref x 116 dist, ELO scores (reversed + linearized)
    (reference: pipal.py:6-61)."""

    num_ref_images = 200
    num_dist_images = 116
    num_distortions = 75
    img_dim = (288, 288)

    def __init__(self, name="PIPAL", path="PIPAL", **kwargs):
        kwargs.setdefault("qs_reverse", True)
        kwargs.setdefault("qs_linearize", True)
        super().__init__(name=name, path=path, **kwargs)

    def read_dataset(self):
        labels_dir = self.path + "/Train_Label"
        paths_ref, paths_dist, qs = [], [], []
        for filename in sorted(os.listdir(labels_dir)):
            with open(f"{labels_dir}/{filename}", "r") as f:
                for line in f:
                    parts = line.strip().split(",")
                    if len(parts) < 2:
                        continue
                    dist_name = parts[0]
                    paths_ref.append(f"{self.path}/Train_Ref/{dist_name[:5]}.bmp")
                    paths_dist.append(f"{self.path}/Train_Dist/{dist_name}")
                    qs.append(float(parts[1]))
        dist_per_image = [self.num_dist_images] * self.num_ref_images
        self.process_dataset_data(qs, paths_ref, paths_dist, dist_per_image)


class PIPALTest(PIPAL):
    """PIPAL unlabeled val/test dirs: q = -1 placeholders (pipal.py:64-102)."""

    num_ref_images = 25
    num_dist_images = 66

    def __init__(self, name="PIPALTest", suffix="Test", **kwargs):
        self.suffix = suffix
        kwargs.setdefault("qs_normalize", False)
        kwargs.setdefault("qs_reverse", False)
        kwargs.setdefault("qs_linearize", False)
        super().__init__(name=name, **kwargs)

    def read_dataset(self):
        dist_dir = f"{self.path}/{self.suffix}_Dist"
        paths_ref, paths_dist, qs = [], [], []
        for dist_name in sorted(os.listdir(dist_dir)):
            paths_ref.append(f"{self.path}/{self.suffix}_Ref/{dist_name[:5]}.bmp")
            paths_dist.append(f"{dist_dir}/{dist_name}")
            qs.append(-1.0)
        dist_per_image = [self.num_dist_images] * self.num_ref_images
        self.process_dataset_data(qs, paths_ref, paths_dist, dist_per_image)

    def process_qs(self):
        # unlabeled: keep the -1 placeholders untouched
        self.qs = np.asarray(self.qs, float)


class PIPALVal(PIPALTest):
    num_ref_images = 25
    num_dist_images = 40

    def __init__(self, **kwargs):
        super().__init__(name="PIPALVal", suffix="Val", **kwargs)


class PIPALVal22(PIPALTest):
    num_ref_images = 25
    num_dist_images = 66

    def __init__(self, **kwargs):
        super().__init__(name="PIPALVal22", suffix="NTIRE2022_FR_Valid", **kwargs)


class PIPALTest22(PIPALTest):
    num_ref_images = 25
    num_dist_images = 66

    def __init__(self, **kwargs):
        super().__init__(name="PIPALTest22", suffix="NTIRE2022_FR_Testing", **kwargs)


class PieAPPTrainPairwise(PairwiseFRIQAPatchDataset):
    """PieAPP train: pairwise preference labels, 140 ref x 483 pairs
    (reference: pieapp_dataset.py:6-63)."""

    num_ref_images = 140
    num_dist_images = 483
    img_dim = (256, 256)

    def __init__(self, name="PieAPPTrainPairwise", path="PieAPP_dataset", **kwargs):
        super().__init__(name=name, path=path, **kwargs)

    def read_dataset(self):
        labels_dir = self.path + "/labels/train"
        paths_ref, paths_dist1, paths_dist2, qs = [], [], [], []
        for label_filename in sorted(os.listdir(labels_dir)):
            with open(f"{labels_dir}/{label_filename}", "r") as f:
                next(f)
                for line in f:
                    parts = line.strip().split(",")
                    if len(parts) < 5:
                        continue
                    ref_name = parts[0]
                    stem = ref_name[:-4]
                    paths_ref.append(f"{self.path}/reference_images/train/{ref_name}")
                    paths_dist1.append(f"{self.path}/distorted_images/train/{stem}/{parts[1]}")
                    paths_dist2.append(f"{self.path}/distorted_images/train/{stem}/{parts[2]}")
                    qs.append(float(parts[4]))  # processed preference prob for image A
        self.qs = np.asarray(qs, float)
        self.paths_ref = paths_ref
        self.paths_dist1 = paths_dist1
        self.paths_dist2 = paths_dist2
        self.dist_images_per_image = np.asarray(
            [self.num_dist_images] * self.num_ref_images, int)
        self.dist_images_before_image = self.compute_dist_images_before_image(
            self.dist_images_per_image)


class PieAPPTestset(PatchFRIQADataset):
    """PieAPP test: 40 ref x 15 dist with per-image scores, no Q processing
    (reference: pieapp_dataset.py:66-121)."""

    num_ref_images = 40
    num_dist_images = 15
    img_dim = (256, 256)

    def __init__(self, name="PieAPPTestset", path="PieAPP_dataset", **kwargs):
        kwargs.setdefault("qs_reverse", False)
        kwargs.setdefault("qs_normalize", False)
        kwargs.setdefault("qs_linearize", False)
        super().__init__(name=name, path=path, **kwargs)

    def read_dataset(self):
        paths_ref, paths_dist, qs = [], [], []
        with open(self.path + "/test_reference_list.txt", "r") as ref_file:
            for line in ref_file:
                ref_name = line.strip()
                if not ref_name:
                    continue
                stem = ref_name[:-4]
                with open(f"{self.path}/labels/test/{stem}_per_image_score.csv", "r") as f:
                    next(f)
                    for row in f:
                        parts = row.strip().split(",")
                        if len(parts) < 3:
                            continue
                        paths_ref.append(f"{self.path}/reference_images/test/{ref_name}")
                        paths_dist.append(f"{self.path}/distorted_images/test/{stem}/{parts[1]}")
                        qs.append(float(parts[2]))
        dist_per_image = [self.num_dist_images] * self.num_ref_images
        self.process_dataset_data(qs, paths_ref, paths_dist, dist_per_image)


class KADIS700kDataset(PatchFRIQADataset):
    """KADIS-700k weak-label pretraining set: 134,260 ref x 5 dist; three
    score-file versions; distortion type 15 skipped (reference:
    kadis700k.py:7-147)."""

    num_ref_images = 134260
    num_dist_images = 5

    DISTORTION_TYPES = {
        "gblur": 1, "lblur": 2, "mblur": 3, "colordiffuse": 4, "colorshift": 5,
        "colorquantize": 6, "colorsaturate": 7, "saturate": 7, "jp2k": 9,
        "jpeg": 10, "noisegauss": 11, "noisecolorcomp": 12, "noiseimpulse": 13,
        "noisemultiplicative": 14, "denoise": 15, "brighten": 16, "darken": 17,
        "meanshift": 18, "jitter": 19, "noneccentricity": 20, "pixelate": 21,
        "noisequantize": 22, "colorblock": 23, "sharpenHi": 24, "contrastchange": 25,
    }

    def __init__(self, preprocess: bool = False, version: int = 1, **kwargs):
        self.preprocess = preprocess
        if version == 0:
            self.scores_file = "kadis700k_friqa_no15.csv"  # original FR-IQM (VSI)
        elif version == 1:
            self.scores_file = "kadis700k_vtamiq.csv"      # VTAMIQ relabeled
        elif version == 2:
            self.scores_file = "kadis700k_v2.csv"          # PU-relabeled
        else:
            raise ValueError(f"KADIS700k: unsupported version [{version}].")
        self.version = version
        kwargs.setdefault("qs_reverse", False)
        kwargs.setdefault("qs_linearize", False)
        super().__init__(name="KADIS700k", path="kadis700k", **kwargs)

    def read_dataset(self):
        ref_dir = self.path + "/kadis700k/ref_imgs"
        dist_dir = self.path + "/kadis700k/dist_imgs"
        q_index = 6 if self.version == 0 else -1
        paths_ref, paths_dist, qs = [], [], []
        with open(f"{self.path}/{self.scores_file}", "r") as f:
            next(f)
            for line in f:
                parts = line.strip().split(",")
                if len(parts) < 2:
                    continue
                dist_stem = parts[0][:-4]
                ref_name = parts[1]
                tokens = dist_stem.split("_")
                dist_type = self.DISTORTION_TYPES[tokens[-2]]
                dist_level = int(tokens[-1])
                if dist_type == 15:
                    continue  # distortion 15 absent from the generated set
                dist_name = f"{ref_name[:-4]}_{dist_type:02d}_{dist_level:02d}.bmp"
                paths_ref.append(f"{ref_dir}/{ref_name}")
                paths_dist.append(f"{dist_dir}/{dist_name}")
                qs.append(float(parts[q_index]))
        dist_per_image = [self.num_dist_images] * self.num_ref_images
        self.process_dataset_data(qs, paths_ref, paths_dist, dist_per_image)

    def process_qs(self):
        if self.preprocess:
            super().process_qs()
        else:
            self.qs = np.asarray(self.qs, float)


class KonIQ10kDataset(PatchFRIQADataset):
    """KonIQ-10k NR-IQA dataset. The reference's NR path is explicitly broken
    (koniq10k.py:5 "TODO: fix this", patch_datasets.py:489); here the NR case
    is served as degenerate FR with ref == dist so the metadata/splits are
    usable, and a warning marks the semantics."""

    num_ref_images = 10073
    num_dist_images = 1
    img_dim = (768, 1024)

    def __init__(self, name="KonIQ10k", path="koniq10k", **kwargs):
        kwargs.setdefault("qs_reverse", True)  # MOS: higher = better
        kwargs.setdefault("qs_linearize", True)
        super().__init__(name=name, path=path, **kwargs)
        log_warn("KonIQ10k: NR-IQA served as ref==dist degenerate FR pairs; "
                 "VTAMIQ's difference head is not meaningful without a "
                 "reference image (NR path is broken in the upstream too).")

    def read_dataset(self):
        csv_path = f"{self.path}/koniq10k_scores_and_distributions.csv"
        paths, qs = [], []
        with open(csv_path, "r") as f:
            header = next(f).strip().split(",")
            name_idx = header.index("image_name") if "image_name" in header else 0
            mos_idx = header.index("MOS") if "MOS" in header else len(header) - 1
            for line in f:
                parts = [p.strip().strip('"') for p in line.strip().split(",")]
                if len(parts) <= max(name_idx, mos_idx):
                    continue
                paths.append(f"{self.path}/1024x768/{parts[name_idx]}")
                qs.append(float(parts[mos_idx]))
        self.num_ref_images = len(paths)
        self.process_dataset_data(qs, paths, list(paths), [1] * len(paths))
