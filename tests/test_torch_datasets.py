"""The port's dataset parsers, loader and dataset writers against the JAX
package's, on the CPU.

- Parsers: every dataset class reads the trees that the JAX package's
  writers (``vtamiq_tpu.data.synth``) put on disk, and gives the same
  processed ``qs`` (to 1e-12: the same numpy code, the linearizing fit
  included), the same paths, distortion counts and split indices, exactly.
- Loader: ``PatchDatasetLoader`` yields the same batches as JAX's for the
  same seed: order, flips, padding and ``valid``, canonical size buckets
  and ``img_hw``, all bit for bit (both decode with native decoders that
  scale by the same fp32 constant).
- Writers: the port's ``generate_*`` write the same file names, label files
  and ``.mat`` contents as the JAX writers, and images that decode to the
  same pixels.
"""

import filecmp
import os

import numpy as np
import pytest
import scipy.io

from vtamiq_tpu.data import datasets as JD
from vtamiq_tpu.data import synth as jsynth
from vtamiq_tpu.data.pipeline import PatchDatasetLoader as JLoader
from vtamiq_tpu_torch.data import datasets as D
from vtamiq_tpu_torch.data import native_io, synth
from vtamiq_tpu_torch.data.buckets import compute_canonical_buckets
from vtamiq_tpu_torch.data.pipeline import PatchDatasetLoader

HW = (24, 32)  # small images: the layouts and label files are full-size
LIVE_SIZES = [(40, 56), (32, 48), (56, 40), (36, 36)]


def _write_trees(mod, root, monkeypatch):
    """Every layout, written by the synth module ``mod`` (JAX's or the
    port's) at small image sizes; returns {name: dataset root}."""
    monkeypatch.setattr(mod, "LIVE_SIZES", LIVE_SIZES)
    return {
        "tid2013": mod.generate_tid2013(os.path.join(root, "tid2013"), hw=HW, image_refs=1),
        "kadid10k": mod.generate_kadid10k(os.path.join(root, "kadid10k"), hw=HW, image_refs=1),
        "live": mod.generate_live(os.path.join(root, "LIVE"), per_dir_real=6),  # every ref
        "csiq": mod.generate_csiq(os.path.join(root, "CSIQ"), hw=HW, image_refs=1),
        "pipal": mod.generate_pipal(os.path.join(root, "PIPAL"), hw=HW, image_refs=1),
        "pieapp": mod.generate_pieapp(os.path.join(root, "PieAPP_dataset"), hw=HW,
                                      image_refs=1, image_test_refs=1),
        "kadis": mod.generate_kadis700k(os.path.join(root, "kadis700k"), num_refs=6,
                                        hw=HW),
    }


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(JAX writers' root, port writers' root)."""
    mp = pytest.MonkeyPatch()
    try:
        jroot = str(tmp_path_factory.mktemp("jax_trees"))
        troot = str(tmp_path_factory.mktemp("torch_trees"))
        _write_trees(jsynth, jroot, mp)
        _write_trees(synth, troot, mp)
    finally:
        mp.undo()
    return jroot, troot


def _pipal_unlabeled(root, suffix, names):
    """PIPAL's unlabeled Val/Test layout (no writer in either package)."""
    os.makedirs(f"{root}/PIPAL/{suffix}_Dist", exist_ok=True)
    os.makedirs(f"{root}/PIPAL/{suffix}_Ref", exist_ok=True)
    for n in names:
        open(f"{root}/PIPAL/{suffix}_Dist/{n}", "w").close()


def _koniq(root):
    os.makedirs(f"{root}/koniq10k", exist_ok=True)
    with open(f"{root}/koniq10k/koniq10k_scores_and_distributions.csv", "w") as f:
        f.write('"image_name","c1","MOS"\n')
        for i in range(7):
            f.write(f'"{i:04d}.jpg",1,{3.1 + 0.37 * i}\n')


# (JAX class, port class, kwargs, class attribute overrides)
PARSERS = [
    ("TID2013Dataset", {}, {}),
    ("TID2008Dataset", {"path": "tid2013"}, {"num_ref_images": 25, "num_dist_images": 120}),
    ("KADID10kDataset", {}, {}),
    ("LIVEDataset", {}, {}),
    ("CSIQDataset", {}, {}),
    ("PIPAL", {}, {}),
    ("PIPALTest", {}, {"num_ref_images": 2, "num_dist_images": 2}),
    ("PIPALVal", {}, {"num_ref_images": 2, "num_dist_images": 2}),
    ("PIPALVal22", {}, {"num_ref_images": 2, "num_dist_images": 2}),
    ("PIPALTest22", {}, {"num_ref_images": 2, "num_dist_images": 2}),
    ("PieAPPTestset", {}, {}),
    ("PieAPPTrainPairwise", {}, {}),
    ("KADIS700kDataset", {"version": 1}, {"num_ref_images": 6}),
    ("KADIS700kDataset", {"version": 0, "preprocess": True}, {"num_ref_images": 6}),
    ("KADIS700kDataset", {"version": 2}, {"num_ref_images": 6}),
    ("KonIQ10kDataset", {}, {}),
]


@pytest.mark.parametrize("name,kwargs,attrs", PARSERS,
                         ids=[f"{p[0]}{p[1].get('version', '')}" for p in PARSERS])
def test_parsers_match_jax(trees, name, kwargs, attrs):
    root = trees[0]
    for suffix in ("Test", "Val", "NTIRE2022_FR_Valid", "NTIRE2022_FR_Testing"):
        _pipal_unlabeled(root, suffix, ["A0001_00_01.bmp", "A0001_01_02.bmp",
                                        "A0002_00_01.bmp", "A0002_03_01.bmp"])
    _koniq(root)
    jcls = type("J", (getattr(JD, name),), dict(attrs))
    tcls = type("T", (getattr(D, name),), dict(attrs))
    jds = jcls(datasets_root=root, **kwargs)
    tds = tcls(datasets_root=root, **kwargs)
    np.testing.assert_allclose(tds.qs, jds.qs, rtol=0, atol=1e-12)
    assert tds.paths_ref == jds.paths_ref
    for attr in ("paths_dist", "paths_dist1", "paths_dist2"):
        assert getattr(tds, attr, None) == getattr(jds, attr, None)
    np.testing.assert_array_equal(tds.dist_images_per_image, jds.dist_images_per_image)
    np.testing.assert_array_equal(tds.dist_images_before_image, jds.dist_images_before_image)
    assert tds.is_pairwise == jds.is_pairwise and tds.img_dim == jds.img_dim
    n = len(tds.dist_images_per_image)
    for split in (None, D.dataset_split("Training", list(range(0, n, 2))),
                  D.dataset_split("Testing", [n - 1])):
        tds.add_split(split)
        jds.add_split(split if split is None else JD.dataset_split(*split))
    for split_name in ("FullDataset", "Training", "Testing"):
        np.testing.assert_array_equal(tds.split_indices(split_name),
                                      jds.split_indices(split_name))


def test_sample_flip_is_shared_by_ref_and_dist(trees):
    """get_sample draws one h/v flip per sample, applied to every image,
    from the caller's rng, as JAX's does."""
    jds = JD.TID2013Dataset(datasets_root=trees[0], allow_img_flip=True)
    tds = D.TID2013Dataset(datasets_root=trees[0], allow_img_flip=True)
    for index in (0, 5, 17):
        jq, jraw, jnorm = jds.get_sample(index, rng=np.random.default_rng(index))
        tq, traw, tnorm = tds.get_sample(index, rng=np.random.default_rng(index))
        assert tq == jq
        for a, b in zip(traw + tnorm, jraw + jnorm):
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(1)
    _, (ref, dist), _ = tds.get_sample(3, rng=rng)
    rng = np.random.default_rng(1)
    h_flip, v_flip = rng.random() < 0.5, rng.random() < 0.5
    _, (ref0, dist0), _ = tds.get_sample(3, allow_img_flip=False)
    flip = lambda x: (x[:, ::-1] if h_flip else x)[::-1] if v_flip else \
        (x[:, ::-1] if h_flip else x)
    np.testing.assert_array_equal(ref, flip(ref0))
    np.testing.assert_array_equal(dist, flip(dist0))


def test_datasets_root_resolution(monkeypatch, tmp_path):
    monkeypatch.setenv("VTAMIQ_DATASETS_PATH", str(tmp_path / "env"))
    assert D.resolve_datasets_root() == str(tmp_path / "env")
    assert D.resolve_datasets_root("explicit") == "explicit"
    monkeypatch.setattr(D, "DATASETS_DEFAULT_PATH", "rebound")
    assert D.resolve_datasets_root() == "rebound"


def _batches(loader):
    return list(loader)


def _assert_same_batches(tb, jb):
    assert len(tb) == len(jb)
    for t, j in zip(tb, jb):
        np.testing.assert_array_equal(t.indices, j.indices)
        assert t.valid == j.valid
        np.testing.assert_array_equal(t.qs.numpy(), j.qs)
        np.testing.assert_array_equal(t.imgs_raw.numpy(), j.imgs_raw)
        if j.img_hw is None:
            assert t.img_hw is None
        else:
            np.testing.assert_array_equal(t.img_hw.numpy(), j.img_hw)


@pytest.mark.parametrize("name,split,kw", [
    ("TID2013Dataset", [0], dict(batch_size=7, shuffle=True, allow_img_flip=True,
                                 num_repeats_data=2, prefetch=2)),
    ("KADID10kDataset", [0], dict(batch_size=16, shuffle=False, prefetch=0,
                                  pad_partial_batches=True)),
    ("PIPAL", [0], dict(batch_size=5, shuffle=True, prefetch=1, pad_partial_batches=False)),
    ("LIVEDataset", None, dict(batch_size=3, shuffle=True, allow_img_flip=True,
                               max_size_buckets=2, prefetch=2)),
    ("LIVEDataset", None, dict(batch_size=4, shuffle=False, max_size_buckets=0, prefetch=0)),
], ids=["tid_flips_repeats", "kadid_png_pad", "pipal_nopad", "live_buckets", "live_exact"])
def test_loader_batches_equal_jax(trees, name, split, kw):
    root = trees[0]
    jds = getattr(JD, name)(datasets_root=root)
    tds = getattr(D, name)(datasets_root=root)
    jds.add_split(None if split is None else JD.dataset_split("S", split))
    tds.add_split(None if split is None else D.dataset_split("S", split))
    split_name = "FullDataset" if split is None else "S"
    args = dict(patch_count=16, seed=11, **kw)
    jl = JLoader(jds, split_name, **args)
    tl = PatchDatasetLoader(tds, split_name, **args)
    assert len(tl) == len(jl)
    assert tl.size_buckets() == jl.size_buckets()
    for _epoch in range(2):  # epochs differ (the rng is keyed by epoch)
        tb, jb = _batches(tl), _batches(jl)
        _assert_same_batches(tb, jb)
        assert len(tb) == len(tl)
    assert len(tl.decode_seconds) == 2 * len(tl)
    if kw.get("max_size_buckets"):
        hw = np.concatenate([b.img_hw.numpy() for b in tb])
        assert len({tuple(b.imgs_raw.shape[2:4]) for b in tb}) <= 2
        assert (hw < np.asarray([b.imgs_raw.shape[2:4] for b in tb for _ in
                                 range(b.imgs_raw.shape[0])])).any()


def test_loader_per_sample_path_equals_native(trees):
    """A dataset overriding img_pretransform decodes sample by sample, with
    the same rng draws, so the batches match JAX's per-sample path too."""
    root = trees[0]

    class JHalf(JD.TID2013Dataset):
        def img_pretransform(self, img):
            return img * 0.5

    class THalf(D.TID2013Dataset):
        def img_pretransform(self, img):
            return img * 0.5

    jds, tds = JHalf(datasets_root=root), THalf(datasets_root=root)
    jds.add_split(JD.dataset_split("S", [0]))
    tds.add_split(D.dataset_split("S", [0]))
    args = dict(batch_size=6, patch_count=16, shuffle=True, allow_img_flip=True, seed=4,
                prefetch=0)
    tl = PatchDatasetLoader(tds, "S", **args)
    assert not tl._use_native_batch_decode()
    _assert_same_batches(_batches(tl), _batches(JLoader(jds, "S", **args)))


def test_loader_stops_its_producer_when_the_consumer_stops(trees):
    tds = D.TID2013Dataset(datasets_root=trees[0])
    tds.add_split(D.dataset_split("S", [0]))
    loader = PatchDatasetLoader(tds, "S", batch_size=4, patch_count=16, prefetch=1)
    it = iter(loader)
    next(it)
    it.close()  # the generator's finally drains the queue and joins the thread
    assert len(list(loader)) == len(loader)


def test_loader_raises_for_multiple_processes(trees):
    """Several processes load their slices of global batches
    (tests/test_torch_parallel.py); a process index outside the count
    raises."""
    tds = D.TID2013Dataset(datasets_root=trees[0])
    tds.add_split(None)
    for index, count in ((2, 2), (-1, 2), (1, 1)):
        with pytest.raises(ValueError, match="outside"):
            PatchDatasetLoader(tds, "FullDataset", batch_size=2, patch_count=4,
                               process_index=index, process_count=count)
    assert PatchDatasetLoader(tds, "FullDataset", batch_size=2, patch_count=4,
                              process_index=1, process_count=2).process_index == 1


def test_canonical_buckets_match_jax():
    from vtamiq_tpu.data.buckets import compute_canonical_buckets as jbuckets
    rng = np.random.default_rng(0)
    sizes = [tuple(s) for s in rng.integers(20, 90, (40, 2))]
    for k in (1, 2, 3, 5):
        for multiple in (1, 8):
            assert compute_canonical_buckets(sizes, k, multiple) == jbuckets(sizes, k, multiple)
    assert compute_canonical_buckets([], 3) == []


def _files(root):
    out = []
    for d, _, names in os.walk(root):
        out += [os.path.relpath(os.path.join(d, n), root) for n in names]
    return sorted(out)


def test_writers_match_jax(trees):
    jroot, troot = trees
    jfiles, tfiles = _files(jroot), _files(troot)
    added = ("PIPAL/Test_", "PIPAL/Val_", "PIPAL/NTIRE2022", "koniq10k/")  # by the parser test
    jfiles = [f for f in jfiles if not f.startswith(added)]
    assert tfiles == jfiles
    images = 0
    for rel in tfiles:
        a, b = os.path.join(troot, rel), os.path.join(jroot, rel)
        ext = os.path.splitext(rel)[1]
        if ext in (".bmp", ".png"):
            np.testing.assert_array_equal(native_io.decode_rgb(a), native_io.decode_rgb(b),
                                          err_msg=rel)
            images += 1
        elif ext == ".mat":
            ma, mb = scipy.io.loadmat(a), scipy.io.loadmat(b)
            for key in ("dmos_new", "orgs"):
                if key in mb:
                    np.testing.assert_array_equal(ma[key], mb[key])
            if "refnames_all" in mb:
                assert [x[0] for x in ma["refnames_all"].flatten()] == \
                    [x[0] for x in mb["refnames_all"].flatten()]
        else:
            assert filecmp.cmp(a, b, shallow=False), rel
    assert images > 400


def test_port_trees_parse_like_jax_trees(trees):
    jroot, troot = trees
    for name in ("TID2013Dataset", "KADID10kDataset", "LIVEDataset", "CSIQDataset", "PIPAL",
                 "PieAPPTestset"):
        a = getattr(D, name)(datasets_root=troot)
        b = getattr(D, name)(datasets_root=jroot)
        np.testing.assert_array_equal(a.qs, b.qs)
        assert [p.replace(troot, "") for p in a.paths_dist] == \
            [p.replace(jroot, "") for p in b.paths_dist]


def test_generate_all_and_cli(tmp_path, capsys):
    synth.main(["--root", str(tmp_path), "--datasets", "csiq"])
    out = capsys.readouterr().out
    assert "CSIQ" in out and os.path.isfile(tmp_path / "CSIQ" / "DMOS.csv")
    marker = tmp_path / "CSIQ" / ".synth_done"
    mtime = os.path.getmtime(marker)
    synth.generate_all(str(tmp_path), ["csiq"])  # the marker matches: no rewrite
    assert os.path.getmtime(marker) == mtime
    with pytest.raises(ValueError, match="unknown dataset"):
        synth.generate_all(str(tmp_path), ["nope"])
