"""The port's remaining host helpers (``vtamiq_tpu_torch/utils``: image
tools, the MATLAB bridge, ``LogOnTaskComplete``, ``float2str3``, the
profiling helpers and the measurement harness) on the CPU, mirroring
``tests/test_utils.py`` and ``tests/test_benchharness.py``; the numpy image
tools against the JAX package's, bit for bit."""

import types

import numpy as np
import pytest
import torch

import vtamiq_tpu.utils.image_tools as jtools
import vtamiq_tpu_torch.utils as U
import vtamiq_tpu_torch.utils.benchharness as bh
import vtamiq_tpu_torch.utils.image_tools as ttools
import vtamiq_tpu_torch.utils.profiling as prof
from vtamiq_tpu.utils import float2str3 as jfloat2str3
from vtamiq_tpu_torch.utils.matlab_bridge import MatlabWrapper
from vtamiq_tpu_torch.utils.profiling import StepTimer, synchronize_on, trace


def _img(seed, shape=(37, 53, 3)):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("name,args", [
    ("normalize_array", ()),
    ("resize_image", (24, 40)),
    ("resize_image", (80, 96)),
    ("crop_image", (3, 5, 10, 12)),
    ("center_crop", (20, 31)),
    ("center_crop", (60, 80)),
    ("extract_windows", ((8, 8), (4, 6))),
    ("reinhard_tmo", ()),
    ("reinhard_tmo", (2.5,)),
])
def test_image_tools_match_jax(name, args):
    img = _img(len(name) + len(args)) * 4.0
    got = getattr(ttools, name)(img, *args)
    want = getattr(jtools, name)(img, *args)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_image_tools_cases():
    img = np.arange(36, dtype=float).reshape(6, 6)
    w = ttools.extract_windows(img, (3, 3), (2, 2))
    assert w.shape == (2, 2, 3, 3)
    np.testing.assert_array_equal(w[0, 0], img[:3, :3])
    np.testing.assert_array_equal(w[1, 1], img[2:5, 2:5])
    img = np.arange(48).reshape(6, 8)
    np.testing.assert_array_equal(ttools.crop_image(img, 1, 2, 2, 3), img[1:3, 2:5])
    assert ttools.center_crop(img, 4, 4).shape == (4, 4)
    y = ttools.reinhard_tmo(np.array([0.0, 1.0, 100.0]))
    assert y[0] == 0.0 and y[1] == 0.5 and y[2] < 1.0
    n = ttools.normalize_array(np.array([2.0, 4.0, 6.0]))
    np.testing.assert_array_equal(n, [0.0, 0.5, 1.0])


def test_float2str3_and_exports():
    assert U.float2str3(1.23456) == "1.235" == jfloat2str3(1.23456)
    assert U.float2str(1.23456) == "1.2346"
    for name in ("LogOnTaskComplete", "TemporaryNumpySeed", "fold_seed", "StepTimer", "trace",
                 "looping_iterator", "color_iterator", "batched"):
        assert callable(getattr(U, name)), name
    assert list(U.batched(range(5), 2)) == [[0, 1], [2, 3], [4]]


class _Lines:
    def __init__(self):
        self.lines = []

    def __call__(self, *a, **k):
        self.lines.append(" ".join(str(x) for x in a))


def test_log_on_task_complete():
    log = _Lines()
    with U.LogOnTaskComplete("mytask", logger=log):
        pass
    assert any("mytask" in line and "started" in line for line in log.lines)
    assert any("completed" in line for line in log.lines)
    log = _Lines()
    with pytest.raises(RuntimeError):
        with U.LogOnTaskComplete("failtask", logger=log):
            raise RuntimeError("boom")
    assert any("FAILED (RuntimeError)" in line for line in log.lines)


def test_step_timer_skips_warmup_and_syncs_cpu_results(monkeypatch):
    clock = iter([10.0, 10.5, 11.5])
    monkeypatch.setattr(prof, "time", types.SimpleNamespace(perf_counter=lambda: next(clock)))
    st = StepTimer(warmup_steps=1)
    st.tick(4, block_on=torch.ones(2))    # warmup: starts the clock
    st.tick(4, block_on={"q": [torch.zeros(1)]})
    st.tick(4)
    assert st.timer.deltas == [0.5, 1.0]
    assert st.items_per_sec == pytest.approx(8 / 1.5)
    assert "items/sec" in st.summary() and "2 timed steps" in st.summary()
    synchronize_on([torch.ones(1), (torch.ones(1), {"a": 3.0})])  # CPU: nothing to wait for


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "prof")):
        torch.ones(8, 8) @ torch.ones(8, 8)
    files = list((tmp_path / "prof").glob("trace_*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    assert "traceEvents" in files[0].read_text()


def test_matlab_wrapper_raises_without_matlab():
    with pytest.raises(ImportError, match="matlab.engine"):
        MatlabWrapper()


class _FakeClock:
    """perf_counter that each call of the timed function advances."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


def _fake_time(monkeypatch, durations):
    clock = _FakeClock()
    monkeypatch.setattr(bh, "time", types.SimpleNamespace(perf_counter=clock.perf_counter,
                                                          time_ns=bh.time.time_ns))
    seen = []

    def fn(t):
        seen.append(t)
        clock.now += durations[len(seen) - 1]
        return torch.zeros(1)
    return fn, seen


def test_timed_stats_on_a_fake_clock(monkeypatch):
    fn, seen = _fake_time(monkeypatch, [0.02, 0.04, 0.03])
    # bound 1000 pairs/s -> 10 pairs take at least 0.01 s: all plausible
    st = bh.timed_stats(fn, pairs_per_call=10, bound=1000.0, trials=3)
    assert seen == [0, 1, 2] and st["trials"] == 3
    assert st["median"] == pytest.approx(10 / 0.03)
    assert st["min"] == pytest.approx(10 / 0.04) and st["max"] == pytest.approx(10 / 0.02)


def test_timed_stats_spare_attempts_and_median(monkeypatch):
    fn, seen = _fake_time(monkeypatch, [0.001, 0.001, 0.02, 0.05])
    rate = bh.timed_median(fn, pairs_per_call=10, bound=1000.0, trials=2)
    assert seen == [0, 1, 2, 3]  # 2 rejected + 2 plausible (trials + 2)
    assert rate == pytest.approx(10 / 0.02)  # the upper middle of two


def test_timed_stats_rejects_implausibly_fast(monkeypatch):
    fn, seen = _fake_time(monkeypatch, [1e-6] * 4)
    with pytest.raises(bh.ImplausiblyFast):
        bh.timed_median(fn, pairs_per_call=1000, bound=10.0, trials=2)
    assert len(seen) == 4


def test_fresh_pair_batch_on_the_cpu():
    raw1, g1 = bh.fresh_pair_batch(2, 32, 48, device="cpu")
    raw2, g2 = bh.fresh_pair_batch(2, 32, 48, seed_extra=1, device="cpu")
    assert raw1.shape == (2, 2, 32, 48, 3) and raw1.dtype == torch.float32
    assert raw1.device.type == "cpu" and isinstance(g1, torch.Generator)
    assert float(raw1.min()) >= 0.0 and float(raw1.max()) < 1.0
    assert not torch.equal(raw1, raw2)
    assert g1.initial_seed() != g2.initial_seed()
