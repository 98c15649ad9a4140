"""The port's IQA metrics (values, fitting, correlations) and in-memory
synthetic pairs against the JAX package's, on the CPU: the same numpy and
scipy computations, equal to 1e-12 (the generators bit for bit)."""

import numpy as np
import pytest

from vtamiq_tpu.data import synth as jsynth
from vtamiq_tpu.ops import correlations as jcorr
from vtamiq_tpu.ops import fitting as jfit
from vtamiq_tpu.ops import values as jvalues
from vtamiq_tpu_torch.data import synth as tsynth
from vtamiq_tpu_torch.ops import correlations as tcorr
from vtamiq_tpu_torch.ops import fitting as tfit
from vtamiq_tpu_torch.ops import values as tvalues

TOL = 1e-12


def scores(seed, n=96, noise=0.1):
    rng = np.random.default_rng(seed)
    mos = rng.uniform(0, 1, n)
    pred = 2.0 * np.tanh(1.5 * mos - 0.5) + rng.normal(0, noise, n)
    return mos, pred


def assert_dicts_close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=TOL, abs=TOL), k


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_compute_correlations(seed, normalize):
    mos, pred = scores(seed)
    got = tcorr.compute_correlations(mos, pred, normalize=normalize)
    assert_dicts_close(got, jcorr.compute_correlations(mos, pred, normalize=normalize))
    assert set(got) == set(tcorr.CORRELATION_FIELDS)


@pytest.mark.parametrize("num_repeats", [1, 3])
def test_compute_correlations_flat(num_repeats):
    mos, pred = scores(2, n=24 * num_repeats)
    ys = np.split(np.tile(mos[:24], num_repeats), 4 * num_repeats)
    yp = np.split(pred, 4 * num_repeats)
    assert_dicts_close(tcorr.compute_correlations_flat(ys, yp, num_repeats),
                       jcorr.compute_correlations_flat(ys, yp, num_repeats))
    np.testing.assert_array_equal(tcorr.average_over_repeats(pred, num_repeats),
                                  jcorr.average_over_repeats(pred, num_repeats))


def test_compute_correlations_overflow_warns_like_jax():
    """Too few points for the 5-parameter fit: both warn and keep the
    unfitted predictions."""
    got_msgs, want_msgs = [], []
    got = tcorr.compute_correlations([0.1, 0.5, 0.9], [0.2, 0.4, 1.0], warn=got_msgs.append)
    want = jcorr.compute_correlations([0.1, 0.5, 0.9], [0.2, 0.4, 1.0], warn=want_msgs.append)
    assert_dicts_close(got, want)
    assert len(got_msgs) == len(want_msgs) == 1


@pytest.mark.parametrize("residuals", ["L1", "L2"])
@pytest.mark.parametrize("family", [1, 2, 3, 4])
def test_fit_function(family, residuals):
    mos, pred = scores(3 + family, n=64, noise=0.05)
    got = tfit.FitFunction(pred, mos, family, residuals)
    want = jfit.FitFunction(pred, mos, family, residuals)
    np.testing.assert_allclose(got.p, want.p, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got(pred), want(pred), rtol=TOL, atol=TOL)


def test_fit_function_rejects_unknown_options():
    with pytest.raises(ValueError, match="fit function"):
        tfit.FitFunction([0, 1], [0, 1], 9)
    with pytest.raises(ValueError, match="residuals"):
        tfit.FitFunction([0, 1], [0, 1], 1, "L3")


def test_fit_values():
    mos, pred = scores(9, n=48)
    got, gfit = tfit.fit_values(pred, mos)
    want, wfit = jfit.fit_values(pred, mos)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert (gfit is None) == (wfit is None)


@pytest.mark.parametrize("kw", [dict(), dict(qs_linearize=False),
                                dict(qs_linearize=False, qs_normalize_mean_std=True),
                                dict(qs_reverse=False)])
def test_values(kw):
    qs = scores(5, n=80)[1] * 3 + 1
    np.testing.assert_allclose(tvalues.process_qs(qs, **kw), jvalues.process_qs(qs, **kw),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tvalues.normalize_array(qs), jvalues.normalize_array(qs),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tvalues.reverse_values(qs), jvalues.reverse_values(qs),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tvalues.linearize_values(qs)[0], jvalues.linearize_values(qs)[0],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tvalues.normalize_values(qs, vmin=0.5, vmax=3.0, inplace=False),
                               jvalues.normalize_values(qs, vmin=0.5, vmax=3.0, inplace=False),
                               rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tvalues.process_qs(qs, qs_normalize_mean_std=True)


def test_synthetic_pairs_equal_jax():
    """Base images, every distortion of the bank at two severities, the
    quality labels and the per-type gains: bit for bit, from equal seeds."""
    a, b = np.random.default_rng(0), np.random.default_rng(0)
    ref_t, ref_j = tsynth.make_base_image(a, 48, 64), jsynth.make_base_image(b, 48, 64)
    np.testing.assert_array_equal(ref_t, ref_j)
    np.testing.assert_array_equal(tsynth._type_gains(a, 12), jsynth._type_gains(b, 12))
    assert len(tsynth.DISTORTION_BANK) == len(jsynth.DISTORTION_BANK) == 12
    for dist_type in range(14):   # past the bank's end it cycles
        for level in (1, 5):
            np.testing.assert_array_equal(
                tsynth.apply_distortion(a, ref_t, dist_type, level, 5, 1.1),
                jsynth.apply_distortion(b, ref_j, dist_type, level, 5, 1.1))
            assert (tsynth.severity_to_quality(a, level, 5, 0.9)
                    == jsynth.severity_to_quality(b, level, 5, 0.9))
