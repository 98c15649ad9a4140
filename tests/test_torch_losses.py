"""The port's losses against the JAX package's: values and gradients on the
same inputs (made with numpy), with padded batches (``valid``), batches of
fewer than two items, constant predictions and the weighted combination."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vtamiq_tpu.ops import losses as jl
from vtamiq_tpu_torch.ops import losses as tl

# fp32 on both sides, the same formulas summed in other orders
TOL = 1e-6
# the Pearson gradient at constant predictions is ~1/eps = 1e6 times the
# normalized targets, so its absolute error scales with it
CONST_GRAD_RTOL = 1e-5


def data(n=8, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n).astype(np.float32), rng.uniform(size=n).astype(np.float32))


def both(fn_name, d, y, *args, **kw):
    """(value, gradient in d) from each package."""
    jf = getattr(jl, fn_name)
    tf = getattr(tl, fn_name)
    jv, jg = jax.value_and_grad(lambda dd: jf(dd, jnp.asarray(y), *args, **kw))(jnp.asarray(d))
    td = torch.from_numpy(d.copy()).requires_grad_()
    tv = tf(td, torch.from_numpy(y), *args, **kw)
    (tg,) = torch.autograd.grad(tv, td)
    return (float(jv), np.asarray(jg)), (float(tv.detach()), tg.numpy())


@pytest.mark.parametrize("name", ["mae_loss", "mse_loss", "pears_loss", "rank_loss",
                                  "loss_func_pairwise"])
@pytest.mark.parametrize("valid", [None, 5, 1])
def test_loss_and_gradient_match_jax(name, valid):
    d, y = data()
    kw = {} if valid is None else {"valid": valid}
    (jv, jg), (tv, tg) = both(name, d, y, **kw)
    assert tv == pytest.approx(jv, rel=TOL, abs=TOL)
    np.testing.assert_allclose(tg, jg, rtol=TOL, atol=TOL)
    if valid is not None:  # padded items get no gradient
        assert np.all(tg[valid:] == 0.0)


@pytest.mark.parametrize("n", [0, 1])
def test_rank_loss_below_two_items_is_zero(n):
    d, y = data(n)
    assert float(tl.rank_loss(torch.from_numpy(d), torch.from_numpy(y))) == 0.0
    assert float(jl.rank_loss(jnp.asarray(d), jnp.asarray(y))) == 0.0


@pytest.mark.parametrize("const", [0.0, 12.8591])
def test_gradient_at_constant_predictions_is_finite_and_matches_jax(const):
    """All-equal predictions zero the centered vector: the smooth norm keeps
    the Pearson gradient finite (no NaN), and the rank loss's hinge sits at
    its tie; both split the gradient as JAX does."""
    _, y = data(4, seed=1)
    d = np.full(4, const, np.float32)
    for name in ("pears_loss", "rank_loss"):
        (jv, jg), (tv, tg) = both(name, d, y)
        assert np.isfinite(tv) and np.isfinite(tg).all()
        assert tv == pytest.approx(jv, rel=TOL)
        np.testing.assert_allclose(tg, jg, rtol=CONST_GRAD_RTOL, atol=TOL)
    # a single valid item is constant by definition
    d = np.array([12.8591, 7.0, -3.0], np.float32)
    (_, jg), (_, tg) = both("pears_loss", d, y[:3], valid=1)
    assert np.isfinite(tg).all()
    np.testing.assert_allclose(tg, jg, rtol=CONST_GRAD_RTOL, atol=TOL)


def test_rank_loss_masks_before_it_divides():
    """Zero predictions make every max(|d_i|, |d_j|) zero: no NaN."""
    y = np.array([0.1, 0.9, 0.5], np.float32)
    (jv, jg), (tv, tg) = both("rank_loss", np.zeros(3, np.float32), y)
    assert np.isfinite(tv) and np.isfinite(tg).all()
    assert tv == pytest.approx(jv, abs=TOL)
    np.testing.assert_allclose(tg, jg, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("valid", [None, 6])
def test_loss_func_iqa_matches_jax(weighted, valid):
    """Unweighted: rank + pears, weights ignored (MAE reported only);
    weighted: w_mae*mae + w_rank*rank + w_pears*pears."""
    d, y = data(seed=2)
    w = (0.75, 1.0, 0.2)

    def jf(dd):
        return jl.loss_func_iqa(dd, jnp.asarray(y), *w, weighted=weighted, valid=valid)

    (jv, jaux), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(d))
    td = torch.from_numpy(d.copy()).requires_grad_()
    tv, taux = tl.loss_func_iqa(td, torch.from_numpy(y), *w, weighted=weighted, valid=valid)
    (tg,) = torch.autograd.grad(tv, td)
    assert float(tv.detach()) == pytest.approx(float(jv), rel=TOL)
    for key in ("mae", "rank", "pears"):
        assert float(taux[key].detach()) == pytest.approx(float(jaux[key]), rel=TOL, abs=TOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=TOL, atol=TOL)
    if not weighted:
        assert float(tv.detach()) == pytest.approx(float((taux["rank"] + taux["pears"]).detach()), rel=1e-7)


def test_spearman_loss_matches_jax():
    rng = np.random.default_rng(3)
    x, y = rng.normal(size=(3, 7)).astype(np.float32), rng.normal(size=(3, 7)).astype(np.float32)
    want = float(jl.spearman_loss(jnp.asarray(x), jnp.asarray(y)))
    got = float(tl.spearman_loss(torch.from_numpy(x), torch.from_numpy(y)))
    assert got == pytest.approx(want, rel=TOL)
