"""Parametric curve fitting for metric calibration and Q linearization.

Port of ``vtamiq_tpu/ops/fitting.py`` (numpy and scipy, unchanged): four
fit-function families, L1/L2 residuals, scipy ``leastsq``. It runs once per
dataset or correlation report, on the host.
"""

from __future__ import annotations

import numpy as np
import scipy.optimize

FIT_EPS = 1e-6


def _fit_logistic5(p, x):
    # y = p0 * (0.5 - 1/(1 + exp(p1*(x - p2)))) + |p3|*x + p4
    p0, p1, p2, p3, p4 = p[:5]
    return p0 * (0.5 - 1.0 / (1.0 + np.exp(p1 * (x - p2) + FIT_EPS))) + abs(p3) * x + p4


def _fit_logistic4(p, x):
    p0, p1, p2, p3 = p[:4]
    return p0 / (1.0 + np.exp(-p1 * (x - p2))) + p3


def _fit_sqrt_quad(p, x):
    p0, p1, p2, p3 = p[:4]
    return p0 * np.sqrt(np.abs(x - p1 + FIT_EPS)) + p2 * (x - p1) ** 2 + p3


def _fit_sigmoid3(p, x):
    p0, p1, p2 = p[:3]
    return p0 / (p1 + np.exp(-x)) + p2


class FitFunction:
    """Least-squares fit of ``source -> target`` with a chosen function family.

    Family 1 (default) is the 5-parameter logistic used throughout IQA
    literature for PLCC/RMSE calibration.
    """

    _FAMILIES = {
        1: (_fit_logistic5, lambda s, t: (1.0, 1.0, float(np.median(s)), 1.0, float(np.median(t)))),
        2: (_fit_logistic4, lambda s, t: (1.0, 1.0, float(np.median(s)), float(np.median(t)))),
        3: (_fit_sqrt_quad, lambda s, t: (1.0, 0.0, 1.0, 0.0)),
        4: (_fit_sigmoid3, lambda s, t: (1.0, 1.0, 0.0)),
    }

    def __init__(self, source, target, fit_function_to_use: int = 1,
                 residuals_func: str = "L1", pguess=None):
        source = np.asarray(source, dtype=float)
        target = np.asarray(target, dtype=float)

        if fit_function_to_use not in self._FAMILIES:
            raise ValueError(f"Unsupported fit function family [{fit_function_to_use}].")
        self.fit_function, guess_fn = self._FAMILIES[fit_function_to_use]
        self.pguess = tuple(pguess) if pguess is not None else guess_fn(source, target)

        if residuals_func == "L1":
            self.regularization = 1
        elif residuals_func == "L2":
            self.regularization = 2
        else:
            raise ValueError(f"Unsupported residuals function [{residuals_func}].")

        try:
            with np.errstate(over="ignore", invalid="ignore"):
                self.p, _cov, _info, _msg, _ier = scipy.optimize.leastsq(
                    self._residuals, self.pguess, args=(source, target), full_output=True)
        except TypeError as e:
            # leastsq requires at least as many points as parameters
            raise OverflowError(f"FitFunction: fit failed ({e}).")

        if np.isnan(np.asarray(self.p, dtype=float)).any():
            raise OverflowError("FitFunction: fit produced NaNs.")

    def _residuals(self, p, x, y):
        return (y - self.fit_function(p, x)) ** self.regularization

    def __call__(self, x, p=None):
        x = np.asarray(x, dtype=float)
        with np.errstate(over="ignore", invalid="ignore"):
            return self.fit_function(self.p if p is None else p, x)


def fit_values(source, target, max_fit_error: float = 0.2, warn=None):
    """Fit ``source`` onto ``target`` and return (fitted_source, fit | None).

    Falls back to the unfitted input when the optimizer overflows
    (reference: correlations.py:147-162 fit_values/fit_regression).
    """
    source = np.asarray(source, dtype=float)
    target = np.asarray(target, dtype=float)
    try:
        fit = FitFunction(source, target)
    except OverflowError:
        if warn is not None:
            warn("FitFunction failed (overflow); returning unfitted values.")
        return source.copy(), None

    fitted = fit(source)
    res_max = np.abs(fitted - target).max()
    allowed = max_fit_error * (target.max() - target.min())
    if res_max > allowed and warn is not None:
        warn(f"fit max error [{res_max:.4g}] exceeds allowed [{allowed:.4g}].")
    return fitted, fit
