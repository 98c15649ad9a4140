"""Quality-score preprocessing: normalize / reverse / linearize.

Port of ``vtamiq_tpu/ops/values.py`` (numpy only, unchanged): min-max and
mean/std normalization, score reversal, and the histogram-equalizing
"linearize" step of the datasets' quality processing.
"""

from __future__ import annotations

import numpy as np

from .fitting import FitFunction


def normalize_values(v, normalize: bool = True, normalize_mean_std: bool = False,
                     vmin=None, vmax=None, vmean=None, vstd=None, inplace: bool = True):
    v = np.asarray(v, dtype=float)
    if not inplace:
        v = v.copy()
    if normalize:
        v -= v.min() if vmin is None else vmin
        v /= v.max() if vmax is None else (vmax - vmin)
    if normalize_mean_std:
        v -= v.mean() if vmean is None else vmean
        v /= v.std() if vstd is None else vstd
    return v


def reverse_values(v, reverse: bool = True, vmin=None, vmax=None):
    """Flip score convention (e.g. MOS "higher=better" -> "lower=better")."""
    v = np.asarray(v, dtype=float)
    if reverse:
        v = (v.min() if vmin is None else vmin) + (v.max() if vmax is None else vmax) - v
    return v


def linearize_values(qs, warn=None):
    """Histogram-equalize a score array via a monotone parametric fit.

    Sorts the scores, targets a uniform ramp, fits the 5-param logistic with
    L2 residuals, and applies it (reference: patch_datasets.py:217-229).
    Returns (linearized_qs, fit | None); falls back to the input on overflow.
    """
    qs = np.asarray(qs, dtype=float)
    sorted_indices = np.argsort(qs)
    qs_counts = np.arange(len(qs))
    qs_lin = qs_counts / len(qs) * qs.max() - qs.min()
    qs_sort = qs[sorted_indices]
    try:
        fit = FitFunction(qs_sort, qs_lin, residuals_func="L2")
        return fit(qs), fit
    except OverflowError:
        if warn is not None:
            warn("Overflow during Q linearization; using raw quality values.")
        return qs.copy(), None


def process_qs(qs, qs_normalize: bool = True, qs_reverse: bool = True,
               qs_normalize_mean_std: bool = False, qs_linearize: bool = True,
               warn=None):
    """Full Q preprocessing chain: normalize -> linearize -> renormalize -> reverse.

    Mirrors ``IQADataset.process_qs`` (patch_datasets.py:207-241) exactly,
    including ordering of the steps.
    """
    if qs_linearize and qs_normalize_mean_std:
        raise ValueError("qs_normalize_mean_std is mutually exclusive with qs_linearize.")
    qs = np.asarray(qs, dtype=float).copy()
    qs = normalize_values(qs, qs_normalize, qs_normalize_mean_std)
    if qs_linearize:
        qs, _ = linearize_values(qs, warn=warn)
        qs = normalize_values(qs, qs_normalize, qs_normalize_mean_std)
    qs = reverse_values(qs, qs_reverse)
    return qs


def normalize_array(a, eps: float = 1e-12):
    """Min-max normalize to [0, 1] (reference: image_tools.normalize_array)."""
    a = np.asarray(a, dtype=float)
    amin, amax = a.min(), a.max()
    return (a - amin) / max(amax - amin, eps)
