"""IQA evaluation metrics: SROCC / KROCC / PLCC / RMSE (+ unfitted variants).

Port of ``vtamiq_tpu/ops/correlations.py`` (numpy and scipy, unchanged):
min-max normalize both arrays, Spearman and Kendall rank correlations, then
a 5-parameter logistic fit of predictions onto labels before PLCC/RMSE.
They run on the host, once per report, on small arrays.
"""

from __future__ import annotations

import numpy as np
import scipy.stats

from .fitting import FitFunction
from .values import normalize_array

SROCC_FIELD = "SROCC"
KROCC_FIELD = "KROCC"
PLCC_FIELD = "PLCC"
RMSE_FIELD = "RMSE"
PLCC_NOFIT_FIELD = "PLCC_NOFIT"
RMSE_NOFIT_FIELD = "RMSE_NOFIT"

CORRELATION_FIELDS = (SROCC_FIELD, KROCC_FIELD, PLCC_FIELD, RMSE_FIELD,
                      PLCC_NOFIT_FIELD, RMSE_NOFIT_FIELD)


def compute_correlations(a, b, normalize: bool = True, warn=None):
    """Correlations between label array ``a`` and prediction array ``b``."""
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    if normalize:
        aa = normalize_array(a)
        bb = normalize_array(b)
    else:
        aa = a.copy()
        bb = b.copy()

    spearman = scipy.stats.spearmanr(aa, bb).correlation
    kendall = scipy.stats.kendalltau(aa, bb).correlation

    pearson_nofit = scipy.stats.pearsonr(aa, bb)[0]
    rmse_nofit = float(np.sqrt(((aa - bb) ** 2).mean()))

    # logistic calibration of predictions onto labels before PLCC/RMSE
    try:
        fit = FitFunction(bb, aa)
        bb = fit(bb)
    except OverflowError as e:
        if warn is not None:
            warn(f"Overflow during logistic fit: {e}")

    pearson = scipy.stats.pearsonr(aa, bb)[0]
    rmse = float(np.sqrt(((aa - bb) ** 2).mean()))

    return {
        SROCC_FIELD: float(spearman),
        KROCC_FIELD: float(kendall),
        PLCC_FIELD: float(pearson),
        RMSE_FIELD: float(rmse),
        PLCC_NOFIT_FIELD: float(pearson_nofit),
        RMSE_NOFIT_FIELD: float(rmse_nofit),
    }


def average_over_repeats(x, num_repeats: int):
    """Average predictions across eval repeats: (R*M,) -> (M,) by mean over R.

    The reference averages *predictions* across repeats, not metrics
    (train.py:398-409) — preserved here.
    """
    x = np.asarray(x, dtype=float)
    return x.reshape(num_repeats, -1).mean(axis=0)


def compute_correlations_flat(ys, yp, num_repeats: int = 1, warn=None):
    """Concatenate per-batch label/prediction lists and compute correlations."""
    ys = np.concatenate([np.asarray(y, dtype=float).ravel() for y in ys])
    yp = np.concatenate([np.asarray(p, dtype=float).ravel() for p in yp])
    if num_repeats > 1:
        ys = average_over_repeats(ys, num_repeats)
        yp = average_over_repeats(yp, num_repeats)
    return compute_correlations(ys, yp, warn=warn)
