"""Canonical (H, W) size buckets for variable-size datasets.

Port of ``vtamiq_tpu/data/buckets.py`` (numpy only). The loader and the
scorer pad each image up to one of a few bucket shapes and carry its true
(h, w) beside it; the sampler confines patches to the true region, so the
padding never reaches the model, and mixed sizes share one device batch.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

Size = Tuple[int, int]


def compute_canonical_buckets(sizes: Sequence[Size], max_buckets: int = 4,
                              multiple: int = 1) -> List[Size]:
    """Choose <= max_buckets bucket shapes covering every (h, w) in ``sizes``
    (bucket_h >= h and bucket_w >= w), minimizing total padded pixel count.

    Exact DP over sizes sorted by height, partitioned into contiguous height
    groups; each group's bucket is (max h, max w) of the group — O(n^2 * k)
    over n unique sizes. Contiguous-by-height partitions are a restriction
    (mixed portrait/landscape datasets may pay extra pad), but the bound
    holds: every size is covered and the executable count is <= max_buckets.

    ``multiple`` rounds bucket dims up (e.g. 8) so closely-spaced size
    clusters in huge datasets (KADIS) collapse onto shared buckets.
    """
    if not sizes:
        return []
    uniq: Dict[Size, int] = {}
    for s in sizes:
        s = (int(s[0]), int(s[1]))
        uniq[s] = uniq.get(s, 0) + 1
    items = sorted(uniq.items())  # by (h, w)
    n = len(items)
    k = min(max_buckets, n)

    def rup(x: int) -> int:
        return ((x + multiple - 1) // multiple) * multiple

    # cost[i][j]: padded pixels if sizes i..j share one bucket
    hs = [s[0] for s, _ in items]
    ws = [s[1] for s, _ in items]
    cnt = [c for _, c in items]
    cost = np.zeros((n, n))
    bucket_for = {}
    for i in range(n):
        max_w = 0
        for j in range(i, n):
            max_w = max(max_w, ws[j])
            bh, bw = rup(hs[j]), rup(max_w)  # heights sorted: hs[j] is max
            bucket_for[(i, j)] = (bh, bw)
            cost[i, j] = sum(cnt[t] * (bh * bw - hs[t] * ws[t])
                             for t in range(i, j + 1))

    # DP: best[m][j] = min cost covering sizes 0..j with m buckets
    INF = float("inf")
    best = np.full((k + 1, n), INF)
    choice = np.full((k + 1, n), -1, int)
    for j in range(n):
        best[1, j] = cost[0, j]
    for m in range(2, k + 1):
        for j in range(n):
            for i in range(j + 1):
                prev = 0.0 if i == 0 else best[m - 1, i - 1]
                c = prev + cost[i, j]
                if c < best[m, j]:
                    best[m, j] = c
                    choice[m, j] = i
    # fewer buckets may already be optimal
    m_best = int(np.argmin(best[1:, n - 1])) + 1
    # reconstruct
    buckets = []
    j = n - 1
    m = m_best
    while j >= 0 and m >= 1:
        i = 0 if m == 1 else int(choice[m, j])
        buckets.append(bucket_for[(i, j)])
        j = i - 1
        m -= 1
    return sorted(set(buckets))


def assign_bucket(size: Size, buckets: Sequence[Size]) -> Size:
    """Smallest-area bucket covering ``size``; falls back to elementwise max
    (a fresh shape) if nothing covers it — never crops."""
    h, w = int(size[0]), int(size[1])
    candidates = [b for b in buckets if b[0] >= h and b[1] >= w]
    if not candidates:
        return (h, w)
    return min(candidates, key=lambda b: b[0] * b[1])


def pad_to_bucket(img: np.ndarray, bucket: Size) -> np.ndarray:
    """Zero-pad an (h, w, c) image bottom/right to the bucket shape. The
    device sampler never reads the pad (positions are confined to the true
    region via img_hw), so the fill value is irrelevant."""
    h, w = img.shape[:2]
    bh, bw = bucket
    if (h, w) == (bh, bw):
        return img
    out = np.zeros((bh, bw) + img.shape[2:], dtype=img.dtype)
    out[:h, :w] = img
    return out
