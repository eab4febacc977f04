"""The climatology of many cells at once, in float64 NumPy.

:func:`oracle.clim_oracle` for a (T, m) block: the same pools (for every
step t and offset |k| <= w, ts[t + k] joins the pool of t's row; NaN
never enters a pool), numpy's linear-interpolation quantile and the mean
of each pool, the 29 February row as the mean of rows 59-61, and the
circular running mean. The pools are built once for all m cells, so a
block of cells costs one pass of Python over the time axis.
"""

from __future__ import annotations

import warnings

import numpy as np


def pools(doy, ndoy, w):
    """For each 0-based row, the time indexes pooled into it."""
    T = len(doy)
    out = [[] for _ in range(ndoy)]
    for t in range(T):
        out[doy[t] - 1].extend(range(max(t - w, 0), min(t + w + 1, T)))
    return [np.asarray(p, np.int64) for p in out]


def quantile(v, q):
    """numpy's linear-interpolation quantile of each column of ``v`` over
    its non-NaN values (NaN for a column without any): the sort, the
    virtual index q * (n - 1) and numpy's interpolation, written out so
    that the columns are done together."""
    v = np.sort(v, axis=0)  # NaN last
    n = (~np.isnan(v)).sum(axis=0)
    virt = q * (n - 1)
    lo = np.clip(np.floor(virt), 0, None).astype(np.int64)
    hi = np.minimum(lo + 1, np.maximum(n - 1, 0))
    g = virt - lo
    a = np.take_along_axis(v, lo[None], axis=0)[0]
    b = np.take_along_axis(v, hi[None], axis=0)[0]
    d = b - a
    out = np.where(g >= 0.5, b - d * (1 - g), a + d * g)
    return np.where(n > 0, out, np.nan)


def circ_smooth(x, w):
    """Centred running mean of odd width ``w`` along axis 0, periodic and
    NaN-propagating (:func:`oracle._circ_smooth` for every column)."""
    half = (w - 1) // 2
    acc = np.zeros_like(x)
    for k in range(-half, half + 1):
        acc = acc + np.roll(x, -k, axis=0)
    return acc / w


def clim_many(ts, doy, ndoy, w=5, pctile=90, smooth=True, smooth_w=31,
              feb29=True):
    """ts: (T, m) float; returns (thresh, seas), each (ndoy, m) float64."""
    x = np.asarray(ts, np.float64)
    th = np.full((ndoy, x.shape[1]), np.nan)
    se = np.full_like(th, np.nan)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN pools
        for d, idx in enumerate(pools(doy, ndoy, w)):
            if len(idx):
                v = x[idx]
                th[d] = quantile(v, pctile / 100)
                se[d] = np.nanmean(v, axis=0)
        if feb29:
            th[59] = np.nanmean(th[58:61], axis=0)
            se[59] = np.nanmean(se[58:61], axis=0)
    if smooth:
        th = circ_smooth(th, smooth_w)
        se = circ_smooth(se, smooth_w)
    return th, se
