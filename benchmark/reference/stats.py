"""Year-bin statistics of one cell, in plain NumPy.

The block statistics of xmhw's ``block_average`` (its stats.py, agg_event
and agg_ts/agg_cats) for bins of whole years:

* events go to the bin of their start year; each statistic reduces the
  events of a bin whose value is finite: the count of events, the mean of
  thirteen properties, the largest ``intensity_max`` and the sum of
  ``intensity_cumulative`` (0 for a bin without events, NaN for the
  others);
* days go to the bin of their year: the mean, largest and smallest value,
  and the days of each category, ``floor(1 + (ts - th) / (th - se))``
  equal to 1, 2, 3 and 4 (moderate, strong, severe, extreme), and their
  total.
"""

from __future__ import annotations

import numpy as np

# output -> (event property, reduction)
EVENT_STATS = {
    "ecount": ("event", "count"),
    "duration": ("duration", "mean"),
    "intensity_max": ("intensity_max", "mean"),
    "intensity_max_max": ("intensity_max", "max"),
    "intensity_mean": ("intensity_mean", "mean"),
    "intensity_cumulative": ("intensity_cumulative", "mean"),
    "total_icum": ("intensity_cumulative", "sum"),
    "intensity_mean_relThresh": ("intensity_mean_relThresh", "mean"),
    "intensity_cumulative_relThresh": ("intensity_cumulative_relThresh",
                                       "mean"),
    "severity_mean": ("severity_mean", "mean"),
    "severity_cumulative": ("severity_cumulative", "mean"),
    "intensity_mean_abs": ("intensity_mean_abs", "mean"),
    "intensity_cumulative_abs": ("intensity_cumulative_abs", "mean"),
    "rate_onset": ("rate_onset", "mean"),
    "rate_decline": ("rate_decline", "mean"),
}
CATEGORY_DAYS = {"moderate_days": 1, "strong_days": 2, "severe_days": 3,
                 "extreme_days": 4}


def event_stats(events, year_of_step, bins):
    """events: the oracle's dicts of one cell; year_of_step: (T,) years;
    bins: the nbins + 1 left-closed bin edges in years. Returns name ->
    (nbins,) float64."""
    nb = len(bins) - 1
    out = {}
    for name, (prop, how) in EVENT_STATS.items():
        vals = [[] for _ in range(nb)]
        for e in events:
            b = int(np.searchsorted(bins, year_of_step[int(e["index_start"])],
                                    side="right")) - 1
            if 0 <= b < nb and np.isfinite(e[prop]):
                vals[b].append(e[prop])
        col = np.full(nb, np.nan)
        for b, v in enumerate(vals):
            if how == "count":
                col[b] = len(v)
            elif how == "sum":
                col[b] = float(np.sum(v)) if v else 0.0
            elif v:
                col[b] = float(np.mean(v)) if how == "mean" else max(v)
        out[name] = col
    return out


def day_edges(year_of_step, bins):
    """Step index at which each bin starts, and where the last one ends
    (the steps run in time order)."""
    return np.searchsorted(year_of_step, bins, side="left")


def categories(ts, th_t, se_t):
    """The category of each day (float64; NaN where any input is)."""
    return np.floor(1.0 + (ts - th_t) / (th_t - se_t))


def day_stats(ts, cats, edges):
    """ts, cats: (T,); edges from :func:`day_edges`. Returns name ->
    (nbins,) float64: ts_mean, ts_max, ts_min and the category days."""
    nb = len(edges) - 1
    out = {k: np.full(nb, np.nan) for k in ("ts_mean", "ts_max", "ts_min")}
    out.update({k: np.zeros(nb) for k in (*CATEGORY_DAYS, "total_days")})
    for b in range(nb):
        seg = np.asarray(ts[edges[b]:edges[b + 1]], np.float64)
        fin = seg[np.isfinite(seg)]
        if fin.size:
            out["ts_mean"][b] = fin.mean()
            out["ts_max"][b] = fin.max()
            out["ts_min"][b] = fin.min()
        c = cats[edges[b]:edges[b + 1]]
        for name, k in CATEGORY_DAYS.items():
            out[name][b] = float((c == k).sum())
        out["total_days"][b] = sum(out[n][b] for n in CATEGORY_DAYS)
    return out
