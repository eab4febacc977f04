"""Year-block statistics and ranks on the device, in torch.

Port of :mod:`xmhw_tpu.core.stats`. The host path
(``stats_api._binned_reduce``) uses numpy bincount; these functions do
the same aggregations over dense tensors on any device. The JAX package
leans on XLA fusion for two broadcasts that eager torch would
materialise, so two reductions are written differently here:

* :func:`binned_event_stats` reduces one year bin at a time with a masked
  sum over the event axis, instead of a ``(nbins, K, C)`` one-hot
  membership (3.2e9 entries per variable at the 620k-cell OISST grid);
* :func:`rank_events_desc` ranks with a stable sort along the event axis,
  instead of a ``(K, K, C)`` compare-count.

No reduction is a ``scatter_add_`` or ``index_add_``, and float sums
are running sums (:func:`core.clim.ordered_sum`), so each output's order
of float adds is fixed from run to run and from one block width to
another.
"""

from __future__ import annotations

import numpy as np
import torch

from .clim import ordered_sum

# output name -> (source index, reduction); sources order fixed below
EVENT_AGGS = [
    ("ecount", 0, "count"),
    ("duration", 1, "mean"),
    ("intensity_max", 2, "mean"),
    ("intensity_max_max", 2, "max"),
    ("intensity_mean", 3, "mean"),
    ("intensity_cumulative", 4, "mean"),
    ("total_icum", 4, "sum"),
    ("intensity_mean_relThresh", 5, "mean"),
    ("intensity_cumulative_relThresh", 6, "mean"),
    ("severity_mean", 7, "mean"),
    ("severity_cumulative", 8, "mean"),
    ("intensity_mean_abs", 9, "mean"),
    ("intensity_cumulative_abs", 10, "mean"),
    ("rate_onset", 11, "mean"),
    ("rate_decline", 12, "mean"),
]
EVENT_VARS = [
    "event", "duration", "intensity_max", "intensity_mean",
    "intensity_cumulative", "intensity_mean_relThresh",
    "intensity_cumulative_relThresh", "severity_mean",
    "severity_cumulative", "intensity_mean_abs",
    "intensity_cumulative_abs", "rate_onset", "rate_decline",
]


def category_index(ts, th, se, xp=torch):
    """Hobday category index ``floor(1 + (ts-th)/(th-se))`` (reference:
    xmhw/stats.py:227-231, features.py:62). The one definition used by
    the fused pipeline and by block_average (pass ``xp=numpy`` for the
    host path)."""
    return xp.floor(1.0 + (ts - th) / (th - se))


def _masked_extreme(x, keep, largest):
    """Max (or min) over axis 0 of ``x`` where ``keep``; -inf (+inf)
    where no entry is kept, also for an empty axis (no events, or a year
    block without days), where torch's amax/amin would raise."""
    fill = -torch.inf if largest else torch.inf
    if x.shape[0] == 0:
        return torch.full(x.shape[1:], fill, dtype=x.dtype, device=x.device)
    v = torch.where(keep, x, fill)
    return v.amax(dim=0) if largest else v.amin(dim=0)


def binned_event_stats(values, bin_idx, valid, nbins):
    """All block aggregations over compact event tables, on the device.

    values: (NV, K, C) float, the stacked EVENT_VARS; bin_idx: (K, C)
    int; valid: (K, C) bool. Returns dict name -> (nbins, C) in the dtype
    of ``values`` (NaN where a bin has no event; ``total_icum`` 0.0).
    """
    dt = values.dtype
    nan = torch.tensor(float("nan"), dtype=dt, device=values.device)
    fin = {i: valid & torch.isfinite(values[i])
           for i in sorted({i for _, i, _ in EVENT_AGGS})}
    rows = {name: [] for name, _, _ in EVENT_AGGS}
    for b in range(nbins):
        in_bin = bin_idx == b
        member, count = {}, {}
        for name, i, how in EVENT_AGGS:
            if i not in member:
                member[i] = fin[i] & in_bin
                count[i] = member[i].sum(dim=0).to(dt)
            m, cnt = member[i], count[i]
            if how == "count":
                rows[name].append(cnt)
                continue
            v = values[i]
            if how == "max":
                rows[name].append(torch.where(
                    cnt > 0, _masked_extreme(v, m, True), nan))
                continue
            s = ordered_sum(torch.where(m, v, 0), 0)
            if how == "sum":
                # pandas sum of an empty group is 0.0 (reference total_icum)
                rows[name].append(s)
            else:  # mean
                rows[name].append(torch.where(
                    cnt > 0, s / torch.clamp(cnt, min=1), nan))
    return {n: torch.stack(r) for n, r in rows.items()}


def binned_day_stats(ts, cats, edges, with_cats=False, count_nans=False):
    """Per-day year-block statistics on the device: the other half of
    block_average (reference: xmhw/stats.py:366-428, agg_ts/agg_cats).

    ts: (T, C) float; cats: (T, C) float, read only with ``with_cats``.
    ``edges``: nbins+1 time indexes; year blocks are contiguous runs of
    the time axis, so each block is a slice and a reduction over it.
    Returns dict of (nbins, C) tensors: ts_mean/ts_max/ts_min, plus
    moderate/strong/severe/extreme/total_days with ``with_cats``, plus
    nan_days with ``count_nans`` (for removeMissing masking).
    """
    dt = ts.dtype
    nan = torch.tensor(float("nan"), dtype=dt, device=ts.device)
    names = ["ts_mean", "ts_max", "ts_min"]
    if with_cats:
        names += ["moderate_days", "strong_days", "severe_days",
                  "extreme_days", "total_days"]
    if count_nans:
        names += ["nan_days"]
    rows = {n: [] for n in names}
    for i in range(len(edges) - 1):
        seg = ts[edges[i]:edges[i + 1]]
        fin = torch.isfinite(seg)
        cnt = fin.sum(dim=0).to(dt)
        s = ordered_sum(torch.where(fin, seg, 0), 0)
        nz = cnt > 0
        rows["ts_mean"].append(torch.where(nz, s / torch.clamp(cnt, min=1),
                                           nan))
        rows["ts_max"].append(torch.where(
            nz, _masked_extreme(seg, fin, True), nan))
        rows["ts_min"].append(torch.where(
            nz, _masked_extreme(seg, fin, False), nan))
        if with_cats:
            cseg = cats[edges[i]:edges[i + 1]]
            total = torch.zeros(ts.shape[1], dtype=dt, device=ts.device)
            for cat, cname in ((1, "moderate_days"), (2, "strong_days"),
                               (3, "severe_days"), (4, "extreme_days")):
                c = (cseg == cat).sum(dim=0).to(dt)
                rows[cname].append(c)
                total = total + c
            rows["total_days"].append(total)
        if count_nans:
            rows["nan_days"].append((edges[i + 1] - edges[i]) - cnt)
    return {n: torch.stack(v) for n, v in rows.items()}


def day_block_edges(tyears, bins):
    """Time-axis slice edges for ``binned_day_stats``.

    tyears: (T,) host int years (monotone non-decreasing); bins: block
    boundary years (left-closed). Days before bins[0] / after bins[-1]
    fall outside every edge pair and are excluded, matching the host
    path's in-range mask. Returns a hashable tuple of nbins+1 ints.
    """
    return tuple(int(x) for x in np.searchsorted(tyears, bins,
                                                 side="left"))


def rank_events_desc(v, valid):
    """Ordinal descending rank over the event axis, on the device.

    v: (K, C) float; valid: (K, C) bool. Returns (K, C) float ranks
    (1 = largest; NaN where invalid or non-finite), with
    stats_api.rank_variable's tie rule exactly (reference:
    xmhw/stats.py:493-510): among equal values the EARLIER slot receives
    the larger rank. A stable ascending sort puts equal values in slot
    order, and excluded entries (as +inf) after every finite one, so an
    entry's position counts the entries before it and rank = count -
    position.
    """
    ok = valid & torch.isfinite(v)
    order = torch.sort(torch.where(ok, v, torch.inf), dim=0,
                       stable=True).indices
    pos = torch.empty_like(order)
    pos.scatter_(0, order, torch.arange(
        v.shape[0], device=v.device).view(-1, 1).expand_as(order))
    m = ok.sum(dim=0)
    return torch.where(ok, (m - pos).to(v.dtype), torch.nan)
