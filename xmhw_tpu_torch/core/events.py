"""Event identification in torch: vectorized run-length encoding.

Port of :mod:`xmhw_tpu.core.events` (reference: xmhw/identify.py:273-479,
532-536). The pandas ffill/shift chain becomes cumulative max/min scans
over the time axis of dense ``(time, cell)`` tensors:

* run start for every day = 1 + (last below-threshold index before it),
  a cummax scan (identify.py:441);
* run end / run length via the mirrored reverse cummin scan;
* events shorter than minDuration are dropped (identify.py:458);
* gap joining (identify.py:273-325): a below-duration stretch of days
  between two kept events, of length <= maxGap, is absorbed into one
  merged event; chains merge transitively.

Event ids equal the event's start index. ``day0_fillna_quirk=True``
reproduces the reference's fillna(0) artifact for runs touching day 0
(see :mod:`xmhw_tpu.core.events` for the full note).

:func:`mhw_filter` is also the plain version of the RLE kernel
(:mod:`xmhw_tpu_torch.ops.rle`), which must equal it bit for bit.
"""

from __future__ import annotations

import torch

_I32 = torch.int32


def _cummax(x):
    return torch.cummax(x, dim=0).values


def _rev_cummin(x):
    return torch.flip(torch.cummin(torch.flip(x, (0,)), dim=0).values, (0,))


def _time_index(x):
    T = x.shape[0]
    idx = torch.arange(T, dtype=_I32, device=x.device)
    return idx.view((T,) + (1,) * (x.dim() - 1)).expand(x.shape)


def run_geometry(bthresh):
    """Per-day run start/end/length for runs of True in ``bthresh`` (T, C).

    Returns (run_start, run_end, run_len) int32 (T, C); values are only
    meaningful on True days.
    """
    T = bthresh.shape[0]
    idx = _time_index(bthresh)
    last_false = _cummax(torch.where(bthresh, -1, idx))
    next_false = _rev_cummin(torch.where(bthresh, T, idx))
    return last_false + 1, next_false - 1, next_false - last_false - 1


def mhw_filter(bthresh, min_duration=5, join_gaps=True, max_gap=2,
               day0_fillna_quirk=False):
    """Identify qualifying (possibly gap-joined) events per cell.

    bthresh: (T, C) bool exceedance mask (ts > thresh; NaN compares
    False). Returns a dict of (T, C) tensors: ``event_day`` (bool),
    ``event_id``/``ev_start``/``ev_end`` (int32, -1 off-event),
    ``is_start`` (bool), ``slot`` (int32 dense per-cell event rank,
    cumsum(is_start) - 1) and ``n_events`` (C,) int32.
    """
    T = bthresh.shape[0]
    big = 4 * T + 64
    idx = _time_index(bthresh)

    run_start, _, run_len = run_geometry(bthresh)
    if day0_fillna_quirk:
        leading = run_start == 0
        run_len = torch.where(leading, run_len - 1, run_len)
        kept = (bthresh & (run_len >= min_duration)
                & ~(leading & (idx == 0)))
    else:
        kept = bthresh & (run_len >= min_duration)

    if join_gaps:
        prev_kept = _cummax(torch.where(kept, idx, -big))
        next_kept = _rev_cummin(torch.where(kept, idx, big))
        stretch = next_kept - prev_kept - 1
        join_day = (~kept & (stretch <= max_gap) & (prev_kept >= 0)
                    & (next_kept < T))
        merged = kept | join_day
    else:
        merged = kept

    ev_start, ev_end, _ = run_geometry(merged)
    is_start = merged & (idx == ev_start)
    starts = is_start.to(_I32)
    return {
        "event_day": merged,
        "event_id": torch.where(merged, ev_start, -1),
        "ev_start": torch.where(merged, ev_start, -1),
        "ev_end": torch.where(merged, ev_end, -1),
        "is_start": is_start,
        "slot": torch.cumsum(starts, dim=0, dtype=_I32) - 1,
        "n_events": starts.sum(dim=0, dtype=_I32),
    }


def interpolate_na_device(ts, max_gap=None):
    """Linear interpolation of interior NaN runs along axis 0.

    Equivalent of ``interpolate_na(max_gap=maxPadLength)`` (reference:
    xmhw.py:159-160): runs strictly between valid samples are filled;
    runs longer than ``max_gap`` (if given) are left as NaN.
    """
    T = ts.shape[0]
    idx = _time_index(ts)
    good = torch.isfinite(ts)
    prev_i = _cummax(torch.where(good, idx, -1))
    next_i = _rev_cummin(torch.where(good, idx, T))
    prev_v = torch.gather(ts, 0, torch.clamp(prev_i, 0, T - 1).long())
    next_v = torch.gather(ts, 0, torch.clamp(next_i, 0, T - 1).long())
    span = (next_i - prev_i).to(ts.dtype)
    frac = (idx - prev_i).to(ts.dtype) / torch.clamp(span, min=1.0)
    interp = prev_v + frac * (next_v - prev_v)
    fillable = ~good & (prev_i >= 0) & (next_i < T)
    if max_gap is not None:
        fillable &= (next_i - prev_i - 1) <= max_gap
    return torch.where(fillable, interp, ts)
