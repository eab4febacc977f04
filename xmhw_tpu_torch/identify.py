"""Reference-style helper module: ``from xmhw_tpu_torch.identify import ...``
mirrors the reference's ``xmhw.identify`` surface (reference:
xmhw/identify.py) with the same names and semantics, implemented on the
port's torch core (on CPU tensors). Functions operating on labeled
arrays take/return :class:`xmhw_tpu_torch.DataArray`.
"""

from __future__ import annotations

import numpy as np
import torch

from .annotate import annotate_ds  # noqa: F401 (same name as reference)
from .api import land_check  # noqa: F401
from .core.calendar import build_window_index, compute_doy
from .core.calendar import get_calendar  # noqa: F401
from .exception import XmhwException
from .xrlite import Coord, DataArray, TimeIndex

__all__ = [
    "add_doy",
    "annotate_ds",
    "calculate_seas",
    "calculate_thresh",
    "feb29",
    "get_calendar",
    "join_events",
    "land_check",
    "mhw_filter",
    "runavg",
    "window_roll",
    "window_roll_index",
]


def add_doy(ts: DataArray, tdim: str = "time", keep_tstep: bool = False):
    """Add a 'doy' coordinate (366-day mapping, or step numbering in
    tstep mode). Reference: identify.py:28-79."""
    coord = ts.coords[tdim]
    vals = coord.values
    tindex = vals if isinstance(vals, TimeIndex) else TimeIndex(
        np.asarray(vals))
    doy, _ = compute_doy(tindex, keep_tstep=keep_tstep)
    out = ts.copy()
    out.coords["doy"] = Coord((tdim,), np.asarray(doy))
    return out


def feb29(clim: DataArray, dim: str = "doy"):
    """Mean of doys 59..61 (28 Feb, 29 Feb, 1 Mar), skipna.
    Reference: identify.py:137-151."""
    ax = clim.dims.index(dim)
    doyvals = np.asarray(clim.coords[dim].values)
    sel = np.isin(doyvals, [59, 60, 61])
    sub = np.take(clim.data, np.nonzero(sel)[0], axis=ax)
    return np.nanmean(sub, axis=ax)


def runavg(ts: DataArray, w: int):
    """Periodic running mean over the 'doy' dim; w must be odd.
    Reference: identify.py:154-181."""
    from .core.clim import runavg_circular

    if w % 2 == 0:
        raise XmhwException("Running average window should be odd")
    ax = ts.dims.index("doy")
    data = np.moveaxis(np.asarray(ts.data, np.float64), ax, 0)
    lead = data.shape
    flat = data.reshape(lead[0], -1)
    out = runavg_circular(torch.from_numpy(np.ascontiguousarray(flat)),
                          w).numpy()
    out = np.moveaxis(out.reshape(lead), 0, ax)
    res = ts.copy(data=out.astype(ts.data.dtype, copy=False))
    return res


def window_roll_index(ts: DataArray, w: int, tdim: str = "time",
                      keep_tstep: bool = False):
    """TPU-native replacement for the reference's window_roll
    (identify.py:184-209): instead of materializing an 11x-length stacked
    series, return the static (ndoy, Z) gather table of pooled time
    indices (-1 padded). ``ts[gidx[d]]`` reproduces the pooled multiset
    for doy d+1 (positions only; NaN values are dropped on device)."""
    coord = ts.coords[tdim]
    vals = coord.values
    tindex = vals if isinstance(vals, TimeIndex) else TimeIndex(
        np.asarray(vals))
    doy, ndoy = compute_doy(tindex, keep_tstep=keep_tstep)
    gidx, _ = build_window_index(doy, w, ndoy)
    return gidx


def mhw_filter(bthresh, min_duration=5, join_gaps=True, max_gap=2,
               day0_fillna_quirk=False):
    """Identify qualifying events from a boolean exceedance series.

    Reference: identify.py:415-479. Accepts a 1-D or (time, cell) boolean
    numpy array; returns dict with per-day 'events' (start-index labels,
    NaN off-event) plus 'start'/'end' index arrays per event.
    ``day0_fillna_quirk`` reproduces the reference's fillna(0) artifact for
    runs touching day 0 (see core/events.py docstring).
    """
    from .core.events import mhw_filter as _filter

    b = np.asarray(bthresh, bool)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    f = _filter(torch.from_numpy(np.ascontiguousarray(b)),
                min_duration=int(min_duration), join_gaps=bool(join_gaps),
                max_gap=int(max_gap),
                day0_fillna_quirk=bool(day0_fillna_quirk))
    f = {k: v.numpy() for k, v in f.items()}
    eid = np.asarray(f["event_id"]).astype(float)
    eid[eid < 0] = np.nan
    # reference surface (identify.py:461-471 + join_gaps concat):
    # per-day float series. The END value sits at each (merged) event's
    # end row; the START value sits at the end row of the event's FIRST
    # component run (reference join_gaps keeps st where gaps is True —
    # identify.py:313-316) — for unjoined events the two coincide.
    ev_start = np.asarray(f["ev_start"])
    ev_end = np.asarray(f["ev_end"])
    T = b.shape[0]
    rows = np.arange(T)[:, None]
    is_end = np.asarray(f["event_day"]) & (rows == ev_end)
    end = np.where(is_end, ev_end.astype(float), np.nan)
    # first component run's end: the raw exceedance run containing each
    # event's start index (gap days absorbed by joining are False in b).
    # Vectorized over the whole (T, C) grid: a reverse running minimum
    # of the next-False row gives every raw run's end in one pass.
    start = np.full(b.shape, np.nan)
    next_false = np.minimum.accumulate(
        np.where(b, T, rows)[::-1], axis=0)[::-1]
    erow, ecol = np.nonzero(is_end)
    s0 = ev_start[erow, ecol]
    e0 = next_false[s0, ecol] - 1  # end of the raw run starting at s0
    start[e0, ecol] = s0.astype(float)

    def _sq(x):
        return x[:, 0] if squeeze else x

    n_events = np.asarray(f["n_events"])
    return {
        "events": _sq(eid),
        "n_events": int(n_events[0]) if squeeze else n_events,
        "start": _sq(start),
        "end": _sq(end),
    }


def window_roll(ts: DataArray, w: int, tdim: str = "time",
                keep_tstep: bool = False):
    """Pooled window values as a flat 'z' series with a doy coordinate.

    Host-side parity helper for the reference's window_roll
    (identify.py:184-209): returns a 1-D DataArray of every value within
    +-w steps of each timestep, labeled by the center's doy, NaN values
    dropped. For a single-cell (1-D) series only; grid pipelines use the
    gather tables instead.
    """
    if len(ts.dims) != 1:
        raise XmhwException("window_roll parity helper takes a 1-D series")
    gidx = window_roll_index(ts, w, tdim=tdim, keep_tstep=keep_tstep)
    vals = np.asarray(ts.data, np.float64)
    ndoy, Z = gidx.shape
    flat_vals = []
    flat_doy = []
    for d in range(ndoy):
        members = gidx[d][gidx[d] >= 0]
        v = vals[members]
        keep = np.isfinite(v)
        flat_vals.append(v[keep])
        flat_doy.append(np.full(keep.sum(), d + 1))
    data = np.concatenate(flat_vals) if flat_vals else np.zeros(0)
    doys = np.concatenate(flat_doy) if flat_doy else np.zeros(0, int)
    return DataArray(data, ("z",), {"doy": Coord(("z",), doys)},
                     name="twindow")


def calculate_thresh(twindow: DataArray, pctile: int = 90,
                     skipna: bool = False, tstep: bool = False):
    """Per-doy percentile of a pooled window series
    (reference: identify.py:212-242). NaNs are already dropped by
    window_roll, so skipna is accepted for compatibility only."""
    doys = np.asarray(twindow.coords["doy"].values)
    vals = np.asarray(twindow.data, np.float64)
    # reference groupby('doy') emits only PRESENT doys (noleap data has
    # no doy-60 row at all — identify.py:233-240; its feb29 substitution
    # is then a no-op)
    present = np.unique(doys).astype(np.int64)
    out = np.array([np.quantile(vals[doys == d], pctile / 100.0)
                    for d in present])
    if not tstep and 60 in present:
        win = np.isin(present, (59, 60, 61))
        out[present == 60] = np.nanmean(out[win])
    return DataArray(out, ("doy",),
                     {"doy": Coord(("doy",), present)}, name="thresh")


def calculate_seas(twindow: DataArray, skipna: bool = False,
                   tstep: bool = False):
    """Per-doy mean of a pooled window series
    (reference: identify.py:245-270)."""
    doys = np.asarray(twindow.coords["doy"].values)
    vals = np.asarray(twindow.data, np.float64)
    present = np.unique(doys).astype(np.int64)
    out = np.array([vals[doys == d].mean() for d in present])
    if not tstep and 60 in present:
        win = np.isin(present, (59, 60, 61))
        out[present == 60] = np.nanmean(out[win])
    return DataArray(out, ("doy",),
                     {"doy": Coord(("doy",), present)}, name="seas")


def join_events(events: np.ndarray, joined):
    """Relabel joined event spans (reference: identify.py:532-536):
    for each (s, e) pair set events[s:e+1] = s. Works on a float array
    with NaN for non-event entries."""
    events = np.array(events, dtype=float, copy=True)
    for s, e in joined:
        events[int(s):int(e) + 1] = s
    return events
