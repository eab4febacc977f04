"""Statistics layer: block_average() and mhw_rank().

Port of :mod:`xmhw_tpu.stats_api`: the numpy host functions are copies
(``tests/test_torch_port_guard.py`` holds them to the originals); the
device branches of block_average, _block_ts_stats_device and
_rank_device run torch (core/stats.py) on the device ``device`` names.

Reference-compatible rebuild of xmhw/stats.py. The reference marks both as
work-in-progress (README.rst:16-21) and ships several latent bugs; this
implementation keeps the reference's semantics for everything that works,
fixes the broken paths (documented inline), and computes everything as
vectorized binned reductions over ALL cells at once instead of a per-cell
dask loop (reference: stats.py:137-149).

Fixes relative to the reference (kept behind sensible defaults):
* ``intensity_mean_abs``/``intensity_cumulative_abs`` block stats aggregate
  the *_abs event variables; the reference aggregates intensity_mean /
  intensity_cumulative instead (copy-paste slip at stats.py:358-359). Pass
  ``reference_quirks=True`` to reproduce the old behavior.
* point-mode paths (undefined variables at stats.py:138,166,176) work.
* ``mhw_rank`` derives the record length from the data instead of the
  hard-coded ``14245/365.25`` (stats.py:477-478); pass ``nYears`` to
  override. Ranking is per cell along the events axis, and NaN-padded
  events receive NaN ranks instead of polluting the order.
* ``split=True`` assigns events crossing a block boundary to the block
  containing the majority of their days (the reference's stated intent at
  stats.py:121-123; its split_event is a stub returning its input,
  stats.py:439-443).
* ``removeMissing=True`` masks block stats where the input ts has NaNs
  (validated but never applied in the reference).
"""

from __future__ import annotations

import numpy as np
import torch

from .core.pipeline import fetch_rows, resolve_device
from .exception import XmhwException
from .xrlite import Coord, DataArray, Dataset, TimeIndex
from .xrlite.adapt import as_dataarray, as_dataset

__all__ = ["block_average", "check_coordinates", "check_variables",
           "mhw_rank", "rank_variable"]

# block stats: output name -> (event variable, reduction)
# (reference aggregation dict: stats.py:343-362)
_AGG_MHW = [
    ("ecount", "event", "count"),
    ("duration", "duration", "mean"),
    ("intensity_max", "intensity_max", "mean"),
    ("intensity_max_max", "intensity_max", "max"),
    ("intensity_mean", "intensity_mean", "mean"),
    ("intensity_cumulative", "intensity_cumulative", "mean"),
    ("total_icum", "intensity_cumulative", "sum"),
    ("intensity_mean_relThresh", "intensity_mean_relThresh", "mean"),
    ("intensity_cumulative_relThresh", "intensity_cumulative_relThresh",
     "mean"),
    ("severity_mean", "severity_mean", "mean"),
    ("severity_cumulative", "severity_cumulative", "mean"),
    ("intensity_mean_abs", "intensity_mean_abs", "mean"),
    ("intensity_cumulative_abs", "intensity_cumulative_abs", "mean"),
    ("rate_onset", "rate_onset", "mean"),
    ("rate_decline", "rate_decline", "mean"),
]


def _years_of(values, attrs=None):
    """Calendar year per entry + validity mask.

    Handles datetime64 values, synthetic-calendar TimeIndexes, and raw
    CF offsets whose ``attrs`` carry units/calendar (detect() attaches
    them to the time_* variables for non-datetime calendars). Plain
    numeric values without CF metadata are taken as years directly
    (tstep inputs where the caller supplies year numbers)."""
    if isinstance(values, TimeIndex):
        vals = np.asarray(values.values)
        if np.issubdtype(vals.dtype, np.datetime64):
            return (TimeIndex(vals.reshape(-1)).year.reshape(vals.shape),
                    ~np.isnat(vals))
        yr = np.asarray(values.year)
        return yr.reshape(vals.shape), np.isfinite(
            np.asarray(vals, np.float64))
    vals = np.asarray(values)
    if np.issubdtype(vals.dtype, np.datetime64):
        return TimeIndex(vals.reshape(-1)).year.reshape(vals.shape), \
            ~np.isnat(vals)
    units = (attrs or {}).get("units")
    if units is not None and "since" in str(units):
        from .xrlite import decode_cf_time

        cal = str((attrs or {}).get("calendar", "standard"))
        valid = np.isfinite(np.asarray(vals, np.float64))
        safe = np.where(valid, vals, 0.0).astype(np.float64)
        # decode_cf_time maps standard-family calendars onto datetime64
        # and synthetic calendars onto arithmetic decoding — raw offsets
        # with calendar="standard" (streamed detect outputs) need this
        ti = decode_cf_time(safe.reshape(-1), str(units), cal)
        return np.asarray(ti.year).reshape(vals.shape), valid
    return vals.astype(np.int64), np.isfinite(vals)


def _binned_reduce(values, bin_idx, valid, nbins, how):
    """Reduce ``values`` (N, C) into (nbins, C) by bin index per entry."""
    N, C = values.shape
    cols = np.broadcast_to(np.arange(C), (N, C))
    fin = valid & np.isfinite(values)
    b = np.where(fin, bin_idx, 0)
    flat = b * C + cols
    if how == "count":
        out = np.bincount(flat[fin], minlength=nbins * C).astype(np.float64)
        return out.reshape(nbins, C)
    if how in ("mean", "sum"):
        s = np.bincount(flat[fin], weights=values[fin],
                        minlength=nbins * C).reshape(nbins, C)
        n = np.bincount(flat[fin], minlength=nbins * C).reshape(nbins, C)
        if how == "sum":
            # pandas groupby sum of an EMPTY group is 0.0, not NaN
            # (reference total_icum, stats.py:358-359) — match it
            return s
        return np.where(n > 0, s / np.maximum(n, 1), np.nan)
    if how in ("max", "min"):
        out = np.full((nbins, C), np.nan)
        np_op = np.fmax if how == "max" else np.fmin
        np_op.at(out, (bin_idx[fin], cols[fin]), values[fin])
        return out
    raise ValueError(how)


def check_variables(dstime):
    """Determine which per-day stats can be computed
    (reference: stats.py:186-238)."""
    sw_temp = True
    sw_cats = False
    if isinstance(dstime, DataArray):
        name = dstime.name or "ts"
        d = Dataset()
        d["ts"] = dstime
        dstime = d
        variables = ["ts"]
        del name
    else:
        dstime = dstime.copy()
        variables = list(dstime.keys())
        if len(variables) == 1:
            dstime["ts"] = dstime[variables[0]]
        elif "cats" in variables:
            sw_cats = True
        elif all(x in variables for x in ("ts", "thresh", "seas")):
            sw_cats = True
            ts = dstime["ts"].data
            th = dstime["thresh"].data
            se = dstime["seas"].data
            from .core.stats import category_index

            cats = category_index(ts, th, se, xp=np)
            dstime["cats"] = dstime["ts"].copy(data=cats)
        if "ts" not in variables and len(variables) != 1:
            sw_temp = False
            print("Cannot identify temperature as it is not named 'ts'")
    for v in list(dstime.keys()):
        if v not in ("ts", "cats"):
            del dstime.data_vars[v]
    return dstime, sw_cats, sw_temp


def check_coordinates(dstime, tdim=None):
    """Identify the time dimension and the cell stacking of ``dstime``.

    Reference: stats.py:241-281 — finds the time dim by datetime dtype,
    treats a 1-D input as a point, a 'cell'/int64 dim as already stacked,
    and applies land_check semantics to an unstacked grid (raises on
    0-length dims and when every cell is land).

    Returns (tdim, stack_coord) with stack_coord one of 'point', 'cell'
    (already stacked) or 'grid' (unstacked lat/lon-style dims; the binned
    reducers flatten them and NaN cells fall out of every aggregation,
    which is land_check + unstack-to-NaN in one step).
    """
    da = dstime["ts"] if not isinstance(dstime, DataArray) else dstime
    if tdim is None:
        for d in da.dims:
            c = da.coords.get(d)
            if c is None:
                continue
            vals = c.values
            if isinstance(vals, TimeIndex) or np.issubdtype(
                    np.asarray(vals).dtype, np.datetime64):
                tdim = d
                break
    if tdim is None:
        tdim = "time" if "time" in da.dims else (
            "index" if "index" in da.dims else None)
    if tdim is None or tdim not in da.dims:
        raise XmhwException(
            "Cannot identify a time dimension in the dstime input")
    other = [d for d in da.dims if d != tdim]
    if not other:
        return tdim, "point"
    for d in other:
        if da.sizes[d] == 0:
            raise XmhwException(f"Dimension {d} has 0 lenght, exiting")
    if len(other) == 1 and (other[0] == "cell" or
                            other[0] not in da.coords):
        return tdim, other[0]
    tax = da.dims.index(tdim)
    if bool(np.isnan(np.asarray(da.data)).all(axis=tax).all()):
        raise XmhwException("All points of grid are either land or NaN")
    return tdim, "grid"


def _flatten_cells(da, lead_dim):
    """(lead, *grid) -> (lead, C) plus grid metadata for unstacking."""
    grid_dims = [d for d in da.dims if d != lead_dim]
    arr = da.data
    lead_ax = da.dims.index(lead_dim)
    arr = np.moveaxis(arr, lead_ax, 0)
    shape = arr.shape
    return arr.reshape(shape[0], -1), grid_dims, shape[1:]


def block_average(
    mhw,
    dstime=None,
    period=None,
    blockLength=1,
    mtime="time_start",
    removeMissing=False,
    split=False,
    reference_quirks=False,
    device=True,
):
    """Statistics on blocks of years (reference: stats.py:27-183).

    Returns a Dataset with dims (years [, lat, lon ...]); the ``years``
    coordinate holds the left edge of each block.

    ``device``: True (the default) means ``"cuda"``; a string or
    torch.device runs the aggregations as torch reductions on that
    device (core/stats.py) — the planet-scale path; results match the
    host path (tested). False runs the numpy host path, the JAX
    package's default. A CUDA device without a GPU raises.
    ``reference_quirks=True`` always takes the host path, as in the JAX
    package, so ``device`` is then not read.
    """
    # the device branch has no aggregation of the reference's swapped
    # sources, so the quirks take the host path whatever the device
    dev = None if reference_quirks else _stats_device(device)
    mhw = as_dataset(mhw)
    if dstime is not None and not isinstance(dstime, (Dataset, DataArray)):
        dstime = (as_dataset(dstime) if hasattr(dstime, "data_vars")
                  else as_dataarray(dstime))
    sw_temp = False
    sw_cats = False
    if dstime is not None:
        dstime, sw_cats, sw_temp = check_variables(dstime)
        if "ts" not in dstime:
            # no usable temperature variable (check_variables warned):
            # fall back to event-only statistics like the reference
            dstime, sw_temp, sw_cats = None, False, False
        else:
            tdim, _stack = check_coordinates(dstime)
            tcoord = dstime["ts"].coords[tdim]
            tyears, _ = _years_of(tcoord.values, tcoord.attrs)
            period = [int(tyears[0]), int(tyears[-1])]

    if removeMissing and not sw_temp:
        raise XmhwException(
            "To remove missing values you need to pass "
            "the original temperature timeseries")
    if not period and not sw_temp:
        raise XmhwException(
            "As the original timeseries is not available, the"
            " timeseries period as [start_year, end_year] has to be passed")

    bins = np.arange(period[0], period[1] + blockLength + 1, blockLength)
    nbins = len(bins) - 1
    years_coord = Coord(("years",), bins[:-1].astype(np.int64),
                        {"long_name": "start year of block",
                         "block_length": blockLength})

    # ---- event-table stats -------------------------------------------------
    tvar = mhw[mtime]
    ev_years, ev_valid = _years_of(tvar.data, tvar.attrs)
    # explicit trailing size: reshape(0, -1) on a zero-event union
    # layout is rejected by numpy, but an empty event axis is a
    # legitimate detect() result (no heatwaves in the region)
    ncells = int(np.prod(ev_years.shape[1:], dtype=np.int64))
    flat_years = ev_years.reshape(ev_years.shape[0], ncells)
    flat_valid = ev_valid.reshape(ev_valid.shape[0], ncells)
    if split:
        flat_years = _split_assignment(mhw, bins, flat_years)
    bin_idx = np.searchsorted(bins, flat_years, side="right") - 1
    in_range = (bin_idx >= 0) & (bin_idx < nbins)
    bin_idx = np.clip(bin_idx, 0, nbins - 1)
    flat_valid = flat_valid & in_range

    tdims = mhw[mtime].dims
    ev_dim = ("events" if "events" in tdims else
              "ev" if "ev" in tdims else tdims[0])
    grid_dims = [d for d in mhw[mtime].dims if d != ev_dim]
    grid_shape = tuple(mhw[mtime].sizes[d] for d in grid_dims)

    out = Dataset()
    coords = {"years": years_coord}
    for d in grid_dims:
        coords[d] = mhw[mtime].coords[d]
    if dev is not None:
        from .core.stats import EVENT_VARS, binned_event_stats

        vals = np.stack([
            mhw[v].data.reshape(flat_years.shape) for v in EVENT_VARS
        ]).astype(mhw["duration"].data.dtype, copy=False)
        res = fetch_rows(binned_event_stats(
            torch.from_numpy(vals).to(dev),
            torch.from_numpy(bin_idx.astype(np.int32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(flat_valid)).to(dev),
            nbins))
        for oname, arr in res.items():
            out[oname] = DataArray(
                arr.reshape((nbins,) + grid_shape),
                ("years", *grid_dims), coords)
        return _block_ts_stats(out, dstime, sw_temp, sw_cats, bins, nbins,
                               years_coord, removeMissing, device=dev)
    for oname, vname, how in _AGG_MHW:
        src = vname
        if reference_quirks and oname in ("intensity_mean_abs",
                                          "intensity_cumulative_abs"):
            src = vname.replace("_abs", "")
        vals = mhw[src].data.reshape(flat_years.shape).astype(np.float64)
        red = _binned_reduce(vals, bin_idx, flat_valid, nbins, how)
        out[oname] = DataArray(
            red.reshape((nbins,) + grid_shape), ("years", *grid_dims),
            coords)

    return _block_ts_stats(out, dstime, sw_temp, sw_cats, bins, nbins,
                           years_coord, removeMissing)


def _apply_missing_mask(out, has_nan, nbins, ts_grid_dims,
                        ts_grid_shape, ts_coords):
    """NaN-mask every year-block variable where the input ts had NaNs,
    aligning the mask (built on the DSTIME grid) to EACH variable's own
    coordinate order — the event-table stats follow the mhw dataset's
    layout (e.g. sorted-unique coords from the union assembly), which
    need not match the dstime file's native order (descending latitude
    is the common SST layout)."""
    mask_nd = has_nan.reshape((nbins,) + tuple(ts_grid_shape))
    ts_grid_dims = tuple(ts_grid_dims)
    for name, da in out.items():
        if da.dims[0] != "years" or name == "years":
            continue
        # the variable's grid dims may be a PERMUTATION of the dstime
        # grid dims (not just reordered coords within each dim):
        # transpose the mask to the variable's dim order first, or the
        # per-dim value alignment below would mask the wrong axes
        if sorted(da.dims[1:]) != sorted(ts_grid_dims):
            continue  # incommensurate grids: leave unmasked
        m = mask_nd
        if tuple(da.dims[1:]) != ts_grid_dims:
            perm = (0,) + tuple(ts_grid_dims.index(d) + 1
                                for d in da.dims[1:])
            m = np.transpose(m, perm)
        aligned = True
        for ax, d in enumerate(da.dims[1:], start=1):
            if d not in ts_coords:
                aligned = False
                break
            src = np.asarray(ts_coords[d].values)
            dst = np.asarray(da.coords[d].values)
            if src.shape == dst.shape and np.array_equal(src, dst):
                continue
            pos = np.array([np.nonzero(src == x)[0] for x in dst])
            if pos.size != len(dst):
                aligned = False
                break
            m = np.take(m, pos.reshape(-1), axis=ax)
        if not aligned:
            continue  # incommensurate grids: leave unmasked
        out[name] = da.copy(data=np.where(m, np.nan, da.data))


def _block_ts_stats(out, dstime, sw_temp, sw_cats, bins, nbins,
                    years_coord, removeMissing, device=False):
    """Per-day ts / category block stats appended to ``out``."""
    if sw_temp:
        mode = "cats" if sw_cats else "ts"
        tdim, _stack = check_coordinates(dstime)
        tcoord = dstime["ts"].coords[tdim]
        tyears, _ = _years_of(tcoord.values, tcoord.attrs)
        ts_flat, ts_grid_dims, ts_grid_shape = _flatten_cells(
            dstime["ts"], tdim)
        if device and np.any(np.diff(np.asarray(tyears)) < 0):
            # the device path's contiguous-slice year blocks require a
            # year-sorted time axis; fall back to the (always-correct)
            # host binning for out-of-order inputs
            device = False
        if device:
            return _block_ts_stats_device(
                out, dstime, mode, tdim, tyears, ts_flat, ts_grid_dims,
                ts_grid_shape, bins, nbins, years_coord, removeMissing,
                device)
        dy_idx = np.searchsorted(bins, tyears, side="right") - 1
        dy_ok = (dy_idx >= 0) & (dy_idx < nbins)
        dy_idx2 = np.broadcast_to(
            np.clip(dy_idx, 0, nbins - 1)[:, None], ts_flat.shape)
        dy_ok2 = np.broadcast_to(dy_ok[:, None], ts_flat.shape)
        tcoords = {"years": years_coord}
        for d in ts_grid_dims:
            tcoords[d] = dstime["ts"].coords[d]

        def emit(name, arr):
            out[name] = DataArray(
                arr.reshape((nbins,) + tuple(ts_grid_shape)),
                ("years", *ts_grid_dims), tcoords)

        emit("ts_mean", _binned_reduce(ts_flat, dy_idx2, dy_ok2, nbins,
                                       "mean"))
        emit("ts_max", _binned_reduce(ts_flat, dy_idx2, dy_ok2, nbins,
                                      "max"))
        emit("ts_min", _binned_reduce(ts_flat, dy_idx2, dy_ok2, nbins,
                                      "min"))
        if mode == "cats":
            cats_flat, _, _ = _flatten_cells(dstime["cats"], tdim)
            total = None
            for cat, cname in ((1, "moderate_days"), (2, "strong_days"),
                               (3, "severe_days"), (4, "extreme_days")):
                cnt = _binned_reduce(
                    np.where(cats_flat == cat, 1.0, np.nan), dy_idx2,
                    dy_ok2, nbins, "count")
                emit(cname, cnt)
                total = cnt if total is None else total + cnt
            emit("total_days", total)
        if removeMissing:
            has_nan = _binned_reduce(
                np.where(np.isnan(ts_flat), 1.0, np.nan), dy_idx2, dy_ok2,
                nbins, "count") > 0
            _apply_missing_mask(out, has_nan, nbins, ts_grid_dims,
                                ts_grid_shape, dstime["ts"].coords)
    return out



def _block_ts_stats_device(out, dstime, mode, tdim, tyears, ts_flat,
                           ts_grid_dims, ts_grid_shape, bins, nbins,
                           years_coord, removeMissing, device,
                           cell_block=1 << 16):
    """Device per-day block stats: slice reductions per year block
    (core/stats.py:binned_day_stats) on ``device``, cell-blocked for
    planet-scale grids. Matches the host path (_block_ts_stats) for
    ts_mean/max/min and the category day counts (summation-order
    tolerance) — tested."""
    from .core.stats import binned_day_stats, day_block_edges

    edges = day_block_edges(np.asarray(tyears), bins)
    with_cats = mode == "cats"
    cats_flat = (_flatten_cells(dstime["cats"], tdim)[0] if with_cats
                 else None)
    C = ts_flat.shape[1]
    parts = {}

    def put(a, lo, hi):
        # f64 to match the host bincount accumulation
        return torch.from_numpy(np.ascontiguousarray(
            a[:, lo:hi], dtype=np.float64)).to(device)

    for lo in range(0, C, cell_block):
        hi = min(lo + cell_block, C)
        res = fetch_rows(binned_day_stats(
            put(ts_flat, lo, hi), put(cats_flat, lo, hi) if with_cats
            else None, edges, with_cats=with_cats,
            count_nans=removeMissing))
        for name, arr in res.items():
            parts.setdefault(name, []).append(arr)
    full = {name: np.concatenate(blocks, axis=1)
            for name, blocks in parts.items()}
    has_nan = full.pop("nan_days", None)
    tcoords = {"years": years_coord}
    for d in ts_grid_dims:
        tcoords[d] = dstime["ts"].coords[d]
    for name, arr in full.items():
        out[name] = DataArray(
            arr.astype(np.float64).reshape((nbins,) + tuple(ts_grid_shape)),
            ("years", *ts_grid_dims), tcoords)
    if removeMissing and has_nan is not None:
        _apply_missing_mask(out, has_nan > 0, nbins, ts_grid_dims,
                            ts_grid_shape, dstime["ts"].coords)
    return out


def _split_assignment(mhw, bins, flat_years):
    """Year used for binning under ``split=True``: events crossing a
    block boundary go to the block containing the MOST of their days
    (counted from time_start/time_end; earliest block wins ties). The
    reference's split_event is a stub (stats.py:439-443); this implements
    its stated intent. Falls back to the midpoint year when event times
    are not datetimes (tstep mode)."""
    t0 = np.asarray(mhw["time_start"].data).reshape(flat_years.shape)
    t1 = np.asarray(mhw["time_end"].data).reshape(flat_years.shape)
    y0, v0 = _years_of(t0, mhw["time_start"].attrs)
    y1, v1 = _years_of(t1, mhw["time_end"].attrs)
    crossing = (y0 != y1) & v0 & v1
    if not crossing.any():
        return flat_years
    if not np.issubdtype(t0.dtype, np.datetime64):
        mid = (y0 + y1) // 2
        return np.where(crossing, mid, flat_years)
    day = np.timedelta64(1, "D")
    t0d = t0.astype("datetime64[D]")
    t1d = t1.astype("datetime64[D]")
    edges = np.array([np.datetime64(f"{y:04d}-01-01", "D") for y in bins])
    best_days = np.full(flat_years.shape, -1, np.int64)
    best_year = flat_years.copy()
    for i in range(len(bins) - 1):
        ov = ((np.minimum(t1d, edges[i + 1] - day)
               - np.maximum(t0d, edges[i])) / day).astype(np.int64) + 1
        ov = np.where(crossing, ov, -1)
        better = ov > best_days
        best_days = np.where(better, ov, best_days)
        best_year = np.where(better, bins[i], best_year)
    return np.where(crossing & (best_days > 0), best_year, flat_years)


def find_across(mhw):
    """Boolean (events, cells) mask of events spanning a year boundary
    (reference: stats.py:431-436)."""
    y0, v0 = _years_of(mhw["time_start"].data, mhw["time_start"].attrs)
    y1, v1 = _years_of(mhw["time_end"].data, mhw["time_end"].attrs)
    return (y0 != y1) & v0 & v1


def rank_variable(values, axis=0):
    """Descending rank (1 = largest) along ``axis``; NaN -> NaN.

    Matches the reference's double-argsort (stats.py:493-510) on finite
    values.
    """
    values = np.asarray(values, dtype=np.float64)
    values = np.moveaxis(values, axis, 0)
    n = values.shape[0]
    if values.size == 0:  # zero events anywhere: nothing to rank
        return np.moveaxis(values.copy(), 0, axis)
    flat = values.reshape(n, -1)
    fin = np.isfinite(flat)
    # one axis-wise argsort for ALL columns: NaNs sort to the end (as
    # +inf), so finite entries occupy ascending positions 0..m_c-1 and
    # rank = m_c - position (ties: the earlier occurrence gets the larger
    # rank, matching the reference fixture [2.3,1.2,3.5,2.4,2.3]->[4,5,1,2,3])
    asc = np.where(fin, flat, np.inf)
    order = np.argsort(asc, axis=0, kind="stable")
    pos = np.empty(flat.shape, np.int64)
    np.put_along_axis(pos, order,
                      np.broadcast_to(np.arange(n)[:, None], flat.shape),
                      axis=0)
    m = fin.sum(axis=0)
    out = np.where(fin, m[None, :] - pos, np.nan)
    return np.moveaxis(out.reshape(values.shape), 0, axis)


def mhw_rank(mhwds, nYears=None, device=True, cell_block=65536):
    """Rank each MHW property (1 = largest) and derive return periods.

    Reference: stats.py:446-490. ``nYears`` defaults to the record length
    derived from time_start/time_end instead of the reference's hard-coded
    constant. ``device`` as in block_average (default True: ``"cuda"``;
    False: the numpy host path): a device runs the ranking as a stable
    sort over cell blocks there (core/stats.py: rank_events_desc — exact
    same tie semantics), the planet-scale path.
    """
    dev = _stats_device(device)
    mhwds = as_dataset(mhwds)
    if nYears is None:
        try:
            y0, v0 = _years_of(mhwds["time_start"].data,
                               mhwds["time_start"].attrs)
            y1, v1 = _years_of(mhwds["time_end"].data,
                               mhwds["time_end"].attrs)
            t0 = np.asarray(mhwds["time_start"].data).reshape(-1)
            t1 = np.asarray(mhwds["time_end"].data).reshape(-1)
            if np.issubdtype(t0.dtype, np.datetime64):
                span = (t1[~np.isnat(t1)].max()
                        - t0[~np.isnat(t0)].min())
                nYears = span / np.timedelta64(1, "D") / 365.25
            else:
                nYears = float(y1[v1].max() - y0[v0].min() + 1)
        except Exception:
            nYears = 14245 / 365.25  # reference fallback (stats.py:477-478)
    rank = Dataset()
    return_period = Dataset()
    variables = [
        k for k in mhwds.keys()
        if not any(x in k for x in ("event", "time", "index"))
    ]
    for var in variables:
        da = mhwds[var]
        ev_dim = "events" if "events" in da.dims else (
            "ev" if "ev" in da.dims else None)
        if ev_dim is None:
            continue
        ax = da.dims.index(ev_dim)
        if dev is not None:
            r = _rank_device(da.data, ax, cell_block, dev)
        else:
            r = rank_variable(da.data, axis=ax)
        rank[var] = da.copy(data=r)
        return_period[var] = da.copy(data=(nYears + 1) / r)
    return rank, return_period


def _rank_device(data, axis, cell_block, device):
    """Device ordinal descending rank over ``axis``, cell-blocked."""
    from .core.stats import rank_events_desc

    v = np.moveaxis(np.asarray(data, np.float64), axis, 0)
    K = v.shape[0]
    flat = v.reshape(K, -1)
    out = np.empty_like(flat)
    for lo in range(0, flat.shape[1], cell_block):
        hi = min(lo + cell_block, flat.shape[1])
        blk = torch.from_numpy(np.ascontiguousarray(flat[:, lo:hi])).to(
            device)
        out[:, lo:hi] = rank_events_desc(
            blk, torch.ones(blk.shape, dtype=torch.bool,
                            device=device)).cpu().numpy()
    return np.moveaxis(out.reshape(v.shape), 0, axis)


def _stats_device(device):
    """The device of the stats API's ``device`` argument: None for the
    host numpy path (False), "cuda" for True, else the device named."""
    if device is None or isinstance(device, bool):
        return resolve_device("cuda") if device else None
    return resolve_device(device)
