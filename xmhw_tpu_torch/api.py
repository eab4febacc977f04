"""Public API: threshold() and detect() with reference-compatible surface.

Port of :mod:`xmhw_tpu.api`. Signatures, parameter names, defaults,
validation errors, output variables and attributes match the reference
(threshold: xmhw/xmhw.py:38-51, detect: xmhw/xmhw.py:310-323); all cells
are processed as dense (time, cell) torch tensors in cell blocks,
optionally split over a cell mesh of devices (see
:mod:`xmhw_tpu_torch.core.pipeline`).

Added: ``device`` (default ``"cuda"``; a CUDA device without a GPU
raises). ``mesh``: None, or a :func:`xmhw_tpu_torch.parallel.cell_mesh`
whose devices split each cell block (``device`` is then not read); with
None and ``device="cuda"`` every GPU is used when more than one is
visible (the JAX package's default); ``"cuda:0"`` or ``"cpu"`` mean one
device. Anything else raises TypeError.

Both calls first keep large host temporaries in glibc's heap
(:func:`xmhw_tpu_torch.xrlite.alloc.tune_malloc`, as the streamed
functions do): the land check, gathers and fetches of a daily grid
allocate hundreds of MB a call, which would otherwise be mapped afresh
and page-faulted in on every call.

Under a profiler (:func:`xmhw_tpu_torch.utils.trace`) each call and its
host stages are ``xmhw/`` spans: ``threshold``, ``detect``,
``land_check``, ``align_clim``, ``assemble`` (the output Dataset's
build; in the union layout on a grid, ``union_geometry`` and
``union_grids`` inside it) and ``assemble_inter`` (the intermediate
Dataset's), around those of ``core/pipeline.py``.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .annotate import annotate_ds, detect_params_attr, threshold_params_attr
from .core.calendar import compute_doy, get_calendar
from .core.pipeline import mesh_device, run_clim, run_detect
from .core.point import (point_clim, point_detect, point_interpolate_na,
                         runavg_circular_np as _runavg_circular_np)
from .exception import XmhwException
from .utils import count, in_span, span
from .xrlite import Coord, DataArray, Dataset, TimeIndex, unstack_cell
from .xrlite.adapt import as_dataarray
from .xrlite.alloc import tune_malloc

__all__ = ["threshold", "detect", "land_check", "flip_cold"]


@in_span("land_check")
def land_check(temp, tdim="time", anynans=False, *, device=None,
               dtype=None):
    """Stack all non-time dims into 'cell' and drop land (NaN) cells.

    Reference: xmhw/identify.py:482-529. Raises on time-only input, on a
    zero-length dim, and when every cell is land.

    The kept cells are gathered into a new (time, cell) array by row
    chunks on the process's torch threads (:func:`_compact`). ``device``
    and ``dtype`` are :func:`threshold`'s and :func:`detect`'s: the
    device their cell blocks run on, where a CUDA device puts the array
    in page-locked memory if it fits (:func:`_land_pinned`), and their
    compute dtype, which the array is written in. Without them the array
    is plain memory of the series' dtype.
    """
    temp = as_dataarray(temp)
    dims = [d for d in temp.dims if d != tdim]
    if tdim not in temp.dims:
        raise XmhwException(f"{tdim} dimension not present")
    if len(dims) == 0:
        raise XmhwException(
            "Series has only time dimension use point=True option, exiting")
    for d in dims:
        if temp.sizes[d] == 0:
            raise XmhwException(f"Dimension {d} has 0 lenght, exiting")
    ts = temp.stack_cell(dims, "cell")  # dims (tdim, "cell")
    keep, data = _compact(ts.data, anynans, dtype, device)
    # the coordinates as ts.isel(cell=keep) selects them: after the
    # stacking each is 0-D, along tdim or along "cell"
    coords = {}
    for k, c in ts.coords.items():
        idx = keep if c.dims == ("cell",) else slice(None)
        coords[k] = Coord(c.dims, c.values[idx], c.attrs) if c.dims else c
    return DataArray(data, ts.dims, coords, dict(ts.attrs), ts.name)


# bytes of the series in a chunk of rows: a chunk per thread, but at
# most the first (enough chunks to even out the threads) and at least
# the second (a smaller series is one chunk, on the calling thread)
_CHUNK_BYTES = (4 << 20, 1 << 20)
# {(process id, threads): the land check's thread pool}
_POOLS = {}


def _each(fn, chunks):
    """``map(fn, chunks)``, on a pool of ``torch.get_num_threads()``
    threads where there is more than one of each. The pool is made once
    for a process and thread count, as starting eight threads costs more
    than a small land check's work (a forked child makes its own: the
    parent's threads are not in it)."""
    nt = torch.get_num_threads()
    if nt < 2 or len(chunks) < 2:
        return map(fn, chunks)
    key = (os.getpid(), nt)
    if key not in _POOLS:
        _POOLS.clear()
        _POOLS[key] = ThreadPoolExecutor(nt, "xmhw_land_check")
    return _POOLS[key].map(fn, chunks)


def _compact(data, anynans, dtype, dev):
    """(keep, kept) of a (T, n) series: the cells with a value that is
    not NaN (``anynans``: with no NaN), and their columns as a new (T,
    len(keep)) array of ``dtype`` (None: ``data``'s), in page-locked
    memory where :func:`_land_pinned` allows. Both passes, the NaN test
    and the gather, run over row chunks on the process's torch threads
    (:func:`_each`; numpy releases the GIL in both). Raises when no cell
    is kept."""
    T, n = data.shape
    out_dt = np.dtype(dtype or data.dtype)
    count("land_calls")
    row = max(1, n * data.itemsize)
    most, least = (max(1, b // row) for b in _CHUNK_BYTES)
    rows = max(least, min(most, -(-T // torch.get_num_threads())))
    chunks = [slice(a, min(a + rows, T)) for a in range(0, T, rows)]

    def nan_test(r):
        # a reduction with no temporary: fmax is NaN where every value
        # is, maximum where any is
        if anynans:
            return np.isnan(np.maximum.reduce(data[r], axis=0))
        return ~np.isnan(np.fmax.reduce(data[r], axis=0))

    found = np.zeros(n, bool)
    for part in _each(nan_test, chunks):
        found |= part
    keep = np.flatnonzero(~found if anynans else found)
    if keep.size == 0:
        raise XmhwException("All points of grid are either land or NaN")
    shape = (T, keep.size)
    nbytes = T * keep.size * out_dt.itemsize
    if _land_pinned(dev, nbytes):
        count("land_pinned_calls")
        # a view of the tensor, which it keeps alive; page-locked from a
        # CUDA dev (on a CPU dev the same steps, in plain memory)
        kept = torch.empty(nbytes, dtype=torch.uint8, pin_memory=(
            torch.device(dev).type == "cuda")).numpy().view(
            out_dt).reshape(shape)
    else:
        kept = np.empty(shape, out_dt)

    def gather(r):
        if out_dt == data.dtype:
            # every index is in range; "clip" writes straight into out,
            # where the default "raise" buffers the chunk first
            np.take(data[r], keep, axis=1, out=kept[r], mode="clip")
        else:
            np.copyto(kept[r], np.take(data[r], keep, axis=1),
                      casting="unsafe")

    for _ in _each(gather, chunks):
        pass
    return keep, kept


def _land_pinned(dev, nbytes):
    """Whether :func:`land_check` writes its ``nbytes`` of kept cells into
    page-locked memory from PyTorch's caching host allocator, from which
    the cell blocks' uploads are direct DMAs: the rule of
    :func:`_union_on_card` for that one buffer (a CUDA ``dev``, and the
    buffer rounded up to a power of two fits in the host memory
    available)."""
    return _union_on_card(dev, [nbytes])


def _use_point_host() -> bool:
    """Single-point workloads run on the HOST numpy engine
    (core/point.py): one cell is far below an accelerator's launch
    floor. The reference keeps a dedicated pandas point mode for the
    same reason (reference: xmhw/xmhw.py:122-126). Set
    XMHW_POINT_HOST=0 to force points through the device engines."""
    return os.environ.get("XMHW_POINT_HOST", "1") != "0"


def _interpolate_na(data, max_gap, dev):
    """Vectorized interior-NaN filling on the device (maxPadLength,
    reference: xmhw.py:159-160)."""
    from .core.events import interpolate_na_device

    out = interpolate_na_device(torch.from_numpy(data).to(dev),
                                max_gap=max_gap)
    return out.cpu().numpy()


def _time_index(da, tdim) -> TimeIndex:
    coord = da.coords.get(tdim)
    if coord is None:
        raise XmhwException(f"{tdim} coordinate missing")
    vals = coord.values
    if isinstance(vals, TimeIndex):
        return vals
    vals = np.asarray(vals)
    if np.issubdtype(vals.dtype, np.datetime64):
        t = TimeIndex(vals.astype("datetime64[ns]"))
        t.attrs = dict(coord.attrs)
        return t
    raise XmhwException(
        f"{tdim} coordinate must be datetime-like or a TimeIndex")


def _cell_coords(ts):
    """Component coords labeling the stacked cell axis."""
    return {
        k: np.asarray(c.values)
        for k, c in ts.coords.items()
        if c.dims == ("cell",)
    }


def _scalar_coords(da, tdim):
    out = {}
    for k, c in da.coords.items():
        if c.dims == () and k not in (tdim, "doy"):
            out[k] = c.values
    return out


@in_span("threshold")
def threshold(
    temp,
    tdim="time",
    climatologyPeriod=[None, None],
    pctile=90,
    windowHalfWidth=5,
    smoothPercentile=True,
    smoothPercentileWidth=31,
    maxPadLength=None,
    coldSpells=False,
    tstep=False,
    anynans=False,
    skipna=False,
    dtype=None,
    cell_block=None,
    mesh=None,
    device="cuda",
):
    """Calculate the day-of-year threshold and mean climatology.

    Reference-compatible API (xmhw/xmhw.py:38-247). Notes on semantics:

    * NaN values never enter the percentile pool regardless of ``skipna``
      (the reference's window_roll drops NaNs before the groupby —
      identify.py:208 — so ``skipna`` only toggled an internal code path
      there). The argument is accepted for compatibility.
    * Extras: ``dtype`` (default float32, which runs the CUDA kernels on
      the GPU; float64 runs the plain torch code for exact reference
      parity), ``cell_block`` (cells per step over the mesh), ``mesh``
      (see the module docstring), ``device``.
    * On a CUDA device (with a mesh, its first device) the land check
      writes the ocean cells' series, in ``dtype``, into page-locked
      host memory where that fits in the host memory available, and
      the cell blocks are uploaded from it by direct DMA. The buffer is
      the series' bytes rounded up to a power of two (up to twice
      them, not swappable while the call runs); PyTorch's caching host
      allocator keeps it for the next call, not returning it to the
      system, once the call ends.
    """
    dev = mesh_device(mesh, device)
    tune_malloc()
    temp = as_dataarray(temp)
    if smoothPercentileWidth % 2 == 0:
        raise XmhwException("smoothPercentileWidth should be odd")
    if tdim not in temp.dims:
        raise XmhwException(
            f"{tdim} dimension not present, default "
            + "is 'time' or pass as tdim='time_dimension_name'"
        )
    if all(climatologyPeriod):
        temp = temp.sel(**{tdim: slice(f"{climatologyPeriod[0]}-01-01",
                                       f"{climatologyPeriod[1]}-12-31")})
    point = len(temp.dims) == 1
    ds_attrs = {"ts": dict(temp.attrs)}
    for c in temp.dims:
        if c in temp.coords:
            ds_attrs[c] = dict(temp.coords[c].attrs)

    ts = temp if point else land_check(temp, tdim=tdim, anynans=anynans,
                                       device=dev, dtype=dtype or np.float32)
    tindex = _time_index(ts, tdim)
    year_days = get_calendar(tindex)
    if year_days == 360.0:
        tstep = True
    doy, ndoy = compute_doy(tindex, keep_tstep=tstep)

    data = np.asarray(ts.data, dtype=dtype or np.float32)
    if point:
        data = data[:, None]
    point_host = point and _use_point_host()
    if maxPadLength:
        data = (point_interpolate_na(data, maxPadLength) if point_host
                else _interpolate_na(data, maxPadLength, dev))
    if coldSpells:
        data = -data

    # noleap/365_day calendars NEVER hit doy 60 under the 366-mapping:
    # the reference's groupby('doy') emits the 365 present doys and the
    # 31-day smoother runs over that axis (no synthetic Feb-29 row in
    # the windows) — reproduce that exactly. Standard-calendar data that
    # merely lacks a leap year keeps the dense 366-row axis with the
    # feb29 patch, so a sub-period climatology still covers leap days
    # during detection.
    doy_labels = np.arange(1, ndoy + 1)
    holey = not tstep and year_days == 365
    present = (np.isin(doy_labels, np.unique(doy)) if holey
               else np.ones(ndoy, bool))

    if point_host:
        thresh, seas = point_clim(
            data, doy, windowHalfWidth, ndoy, pctile=pctile,
            smooth=smoothPercentile and not holey,
            smooth_w=smoothPercentileWidth,
            patch_feb29=not tstep and not holey)
    else:
        thresh, seas = run_clim(
            data, doy, windowHalfWidth, ndoy, pctile=pctile,
            smooth=smoothPercentile and not holey,
            smooth_w=smoothPercentileWidth,
            patch_feb29=not tstep and not holey, block=cell_block,
            mesh=mesh, device=dev,
        )
    if holey:
        doy_labels = doy_labels[present]
        thresh = thresh[present]
        seas = seas[present]
        if smoothPercentile:
            thresh = _runavg_circular_np(thresh, smoothPercentileWidth)
            seas = _runavg_circular_np(seas, smoothPercentileWidth)
        ndoy = len(doy_labels)

    with span("assemble"):
        doy_coord = Coord(("doy",), doy_labels)
        q_coord = Coord((), np.float64(pctile / 100.0))
        ds = Dataset()
        if point:
            scal = {k: Coord((), v)
                    for k, v in _scalar_coords(ts, tdim).items()}
            ds["thresh"] = DataArray(
                thresh[:, 0], ("doy",),
                {"doy": doy_coord, "quantile": q_coord, **scal})
            ds["seas"] = DataArray(seas[:, 0], ("doy",),
                                   {"doy": doy_coord, **scal})
        else:
            cell_coords = _cell_coords(ts)
            grid_dims = sorted(cell_coords)
            th_full, uniques = unstack_cell(thresh, cell_coords, grid_dims)
            se_full, _ = unstack_cell(seas, cell_coords, grid_dims)
            coords = {"doy": doy_coord}
            for d in grid_dims:
                coords[d] = Coord((d,), uniques[d],
                                  ds_attrs.get(d, {}))
            ds["thresh"] = DataArray(th_full, ("doy", *grid_dims),
                                     {**coords, "quantile": q_coord})
            ds["seas"] = DataArray(se_full, ("doy", *grid_dims), coords)

        ds = annotate_ds(ds, ds_attrs, "clim")
        ds.attrs["xmhw_parameters"] = threshold_params_attr(
            pctile, tindex.year[0], tindex.year[-1], windowHalfWidth, skipna,
            smoothPercentile, smoothPercentileWidth, anynans)
    return ds


@in_span("align_clim")
def _align_clim_cells(clim_da, ts_cell_coords, n_cells, name):
    """Reindex a stacked climatology onto the ts cell order.

    The reference assumes land_check produces identical cell sets for ts
    and th/se (xmhw.py:399-402); here cells are matched explicitly by their
    coordinate labels, raising when a ts cell is missing from the
    climatology.
    """
    clim_coords = _cell_coords(clim_da)
    keys = sorted(ts_cell_coords)
    if sorted(clim_coords) != keys:
        raise XmhwException(
            f"{name} cell coordinates {sorted(clim_coords)} do not match "
            f"the timeseries {keys}")

    # vectorized label join: encode each cell's coordinate tuple as a
    # dense int code (re-densified after every key column so codes stay
    # bounded by the cell counts — no int64 overflow), then one
    # searchsorted. O((E+C) log) instead of a per-cell Python loop.
    n_clim = clim_da.sizes["cell"]
    codes_clim = np.zeros(n_clim, np.int64)
    codes_ts = np.zeros(n_cells, np.int64)
    for k in keys:
        a = np.asarray(clim_coords[k])
        b = np.asarray(ts_cell_coords[k])
        uni, inv = np.unique(np.concatenate([a, b]), return_inverse=True)
        codes_clim = codes_clim * len(uni) + inv[:n_clim]
        codes_ts = codes_ts * len(uni) + inv[n_clim:]
        uni2, inv2 = np.unique(np.concatenate([codes_clim, codes_ts]),
                               return_inverse=True)
        codes_clim, codes_ts = inv2[:n_clim], inv2[n_clim:]
    order = np.argsort(codes_clim, kind="stable")
    sorted_codes = codes_clim[order]
    pos = np.searchsorted(sorted_codes, codes_ts)
    ok = (pos < n_clim) & (sorted_codes[np.minimum(pos, n_clim - 1)]
                           == codes_ts)
    if not ok.all():
        i = int(np.nonzero(~ok)[0][0])
        missing = {k: np.asarray(ts_cell_coords[k])[i] for k in keys}
        raise XmhwException(f"No climatology for cell {missing}")
    return clim_da.isel(cell=order[pos])


@in_span("detect")
def detect(
    temp,
    th,
    se,
    tdim="time",
    minDuration=5,
    joinGaps=True,
    maxGap=2,
    maxPadLength=None,
    coldSpells=False,
    intermediate=False,
    anynans=False,
    tstep=False,
    dtype=None,
    cell_block=None,
    mesh=None,
    events_layout="union",
    reference_quirks=False,
    device="cuda",
):
    """Apply the Hobday et al. (2016) MHW definition; return event dataset.

    Reference-compatible API (xmhw/xmhw.py:310-518). Returns the event
    Dataset (dims: events [x lat x lon ...]); with ``intermediate=True``
    also returns the per-day intermediate Dataset.

    ``events_layout``: "union" (reference layout — the events dimension is
    the union of start indexes across cells, NaN elsewhere) or "compact"
    (dims (ev, ...) with per-cell event slots — O(max events/cell) instead
    of O(total distinct events); use for planet-scale grids where the
    union layout would explode; block_average/mhw_rank accept both).

    ``reference_quirks=True`` reproduces the reference's fillna(0) artifact
    for exceedance runs that start on day 0 of the record (their first day
    is dropped; a leading run of exactly minDuration days is discarded —
    reference identify.py:441). Default False treats day-0 runs like any
    other run (a deliberate fix; see core/events.py).

    ``device``: where the cell blocks run (default ``"cuda"``); ``mesh``
    as in :func:`threshold`. On a CUDA device (with a mesh, its first
    device) the union layout's grids are built on the card and copied
    into page-locked host memory, where that fits in the host memory
    available: each output array is then a view of a pinned buffer,
    rounded up to a power of two (up to twice the array's bytes, which
    cannot be swapped out while the array lives), and PyTorch's caching
    host allocator keeps the buffer for reuse, not returning it to the
    system, once the array dies. The land checks of the series and of
    ``th``/``se`` take page-locked buffers as in :func:`threshold`,
    cached likewise once the call ends. With ``intermediate=True`` on a
    grid, the intermediate arrays stay on the card, and their grids are
    built there and land in page-locked buffers in the same way, where
    those buffers fit in the host memory available and the card holds
    the arrays and one grid (:func:`_inter_on_card`); otherwise the
    arrays are fetched and their grids built on the host.
    """
    dev = mesh_device(mesh, device)
    tune_malloc()
    temp = as_dataarray(temp)
    th = as_dataarray(th)
    se = as_dataarray(se)
    if maxGap >= minDuration:
        raise XmhwException(
            "Maximum gap between mhw events should"
            + " be smaller than event minimum duration"
        )
    point = len(temp.dims) == 1
    ds_attrs = {"ts": dict(temp.attrs)}
    for c in temp.coords:
        ds_attrs[c] = dict(temp.coords[c].attrs)

    dt = dtype or np.float32
    if point:
        ts, thc, sec = temp, th, se
    else:
        kw = dict(anynans=anynans, device=dev, dtype=dt)
        ts = land_check(temp, tdim=tdim, **kw)
        thc = land_check(th, tdim="doy", **kw)
        sec = land_check(se, tdim="doy", **kw)
        cell_coords = _cell_coords(ts)
        ncell = ts.sizes["cell"]
        thc = _align_clim_cells(thc, cell_coords, ncell, "thresh")
        sec = _align_clim_cells(sec, cell_coords, ncell, "seas")

    tindex = _time_index(ts, tdim)
    doy, _ = compute_doy(tindex, keep_tstep=tstep)

    data = np.asarray(ts.data, dtype=dt)
    th_data = np.asarray(thc.data, dtype=dt)
    se_data = np.asarray(sec.data, dtype=dt)
    if point:
        data, th_data, se_data = (x[:, None] for x in
                                  (data, th_data, se_data))
    point_host = point and _use_point_host()
    if maxPadLength:
        data = (point_interpolate_na(data, maxPadLength) if point_host
                else _interpolate_na(data, maxPadLength, dev))
    if coldSpells:
        data = -data
    inter_dev = (dev if intermediate and _inter_on_card(dev, point, ts, dt)
                 else None)

    # map each timestep's doy onto the climatology's doy rows
    th_doys = np.asarray(thc.get_index("doy") if "doy" in thc.coords
                         else np.arange(1, th_data.shape[0] + 1))
    pos = np.searchsorted(th_doys, doy)
    if (pos >= len(th_doys)).any() or (th_doys[np.clip(pos, 0,
                                       len(th_doys) - 1)] != doy).any():
        raise XmhwException(
            "Climatology doy axis does not cover the timeseries doys")
    doy_pos = pos.astype(np.int32)

    if point_host:
        tables, n_events, inter = point_detect(
            data, th_data, se_data, doy_pos, min_duration=minDuration,
            join_gaps=joinGaps, max_gap=maxGap,
            intermediate=intermediate,
            day0_fillna_quirk=reference_quirks)
    else:
        tables, n_events, inter = run_detect(
            data, th_data, se_data, doy_pos, min_duration=minDuration,
            join_gaps=joinGaps, max_gap=maxGap, intermediate=intermediate,
            block=cell_block, mesh=mesh,
            day0_fillna_quirk=reference_quirks,
            # device point mode (XMHW_POINT_HOST=0): skip the counting
            # pass and start at a capacity that covers ~50 years of
            # typical MHW density; the overflow retry handles the rest
            first_k=128 if point else None, device=dev,
            inter_device=inter_dev,
        )

    time_vals = tindex.values
    if events_layout == "compact":
        mhw = _assemble_events_compact(tables, n_events, time_vals, point,
                                       ts, tdim, ds_attrs)
    else:
        mhw = _assemble_events(tables, time_vals, point, ts, tdim,
                               ds_attrs, dev)
    if coldSpells:
        mhw = flip_cold(mhw)
    mhw = annotate_ds(mhw, ds_attrs, "mhw")
    mhw.attrs["xmhw_parameters"] = detect_params_attr(
        minDuration, joinGaps, maxGap, coldSpells, maxPadLength, anynans)
    if not np.issubdtype(np.asarray(time_vals).dtype, np.datetime64):
        # synthetic calendars store raw CF offsets in time_* — carry the
        # units/calendar so block_average/mhw_rank can derive years
        units = (getattr(tindex, "encoding", {}) or {}).get(
            "units") or getattr(tindex, "units", None)
        cal = getattr(tindex, "calendar", "standard")
        if units:
            for v in _TIME_LIKE:
                if v in mhw:
                    mhw[v].attrs.update(units=str(units),
                                        calendar=str(cal))
    if intermediate:
        mhw_inter = _assemble_inter(inter, time_vals, point, ts, tdim,
                                    tindex, inter_dev)
        return mhw, mhw_inter
    return mhw


def _union_geometry(labels):
    """Union of per-cell event labels + scatter geometry.

    Returns (union (E,) int64, rows (Nvalid,), cols (Nvalid,),
    valid (K, C) bool): entry (k, c) of a device table lands at
    [rows, cols] of the (E, C) union layout.
    """
    valid = np.isfinite(labels)
    if valid.any():
        union = np.unique(labels[valid]).astype(np.int64)
    else:
        union = np.zeros(0, np.int64)
    K, C = labels.shape
    rows = np.searchsorted(union, labels[valid].astype(np.int64))
    cols = np.broadcast_to(np.arange(C), (K, C))[valid]
    return union, rows, cols, valid


def _union_values(name, vals, time_vals, time_like):
    """Valid entries ``vals`` (Nvalid,) of one event variable,
    time-decoded if needed.

    Returns (values (Nvalid,), fill, storage dtype)."""
    if name in time_like:
        idx = vals.astype(np.int64)
        v = time_vals[np.clip(idx, 0, len(time_vals) - 1)]
        if np.issubdtype(np.asarray(time_vals).dtype, np.datetime64):
            return (np.where(idx >= 0, v, np.datetime64("NaT")),
                    np.datetime64("NaT"), v.dtype)
        return np.where(idx >= 0, v, np.nan), np.nan, np.float64
    return vals, np.nan, vals.dtype


_TIME_LIKE = frozenset({"time_start", "time_end", "time_peak"})


@in_span("assemble")
def _assemble_events(tables, time_vals, point, ts, tdim, ds_attrs, dev=None):
    """Build the events Dataset: union of per-cell event labels.

    The reference's events dimension is the union of start indexes across
    cells, NaN elsewhere (docs/gettingstarted.rst:76-114). The dense
    (K, cell) device tables are scattered DIRECTLY into the final
    (events, lat, lon, ...) grids, with no intermediate (E, cell) arrays
    (the round-1 version materialized both and was page-fault bound).

    Where the grids are built: on a CUDA ``dev``, where their page-locked
    host buffers fit (:func:`_union_on_card`), on the card, then copied
    once into page-locked host memory (:func:`_union_grids_card`);
    otherwise, and for a point series, on the host: one prefaulted
    allocation and one vectorized scatter per variable. Both give the
    same values in the same positions.
    """
    from .xrlite.alloc import alloc_filled
    from .xrlite.dataarray import grid_positions

    count("union_calls")
    with span("union_geometry"):
        labels = tables["event"]  # (K, C)
        union, rows, cols, valid = _union_geometry(labels)
        # np.take at the flat positions gathers the entries tab[valid]
        # gives, in the same order, several times faster than the mask
        flat = np.flatnonzero(valid)
        parts = {name: _union_values(name, np.take(tab, flat), time_vals,
                                     _TIME_LIKE)
                 for name, tab in tables.items()}
        if not point:
            cell_coords = _cell_coords(ts)
            grid_dims = sorted(cell_coords)
            flat_pos, uniques, grid_shape = grid_positions(cell_coords,
                                                           grid_dims)
            G = int(np.prod(grid_shape))
            fidx = rows * G + flat_pos[cols]
    E = len(union)
    count("union_rows", E)
    ev_coord = Coord(("events",), union)
    ds = Dataset()

    if point:
        for name, (tv, fill, dt) in parts.items():
            out = np.full(E, fill, dt)
            out[rows] = tv
            ds[name] = DataArray(out, ("events",), {"events": ev_coord})
        for k, v in _scalar_coords(ts, tdim).items():
            ds[k] = DataArray(np.full(E, v), ("events",),
                              {"events": ev_coord})
        return ds

    coords = {"events": ev_coord}
    for d in grid_dims:
        coords[d] = Coord((d,), uniques[d], ds_attrs.get(d, {}))
    shape = (E,) + grid_shape
    grid_bytes = [E * G * np.dtype(dt).itemsize for _, _, dt in
                  parts.values()]
    with span("union_grids"):
        if _union_on_card(dev, grid_bytes):
            count("union_pinned_bytes", _pinned_bytes(grid_bytes))
            grids = _union_grids_card(parts, fidx, shape, dev)
        else:
            grids = {}
            for name, (tv, fill, dt) in parts.items():
                grids[name] = out = alloc_filled(shape, fill, dt)
                out.reshape(-1)[fidx] = tv
    for name, out in grids.items():
        ds[name] = DataArray(out, ("events", *grid_dims), coords)
    return ds


def _union_on_card(dev, grid_bytes):
    """Whether the union grids are built on the card: ``dev`` is a CUDA
    device, and the page-locked host buffers they land in fit in the host
    memory available now. PyTorch's caching host allocator rounds each
    buffer up to a power of two, so ``grid_bytes`` (each variable's grid)
    may take up to twice as much; where they do not fit, the host route
    builds the grids in pageable memory."""
    if dev is None or torch.device(dev).type != "cuda":
        return False
    return _pinned_bytes(grid_bytes) <= _host_available()


def _pinned_bytes(grid_bytes):
    """The page-locked bytes that grids of ``grid_bytes`` ask of PyTorch's
    caching host allocator: each rounded up to a power of two."""
    return sum(1 << (b - 1).bit_length() for b in grid_bytes if b)


def _host_available():
    """Bytes of host memory available now: the kernel's MemAvailable
    where it reports one, else the free pages."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def _union_grids_card(parts, fidx, shape, dev):
    """The union grids built on ``dev`` and copied to the host.

    ``parts``: {name: (valid values (N,), fill, storage dtype)}, as
    :func:`_union_values` gives them; ``fidx`` (N,): their flat positions
    in a grid of ``shape``. The indexes and every variable's values go
    up once; then each grid is filled and scattered on ``dev`` (a
    datetime64 variable as its int64 view, NaT as int64's least value)
    and copied to the host without blocking, which from a CUDA device
    lands in page-locked memory of PyTorch's caching host allocator. The
    device's stream orders each copy before the next grid reuses its
    memory; one synchronisation at the end. Returns {name: array of
    ``shape``}, each a view of its own host tensor (the array keeps the
    tensor alive). On a CPU ``dev`` the same steps run in host memory.
    """
    n = int(np.prod(shape))
    fidx_d = torch.as_tensor(fidx, dtype=torch.int64, device=dev)
    # all up before the first copy down: a copy from pageable memory
    # waits for the stream, so one between the copies down would stall
    vals = [torch.as_tensor(tv.view(_storage(dt)), device=dev)
            for tv, _, dt in parts.values()]
    grids = {}
    for (name, (_, fill, dt)), v in zip(parts.items(), vals):
        g = torch.full((n,), _NAT if np.dtype(dt).kind == "M" else fill,
                       dtype=v.dtype, device=dev)
        g.index_put_((fidx_d,), v)
        host = g.to("cpu", non_blocking=True)
        grids[name] = host.numpy().view(dt).reshape(shape)
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)
    count("union_card_calls")
    count("union_card_bytes", sum(a.nbytes for a in grids.values()))
    return grids


def _storage(dt):
    """The numpy dtype a variable of storage dtype ``dt`` has on the
    device: datetime64 as int64, anything else as itself."""
    dt = np.dtype(dt)
    return np.dtype(np.int64) if dt.kind == "M" else dt


_NAT = int(np.datetime64("NaT").view(np.int64))


@in_span("assemble")
def _assemble_events_compact(tables, n_events, time_vals, point, ts, tdim,
                             ds_attrs):
    """Compact layout: dims (ev, ...) with per-cell event slots.

    Rows beyond a cell's event count are NaN/NaT padded. Memory scales
    with max-events-per-cell, not the global union — the layout for
    planet-scale stats pipelines.
    """
    kmax = max(int(n_events.max()), 1) if n_events.size else 1
    ev_coord = Coord(("ev",), np.arange(kmax),
                     {"long_name": "per-cell MHW event slot"})
    per_var = {}
    for name, tab in tables.items():
        tab = tab[:kmax]
        if name in _TIME_LIKE:
            # same time-index decode as the union layout
            per_var[name], _, _ = _union_values(
                name, tab.reshape(-1), time_vals, _TIME_LIKE)
            per_var[name] = per_var[name].reshape(tab.shape)
        else:
            per_var[name] = tab
    ds = Dataset()
    if point:
        for name, out in per_var.items():
            ds[name] = DataArray(out[:, 0], ("ev",), {"ev": ev_coord})
    else:
        cell_coords = _cell_coords(ts)
        grid_dims = sorted(cell_coords)
        for name, out in per_var.items():
            full, uniques = unstack_cell(out, cell_coords, grid_dims)
            coords = {"ev": ev_coord}
            for d in grid_dims:
                coords[d] = Coord((d,), uniques[d], ds_attrs.get(d, {}))
            ds[name] = DataArray(full, ("ev", *grid_dims), coords)
    return ds


def _inter_on_card(dev, point, ts, dtype):
    """Whether :func:`detect` builds the intermediate grids of the
    series ``ts`` (its land check's (T, C) DataArray) on the card: ``ts``
    is a grid, not a point series; the grids' page-locked host buffers
    fit (:func:`_union_on_card`'s rule, which also asks a CUDA ``dev``);
    and the card's free memory holds the (T, C) arrays and one grid with
    its variable's column cast to the grid's dtype. A grid is T x G
    values of :func:`_fill_like`'s storage dtype (the series' ``dtype``;
    float64 for a flag), G the cells of the unstacked grid."""
    from .core.features_scan import INTER_FLAGS, INTER_VARS
    from .xrlite.dataarray import _fill_like, grid_positions

    if point:
        return False
    T, C = ts.data.shape
    cell_coords = _cell_coords(ts)
    _, _, grid_shape = grid_positions(cell_coords, sorted(cell_coords))
    G = int(np.prod(grid_shape))
    dts = [np.dtype(bool if k in INTER_FLAGS else dtype) for k in INTER_VARS]
    sts = [_fill_like(d, np.nan)[0].itemsize for d in dts]
    grid_bytes = [T * G * b for b in sts]
    if not _union_on_card(dev, grid_bytes):
        return False
    columns = T * C * sum(d.itemsize for d in dts)
    return columns + max(grid_bytes) + T * C * max(sts) <= _card_free(dev)


def _card_free(dev):
    """Bytes the card ``dev`` can still give a tensor: its free memory,
    and what PyTorch's caching allocator holds there unused."""
    free, _ = torch.cuda.mem_get_info(dev)
    return (free + torch.cuda.memory_reserved(dev)
            - torch.cuda.memory_allocated(dev))


def _inter_grids_card(inter, flat_pos, grid_shape, dev):
    """The intermediate grids built on ``dev`` from its (T, C) tensors
    ``inter``, which the call empties.

    Each variable, in ``inter``'s order, is filled with NaN in
    :func:`_fill_like`'s storage dtype (a bool flag as float64 0/1), its
    columns are copied to their ``flat_pos`` in the (T, G) grid of
    ``grid_shape``, and the grid is copied to the host without
    blocking, which from a CUDA device lands in page-locked memory of
    PyTorch's caching host allocator. The variable's tensor is let go as
    its grid is queued; the device's stream orders each copy before the
    next grid reuses its memory; one synchronisation at the end.
    Returns {name: array (T, *grid_shape)}, each a view of its own host
    tensor (the array keeps the tensor alive). On a CPU ``dev`` the same
    steps run in host memory."""
    from .xrlite.dataarray import _fill_like

    pos = torch.as_tensor(flat_pos, dtype=torch.int64, device=dev)
    G = int(np.prod(grid_shape))
    grids = {}
    for name in list(inter):
        col = inter.pop(name)
        st, fill = _fill_like(torch.empty(0, dtype=col.dtype).numpy().dtype,
                              np.nan)
        g = torch.full((col.shape[0], G), fill, device=dev,
                       dtype=torch.from_numpy(np.empty(0, st)).dtype)
        g.index_copy_(1, pos, col.to(g.dtype))
        host = g.to("cpu", non_blocking=True)
        grids[name] = host.numpy().reshape((col.shape[0],) + grid_shape)
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)
    return grids


@in_span("assemble_inter")
def _assemble_inter(inter, time_vals, point, ts, tdim, tindex=None,
                    dev=None):
    """Per-day intermediate Dataset (reference: xmhw.py:471-478;
    point-mode keeps the pandas 'index' dim name, grid mode uses time).
    ``inter``: {name: (T, C) array}; with ``dev``, {name: (T, C) tensor
    on ``dev``}, whose grids are built there (:func:`_inter_grids_card`;
    a call counts one ``inter_card_calls`` and the grids' bytes in
    ``inter_bytes``). Counts the bytes of the arrays it builds in
    ``inter_grid_bytes``."""
    dimname = "index" if point else "time"
    tattrs = {}
    if tindex is not None and not np.issubdtype(
            np.asarray(time_vals).dtype, np.datetime64):
        # synthetic calendars keep raw CF offsets: carry units/calendar
        # on the time coord so block_average(dstime=mhw_inter) can
        # derive years (same treatment as the mhw time_* variables)
        units = (getattr(tindex, "encoding", {}) or {}).get(
            "units") or getattr(tindex, "units", None)
        if units:
            tattrs = {"units": str(units),
                      "calendar": str(getattr(tindex, "calendar",
                                              "standard"))}
    tcoord = Coord((dimname,), time_vals, tattrs)
    ds = Dataset()
    if point:
        for name, arr in inter.items():
            ds[name] = DataArray(arr[:, 0], (dimname,), {dimname: tcoord})
        for k, v in _scalar_coords(ts, tdim).items():
            ds[k] = DataArray(np.full(len(time_vals), v), (dimname,),
                              {dimname: tcoord})
    elif dev is not None:
        from .xrlite.dataarray import grid_positions

        cell_coords = _cell_coords(ts)
        grid_dims = sorted(cell_coords)
        flat_pos, uniques, grid_shape = grid_positions(cell_coords,
                                                       grid_dims)
        coords = {dimname: tcoord}
        for d in grid_dims:
            coords[d] = Coord((d,), uniques[d])
        grids = _inter_grids_card(inter, flat_pos, grid_shape, dev)
        for name, full in grids.items():
            ds[name] = DataArray(full, (dimname, *grid_dims), coords)
        count("inter_card_calls")
        count("inter_bytes", sum(a.nbytes for a in grids.values()))
    else:
        cell_coords = _cell_coords(ts)
        grid_dims = sorted(cell_coords)
        for name, arr in inter.items():
            full, uniques = unstack_cell(arr, cell_coords, grid_dims)
            coords = {dimname: tcoord}
            for d in grid_dims:
                coords[d] = Coord((d,), uniques[d])
            ds[name] = DataArray(full, (dimname, *grid_dims), coords)
    count("inter_grid_bytes", sum(ds[k].data.nbytes for k in ds.keys()))
    return ds


def flip_cold(ds):
    """Negate intensity variables for cold-spell output
    (reference: xmhw/features.py:298-315)."""
    for varname in list(ds.keys()):
        if "intensity" in varname and "_var" not in varname:
            ds[varname] = ds[varname] * -1
    return ds
