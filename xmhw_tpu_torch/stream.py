"""Streamed planet-scale pipeline: chunked NetCDF in, region-written NetCDF out.

Port of :mod:`xmhw_tpu.stream`. The reference documents a manual workflow
for grids too large for memory: split the grid into chunk-aligned blocks,
run threshold/detect per block, and recombine the outputs (reference:
docs/dask.rst:44-86). This module automates it with host memory bounded
by O(time x stripe):

* the input variable is read in latitude stripes via HDF5 hyperslabs
  (never the whole grid);
* each stripe is land-compacted, pushed through the same device code the
  in-memory API uses (core.pipeline.run_clim / run_detect / run_fused,
  which launch the CUDA kernels on a GPU), and the result is
  region-written into the output file;
* every large host buffer is REUSED across stripes (see
  xrlite/alloc.py).

The host code (reader, writers, resume watermark, read-ahead and
write-behind threads) is a copy of the JAX package's; the functions that
differ from it, and the copies whose docstrings say what overlaps what on
the card, are listed in tests/test_torch_port_guard.py. What touches
the device takes ``device`` (default ``"cuda"``, as in :func:`threshold`; a
CUDA device without a GPU raises). ``mesh`` is passed on as the JAX
package passes it: to run_clim/run_detect with their default ``use_mesh``
(on the un-indexed ``"cuda"`` with more than one GPU visible, every GPU),
and to run_fused explicitly; with a mesh, ``device`` is not read. The
devices are synchronised once per stage of a stripe, the last time by
the fetch of the stripe's results.

Outputs are normal NetCDF4 files that xmhw_tpu_torch.open_dataset (or
xarray) reads back; variables, attributes and fill values match the JAX
package's files, and the global ``source`` attribute names this package.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .annotate import (MHW_VAR_ATTRS, detect_params_attr,
                       threshold_params_attr)
from .core.calendar import compute_doy, get_calendar
from .core.pipeline import (mesh_device, resolve_device, run_clim,
                            run_detect)
from .exception import XmhwException
from .xrlite import TimeIndex, encode_cf_time
from .xrlite.alloc import alloc_empty, alloc_filled, tune_malloc

__all__ = ["stream_threshold", "stream_detect", "stream_block_average",
           "stream_rank", "stream_run", "GridReader"]

_TIME_LIKE = ("time_start", "time_end", "time_peak")


class GridReader:
    """Lazy handle on one (time|doy, y, x, ...) NetCDF4/HDF5 variable.

    Reads hyperslab stripes over the FIRST grid dimension without loading
    the variable. Classic netCDF3 files are not supported for streaming
    (convert with nccopy -k nc4; the in-memory API reads them fine).
    """

    def __init__(self, path, var, lead_dim=None):
        import h5py

        with open(path, "rb") as fh:
            if fh.read(4) != b"\x89HDF":
                raise XmhwException(
                    f"{path}: streaming needs a NetCDF4/HDF5 file")
        self._h = h5py.File(path, "r")
        if var not in self._h:
            raise XmhwException(f"variable {var!r} not in {path}")
        self.v = self._h[var]
        self.dims = self._dims_of(self.v)
        self.attrs = {k: v for k, v in self.v.attrs.items()
                      if not k.startswith(("DIMENSION", "CLASS", "NAME",
                                           "_Netcdf4"))}
        # CF packing/fill decode state (xarray-equivalent, matching
        # xrlite/netcdf._cf_unpack): real products such as OISST v2
        # ship SST as int16 with scale_factor/add_offset and an integer
        # fill — read() returns decoded float with NaN fills, so the
        # streamed path sees the same values as the in-memory API
        # (reference relies on xarray decoding: requirements.txt:5-8).
        def _scalar(x):
            return None if x is None else np.asarray(x).reshape(-1)[0]
        self._sf = _scalar(self.attrs.pop("scale_factor", None))
        self._ao = _scalar(self.attrs.pop("add_offset", None))
        self._fv = _scalar(self.attrs.pop("_FillValue", None))
        self._mv = _scalar(self.attrs.pop("missing_value", None))
        packed = self._sf is not None or self._ao is not None
        if packed or not np.issubdtype(self.v.dtype, np.floating):
            self._decode_dt = np.result_type(
                np.float32 if self.v.dtype.itemsize <= 2 else np.float64,
                *(np.asarray(x).dtype for x in (self._sf, self._ao)
                  if x is not None))
        else:
            self._decode_dt = None  # float var: NaN-fill in place
        lead = lead_dim or self.dims[0]
        if self.dims[0] != lead:
            raise XmhwException(
                f"{var}: leading dim is {self.dims[0]}, expected {lead} "
                "(streaming requires the time/doy axis first)")
        self.grid_dims = self.dims[1:]
        if not self.grid_dims:
            raise XmhwException(
                "Series has only time dimension use point=True option,"
                " exiting")
        self.grid_shape = self.v.shape[1:]

    @staticmethod
    def _dims_of(node):
        dims = []
        if "DIMENSION_LIST" in node.attrs:
            for refs in node.attrs["DIMENSION_LIST"]:
                dims.append(node.file[refs[0]].name.lstrip("/"))
        else:
            dims = [f"dim_{i}" for i in range(node.ndim)]
        return dims

    def coord(self, name):
        """(values, attrs) of a dimension coordinate; time decoded."""
        from .xrlite.netcdf import _h5attrs, _is_time
        from .xrlite.timeutils import decode_cf_time

        node = self._h[name]
        attrs = _h5attrs(node)
        vals = node[()]
        if _is_time(name, attrs):
            cal = str(attrs.pop("calendar", "standard"))
            units = str(attrs.pop("units"))
            t = decode_cf_time(vals, units, cal)
            t.attrs.update(attrs)
            t.encoding = {"units": units, "calendar": cal}
            return t, attrs
        return vals, attrs

    def read(self, lo, hi, t_sel=slice(None)):
        """(T, cells) float stripe of grid rows [lo, hi).

        The destination comes from the warm-page pool (xrlite/alloc.py)
        — per-stripe GB-scale fresh allocations dominate host time on
        slow-page-supply hosts."""
        sel = (t_sel, slice(lo, hi)) + (slice(None),) * (self.v.ndim - 2)
        shape = tuple(len(range(*s.indices(n)))
                      for s, n in zip(sel, self.v.shape))
        block = alloc_empty(shape, self.v.dtype)
        self.v.read_direct(block, np.s_[sel])
        # fill mask is computed on the RAW (packed) values, CF-style
        mask = None
        for f in (self._fv, self._mv):
            if f is None:
                continue
            if np.issubdtype(block.dtype, np.floating) and np.isnan(
                    np.float64(f)):
                continue  # NaN fill in a float var is already NaN
            m = block == block.dtype.type(f)
            mask = m if mask is None else (mask | m)
        if self._decode_dt is not None:
            out = alloc_empty(shape, self._decode_dt)
            if self._sf is not None:
                np.multiply(block, self._decode_dt.type(self._sf),
                            out=out)
            else:
                out[...] = block
            if self._ao is not None:
                out += self._decode_dt.type(self._ao)
            block = out
        if mask is not None and mask.any():
            np.copyto(block, np.nan, where=mask)
        return block.reshape(block.shape[0], -1)

    def close(self):
        self._h.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _resume_sig(**params):
    """Canonical fingerprint of the parameters that shape a streamed
    run's outputs. Stored in the watermark and validated on resume, so
    a resumed call cannot silently mix two parameterizations in one
    output file."""
    return json.dumps({k: (list(v) if isinstance(v, tuple) else v)
                       for k, v in sorted(params.items())},
                      default=str)


def _kcache_file():
    """Path of the persisted per-dataset K-capacity table (the directory
    is XMHW_COMPILE_CACHE, default ~/.cache/xmhw_tpu_torch; the JAX
    package's opt-out: XMHW_COMPILE_CACHE=0 disables). A cached K spares
    stream_run's counting pass on a re-run and fixes the event-axis
    length of the compact files."""
    base = os.environ.get("XMHW_COMPILE_CACHE",
                          os.path.expanduser("~/.cache/xmhw_tpu_torch"))
    if base in ("0", ""):
        return None
    return os.path.join(base, "kcache.json")


def _kcache_key(sig):
    import hashlib

    return hashlib.sha1(sig.encode()).hexdigest()[:20]


def _kcache_get(sig):
    """Previously discovered event capacity K for this exact dataset +
    parameter fingerprint, or 0.

    The optimistic-K engine discovers capacity by walking 32->64->...
    with one multi-second remote compile per variant; a re-run of the
    same dataset used to pay that walk again. Same fingerprint => same
    inputs => same K, so the walk is a one-time cost per (dataset,
    params) per machine. If the file at the fingerprinted path changed
    content-wise, a too-small cached K is still safe: the raw-count
    overflow retry grows it exactly as on a fresh run."""
    path = _kcache_file()
    if path is None or not os.path.exists(path):
        return 0
    try:
        with open(path) as f:
            return int(json.load(f).get(_kcache_key(sig), 0))
    except (OSError, ValueError):
        return 0


def _kcache_put(sig, k):
    """Persist the discovered K (atomic rename; keeps newest 128)."""
    path = _kcache_file()
    if path is None or k <= 1:
        return
    try:
        table = {}
        if os.path.exists(path):
            with open(path) as f:
                table = json.load(f)
        key = _kcache_key(sig)
        if table.get(key) == int(k):
            return
        table.pop(key, None)
        table[key] = int(k)  # dict order = insertion = recency
        while len(table) > 128:
            table.pop(next(iter(table)))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(table, f)
        os.replace(tmp, path)
    except (OSError, ValueError):
        pass


def _load_resume(path, sig=None):
    """Watermark of an interrupted streamed run at ``path``, or None.

    A file the crashed run left truncated/invalid (it died before any
    watermarked stripe) reads as no-watermark — the resumed call is
    then a normal fresh run. A watermark whose parameter fingerprint
    differs from the resuming call's raises instead of mixing outputs.
    """
    if not os.path.exists(path):
        return None
    import h5py

    try:
        with h5py.File(path, "r") as f:
            raw = f.attrs.get("xmhw_resume")
        state = json.loads(raw) if raw is not None else None
    except Exception:  # unreadable/torn file from an early crash
        return None
    if state is not None and sig is not None \
            and state.get("sig") != sig:
        raise XmhwException(
            "resume=True but the parameters differ from the "
            "interrupted run's — rerun with the original parameters, "
            "or without resume to start fresh")
    return state


def _filter_resumed(edges, state):
    """Drop the stripes a resumed run has already completed."""
    if state is None:
        return edges
    return [e for e in edges if e[0] >= int(state["hi"])]


def _mark_resume(w, hi, rows, **extra):
    """Advance the per-stripe watermark — the LAST step of a stripe's
    write-behind job. Data is flushed before the watermark and the
    watermark after itself, so a process kill between stripes leaves a
    consistent resumable prefix. flush() reaches the OS page cache,
    not the platter: against power loss / host crashes set
    XMHW_STREAM_DURABLE=1, which adds an os.sync() barrier on either
    side of the watermark (slower; unnecessary for OOM kills and
    preemptions, where the page cache survives)."""
    durable = bool(os.environ.get("XMHW_STREAM_DURABLE"))
    w.h.flush()
    if durable:
        os.sync()
    w.h.attrs["xmhw_resume"] = json.dumps(
        {"hi": int(hi), "rows": int(rows), **extra})
    w.h.flush()
    if durable:
        os.sync()


def _auto_stripe(T, grid_shape, itemsize=4, budget=2 ** 28):
    """Grid rows per stripe so one (T, stripe) read is ~256 MB."""
    row_cells = int(np.prod(grid_shape[1:], dtype=np.int64)) or 1
    rows = max(1, int(budget / (T * row_cells * itemsize)))
    return min(rows, grid_shape[0])


class _Writer:
    """Incremental NetCDF4 writer (dimension-scales convention).

    ``resizable`` names dimensions whose length may grow after creation
    (see :meth:`resize_dim`) — their scales are created chunked with an
    unlimited maxshape, as are any variables created with that dim in
    ``grow_dims``.
    """

    def __init__(self, path, dim_coords, global_attrs=None,
                 resizable=()):
        import h5py

        self.h = h5py.File(path, "w")
        self.scales = {}
        for name, (vals, attrs) in dim_coords.items():
            if isinstance(vals, TimeIndex) or (
                    np.asarray(vals).dtype.kind == "M"):
                t = vals if isinstance(vals, TimeIndex) else TimeIndex(
                    np.asarray(vals))
                raw, units, cal = encode_cf_time(
                    t, getattr(t, "encoding", {}).get("units"))
                attrs = dict(attrs or {}, units=units, calendar=cal)
                vals = raw
            vals = np.asarray(vals)
            kw = ({"maxshape": (None,), "chunks": (max(1, len(vals)),)}
                  if name in resizable else {})
            node = self.h.create_dataset(name, data=vals, **kw)
            node.make_scale(name)
            for k, v in (attrs or {}).items():
                try:
                    node.attrs[k] = v
                except TypeError:
                    node.attrs[k] = str(v)
            self.scales[name] = node
        for k, v in (global_attrs or {}).items():
            try:
                self.h.attrs[k] = v
            except TypeError:
                self.h.attrs[k] = str(v)

    @classmethod
    def open_append(cls, path):
        """Reopen an existing output file to resume an interrupted
        streamed run: scales are discovered from the file; create()
        returns the existing dataset for names already present."""
        import h5py

        self = cls.__new__(cls)
        self.h = h5py.File(path, "r+")
        self.scales = {}
        for name, node in self.h.items():
            if node.attrs.get("CLASS") in (b"DIMENSION_SCALE",
                                           "DIMENSION_SCALE"):
                self.scales[name] = node
        return self

    def create(self, name, dims, dtype, attrs=None, fill=np.nan,
               chunks=None, compress=None, grow_dims=()):
        if name in self.h:  # resumed run: dataset already on disk
            return self.h[name]
        shape = tuple(self.scales[d].shape[0] for d in dims)
        kw = {}
        if (compress or grow_dims) and not chunks:
            # gzip and unlimited dims require a chunked layout; one grid
            # row per chunk
            chunks = (shape[0], 1) + shape[2:] if len(shape) > 1 else shape
        if chunks and not all(s > 0 for s in shape):
            # h5py rejects chunked layouts with any zero extent (e.g. an
            # empty events axis); contiguous is fine for empty datasets,
            # but a requested gzip/growable layout is silently dropped
            # with it — say so instead of losing the request quietly
            if compress or grow_dims:
                import warnings

                warnings.warn(
                    f"{name}: a dimension has zero extent; HDF5 cannot "
                    "chunk it, so the requested "
                    + ("compression" if compress else "growable layout")
                    + " is skipped for this (empty) dataset",
                    stacklevel=2)
            chunks = None
        if chunks:
            kw["chunks"] = tuple(min(c, s) for c, s in zip(chunks, shape))
            if compress:
                # the reference's documented staging encodes the sparse
                # event output with zlib (docs/gettingstarted.rst:64);
                # shuffle + gzip compresses the NaN-padded tables ~5-20x
                kw.update(compression="gzip",
                          compression_opts=int(compress), shuffle=True)
            if grow_dims:
                kw["maxshape"] = tuple(
                    None if d in grow_dims else s
                    for d, s in zip(dims, shape))
        node = self.h.create_dataset(name, shape=shape, dtype=dtype,
                                     fillvalue=fill, **kw)
        for i, d in enumerate(dims):
            node.dims[i].attach_scale(self.scales[d])
        if np.issubdtype(np.dtype(dtype), np.floating):
            node.attrs["_FillValue"] = np.array([np.nan], dtype=dtype)
        for k, v in (attrs or {}).items():
            try:
                node.attrs[k] = v
            except TypeError:
                node.attrs[k] = str(v)
        return node

    def resize_dim(self, name, vals):
        """Grow a ``resizable`` dimension scale and rewrite its values.
        Variables using the dim must be resized by the caller (h5py
        fills the new region with each dataset's fillvalue)."""
        node = self.scales[name]
        node.resize((len(vals),))
        node[...] = np.asarray(vals)

    def close(self):
        self.h.close()


def _prefetched(pairs, fetch):
    """Yield ``(lo, hi, fetch(lo, hi))`` with the NEXT stripe's fetch
    running on a worker thread while the caller processes the current
    one.

    A fetch is the stripe's hyperslab read and ocean compaction (host
    work; HDF5 and numpy's large copies release the GIL) and, with
    ``maxPadLength``, its gap filling, which this thread runs on the
    device: ``.cpu()`` waits for that work, so the consumer gets finished
    host arrays. Meanwhile the consumer's device step uploads the current
    stripe, launches the kernels and waits on the device with the GIL
    released. How long each takes per stripe on a card is in PERF.md §5
    (chip_smoke.py's ``stream band`` line); those runs read raw arrays
    through a numpy stand-in for h5py, so HDF5's own read cost is not in
    them. Exactly one fetch is in flight — host memory stays bounded at
    two stripes. h5py serializes all HDF5 calls under its global lock, so
    the worker's reads interleave safely with the writers on the other
    threads (the stand-in locks each file on its own, so those card runs
    did not exercise h5py's lock). Worker exceptions re-raise at the consumer's next step."""
    import threading

    pairs = list(pairs)
    slot = {}

    def work(lo, hi):
        try:
            slot["v"] = fetch(lo, hi)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            slot["e"] = e

    t = None
    for i, (lo, hi) in enumerate(pairs):
        if t is None:  # first stripe: fetch inline
            work(lo, hi)
        else:
            t.join()
        if "e" in slot:
            raise slot.pop("e")
        val = slot.pop("v")
        if i + 1 < len(pairs):
            t = threading.Thread(target=work, args=pairs[i + 1],
                                 daemon=True)
            t.start()
        yield lo, hi, val


class _WriteBehind:
    """Single-slot deferred writer: ``submit(fn)`` joins the previous
    job, then runs ``fn`` on a worker thread. Lets one stripe's write job
    (the scatter of its results to the grid layout, stream_run's host
    ranks, the region writes) overlap the NEXT stripe's device step
    (upload, kernels, waits on the device with the GIL released) and the
    read after it. With the one-ahead read prefetcher this makes the
    steady state three stripes in flight: reading N+1, device-stepping N,
    writing N-1, and the longest of the three sets the stripe's wall.
    Which one that is per stripe is in PERF.md §5 (chip_smoke.py's
    ``stream band`` line), measured with raw-array files through a numpy
    stand-in for h5py, so without HDF5's own write cost. Exactly one job
    is ever pending, so host memory stays bounded at one extra stripe of
    fetched outputs (captured by the closure). Worker exceptions re-raise at the next submit()/
    finish(). All shared write state (reused expansion buffers, the
    _Writer/_StreamTableWriter objects) must be touched ONLY inside
    submitted jobs — the single slot serializes them."""

    def __init__(self):
        import threading

        self._threading = threading
        self._t = None
        self._err = None

    def _run(self, fn):
        try:
            fn()
            # stripe boundary: release fragmented glibc-arena excess
            # (varying-size fetch/scratch buffers accumulate under
            # tune_malloc's no-trim policy — ~50 GB over the 68 GB
            # full-scale run). Guarded by a 2 GB bloat threshold and
            # running HERE, the refault cost of re-touching the churn
            # overlaps the next stripe's device step.
            from .xrlite.alloc import maybe_trim_arena

            maybe_trim_arena()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            self._err = e

    def submit(self, fn):
        self.finish()
        self._t = self._threading.Thread(target=self._run, args=(fn,),
                                         daemon=True)
        self._t.start()

    def finish(self):
        if self._t is not None:
            self._t.join()
            self._t = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err


def _compact_ocean(block, anynans=False):
    """Drop all-NaN (land) columns — or any-NaN columns with ``anynans``
    (reference land_check: identify.py:522-525); returns
    (compacted, keep_idx). The compacted copy is pool-backed."""
    nan = np.isnan(block)
    drop = nan.any(axis=0) if anynans else nan.all(axis=0)
    keep = np.nonzero(~drop)[0]
    if keep.size == block.shape[1]:
        return block, keep
    out = alloc_empty((block.shape[0], keep.size), block.dtype)
    np.take(block, keep, axis=1, out=out)
    return out, keep


def stream_threshold(
    in_path,
    var,
    out_path,
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
    dtype=np.float32,
    stripe=None,
    cell_block=None,
    mesh=None,
    compress=None,
    resume=False,
    device="cuda",
):
    """threshold() streamed file-to-file; host memory O(time x stripe).

    ``compress``: gzip level (1-9) for the output variables — the
    reference's documented staging encodes outputs with zlib
    (docs/gettingstarted.rst:64).

    ``resume=True`` picks up an interrupted run from its per-stripe
    watermark (see :func:`stream_run`); with no watermark it is a
    normal fresh run.

    ``device``: where the climatology runs (default ``"cuda"``), as in
    :func:`xmhw_tpu_torch.threshold`.

    Same semantics as :func:`xmhw_tpu_torch.threshold` (reference:
    xmhw/xmhw.py:38-247); returns the output path.
    """
    dev = mesh_device(mesh, device)
    tune_malloc()
    if smoothPercentileWidth % 2 == 0:
        raise XmhwException("smoothPercentileWidth should be odd")
    with GridReader(in_path, var, lead_dim=tdim) as g:
        # the input identity (path + grid shape) is part of the resume
        # fingerprint: resuming after swapping the input dataset must
        # raise, not stitch stripes of two datasets into one output
        resume_sig = _resume_sig(
            fn="stream_threshold", var=var,
            in_path=os.path.abspath(in_path),
            grid_shape=list(g.grid_shape),
            climatologyPeriod=list(climatologyPeriod), pctile=pctile,
            windowHalfWidth=windowHalfWidth,
            smoothPercentile=smoothPercentile,
            smoothPercentileWidth=smoothPercentileWidth,
            maxPadLength=maxPadLength, coldSpells=coldSpells,
            tstep=tstep, anynans=anynans, skipna=skipna,
            dtype=np.dtype(dtype).str, compress=compress)
        resume_state = (_load_resume(out_path, resume_sig)
                        if resume else None)
        tindex, _ = g.coord(tdim)
        if not isinstance(tindex, TimeIndex):
            raise XmhwException(f"{tdim} must be a CF time coordinate")
        t_sel = slice(None)
        if all(climatologyPeriod):
            years = tindex.year
            idx = np.nonzero((years >= int(climatologyPeriod[0]))
                             & (years <= int(climatologyPeriod[1])))[0]
            t_sel = slice(int(idx[0]), int(idx[-1]) + 1)
            tindex = TimeIndex(tindex.values[t_sel])
        if get_calendar(tindex) == 360.0:
            tstep = True
        doy, ndoy = compute_doy(tindex, keep_tstep=tstep)
        T = len(doy)

        rows = stripe or _auto_stripe(T, g.grid_shape)
        if resume_state is not None:
            rows = int(resume_state["rows"])
        dim_coords = {"doy": (np.arange(1, ndoy + 1), {})}
        for d in g.grid_dims:
            dim_coords[d] = g.coord(d)
        w = (_Writer.open_append(out_path)
             if resume_state is not None else
             _Writer(out_path, dim_coords, global_attrs={
                 "xmhw_parameters": threshold_params_attr(
                     pctile, tindex.year[0], tindex.year[-1],
                     windowHalfWidth, skipna, smoothPercentile,
                     smoothPercentileWidth, anynans),
                 "source": "xmhw_tpu_torch stream_threshold",
             }))
        units = g.attrs.get("units", "degree_C")
        if isinstance(units, bytes):
            units = units.decode("utf-8", "replace")
        units = str(units)
        out_vars = {
            "thresh": w.create(
                "thresh", ("doy", *g.grid_dims), np.dtype(dtype).str,
                {"long_name": f"{pctile}th percentile threshold",
                 "units": units}, compress=compress),
            "seas": w.create(
                "seas", ("doy", *g.grid_dims), np.dtype(dtype).str,
                {"long_name": "climatological mean", "units": units},
                compress=compress),
        }
        row_cells = int(np.prod(g.grid_shape[1:], dtype=np.int64)) or 1
        buf = alloc_filled((ndoy, rows * row_cells), np.nan, dtype)

        def _fetch(lo, hi):
            block = g.read(lo, hi, t_sel).astype(dtype, copy=False)
            comp, keep = _compact_ocean(block, anynans)
            if keep.size:
                if maxPadLength:
                    from .api import _interpolate_na

                    comp = _interpolate_na(comp, maxPadLength, dev)
                if coldSpells:
                    comp = -comp
            return comp, keep

        edges = [(lo, min(lo + rows, g.grid_shape[0]))
                 for lo in range(0, g.grid_shape[0], rows)]
        edges = _filter_resumed(edges, resume_state)
        wb = _WriteBehind()
        for lo, hi, (comp, keep) in _prefetched(edges, _fetch):
            c_str = (hi - lo) * row_cells
            th = se = None
            if keep.size:
                th, se = run_clim(
                    comp, doy, windowHalfWidth, ndoy, pctile=pctile,
                    smooth=smoothPercentile, smooth_w=smoothPercentileWidth,
                    patch_feb29=not tstep, block=cell_block, mesh=mesh,
                    device=dev)

            def _write(lo=lo, hi=hi, c_str=c_str, keep=keep, th=th,
                       se=se):
                for name, vals in (("thresh", th), ("seas", se)):
                    view = buf[:, :c_str]
                    view.fill(np.nan)
                    if vals is not None:
                        view[:, keep] = vals
                    out_vars[name][:, lo:hi] = view.reshape(
                        ndoy, hi - lo, *g.grid_shape[1:])
                _mark_resume(w, hi, rows, sig=resume_sig)

            wb.submit(_write)
        wb.finish()
        w.h.attrs.pop("xmhw_resume", None)  # run is complete
        w.close()
    return out_path


def _encode_times(idx, time_vals, units, cal):
    """Event time indexes -> CF-encoded floats (NaN where no event)."""
    t = TimeIndex(time_vals[np.clip(idx, 0, len(time_vals) - 1)]
                  .reshape(-1))
    raw, _, _ = encode_cf_time(t, units)
    raw = np.asarray(raw, np.float64).reshape(idx.shape)
    return np.where(idx >= 0, raw, np.nan)


def _scatter_buf(bufs, dt, nrows, ncols):
    """Pooled NaN-fill scatter buffer, keyed by (float-coerced) dtype
    and grown when nrows exceeds the cached buffer's rows. Shared by
    the phase-B union writer and the streaming compact writer so the
    dtype/fill rules live in one place."""
    dt = np.dtype(dt)
    if dt.kind != "f":
        dt = np.dtype(np.float64)
    b = bufs.get(dt)
    if b is None or b.shape[0] < nrows:
        b = alloc_filled((max(nrows, 1), ncols), np.nan, dt)
        bufs[dt] = b
    return b


def _write_table_file(out_path, stripes, names, g, ev_dim, ev_vals,
                      union, time_vals, units, cal, global_attrs, rows,
                      row_cells, attrs_of=None, dtype_of=None,
                      compress=None):
    """Phase-B writer shared by stream_detect / stream_run: scatter the
    per-stripe compact (K_b, n_keep) tables into the (ev|events, grid)
    file layout.

    ``stripes``: list of (lo, hi, keep, tables, labels) — ``labels``
    (the per-slot event ids) drive the union-layout scatter and may be
    None for compact layouts. ``attrs_of(name)`` / ``dtype_of(name,
    arr)`` customize variable attrs and storage dtypes.
    """
    E = len(ev_vals)
    dim_coords = {ev_dim: (ev_vals, {})}
    for d in g.grid_dims:
        dim_coords[d] = g.coord(d)
    w = _Writer(out_path, dim_coords, global_attrs=global_attrs)
    some = next((s for s in stripes if s[3]), None)
    out_vars = {}
    for name in names:
        if dtype_of is not None:
            dt = dtype_of(name, some[3][name] if some else None)
        else:
            dt = (np.float64 if name in _TIME_LIKE
                  else some[3][name].dtype)
        out_vars[name] = w.create(
            name, (ev_dim, *g.grid_dims), np.dtype(dt).str,
            attrs_of(name) if attrs_of is not None else {},
            chunks=(max(1, min(E, 4096)), 1, *g.grid_shape[1:]),
            compress=compress)
    # scatter buffers in the OUTPUT dtype (usually f4): h5py then writes
    # without a per-chunk f8->f4 conversion pass — at planet scale the
    # table files are ~10 GB and this halves the phase-B memory traffic
    bufs = {}

    def _buf(dt):
        return _scatter_buf(bufs, dt, E, rows * row_cells)

    for lo, hi, keep, tables, labels in stripes:
        c_str = (hi - lo) * row_cells
        if union is not None and keep.size:
            fin = np.isfinite(labels)
            rr = np.searchsorted(union, labels[fin].astype(np.int64))
            cc = np.broadcast_to(keep, labels.shape)[fin]
        for name in names:
            view = _buf(out_vars[name].dtype)[:E, :c_str]
            view.fill(np.nan)
            if keep.size:
                tab = tables[name]
                if name in _TIME_LIKE:
                    tab = _encode_times(tab.astype(np.int64),
                                        time_vals, units, cal)
                if union is not None:
                    # 2-D fancy indexing writes through the view; a
                    # flat reshape of the non-contiguous view (when
                    # this is a partial final stripe) would COPY and
                    # silently drop the writes
                    view[rr, cc] = tab[fin]
                else:
                    view[:tab.shape[0], keep] = tab
            out_vars[name][:, lo:hi] = view.reshape(
                E, hi - lo, *g.grid_shape[1:])
    w.close()


class _StreamTableWriter:
    """Incremental compact-layout event-table writer: each stripe's
    tables stream to disk as soon as they are produced, so host memory
    stays O(stripe) instead of accumulating every stripe's compact
    tables for a final write pass (~31 x K x ocean_cells values — tens
    of GB at planet scale; this removes both that resident set and the
    serial write tail after the last device step).

    Datasets are created at the first non-empty stripe with the ``ev``
    axis sized to that stripe's K and an unlimited maxshape; if a later
    stripe arrives with a larger K (run_detect/run_fused only ever grow
    K), every variable and the ``ev`` scale are resized — HDF5 fills
    the new region with the NaN fillvalue, exactly the grown-table
    semantics of the in-memory path. Only the compact layout can be
    streamed this way: the union layout's event axis is the global
    union of start indexes, unknown until every stripe has run (that
    path keeps the accumulate-then-write flow in _write_table_file).
    """

    def __init__(self, out_path, g, time_vals, units, cal, global_attrs,
                 rows, row_cells, attrs_of=None, dtype_of=None,
                 compress=None, reopen=False):
        self.out_path = out_path
        self.g = g
        self.time_vals = time_vals
        self.units = units
        self.cal = cal
        self.global_attrs = global_attrs
        self.rows = rows
        self.row_cells = row_cells
        self.attrs_of = attrs_of
        self.dtype_of = dtype_of
        self.compress = compress
        self.reopen = reopen  # resume: pick up the interrupted file
        self.w = None
        self.vars = {}
        self.E = 0
        self._bufs = {}

    def _buf(self, dt):
        return _scatter_buf(self._bufs, dt, self.E,
                            self.rows * self.row_cells)

    def _ensure(self, tables):
        E = next(iter(tables.values())).shape[0]
        g = self.g
        if self.w is None and self.reopen and os.path.exists(
                self.out_path):
            w = _Writer.open_append(self.out_path)
            if "ev" in w.scales and all(n in w.h for n in tables):
                self.w = w
                self.E = w.scales["ev"].shape[0]
                self.vars = {name: w.h[name] for name in tables}
            else:
                # the interrupted run died mid-creation, before any
                # watermarked stripe referenced this file — recreate
                w.h.close()
        if self.w is None:
            dim_coords = {"ev": (np.arange(E), {})}
            for d in g.grid_dims:
                dim_coords[d] = g.coord(d)
            self.w = _Writer(self.out_path, dim_coords,
                             global_attrs=self.global_attrs,
                             resizable=("ev",))
            self.E = E
            for name, tab in tables.items():
                if self.dtype_of is not None:
                    dt = self.dtype_of(name, tab)
                else:
                    dt = (np.float64 if name in _TIME_LIKE
                          else tab.dtype)
                self.vars[name] = self.w.create(
                    name, ("ev", *g.grid_dims), np.dtype(dt).str,
                    self.attrs_of(name) if self.attrs_of else {},
                    chunks=(max(1, min(E, 4096)), 1,
                            *g.grid_shape[1:]),
                    compress=self.compress, grow_dims=("ev",))
        elif E > self.E:
            self.w.resize_dim("ev", np.arange(E))
            for node in self.vars.values():
                node.resize(E, axis=0)
            self.E = E

    def open_if_exists(self):
        """Open the on-disk file without writing (resumed runs whose
        remaining stripes never produced tables). True if open."""
        if self.w is None and os.path.exists(self.out_path):
            self.w = _Writer.open_append(self.out_path)
            self.E = self.w.scales["ev"].shape[0]
        return self.w is not None

    def write(self, lo, hi, keep, tables):
        """Scatter one stripe's compact (K_b, n_keep) tables into the
        (ev, grid) layout — the same expansion as _write_table_file's
        compact branch. Land-only stripes need no write: the datasets'
        NaN fillvalue already covers them."""
        if not tables:
            return
        self._ensure(tables)
        g = self.g
        c_str = (hi - lo) * self.row_cells
        for name, tab in tables.items():
            node = self.vars[name]
            view = self._buf(node.dtype)[:self.E, :c_str]
            view.fill(np.nan)
            if keep.size:
                if name in _TIME_LIKE:
                    tab = _encode_times(tab.astype(np.int64),
                                        self.time_vals, self.units,
                                        self.cal)
                view[:tab.shape[0], keep] = tab
            node[:, lo:hi] = view.reshape(
                self.E, hi - lo, *g.grid_shape[1:])

    def close(self):
        if self.w is not None:
            self.w.close()


def stream_detect(
    ts_path,
    var,
    clim_path,
    out_path,
    tdim="time",
    minDuration=5,
    joinGaps=True,
    maxGap=2,
    maxPadLength=None,
    coldSpells=False,
    intermediate=False,
    anynans=False,
    tstep=False,
    dtype=np.float32,
    stripe=None,
    cell_block=None,
    mesh=None,
    events_layout="compact",
    thresh_var="thresh",
    seas_var="seas",
    inter_path=None,
    reference_quirks=False,
    resume=False,
    compress=None,
    device="cuda",
):
    """detect() streamed file-to-file.

    ``compress``: gzip level (1-9) for the output variables — the
    reference's documented staging encodes the sparse event output with
    zlib (docs/gettingstarted.rst:64); the NaN-padded tables compress
    ~5-20x.

    Host memory: the time-series data is streamed per stripe
    (O(time x stripe)). With the default ``events_layout="compact"``
    the event tables also stream to disk stripe-by-stripe (resizable
    ``ev`` axis), so the resident set stays O(stripe). The ``"union"``
    layout must retain every stripe's compact tables until the end —
    its event axis is the global union of start indexes, only known
    after all stripes are detected (~31 x K x ocean_cells values, a few
    GB at 620k ocean cells / K=128); the grid itself is never resident.

    ``events_layout="compact"`` writes (ev, lat, lon, ...) per-cell event
    slots — the planet-scale layout. ``"union"`` writes the reference's
    (events, lat, lon, ...) union layout (output size grows with the
    global number of distinct events; fine at regional scale).
    Same event semantics as :func:`xmhw_tpu_torch.detect` including the
    coldSpells intensity flip (reference: xmhw/xmhw.py:310-518);
    returns the output path.

    ``intermediate=True`` also writes the per-day intermediate dataset
    (reference: xmhw/xmhw.py:471-478) to ``inter_path`` (default: the
    output path with an ``_inter`` suffix), streamed stripe-by-stripe
    during the detect pass; returns ``(out_path, inter_path)``. Boolean
    per-day variables are stored as int8 (land cells 0); float variables
    carry NaN on land like the in-memory API.

    ``resume=True`` picks up an interrupted run from the per-stripe
    watermark on the output file (compact layout only; see
    :func:`stream_run`); with no watermark it is a normal fresh run.

    ``device``: where detection runs (default ``"cuda"``), as in
    :func:`xmhw_tpu_torch.detect`.
    """
    dev = mesh_device(mesh, device)
    tune_malloc()
    if maxGap >= minDuration:
        raise XmhwException(
            "Maximum gap between mhw events should"
            + " be smaller than event minimum duration")
    if intermediate and inter_path is None:
        inter_path = (out_path[:-3] + "_inter.nc"
                      if out_path.endswith(".nc")
                      else out_path + "_inter.nc")
    if resume and events_layout == "union":
        raise XmhwException(
            "resume=True requires events_layout='compact' (the "
            "union event axis needs every stripe in memory)")
    with GridReader(ts_path, var, lead_dim=tdim) as g, \
            GridReader(clim_path, thresh_var, lead_dim="doy") as gth, \
            GridReader(clim_path, seas_var, lead_dim="doy") as gse:
        resume_sig = _resume_sig(
            fn="stream_detect", var=var,
            ts_path=os.path.abspath(ts_path),
            clim_path=os.path.abspath(clim_path),
            grid_shape=list(g.grid_shape),
            minDuration=minDuration, joinGaps=joinGaps, maxGap=maxGap,
            maxPadLength=maxPadLength, coldSpells=coldSpells,
            intermediate=intermediate, anynans=anynans, tstep=tstep,
            dtype=np.dtype(dtype).str, events_layout=events_layout,
            thresh_var=thresh_var, seas_var=seas_var,
            reference_quirks=reference_quirks, compress=compress)
        resume_state = (_load_resume(out_path, resume_sig)
                        if resume else None)
        if tuple(gth.grid_shape) != tuple(g.grid_shape):
            raise XmhwException(
                f"climatology grid {gth.grid_shape} != timeseries grid "
                f"{g.grid_shape}")
        tindex, _ = g.coord(tdim)
        doy, _ = compute_doy(tindex, keep_tstep=tstep)
        th_doys, _ = gth.coord("doy")
        pos = np.searchsorted(th_doys, doy)
        bad = (pos >= len(th_doys)) | (
            th_doys[np.clip(pos, 0, len(th_doys) - 1)] != doy)
        if bad.any():
            raise XmhwException(
                "Climatology doy axis does not cover the timeseries doys")
        doy_pos = pos.astype(np.int32)
        time_vals = tindex.values
        units = getattr(tindex, "encoding", {}).get("units")
        cal = getattr(tindex, "encoding", {}).get("calendar", "standard")

        T = len(doy)
        rows = stripe or _auto_stripe(T, g.grid_shape)
        if resume_state is not None:
            rows = int(resume_state["rows"])
        row_cells = int(np.prod(g.grid_shape[1:], dtype=np.int64)) or 1

        u = g.attrs.get("units", "degree_C")
        if isinstance(u, bytes):
            u = u.decode("utf-8", "replace")

        def _attrs_of(name):
            attrs = {}
            if name in MHW_VAR_ATTRS:
                long_name, unit_t = MHW_VAR_ATTRS[name]
                attrs = {"long_name": long_name,
                         "units": str(unit_t).format(u=str(u))}
            if name in _TIME_LIKE and units:
                attrs.update(units=units, calendar=cal)
            return attrs

        out_attrs = {"xmhw_parameters": detect_params_attr(
            minDuration, joinGaps, maxGap, coldSpells, maxPadLength,
            anynans),
            "source": "xmhw_tpu_torch stream_detect"}
        compact = events_layout != "union"
        tw = (_StreamTableWriter(out_path, g, time_vals, units, cal,
                                 out_attrs, rows, row_cells,
                                 attrs_of=_attrs_of, compress=compress,
                                 reopen=resume_state is not None)
              if compact else None)

        # ---- phase A: detect per stripe; compact tables stream to disk,
        # union-layout tables are retained for the phase-B union scatter
        stripes = []  # (lo, hi, keep, tables {name: (K_b, n_keep)})
        kmax = max(1, _kcache_get(resume_sig))  # skip the K re-walk
        label_union = []
        iw = None  # lazy intermediate writer (phase-A streamed)
        inter_vars = {}
        if resume_state is not None:
            kmax = max(kmax, int(resume_state.get("kmax", 1)))
            if intermediate and os.path.exists(inter_path):
                iw = _Writer.open_append(inter_path)
                inter_vars = {n: iw.h[n] for n in iw.h
                              if n not in iw.scales}
        def _fetch(lo, hi):
            block = g.read(lo, hi).astype(dtype, copy=False)
            comp, keep = _compact_ocean(block, anynans)
            if keep.size == 0:
                return comp, keep, None, None
            th = gth.read(lo, hi).astype(dtype, copy=False)[:, keep]
            se = gse.read(lo, hi).astype(dtype, copy=False)[:, keep]
            if maxPadLength:
                from .api import _interpolate_na

                comp = _interpolate_na(comp, maxPadLength, dev)
            if coldSpells:
                comp = -comp
            return comp, keep, th, se

        edges = [(lo, min(lo + rows, g.grid_shape[0]))
                 for lo in range(0, g.grid_shape[0], rows)]
        edges = _filter_resumed(edges, resume_state)
        wb = _WriteBehind()
        for lo, hi, (comp, keep, th, se) in _prefetched(edges, _fetch):
            if keep.size == 0:
                if not compact:
                    stripes.append((lo, hi, keep, {}))
                continue
            tables, n_events, inter = run_detect(
                comp, th, se, doy_pos, min_duration=minDuration,
                join_gaps=joinGaps, max_gap=maxGap, block=cell_block,
                mesh=mesh, intermediate=intermediate,
                day0_fillna_quirk=reference_quirks,
                k_min=kmax,  # stabilize K across stripes
                device=dev)
            if intermediate and iw is None:
                iw, inter_vars = _make_inter_writer(
                    inter_path, tindex, g, tdim, inter)
            if coldSpells:
                # flip_cold (reference: xmhw/features.py:298-315): cold
                # spells report negated intensities, variances excluded
                for k in tables:
                    if "intensity" in k and "_var" not in k:
                        tables[k] = -tables[k]
            kmax = max(kmax, tables["event"].shape[0])
            if not compact:
                lab = tables["event"]
                fin = np.isfinite(lab)
                if fin.any():
                    label_union.append(np.unique(lab[fin]))
                stripes.append((lo, hi, keep, tables))

            def _write(lo=lo, hi=hi, keep=keep, tables=tables,
                       inter=inter, kmax=kmax):
                if intermediate:
                    _write_inter_stripe(inter_vars, inter, lo, hi,
                                        keep, g, row_cells, T)
                if compact:
                    tw.write(lo, hi, keep, tables)
                    if iw is not None:
                        iw.h.flush()
                    _mark_resume(tw.w, hi, rows, kmax=int(kmax),
                                 sig=resume_sig)

            wb.submit(_write)
        wb.finish()
        _kcache_put(resume_sig, kmax)  # re-runs start at the final K

        # ---- phase B: close (compact) / union scatter-write -------------
        if compact:
            if tw.w is None and resume_state is not None:
                tw.open_if_exists()
            if tw.w is None:
                raise XmhwException(
                    "All points of grid are either land or NaN")
            tw.w.h.attrs.pop("xmhw_resume", None)  # run is complete
            tw.close()
        else:
            union = (np.unique(np.concatenate(label_union))
                     .astype(np.int64) if label_union
                     else np.zeros(0, np.int64))
            some = next((s for s in stripes if s[3]), None)
            if some is None:
                raise XmhwException(
                    "All points of grid are either land or NaN")
            names = list(some[3].keys())
            _write_table_file(
                out_path,
                [(lo, hi, keep, tables, tables.get("event"))
                 for lo, hi, keep, tables in stripes],
                names, g, "events", union, union, time_vals, units, cal,
                out_attrs, rows, row_cells, attrs_of=_attrs_of,
                compress=compress)
        if iw is not None:
            iw.close()
    if intermediate:
        return out_path, inter_path
    return out_path


def stream_block_average(
    mhw_path,
    out_path,
    dstime_path=None,
    dstime_var=None,
    clim_path=None,
    period=None,
    blockLength=1,
    mtime="time_start",
    tdim="time",
    removeMissing=False,
    stripe=None,
    thresh_var="thresh",
    seas_var="seas",
    compress=None,
    resume=False,
    device="cuda",
):
    """block_average() streamed file-to-file — the stats stage of the
    planet-scale pipeline (reference workflow: docs/gettingstarted.rst:
    158-188, docs/block_average.rst:19-40; block_average itself:
    stats.py:27-183).

    ``mhw_path`` is a stream_detect output (compact ``ev`` or union
    ``events`` layout). With ``dstime_path``/``dstime_var`` (the original
    SST file) the per-day ts stats are added; with ``clim_path`` too, the
    category-day counts (cats = floor(1+(ts-th)/(th-se)), reference
    stats.py:225-231). Both halves run on device per stripe: event
    aggregations via ops/block_stats.event_bins, per-day stats via
    ops/block_stats.day_bins (float64: their plain versions,
    core/stats.binned_*). Host memory stays O(stripe).
    ``resume=True`` picks up an interrupted run from the per-stripe
    watermark on the output file (see :func:`stream_run`).
    ``device``: where both halves run (default ``"cuda"``); the event
    sums stay float64 there, as on the host.
    Returns the output path.
    """
    from .core.stats import EVENT_AGGS, EVENT_VARS, day_block_edges

    dev = resolve_device(device)
    tune_malloc()
    with GridReader(mhw_path, "time_start") as gm:
        resume_sig = _resume_sig(
            fn="stream_block_average",
            mhw_path=os.path.abspath(mhw_path),
            dstime_path=(os.path.abspath(dstime_path)
                         if dstime_path else None),
            dstime_var=dstime_var,
            clim_path=(os.path.abspath(clim_path)
                       if clim_path else None),
            grid_shape=list(gm.grid_shape),
            period=list(period) if period else None,
            blockLength=blockLength, mtime=mtime,
            removeMissing=removeMissing, thresh_var=thresh_var,
            seas_var=seas_var, compress=compress)
        resume_state = (_load_resume(out_path, resume_sig)
                        if resume else None)
        ev_dim = gm.dims[0]
        tattrs = {k: (v.decode() if isinstance(v, bytes) else v)
                  for k, v in gm.attrs.items()}
        gts = gth = gse = None
        tindex = doy_pos = None
        try:
            if dstime_path is not None:
                if dstime_var is None:
                    raise XmhwException(
                        "dstime_path requires dstime_var (the SST "
                        "variable name)")
                gts = GridReader(dstime_path, dstime_var, lead_dim=tdim)
                if tuple(gts.grid_shape) != tuple(gm.grid_shape):
                    raise XmhwException(
                        f"dstime grid {gts.grid_shape} != mhw grid "
                        f"{gm.grid_shape}")
                tindex, _ = gts.coord(tdim)
                tyears = np.asarray(tindex.year)
                period = [int(tyears[0]), int(tyears[-1])]
                if clim_path is not None:
                    gth = GridReader(clim_path, thresh_var,
                                     lead_dim="doy")
                    gse = GridReader(clim_path, seas_var, lead_dim="doy")
                    th_doys, _ = gth.coord("doy")
                    doy, _ = compute_doy(tindex)
                    pos = np.searchsorted(th_doys, doy)
                    bad = (pos >= len(th_doys)) | (
                        th_doys[np.clip(pos, 0, len(th_doys) - 1)] != doy)
                    if bad.any():
                        raise XmhwException(
                            "Climatology doy axis does not cover the "
                            "timeseries doys")
                    doy_pos = torch.from_numpy(pos.astype(np.int64)).to(dev)
            elif removeMissing:
                raise XmhwException(
                    "To remove missing values you need to pass "
                    "the original temperature timeseries")
            if not period:
                raise XmhwException(
                    "As the original timeseries is not available, the"
                    " timeseries period as [start_year, end_year] has to"
                    " be passed")
            bins = np.arange(period[0], period[1] + blockLength + 1,
                             blockLength)
            nbins = len(bins) - 1
            edges = (day_block_edges(tyears, bins)
                     if gts is not None else None)

            K = gm.v.shape[0]
            T = gts.v.shape[0] if gts is not None else 0
            rows = stripe or _auto_stripe(max(T, K * 16), gm.grid_shape)
            if resume_state is not None:
                rows = int(resume_state["rows"])
            row_cells = int(np.prod(gm.grid_shape[1:],
                                    dtype=np.int64)) or 1

            dim_coords = {"years": (bins[:-1].astype(np.int64),
                                    {"long_name": "start year of block",
                                     "block_length": blockLength})}
            for d in gm.grid_dims:
                dim_coords[d] = gm.coord(d)
            w = (_Writer.open_append(out_path)
                 if resume_state is not None else
                 _Writer(out_path, dim_coords, global_attrs={
                     "source": "xmhw_tpu_torch stream_block_average"}))
            evr = {v: GridReader(mhw_path, v) for v in EVENT_VARS}
            out_names = [n for n, _, _ in EVENT_AGGS]
            if gts is not None:
                out_names += ["ts_mean", "ts_max", "ts_min"]
                if gth is not None:
                    out_names += ["moderate_days", "strong_days",
                                  "severe_days", "extreme_days",
                                  "total_days"]
            out_vars = {n: w.create(n, ("years", *gm.grid_dims), "f8",
                                    compress=compress)
                        for n in out_names}
            buf = alloc_filled((nbins, rows * row_cells), np.nan,
                               np.float64)

            def _fetch(lo, hi):
                t0 = gm.read(lo, hi)
                vals = np.stack([evr[v].read(lo, hi)
                                 for v in EVENT_VARS]).astype(np.float64)
                comp2 = keep2 = th_p = se_p = None
                if gts is not None:
                    # land-compact before the (T, cells) upload (the
                    # dominant transfer)
                    ts_np = gts.read(lo, hi)
                    comp2, keep2 = _compact_ocean(ts_np)
                    comp2 = comp2.astype(np.float64)
                    if gth is not None:
                        th_p = gth.read(lo, hi)[:, keep2].astype(np.float64)
                        se_p = gse.read(lo, hi)[:, keep2].astype(np.float64)
                return t0, vals, comp2, keep2, th_p, se_p

            bedges = [(lo, min(lo + rows, gm.grid_shape[0]))
                      for lo in range(0, gm.grid_shape[0], rows)]
            bedges = _filter_resumed(bedges, resume_state)
            wb = _WriteBehind()
            for lo, hi, fetched in _prefetched(bedges, _fetch):
                t0, vals, comp2, keep2, th_p, se_p = fetched
                c_str = (hi - lo) * row_cells
                res = {}
                # ---- event-table half --------------------------------
                ev_years, ev_valid = _years_of_cf(t0, tattrs)
                bin_idx = np.searchsorted(bins, ev_years,
                                          side="right") - 1
                in_range = (bin_idx >= 0) & (bin_idx < nbins)
                bin_idx = np.clip(bin_idx, 0, nbins - 1)
                # ---- both halves on the device, one download ---------
                ev, day = _block_stats_step(
                    vals, bin_idx, ev_valid & in_range, nbins, dev,
                    comp2, th_p, se_p, doy_pos, edges, removeMissing)
                res.update(ev)
                nan_days = None
                if day is not None:
                    nan_days = (day.pop("nan_days")
                                if removeMissing else None)

                def _write(lo=lo, hi=hi, c_str=c_str, keep2=keep2,
                           res=res, day=day, nan_days=nan_days):
                    if day is not None:
                        # scatter compacted results back to stripe
                        # width: land cells get NaN means and ZERO day
                        # counts, matching the in-memory device path on
                        # full grids
                        for k, v in day.items():
                            fill = (0.0 if k.endswith("_days")
                                    else np.nan)
                            full_v = np.full((nbins, c_str), fill)
                            full_v[:, keep2] = v[:, :keep2.size]
                            res[k] = full_v
                        if nan_days is not None:
                            mask = np.ones((nbins, c_str), bool)
                            mask[:, keep2] = nan_days[:, :keep2.size] > 0
                            for k in list(res):
                                res[k] = np.where(mask, np.nan, res[k])
                    for name in out_names:
                        view = buf[:, :c_str]
                        view[...] = res[name]
                        out_vars[name][:, lo:hi] = view.reshape(
                            nbins, hi - lo, *gm.grid_shape[1:])
                    _mark_resume(w, hi, rows, sig=resume_sig)

                wb.submit(_write)
            wb.finish()
            for r in evr.values():
                r.close()
            w.h.attrs.pop("xmhw_resume", None)  # run is complete
            w.close()
        finally:
            for r in (gts, gth, gse):
                if r is not None:
                    r.close()
    return out_path


def _years_of_cf(vals, attrs):
    """Years + validity of CF-encoded (or datetime64) event times."""
    from .stats_api import _years_of

    return _years_of(vals, attrs)


def _record_nyears(t0, t1, attrs):
    """Record length in years from CF-encoded time_start/time_end,
    matching mhw_rank's derivation exactly (day span / 365.25 for
    datetime-family calendars, integer year span for synthetic)."""
    from .xrlite.timeutils import normalize_calendar, parse_cf_units

    units = str(attrs.get("units", ""))
    cal = normalize_calendar(str(attrs.get("calendar", "standard")))
    v0 = np.isfinite(np.asarray(t0, np.float64))
    v1 = np.isfinite(np.asarray(t1, np.float64))
    if not (v0.any() and v1.any()):
        return 14245 / 365.25  # reference fallback (stats.py:477-478)
    if cal in ("standard", "gregorian", "proleptic_gregorian", "") \
            and "since" in units:
        step_s, _ = parse_cf_units(units)
        span_days = float(np.asarray(t1)[v1].max()
                          - np.asarray(t0)[v0].min()) * step_s / 86400.0
        return span_days / 365.25
    y0, w0 = _years_of_cf(np.asarray(t0), attrs)
    y1, w1 = _years_of_cf(np.asarray(t1), attrs)
    return float(y1[w1].max() - y0[w0].min() + 1)


def _block_stats_step(vals, bin_idx, valid, nbins, dev, ts=None, th=None,
                      se=None, doy_pos=None, edges=None, count_nans=False):
    """One stripe of stream_block_average on ``dev``: the year-block
    aggregations of the (NV, K, cells) float64 event tables ``vals``
    (``bin_idx``/``valid``: (K, cells) host arrays), in float64 there
    too; with ``ts`` ((T, cells) float64) the per-day statistics, and
    with ``th``/``se`` ((ndoy, cells)) and ``doy_pos`` ((T,) long tensor
    on ``dev``) the category days (ops/block_stats.py, by
    ``use_kernels_for``: float64 takes the plain versions). One upload
    per array and ONE download. Returns
    (event stats, day stats or None), numpy dicts of (nbins, cells)."""
    from .core.pipeline import fetch_rows, use_kernels_for
    from .ops.block_stats import bins_for

    def up(a):
        return None if a is None else torch.from_numpy(a).to(dev)

    key = np.where(valid, bin_idx, -1).astype(np.int32)
    event_bins, _ = bins_for(use_kernels_for(vals.dtype, dev))
    parts = {("ev", k): v
             for k, v in event_bins(up(vals), up(key), nbins).items()}
    if ts is not None:
        _, day_bins = bins_for(use_kernels_for(ts.dtype, dev))
        parts.update({("day", k): v for k, v in day_bins(
            up(ts), edges, up(th), up(se), doy_pos,
            count_nans=count_nans).items()})
    got = fetch_rows(parts)
    ev = {k: v for (h, k), v in got.items() if h == "ev"}
    day = ({k: v for (h, k), v in got.items() if h == "day"}
           if ts is not None else None)
    return ev, day


def _rank_stack(a):
    """Descending ranks of a (V, K, cells) tensor along its event axis,
    each (variable, cell) column on its own, in ONE call: the stack is
    ranked as one (K, V * cells) table (core/stats.rank_events_desc)."""
    from .core.stats import rank_events_desc

    V, K = a.shape[:2]
    flat = a.permute(1, 0, 2).reshape(K, -1)
    r = rank_events_desc(flat, torch.ones_like(flat, dtype=torch.bool))
    return r.reshape(K, V, -1).permute(1, 0, 2)


def stream_rank(
    mhw_path,
    rank_path,
    return_path=None,
    nYears=None,
    stripe=None,
    compress=None,
    resume=False,
    device="cuda",
):
    """mhw_rank() streamed file-to-file (reference: stats.py:446-490).

    Reads a stream_detect output (compact or union layout), ranks every
    event property per cell on device (core/stats.rank_events_desc —
    identical tie semantics to the reference's double argsort) and
    writes the ranks to ``rank_path`` and the return periods
    ``(nYears+1)/rank`` to ``return_path`` (default: rank_path with a
    ``_return`` suffix). ``nYears`` defaults to the record span derived
    from time_start/time_end like :func:`xmhw_tpu_torch.mhw_rank`.
    ``device``: where the ranks are computed (default ``"cuda"``).
    Returns (rank_path, return_path).
    """
    import h5py

    dev = resolve_device(device)
    tune_malloc()
    if return_path is None:
        return_path = (rank_path[:-3] + "_return.nc"
                       if rank_path.endswith(".nc")
                       else rank_path + "_return.nc")
    with h5py.File(mhw_path, "r") as f:
        gm = GridReader(mhw_path, "time_start")
        resume_sig = _resume_sig(
            fn="stream_rank", mhw_path=os.path.abspath(mhw_path),
            grid_shape=list(gm.grid_shape), nYears=nYears,
            return_path=return_path, compress=compress)
        resume_state = (_load_resume(rank_path, resume_sig)
                        if resume else None)
        ev_dim = gm.dims[0]
        variables = [
            k for k in f.keys()
            if isinstance(f[k], h5py.Dataset)
            and f[k].ndim == gm.v.ndim and f[k].shape == gm.v.shape
            and not any(x in k for x in ("event", "time", "index"))
            and k not in gm.grid_dims and k != ev_dim
        ]
        if nYears is None:
            tattrs = {k: (v.decode() if isinstance(v, bytes) else v)
                      for k, v in gm.attrs.items()}
            g1 = GridReader(mhw_path, "time_end")
            nYears = _record_nyears(gm.v[()], g1.v[()], tattrs)
            g1.close()
        dim_coords = {ev_dim: gm.coord(ev_dim)}
        for d in gm.grid_dims:
            dim_coords[d] = gm.coord(d)
        K = gm.v.shape[0]
        # stripe sized for the STACKED (V, K, cells) device block
        rows = stripe or _auto_stripe(
            max(K * len(variables), 1), gm.grid_shape, budget=2 ** 29)
        if resume_state is not None:
            rows = int(resume_state["rows"])
        row_cells = int(np.prod(gm.grid_shape[1:], dtype=np.int64)) or 1
        if resume_state is not None:
            wr = _Writer.open_append(rank_path)
            wp = _Writer.open_append(return_path)
        else:
            wr = _Writer(rank_path, dim_coords, global_attrs={
                "source": "xmhw_tpu_torch stream_rank", "nYears": nYears})
            wp = _Writer(return_path, dim_coords, global_attrs={
                "source": "xmhw_tpu_torch stream_rank return periods",
                "nYears": nYears})
        # f4 storage: ranks are small integers and return periods small
        # ratios — exactly/adequately representable, half the file size
        # (the in-memory API returns float64; files are the streamed
        # contract)
        rvars = {v: wr.create(v, (ev_dim, *gm.grid_dims), "f4",
                              compress=compress)
                 for v in variables}
        pvars = {v: wp.create(v, (ev_dim, *gm.grid_dims), "f4",
                              compress=compress)
                 for v in variables}
        # all variables ride ONE (V, K, cells) upload + ONE rank call +
        # ONE fetch per stripe (_rank_stack)
        def _fetch(lo, hi):
            return np.stack([
                np.asarray(f[v][(slice(None), slice(lo, hi))],
                           np.float64).reshape(K, -1)
                for v in variables])

        redges = [(lo, min(lo + rows, gm.grid_shape[0]))
                  for lo in range(0, gm.grid_shape[0], rows)]
        redges = _filter_resumed(redges, resume_state)
        wb = _WriteBehind()
        for lo, hi, blk in _prefetched(redges, _fetch):
            r_all = _rank_stack(torch.from_numpy(blk).to(dev)).cpu().numpy()

            def _write(lo=lo, hi=hi, r_all=r_all):
                shape = (K, hi - lo, *gm.grid_shape[1:])
                for i, v in enumerate(variables):
                    r = r_all[i]
                    rvars[v][:, lo:hi] = r.reshape(shape)
                    pvars[v][:, lo:hi] = (
                        (nYears + 1) / r).reshape(shape)
                wp.h.flush()
                _mark_resume(wr, hi, rows, sig=resume_sig)

            wb.submit(_write)
        wb.finish()
        wr.h.attrs.pop("xmhw_resume", None)  # run is complete
        wr.close()
        wp.close()
        gm.close()
    return rank_path, return_path


def stream_run(
    ts_path,
    var,
    clim_path,
    mhw_path,
    block_path=None,
    rank_path=None,
    return_path=None,
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
    minDuration=5,
    joinGaps=True,
    maxGap=2,
    blockLength=1,
    removeMissing=False,
    stripe=None,
    cell_block=None,
    mesh=None,
    events_layout="compact",
    dtype=np.float32,
    reference_quirks=False,
    compress=None,
    resume=False,
    grid_rows=None,
    device="cuda",
):
    """The SINGLE-PASS planet-scale pipeline: climatology + detection +
    year-block statistics + event ranks, file-to-file, reading and
    uploading every grid stripe exactly ONCE.

    ``grid_rows=(lo, hi)``: process only this band of leading grid rows
    (a deployment over several GPUs or hosts gives each process its own
    latitude band). Output files keep the FULL grid
    shape with unprocessed rows left at the fill value, so N band files
    merge by copying each band (:func:`merge_grid_band_files`).
    Requires ``events_layout='compact'``. For bit-reproducibility
    against a single-process run, align band edges to ``stripe``
    multiples (misaligned bands change the per-stripe ocean-cell
    compaction, hence the cell blocks, and a plain torch reduction may
    sum float32 in another order for another shape). Note:
    ``rank_path`` under a band uses the band-local event record span
    for nYears — multi-host runs should pass ``rank_path=None`` and
    derive ranks from the MERGED mhw file with :func:`stream_rank`
    (nYears is a record-span global).

    ``resume=True`` picks up an interrupted run (compact layout only):
    the write-behind slot writes stripes strictly in order and records
    a progress watermark on the climatology file as the LAST step of
    each stripe's write job, so a killed run leaves a clean prefix of
    fully-written stripes. The resumed call skips them (no read, no
    device step), restores the event-capacity/record-span state, and
    continues; a completed run clears the watermark, making a stale
    ``resume=True`` a normal fresh run. The reference has no in-library
    checkpointing — its documented recovery is rerunning the staged
    workflow per manual grid block (reference: docs/dask.rst:44-86).

    The reference's documented workflow stages threshold -> detect ->
    block_average -> mhw_rank through intermediate NetCDF files
    (reference: docs/gettingstarted.rst:158-188, docs/dask.rst:44-86),
    which re-reads — and on an accelerator re-uploads — the same SST
    series at every stage. This function collapses it: each stripe's
    series is shipped to the device once and the whole
    stack (core.pipeline.run_fused) runs on device-resident data; only
    compact results come back. The staged functions
    (:func:`stream_threshold` ... :func:`stream_rank`) remain available
    and produce identical files — tests assert it.

    Outputs: ``clim_path`` (thresh/seas), ``mhw_path`` (event tables;
    ``events_layout`` as in :func:`stream_detect`), and optionally
    ``block_path`` (block_average with per-day ts/category stats) and
    ``rank_path``/``return_path`` (mhw_rank ranks + return periods).
    ``device``: where the fused pass runs (default ``"cuda"``).
    Returns a dict of the written paths.
    """
    dev = mesh_device(mesh, device)
    tune_malloc()
    if smoothPercentileWidth % 2 == 0:
        raise XmhwException("smoothPercentileWidth should be odd")
    if maxGap >= minDuration:
        raise XmhwException(
            "Maximum gap between mhw events should"
            + " be smaller than event minimum duration")
    if rank_path is not None and return_path is None:
        return_path = (rank_path[:-3] + "_return.nc"
                       if rank_path.endswith(".nc")
                       else rank_path + "_return.nc")

    from .core.features_scan import RANK_VARS
    from .core.pipeline import run_fused
    from .core.stats import EVENT_AGGS, day_block_edges

    with GridReader(ts_path, var, lead_dim=tdim) as g:
        tindex, _ = g.coord(tdim)
        if not isinstance(tindex, TimeIndex):
            raise XmhwException(f"{tdim} must be a CF time coordinate")
        if get_calendar(tindex) == 360.0:
            tstep = True
        doy, ndoy = compute_doy(tindex, keep_tstep=tstep)
        doy_pos = (doy - 1).astype(np.int32)
        T = len(doy)
        time_vals = tindex.values
        units = getattr(tindex, "encoding", {}).get("units")
        cal = getattr(tindex, "encoding", {}).get("calendar", "standard")
        years = np.asarray(tindex.year)

        t_sel = None
        doy_clim = doy
        if all(climatologyPeriod):
            idx = np.nonzero((years >= int(climatologyPeriod[0]))
                             & (years <= int(climatologyPeriod[1])))[0]
            t_sel = slice(int(idx[0]), int(idx[-1]) + 1)
            doy_clim, ndoy_c = compute_doy(
                TimeIndex(time_vals[t_sel]), keep_tstep=tstep)
            if ndoy_c != ndoy:
                raise XmhwException(
                    "climatologyPeriod subset has a different doy axis "
                    f"length ({ndoy_c}) than the full series ({ndoy})")
        clim_y0 = int(years[t_sel][0]) if t_sel else int(years[0])
        clim_y1 = int(years[t_sel][-1]) if t_sel else int(years[-1])

        with_stats = block_path is not None
        nbins = 0
        day_edges = None
        ybod = None
        if with_stats:
            bins = np.arange(int(years[0]), int(years[-1])
                             + blockLength + 1, blockLength)
            nbins = len(bins) - 1
            ybod = (np.searchsorted(bins, years, side="right")
                    - 1).astype(np.int32)
            ybod[(ybod < 0) | (ybod >= nbins)] = -1
            day_edges = day_block_edges(years, bins)
        rank_names = RANK_VARS if rank_path is not None else ()

        rows = stripe or _auto_stripe(T, g.grid_shape)
        row_cells = int(np.prod(g.grid_shape[1:], dtype=np.int64)) or 1

        # ---- resume: pick up an interrupted run's clean prefix ----------
        # the write-behind slot writes stripes strictly in order, so a
        # crashed run leaves every stripe below the recorded watermark
        # fully written; the watermark attr is the LAST thing each
        # stripe's write job sets
        resume_sig = _resume_sig(
            fn="stream_run", var=var,
            ts_path=os.path.abspath(ts_path),
            grid_shape=list(g.grid_shape),
            grid_rows=list(grid_rows) if grid_rows else None,
            mhw_path=mhw_path,
            block_path=block_path, rank_path=rank_path,
            return_path=return_path,
            climatologyPeriod=list(climatologyPeriod), pctile=pctile,
            windowHalfWidth=windowHalfWidth,
            smoothPercentile=smoothPercentile,
            smoothPercentileWidth=smoothPercentileWidth,
            maxPadLength=maxPadLength, coldSpells=coldSpells,
            tstep=tstep, anynans=anynans, skipna=skipna,
            minDuration=minDuration, joinGaps=joinGaps, maxGap=maxGap,
            blockLength=blockLength, removeMissing=removeMissing,
            events_layout=events_layout, dtype=np.dtype(dtype).str,
            reference_quirks=reference_quirks, compress=compress)
        resume_state = None
        if resume:
            if events_layout == "union":
                raise XmhwException(
                    "resume=True requires events_layout='compact' (the "
                    "union event axis needs every stripe in memory)")
            resume_state = _load_resume(clim_path, resume_sig)
        if resume_state is not None:
            rows = int(resume_state["rows"])  # keep stripe alignment

        # ---- incremental writers (clim + block) -------------------------
        u = g.attrs.get("units", "degree_C")
        if isinstance(u, bytes):
            u = u.decode("utf-8", "replace")
        u = str(u)
        dimc = {"doy": (np.arange(1, ndoy + 1), {})}
        for d in g.grid_dims:
            dimc[d] = g.coord(d)
        cw = (_Writer.open_append(clim_path)
              if resume_state is not None else
              _Writer(clim_path, dimc, global_attrs={
                  "xmhw_parameters": threshold_params_attr(
                      pctile, clim_y0, clim_y1, windowHalfWidth, skipna,
                      smoothPercentile, smoothPercentileWidth, anynans),
                  "source": "xmhw_tpu_torch stream_run"}))
        clim_vars = {
            "thresh": cw.create("thresh", ("doy", *g.grid_dims),
                                np.dtype(dtype).str,
                                {"long_name":
                                 f"{pctile}th percentile threshold",
                                 "units": u}, compress=compress),
            "seas": cw.create("seas", ("doy", *g.grid_dims),
                              np.dtype(dtype).str,
                              {"long_name": "climatological mean",
                               "units": u}, compress=compress),
        }
        bw = None
        if with_stats:
            bdimc = {"years": (bins[:-1].astype(np.int64),
                               {"long_name": "start year of block",
                                "block_length": blockLength})}
            for d in g.grid_dims:
                bdimc[d] = g.coord(d)
            bw = (_Writer.open_append(block_path)
                  if resume_state is not None and
                  os.path.exists(block_path) else
                  _Writer(block_path, bdimc, global_attrs={
                      "source": "xmhw_tpu_torch stream_run block_average"}))
            blk_names = [n for n, _, _ in EVENT_AGGS] + [
                "ts_mean", "ts_max", "ts_min", "moderate_days",
                "strong_days", "severe_days", "extreme_days",
                "total_days"]
            blk_vars = {n: bw.create(n, ("years", *g.grid_dims), "f8",
                                     compress=compress)
                        for n in blk_names}
            bbuf = alloc_filled((nbins, rows * row_cells), np.nan,
                                np.float64)
        cbuf = alloc_filled((ndoy, rows * row_cells), np.nan, dtype)

        def _attrs_of(name):
            attrs = {}
            if name in MHW_VAR_ATTRS:
                long_name, unit_t = MHW_VAR_ATTRS[name]
                attrs = {"long_name": long_name,
                         "units": str(unit_t).format(u=u)}
            if name in _TIME_LIKE and units:
                attrs.update(units=units, calendar=cal)
            return attrs

        mhw_attrs = {"xmhw_parameters": detect_params_attr(
            minDuration, joinGaps, maxGap, coldSpells, maxPadLength,
            anynans),
            "source": "xmhw_tpu_torch stream_run"}
        compact = events_layout != "union"
        # compact layout: tables/ranks stream to disk per stripe (host
        # memory O(stripe)); union layout accumulates for the phase-B
        # union scatter (its event axis needs every stripe first)
        tw = rw = None
        if compact:
            tw = _StreamTableWriter(mhw_path, g, time_vals, units, cal,
                                    mhw_attrs, rows, row_cells,
                                    attrs_of=_attrs_of,
                                    compress=compress,
                                    reopen=resume_state is not None)
            if rank_path is not None:
                rw = _StreamTableWriter(
                    rank_path, g, time_vals, units, cal,
                    {"source": "xmhw_tpu_torch stream_run ranks"},
                    rows, row_cells, dtype_of=lambda n, a: "f4",
                    compress=compress,
                    reopen=resume_state is not None)

        # ---- phase A: one fused pass per stripe -------------------------
        stripes = []        # (lo, hi, keep_det, tables, labels)
        rank_stripes = []   # (lo, hi, keep_det, ranks, labels)
        kmax = max(1, _kcache_get(resume_sig))  # skip the K re-walk
        label_union = []
        smin = emax = None  # event time extremes for nYears
        if resume_state is not None:
            kmax = max(kmax, int(resume_state["kmax"]))
            smin = resume_state["smin"]
            emax = resume_state["emax"]
        def _fetch(lo, hi):
            block = g.read(lo, hi).astype(dtype, copy=False)
            # detection drops any-NaN cells under ``anynans``, but the
            # per-day stats half keeps them (the staged block_average
            # land-checks the raw SST with the all-NaN rule): compact
            # with the all-NaN rule, run everything on that superset,
            # and mask detect-side outputs to the anynans-kept subset
            comp, keep_all = _compact_ocean(block, False)
            if anynans:
                det_in_all = ~np.isnan(comp).any(axis=0)
            else:
                det_in_all = np.ones(keep_all.size, bool)
            comp_i = comp
            ts_day = None
            if maxPadLength and keep_all.size:
                from .api import _interpolate_na

                comp_i = _interpolate_na(comp, maxPadLength, dev)
                ts_day = comp
            return comp_i, ts_day, keep_all, det_in_all

        band_lo, band_hi = 0, g.grid_shape[0]
        if grid_rows is not None:
            band_lo, band_hi = int(grid_rows[0]), int(grid_rows[1])
            if not (0 <= band_lo < band_hi <= g.grid_shape[0]):
                raise XmhwException(
                    f"grid_rows {grid_rows} outside the grid's "
                    f"{g.grid_shape[0]} leading rows")
            if events_layout == "union":
                raise XmhwException(
                    "grid_rows requires events_layout='compact' (the "
                    "union event axis needs the whole grid)")
        edges = [(lo, min(lo + rows, band_hi))
                 for lo in range(band_lo, band_hi, rows)]
        all_edges = list(edges)  # return-file read-back covers every stripe
        edges = _filter_resumed(edges, resume_state)

        def _progress(hi, kmax, smin, emax):
            # set LAST in each stripe's write job: stripes at or below
            # the watermark are guaranteed fully on disk (the device
            # step is ~90% of each cycle, so a kill rarely lands inside
            # an HDF5 update)
            if compact:
                for tab in (tw, rw):
                    if tab is not None and tab.w is not None:
                        tab.w.h.flush()
                if bw is not None:
                    bw.h.flush()
                _mark_resume(cw, hi, rows, kmax=int(kmax),
                             smin=smin, emax=emax, sig=resume_sig)

        wb = _WriteBehind()
        for lo, hi, fetched in _prefetched(edges, _fetch):
            comp_i, ts_day, keep_all, det_in_all = fetched
            c_str = (hi - lo) * row_cells
            keep_det = keep_all[det_in_all]
            if keep_all.size == 0:
                if not compact:
                    stripes.append((lo, hi, keep_det, {}, None))
                    if rank_path is not None:
                        rank_stripes.append((lo, hi, keep_det, {}, None))

                def _wempty(lo=lo, hi=hi, c_str=c_str, kmax=kmax,
                            smin=smin, emax=emax):
                    for name, node in clim_vars.items():
                        view = cbuf[:, :c_str]
                        view.fill(np.nan)
                        node[:, lo:hi] = view.reshape(
                            ndoy, hi - lo, *g.grid_shape[1:])
                    if with_stats:
                        for name in blk_names:
                            view = bbuf[:, :c_str]
                            view.fill(
                                0.0 if name in ("ecount", "total_icum")
                                or name.endswith("_days") else np.nan)
                            if removeMissing:
                                view.fill(np.nan)
                            blk_vars[name][:, lo:hi] = view.reshape(
                                nbins, hi - lo, *g.grid_shape[1:])
                    _progress(hi, kmax, smin, emax)

                wb.submit(_wempty)
                continue
            ts_clim = comp_i[t_sel] if t_sel is not None else None
            th, se, tables, nev, extras = run_fused(
                comp_i, doy, doy_pos, w=windowHalfWidth, ndoy=ndoy,
                pctile=pctile, smooth=smoothPercentile,
                smooth_w=smoothPercentileWidth, patch_feb29=not tstep,
                min_duration=minDuration, join_gaps=joinGaps,
                max_gap=maxGap, day0_fillna_quirk=reference_quirks,
                cold_spells=coldSpells, ts_clim_np=ts_clim,
                doy_clim_np=doy_clim if t_sel is not None else None,
                ts_day_np=ts_day, ybod_np=ybod, nbins=nbins,
                day_edges=day_edges, count_nans=removeMissing,
                # ranks are computed HOST-side below from the fetched
                # tables (identical double-argsort semantics), on the
                # write-behind thread: the device rank output would be
                # 24 x K x cells of extra D2H per block
                rank_names=(),
                det_mask_np=det_in_all if anynans else None,
                block=cell_block, mesh=mesh,
                # first stripe: let the counting pass set K exactly
                # (k_min=1 would start at K=32 and pay an overflow
                # retry); later stripes reuse the stable K
                k_min=kmax if kmax > 1 else None, device=dev)
            if coldSpells:
                # flip_cold on the host tables (device stats/ranks were
                # flipped inside the kernel; reference:
                # xmhw/features.py:298-315)
                for k in tables:
                    if "intensity" in k and "_var" not in k:
                        tables[k] = -tables[k]
            tables = {k: v[:, det_in_all] for k, v in tables.items()}
            labels = tables["event"]
            kmax = max(kmax, labels.shape[0])
            if not compact:
                from .stats_api import rank_variable

                fin = np.isfinite(labels)
                if fin.any():
                    label_union.append(np.unique(labels[fin]))
                stripes.append((lo, hi, keep_det, tables, labels))
                if rank_path is not None:
                    # host ranking of the (already flipped+masked)
                    # tables; rank_variable matches
                    # core/stats.rank_events_desc's tie semantics
                    # exactly (both tested vs the reference)
                    ranks = {k: rank_variable(tables[k], axis=0)
                             for k in rank_names}
                    rank_stripes.append((lo, hi, keep_det, ranks,
                                         labels))
            ts_det = tables["time_start"]
            te_det = tables["time_end"]
            vmask = ts_det >= 0
            if vmask.any():
                s0 = int(ts_det[vmask].min())
                e1 = int(te_det[vmask].max())
                smin = s0 if smin is None else min(smin, s0)
                emax = e1 if emax is None else max(emax, e1)

            def _wstripe(lo=lo, hi=hi, c_str=c_str, keep_all=keep_all,
                         keep_det=keep_det, det_in_all=det_in_all,
                         tables=tables, th=th, se=se, extras=extras,
                         kmax=kmax, smin=smin, emax=emax):
                if compact:
                    tw.write(lo, hi, keep_det, tables)
                    if rw is not None:
                        from .stats_api import rank_variable

                        # host ranking (double argsort, ~2 s/stripe at
                        # planet scale) rides the write-behind thread —
                        # hidden behind the next stripe's device step
                        ranks = {k: rank_variable(tables[k], axis=0)
                                 for k in rank_names}
                        rw.write(lo, hi, keep_det, ranks)
                # clim: written at the anynans-kept cells only (parity
                # with stream_threshold's compaction)
                for name, vals in (("thresh", th), ("seas", se)):
                    view = cbuf[:, :c_str]
                    view.fill(np.nan)
                    view[:, keep_det] = vals[:, det_in_all]
                    clim_vars[name][:, lo:hi] = view.reshape(
                        ndoy, hi - lo, *g.grid_shape[1:])
                if with_stats:
                    day = extras["day"]
                    blk = extras["block"]
                    nan_days = (np.asarray(day["nan_days"])
                                if removeMissing else None)
                    for name in blk_names:
                        view = bbuf[:, :c_str]
                        if name in day:
                            view.fill(0.0 if name.endswith("_days")
                                      else np.nan)
                            view[:, keep_all] = day[name]
                        else:
                            # empty-bin/land semantics of the event
                            # half: counts and sums are 0, means/maxes
                            # NaN
                            view.fill(
                                0.0 if name in ("ecount", "total_icum")
                                else np.nan)
                            view[:, keep_det] = blk[name][:, det_in_all]
                        if removeMissing:
                            mask = np.ones((nbins, c_str), bool)
                            mask[:, keep_all] = nan_days > 0
                            view[mask] = np.nan
                        blk_vars[name][:, lo:hi] = view.reshape(
                            nbins, hi - lo, *g.grid_shape[1:])
                _progress(hi, kmax, smin, emax)

            wb.submit(_wstripe)
        wb.finish()
        _kcache_put(resume_sig, kmax)  # re-runs start at the final K
        cw.close()
        if bw is not None:
            bw.close()

        # ---- phase B: event-table files ---------------------------------
        # nYears exactly as stream_rank derives it from the written mhw
        # file (record span; reference: stats.py:477-478)
        if smin is None:
            nYears = 14245 / 365.25
        else:
            idx = np.array([[smin], [emax]], np.int64)
            enc = _encode_times(idx, time_vals, units, cal)
            tattrs = ({"units": units, "calendar": cal}
                      if units else {})
            nYears = _record_nyears(enc[0], enc[1], tattrs)
        out = {"clim": clim_path, "mhw": mhw_path}
        if with_stats:
            out["block"] = block_path

        if compact:
            # tables/ranks already on disk (streamed per stripe); a
            # resumed run whose remaining stripes were all land still
            # has them from the interrupted run
            if tw.w is None and resume_state is not None:
                tw.open_if_exists()
            if tw.w is None:
                raise XmhwException(
                    "All points of grid are either land or NaN")
            tw.close()
            if rw is not None:
                if rw.w is None and resume_state is not None:
                    rw.open_if_exists()
                # nYears is a record-span global, only known now
                rw.w.h.attrs["nYears"] = nYears
                rw.close()
                _write_return_file(
                    return_path, rank_path, rank_names, g, nYears,
                    all_edges, compress)
                out["rank"] = rank_path
                out["return"] = return_path
            import h5py

            with h5py.File(clim_path, "r+") as f:
                f.attrs.pop("xmhw_resume", None)  # run is complete
            return out

        union = (np.unique(np.concatenate(label_union))
                 .astype(np.int64) if label_union
                 else np.zeros(0, np.int64))
        ev_dim, ev_vals = "events", union
        some = next((s for s in stripes if s[3]), None)
        if some is None:
            raise XmhwException("All points of grid are either land or NaN")
        names = list(some[3].keys())

        _write_table_file(
            mhw_path, stripes, names, g, ev_dim, ev_vals, union,
            time_vals, units, cal, mhw_attrs,
            rows, row_cells, attrs_of=_attrs_of, compress=compress)
        if rank_path is not None:
            _write_table_file(
                rank_path, rank_stripes, list(rank_names), g, ev_dim,
                ev_vals, union, time_vals, units, cal,
                {"source": "xmhw_tpu_torch stream_run ranks",
                 "nYears": nYears},
                rows, row_cells, dtype_of=lambda n, a: "f4",
                compress=compress)
            ret_stripes = [
                (lo, hi, keep, {k: (nYears + 1) / v
                                for k, v in tabs.items()}, lab)
                for lo, hi, keep, tabs, lab in rank_stripes]
            _write_table_file(
                return_path, ret_stripes, list(rank_names), g, ev_dim,
                ev_vals, union, time_vals, units, cal,
                {"source": "xmhw_tpu_torch stream_run return periods",
                 "nYears": nYears},
                rows, row_cells, dtype_of=lambda n, a: "f4",
                compress=compress)
            out["rank"] = rank_path
            out["return"] = return_path
    return out


def merge_grid_band_files(parts, out_path, band_dim):
    """Merge N band outputs of ``stream_run(grid_rows=...)`` into one
    full-grid file (the multi-host assembly step; each process runs its
    own latitude band — tools/multihost_stream.py).

    ``parts``: iterable of ``(path, lo, hi)`` — full-grid-shape files
    whose rows [lo, hi) of ``band_dim`` were processed (other rows are
    at the fill value). Event-axis ("ev") lengths may differ between
    bands (K grows with the densest cell seen); the merged axis is the
    maximum, shorter bands padding with the HDF5 fillvalue — exactly
    run_fused's grown-table semantics, so the merged file is
    byte-identical to a single-process run. Returns ``out_path``.
    """
    import shutil

    import h5py

    parts = sorted(((p, int(lo), int(hi)) for p, lo, hi in parts),
                   key=lambda x: x[1])
    shutil.copyfile(parts[0][0], out_path)

    def _is_scale(node):
        try:
            return node.is_scale
        except AttributeError:  # older h5py
            return h5py.h5ds.is_scale(node.id)

    def _axis_of(node, dim):
        for i in range(node.ndim):
            for k in range(len(node.dims[i])):
                sc = node.dims[i][k]
                if sc.name.rsplit("/", 1)[-1] == dim:
                    return i
        return None

    with h5py.File(out_path, "r+") as out:
        for path, lo, hi in parts[1:]:
            with h5py.File(path, "r") as src:
                if ("ev" in out and "ev" in src
                        and src["ev"].shape[0] > out["ev"].shape[0]):
                    E = src["ev"].shape[0]
                    for name, node in out.items():
                        if (not isinstance(node, h5py.Dataset)
                                or _is_scale(node)):
                            continue
                        ax = _axis_of(node, "ev")
                        if ax is not None and node.maxshape[ax] is None:
                            sh = list(node.shape)
                            sh[ax] = E
                            node.resize(sh)
                    out["ev"].resize((E,))
                    out["ev"][...] = np.arange(E)
                for name, node in src.items():
                    if (not isinstance(node, h5py.Dataset)
                            or _is_scale(node)):
                        continue
                    ax = _axis_of(node, band_dim)
                    if ax is None:
                        continue
                    sel = [slice(None)] * node.ndim
                    sel[ax] = slice(lo, hi)
                    # shorter ev axes write only the source's rows; the
                    # resize fill already padded the rest
                    osel = [slice(0, s) for s in node.shape]
                    osel[ax] = slice(lo, hi)
                    out[name][tuple(osel)] = node[tuple(sel)]
    return out_path


def _write_return_file(return_path, rank_path, rank_names, g, nYears,
                       edges, compress):
    """Return periods (nYears+1)/rank, derived by reading the written
    rank file back stripe-by-stripe (nYears is a record-span global, so
    return values cannot stream during phase A; ranks are exact small
    integers, so f4 storage loses nothing and the f8 division
    reproduces the in-memory computation bit-for-bit)."""
    import h5py

    kmax_w = None
    with h5py.File(rank_path, "r") as rf:
        kmax_w = rf["ev"].shape[0]
        dim_coords = {"ev": (np.arange(kmax_w), {})}
        for d in g.grid_dims:
            dim_coords[d] = g.coord(d)
        retw = _Writer(return_path, dim_coords, global_attrs={
            "source": "xmhw_tpu_torch stream_run return periods",
            "nYears": nYears})
        ret_vars = {name: retw.create(
            name, ("ev", *g.grid_dims), "f4",
            chunks=(max(1, min(kmax_w, 4096)), 1, *g.grid_shape[1:]),
            compress=compress) for name in rank_names}
        for lo, hi in edges:
            for name in rank_names:
                v = rf[name][:, lo:hi].astype(np.float64)
                ret_vars[name][:, lo:hi] = (
                    (nYears + 1) / v).astype(np.float32)
        retw.close()


def _make_inter_writer(inter_path, tindex, g, tdim, inter):
    """Writer + variables for the per-day intermediate file."""
    dim_coords = {tdim: (tindex, dict(getattr(tindex, "attrs", {})))}
    for d in g.grid_dims:
        dim_coords[d] = g.coord(d)
    iw = _Writer(inter_path, dim_coords, global_attrs={
        "source": "xmhw_tpu_torch stream_detect intermediate"})
    inter_vars = {}
    for name, arr in inter.items():
        if arr.dtype == bool:
            inter_vars[name] = iw.create(
                name, (tdim, *g.grid_dims), "i1",
                {"dtype_note": "boolean stored as int8"}, fill=0)
        else:
            inter_vars[name] = iw.create(
                name, (tdim, *g.grid_dims), np.dtype(arr.dtype).str)
    return iw, inter_vars


def _write_inter_stripe(inter_vars, inter, lo, hi, keep, g, row_cells, T):
    c_str = (hi - lo) * row_cells
    for name, arr in inter.items():
        if arr.dtype == bool:
            full = np.zeros((T, c_str), np.int8)
            full[:, keep] = arr
        else:
            full = np.full((T, c_str), np.nan, arr.dtype)
            full[:, keep] = arr
        inter_vars[name][:, lo:hi] = full.reshape(
            T, hi - lo, *g.grid_shape[1:])
