"""Host <-> device orchestration: cell blocks, the cell mesh, K selection,
downloads.

Port of :mod:`xmhw_tpu.core.pipeline`. Cells are processed in fixed-size
blocks, and each block is split over the devices of a cell mesh
(:mod:`xmhw_tpu_torch.parallel.mesh`; one device is a mesh of one). Each
shard is uploaded once and stays on its device through every stage; each
stage is issued on every shard before the host waits for any of them, and
the host waits once per stage (the count that fixes K, the overflow check,
the downloads). Each shard's results come back in one copy per dtype
(:func:`fetch_rows`) into its cell range. The event capacity K is one
value per block, the maximum over its shards, as in the JAX package's
sharded block, so a mesh run gives the single-device run's tables.

float32 on the GPU runs the three CUDA kernels (clim percentile, event
RLE, event scan); float64, or ``use_kernels=False``, runs the plain torch
code. The stats stage of :func:`run_fused` (:func:`fused_stats`) takes
the two year-bin kernels of ``ops/block_stats.py`` by the same rule and
override. CPU tensors always take the plain versions.

Each block function and each of its host stages runs in an ``xmhw/``
span (:func:`xmhw_tpu_torch.utils.span`: ``run_clim``, ``run_detect``,
``run_fused``, ``fused_threshold_detect``, ``clim_tables``,
``upload``, ``count_k``, ``detect_retry``, ``fused_stats``,
``fetch_rows``, ``store``, ``inter_store``), so a profiler's trace
names the host work under each idle stretch of the device; the counters
``h2d_bytes``, ``d2h_bytes``, ``h2d_ns``, ``d2h_ns``, ``detect_passes``,
``detect_blocks``, ``inter_calls`` and ``inter_bytes``
(:func:`xmhw_tpu_torch.utils.counts`) count the copies and their host
wall, the passes and the intermediate outputs (``inter_bytes`` those
fetched here; the API counts the grids it lands where it keeps them on
the card).

The block functions read data that one process holds whole. Across
processes (a global mesh, ``parallel.mesh``) each rank runs
:func:`fused_threshold_detect` on its own device-resident shards.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.doy_quantile import doy_quantile
from ..parallel.mesh import (CellMesh, cell_mesh, cell_sharding, check_mesh,
                             in_process_group, process_device, replicated)
from ..utils import copy_wall, count, in_span
from .clim import clim_kernel, finish_clim
from .features_scan import count_events, detect_kernel

# Cells per block on each device. A fixed 4,096: the size the TPU
# benchmark times and the production block width. At T = 14,610 days a
# float32 block is ~240 MB, and the largest temporaries (the plain clim
# pool, ~2.6 GB) fit an 80 GB card many times over.
DEFAULT_BLOCK = 4096


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises for a CUDA device when no GPU
    is available (there is no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain torch code")
    return dev


def mesh_device(mesh, device) -> torch.device:
    """The device of a run's work outside the cell blocks: the first
    entry of an explicit ``mesh`` (``device`` is then not read), else
    :func:`resolve_device` of ``device``. Raises TypeError for a ``mesh``
    that is neither None nor a cell mesh."""
    if check_mesh(mesh) is not None:
        return mesh[0]
    return resolve_device(device)


def resolve_mesh(mesh, use_mesh, device) -> CellMesh:
    """The devices a run splits its cell blocks over. An explicit ``mesh``
    is used as given (``device`` is then not read); one with entries of
    other ranks raises ValueError (:func:`parallel.mesh.check_mesh`).
    Otherwise, with ``use_mesh``, every visible GPU when ``device`` is the
    un-indexed ``"cuda"`` and more than one is visible (the JAX package's
    rule, ``xmhw_tpu/core/pipeline.py:49-50``), but only this process's
    GPU (:func:`parallel.mesh.process_device`) inside an initialised
    torch.distributed group, so that ranks do not each span every card;
    else the one device ``device`` names (``"cuda:1"`` or ``"cpu"``: one
    device)."""
    if check_mesh(mesh) is not None:
        return mesh
    dev = resolve_device(device)
    if (use_mesh and dev.type == "cuda" and dev.index is None
            and torch.cuda.device_count() > 1):
        return (CellMesh((process_device(),)) if in_process_group()
                else cell_mesh())
    return CellMesh((dev,))


def use_kernels_for(dtype, dev, override=None) -> bool:
    """The JAX package's dtype rule: kernels for float32 on the
    accelerator, plain code otherwise, unless overridden."""
    if override is not None:
        return bool(override)
    f32 = (dtype == torch.float32 if isinstance(dtype, torch.dtype)
           else np.dtype(dtype) == np.float32)
    return f32 and dev.type == "cuda"


def _block_size(n_cells, block, n_dev=1):
    """Cells per step: ``block`` over the whole mesh, or DEFAULT_BLOCK on
    each of its ``n_dev`` entries."""
    return max(1, min(block or DEFAULT_BLOCK * n_dev, n_cells))


def _max_over(vals) -> int:
    """The maximum over the shards' (C_i,) int tensors, with one host
    wait: each shard's maximum is taken on its device, the maxima are
    gathered on the first shard's device and read once."""
    ms = [v.max() if v.numel() else
          torch.zeros((), dtype=v.dtype, device=v.device) for v in vals]
    home = ms[0].device
    return int(torch.stack([m.to(home) for m in ms]).max())


@in_span("upload")
def upload(arr_np, lo, hi, dev, pad_rows=0):
    """Cells [lo, hi) of a (T, C) host array as a (T + pad_rows, hi-lo)
    device tensor, the pad rows NaN. Counts the cells' bytes in
    ``h2d_bytes`` and the host wall of the copy in ``h2d_ns``."""
    blk = np.ascontiguousarray(arr_np[..., lo:hi])
    count("h2d_bytes", blk.nbytes)
    src = torch.from_numpy(blk)
    if not pad_rows:
        with copy_wall("h2d_ns", dev):
            return src.to(dev)
    out = torch.empty((blk.shape[0] + pad_rows,) + blk.shape[1:],
                      dtype=src.dtype, device=dev)
    with copy_wall("h2d_ns", dev):
        out[:blk.shape[0]].copy_(src)
    out[blk.shape[0]:] = float("nan")
    return out


@in_span("fetch_rows")
def fetch_rows(d):
    """Download a dict of device tensors with ONE device-to-host copy per
    dtype (flattened and concatenated on the device first). Returns
    numpy arrays of the original shapes. Counts the bytes in
    ``d2h_bytes`` and the host wall of the copies in ``d2h_ns``."""
    groups = {}
    for k, v in d.items():
        groups.setdefault(v.dtype, []).append(k)
    out = {}
    for ks in groups.values():
        flat = torch.cat([d[k].reshape(-1) for k in ks])
        with copy_wall("d2h_ns", flat.device):
            flat = flat.cpu().numpy()
        count("d2h_bytes", flat.nbytes)
        lo = 0
        for k in ks:
            n = d[k].numel()
            out[k] = flat[lo:lo + n].reshape(tuple(d[k].shape))
            lo += n
    return out


def _round_k(k: int) -> int:
    """Round event capacity up (32, then powers of two)."""
    k = max(k, 1)
    if k <= 32:
        return 32
    return 1 << (k - 1).bit_length()


def _fill_of(v):
    return -1 if np.issubdtype(v.dtype, np.integer) else np.nan


@in_span("clim_tables")
def _clim_tables(doy_np, w, ndoy, kernels, mesh):
    """Range tables for the kernel, or the gather table for the plain
    path, one copy per device of the mesh: (kernels, rmax, {device:
    tables}). Sub-daily data with duplicate (doy, year) centres cannot use
    the range form and goes to the gather path (a choice made by the
    data, as in the JAX package)."""
    from .calendar import build_window_index, build_window_ranges

    if kernels:
        try:
            starts, lens, ny, rmax = build_window_ranges(doy_np, w, ndoy)
        except ValueError:
            kernels = False
        else:
            st = replicated(mesh, torch.from_numpy(starts.reshape(-1)))
            ln = replicated(mesh, torch.from_numpy(lens.reshape(-1)))
            return True, rmax, {d: dict(starts=st[d], lens=ln[d], ny=ny,
                                        rmax=rmax) for d in st}
    gidx, _ = build_window_index(doy_np, w, ndoy)
    g = replicated(mesh, torch.from_numpy(gidx))
    return False, 0, {d: dict(gidx=t) for d, t in g.items()}


def _clim_block(x, tables, kernels, ndoy, pctile, smooth, smooth_w,
                patch_feb29):
    """Climatology of one shard: kernels take the rmax-padded series."""
    if kernels:
        th, se = doy_quantile(x, tables["starts"], tables["lens"], ndoy,
                              tables["ny"], tables["rmax"], pctile)
        return finish_clim(th, se, smooth, smooth_w, patch_feb29)
    return clim_kernel(x, tables["gidx"], pctile=pctile, smooth=smooth,
                       smooth_w=smooth_w, patch_feb29=patch_feb29)


@in_span("fused_threshold_detect")
def fused_threshold_detect(ts, doy, doy_pos, pctile=90, smooth=True,
                           smooth_w=31, patch_feb29=True, K=64,
                           min_duration=5, join_gaps=True, max_gap=2, *,
                           w=5, ndoy=366, use_kernels=None):
    """threshold() + detect() as ONE device-resident step for a cell
    block: the climatology feeds detection without leaving the device.
    Port of :func:`xmhw_tpu.core.pipeline.fused_threshold_detect`, the
    step each process runs on its own shards of a global mesh
    (``tools/torch_multiproc_dryrun.py``).

    ``ts``: the (T, C) block, a contiguous tensor on its device. ``doy``:
    (T,) numpy int day of year of each step. The JAX function takes the
    window gather index built from it (``build_window_index(doy, w,
    ndoy)``); the clim kernel takes range tables and an ``rmax``-padded
    series instead, so both come from ``doy`` here, with the window
    half-width ``w`` and the ``ndoy`` climatology rows. ``doy_pos``: (T,)
    int32 climatology row of each step (tensor or array). The other
    arguments and their defaults are the JAX function's.

    Runs at the fixed capacity ``K``, with no counting pass and no retry:
    ``n_events`` is the raw count per cell and may exceed K, as in JAX.
    A float32 CUDA block launches kernels 1-3 once each: the clim
    percentile, the event RLE in its detect mode
    (``mhw_filter(full=False, slot=False)``) and the event scan; CPU
    tensors and float64 take the plain versions (:func:`use_kernels_for`,
    ``use_kernels`` overrides).

    Returns (th, se, table, n_events): the (ndoy, C) climatologies, the
    dict of (K, C) event-table tensors and the (C,) int32 raw counts.
    """
    dev = ts.device
    kernels = use_kernels_for(ts.dtype, dev, use_kernels)
    kclim, rmax, tables = _clim_tables(np.asarray(doy), w, ndoy, kernels,
                                       (dev,))
    x = ts
    if rmax:
        x = torch.cat([ts, ts.new_full((rmax, ts.shape[1]), float("nan"))])
    th, se = _clim_block(x, tables[dev], kclim, ndoy, pctile, smooth,
                         smooth_w, patch_feb29)
    pos = torch.as_tensor(doy_pos, dtype=torch.int32, device=dev)
    table, n_events, _ = detect_kernel(
        ts, th, se, pos, K, min_duration=min_duration, join_gaps=join_gaps,
        max_gap=max_gap, use_kernels=kernels)
    return th, se, table, n_events


@in_span("run_clim")
def run_clim(ts_np, doy_np, w, ndoy, pctile, smooth, smooth_w, patch_feb29,
             block=None, mesh=None, use_kernels=None, use_mesh=True,
             device="cuda"):
    """Climatology for all cells: (T, C) -> (thresh, seas) as (ndoy, C)
    numpy arrays (reference: xmhw/xmhw.py:250-307). ``mesh``/``use_mesh``
    as in :func:`resolve_mesh`; ``block``: cells per step over the whole
    mesh (default 4,096 per device)."""
    mesh = resolve_mesh(mesh, use_mesh, device)
    T, C = ts_np.shape
    kernels, rmax, tables = _clim_tables(
        doy_np, w, ndoy, use_kernels_for(ts_np.dtype, mesh[0], use_kernels),
        mesh)
    out_t = np.empty((ndoy, C), ts_np.dtype)
    out_s = np.empty((ndoy, C), ts_np.dtype)
    B = _block_size(C, block, len(mesh))
    for lo in range(0, C, B):
        shards = cell_sharding(mesh, lo, min(lo + B, C))
        outs = [_clim_block(upload(ts_np, a, b, d, pad_rows=rmax),
                            tables[d], kernels, ndoy, pctile, smooth,
                            smooth_w, patch_feb29) for d, a, b in shards]
        for (_, a, b), (th, se) in zip(shards, outs):
            got = fetch_rows({"th": th, "se": se})
            out_t[:, a:b] = got["th"]
            out_s[:, a:b] = got["se"]
    return out_t, out_s


class _Tables:
    """Host event tables (K, C), filled block by block; grows K when a
    later block needs more rows."""

    def __init__(self, C):
        self.C = C
        self.arrays = None

    @in_span("store")
    def put(self, tbl_h, lo, hi, K):
        from ..xrlite.alloc import alloc_filled

        if self.arrays is None:
            self.arrays = {k: alloc_filled((K, self.C), _fill_of(v), v.dtype)
                           for k, v in tbl_h.items()}
        elif next(iter(self.arrays.values())).shape[0] < K:
            for k, old in self.arrays.items():
                grown = alloc_filled((K, self.C), _fill_of(old), old.dtype)
                grown[:old.shape[0]] = old
                self.arrays[k] = grown
        for k, v in tbl_h.items():
            self.arrays[k][:v.shape[0], lo:hi] = v


@in_span("count_k")
def _count_k(ins, min_duration, join_gaps, max_gap, day0_fillna_quirk,
             kernels, floor=1):
    """The counting pass on every shard of a block: the largest number of
    events in a cell of the block (at least ``floor``). ``ins``: (ts, th,
    se, doy_pos) per shard. One ``detect_passes`` a shard."""
    count("detect_passes", len(ins))
    ns = [count_events(ts, th, pos, min_duration, join_gaps, max_gap,
                       day0_fillna_quirk, kernels)
          for ts, th, _, pos in ins]
    return max(_max_over(ns), floor)


@in_span("detect_retry")
def _detect_retry(ins, K, cap, intermediate, det_kw):
    """detect_kernel on every shard of a block with the overflow retry:
    the raw per-cell counts can exceed K; every shard reruns with a larger
    K (one K per block) unless the cap forbids it. ``ins``: (ts, th, se,
    doy_pos) per shard. Returns ([(table, n_events, inter)] per shard,
    K). One ``detect_passes`` a shard and run, one ``detect_blocks`` a
    shard."""
    count("detect_blocks", len(ins))
    while True:
        count("detect_passes", len(ins))
        outs = [detect_kernel(*i, K, intermediate=intermediate, **det_kw)
                for i in ins]
        raw_max = _max_over([nev for _, nev, _ in outs])
        if raw_max <= K or cap(_round_k(raw_max)) == K:
            return outs, K
        K = cap(_round_k(raw_max))


def _warn_dropped(dropped, k_cap):
    if dropped:
        from ..utils import logger

        logger.warning(
            "k_cap=%d truncated the event table: %d event(s) dropped "
            "across the grid", k_cap, dropped)


@in_span("inter_store")
def _store_inter(out, got, lo, hi, T, C, dev=None):
    """Store one shard's (T, hi - lo) intermediate arrays ``got`` into
    columns [lo, hi) of the (T, C) arrays of ``out``, made on first use:
    fetched numpy arrays, whose bytes count in ``inter_bytes``, or, with
    ``dev``, the shard's tensors, copied into tensors on ``dev`` (from
    another card of a mesh too), which count nothing."""
    for k, v in got.items():
        if dev is None:
            count("inter_bytes", v.nbytes)
        if k not in out:
            out[k] = (np.empty((T, C), v.dtype) if dev is None else
                      torch.empty((T, C), dtype=v.dtype, device=dev))
        out[k][:, lo:hi] = v


@in_span("run_detect")
def run_detect(ts_np, th_np, se_np, doy_pos_np, min_duration, join_gaps,
               max_gap, intermediate=False, block=None, mesh=None,
               k_cap=None, day0_fillna_quirk=False, use_kernels=None,
               k_min=None, first_k=None, use_mesh=True, device="cuda",
               inter_device=None):
    """Detection for all cells: returns (tables dict of (K, C) numpy,
    n_events (C,), inter dict of (T, C) numpy).

    ``th_np``/``se_np`` are (D, C) doy climatologies; ``doy_pos_np`` (T,)
    maps timesteps to climatology rows. K is fixed by a counting pass on
    the first block (or ``first_k``); later blocks run optimistically and
    retry with a larger K when the raw counts overflow. ``k_cap`` is an
    exact memory contract: events beyond it are dropped with a warning.
    ``mesh``/``use_mesh`` as in :func:`resolve_mesh`; ``block``: cells
    per step over the whole mesh (default 4,096 per device).

    ``inter_device``: with ``intermediate``, the intermediate arrays are
    not fetched but kept as (T, C) tensors on this device (the API's
    card route, ``api._inter_on_card``); ``inter`` is then a dict of
    them.
    """
    mesh = resolve_mesh(mesh, use_mesh, device)
    T, C = ts_np.shape
    kernels = use_kernels_for(ts_np.dtype, mesh[0], use_kernels)

    def cap(k):
        return min(k, int(k_cap)) if k_cap is not None else k

    det_kw = dict(min_duration=min_duration, join_gaps=join_gaps,
                  max_gap=max_gap, day0_fillna_quirk=day0_fillna_quirk,
                  use_kernels=kernels)
    if intermediate:
        count("inter_calls")
    n_events = np.zeros(C, np.int32)
    dropped = 0
    K = cap(_round_k(int(first_k))) if first_k else None
    tables = _Tables(C)
    inter_out = {}
    doy_pos = replicated(mesh, torch.from_numpy(
        np.asarray(doy_pos_np, np.int32)))
    B = _block_size(C, block, len(mesh))
    for lo in range(0, C, B):
        shards = cell_sharding(mesh, lo, min(lo + B, C))
        ins = [(*(upload(x, a, b, d) for x in (ts_np, th_np, se_np)),
                doy_pos[d]) for d, a, b in shards]
        if K is None:
            K = cap(_round_k(_count_k(
                ins, min_duration, join_gaps, max_gap, day0_fillna_quirk,
                kernels, int(k_min or 1))))
        outs, K = _detect_retry(ins, K, cap, intermediate, det_kw)
        for (_, a, b), (tbl, nev, inter) in zip(shards, outs):
            parts = {("nev", "nev"): nev}
            parts.update({("tbl", k): v for k, v in tbl.items()})
            if inter_device is None:
                parts.update({("inter", k): v for k, v in inter.items()})
            elif inter:
                _store_inter(inter_out, inter, a, b, T, C, inter_device)
            fetched = fetch_rows(parts)
            nev = fetched[("nev", "nev")]
            dropped += int(np.maximum(nev - K, 0).sum())
            n_events[a:b] = np.minimum(nev, K)
            tables.put({k: fetched[("tbl", k)] for k in tbl}, a, b, K)
            if inter and inter_device is None:
                _store_inter(inter_out, {k: fetched[("inter", k)]
                                         for k in inter}, a, b, T, C)
    _warn_dropped(dropped, k_cap)
    return tables.arrays, n_events, inter_out


@in_span("fused_stats")
def fused_stats(table, ts, th, se, doy_pos, ybod, nbins, day_edges,
                count_nans, rank_names, cold, kernels):
    """The stats layer on a device-resident detect output: the year-block
    event aggregations (reference: xmhw/stats.py:322-363), the per-day
    ts/category block stats (stats.py:366-428) and the per-cell ordinal
    ranks (stats.py:446-510), without the event tables or the day series
    leaving the device. Port of ``xmhw_tpu.core.pipeline.
    fused_stats_kernel``.

    ``table``: detect_kernel's dict of (K, B) tensors. ``ts``: the
    ORIGINAL (un-negated) (T, B) series: day stats run on the input
    values even for cold spells, as in the staged pipeline where
    block_average reads the raw SST file. ``ybod``: (T,) int32 year bin
    of each day, -1 outside the period. ``rank_names``: table variables
    to rank (empty: no ranks). ``cold``: negate the intensities (not the
    variances) before aggregating and ranking, as flip_cold does to the
    staged detect output (reference: xmhw/features.py:298-315).
    ``kernels``: the year-bin statistics are
    :func:`ops.block_stats.event_bins` and :func:`ops.block_stats.day_bins`
    (one kernel launch each on the card), else their plain versions.
    Returns {"block": {...}, "day": {...}, "rank": {...}} for the
    enabled stages.
    """
    from ..ops.block_stats import bins_for
    from .stats import EVENT_VARS, rank_events_desc

    dt = ts.dtype

    def flips(name):
        return cold and "intensity" in name and "_var" not in name

    def flip(name, v):
        return -v if flips(name) else v

    out = {}
    if nbins:
        event_bins, day_bins = bins_for(kernels)
        out["block"] = event_bins(
            [table[k].to(dt) for k in EVENT_VARS], table["time_start"],
            nbins, lut=ybod,
            negate=[i for i, k in enumerate(EVENT_VARS) if flips(k)])
        out["day"] = day_bins(ts, day_edges, th, se, doy_pos,
                              count_nans=count_nans)
    if rank_names:
        ones = torch.ones(table["time_start"].shape, dtype=torch.bool,
                          device=ts.device)
        out["rank"] = {k: rank_events_desc(flip(k, table[k]).to(dt), ones)
                       for k in rank_names}
    return out


class _Extras:
    """Host stats of run_fused, filled block by block: (rows, C) arrays
    per part; the host fill is 0.0 for ``*_days`` and NaN otherwise, and
    the rank rows grow with K."""

    def __init__(self, C):
        self.C = C
        self.parts = {}

    @in_span("store")
    def put(self, st_h, lo, hi):
        from ..xrlite.alloc import alloc_filled

        for part, d in st_h.items():
            rows = self.parts.setdefault(part, {})
            for k, v in d.items():
                old = rows.get(k)
                if old is None or old.shape[0] < v.shape[0]:
                    grown = alloc_filled(
                        (v.shape[0], self.C), 0.0 if str(k).endswith("_days")
                        else np.nan, v.dtype)
                    if old is not None:
                        grown[:old.shape[0]] = old
                    rows[k] = grown
                rows[k][:v.shape[0], lo:hi] = v


@in_span("run_fused")
def run_fused(ts_np, doy_np, doy_pos_np, *, w=5, ndoy=366, pctile=90,
              smooth=True, smooth_w=31, patch_feb29=True, min_duration=5,
              join_gaps=True, max_gap=2, day0_fillna_quirk=False,
              cold_spells=False, ts_clim_np=None, doy_clim_np=None,
              ts_day_np=None, ybod_np=None, nbins=0, day_edges=None,
              count_nans=False, rank_names=(), det_mask_np=None, block=None,
              mesh=None, k_min=None, k_cap=None, use_kernels=None,
              device="cuda"):
    """Climatology + detection + year-block stats + ranks with one upload
    per cell block: every stage consumes the previous stage's
    device-resident output, replacing the reference's staged workflow
    (threshold -> detect -> block_average -> mhw_rank,
    docs/gettingstarted.rst:158-188).

    ``ts_np``: (T, C) original series (not negated; pass
    ``maxPadLength``-interpolated data here and the raw series as
    ``ts_day_np`` to reproduce the staged stats semantics).
    ``ts_clim_np``/``doy_clim_np``: optional climatologyPeriod subset for
    the climatology stage (default: the full series). ``ybod_np``: (T,)
    int32 year bin of each day (-1 outside the period); with
    ``nbins``/``day_edges`` it enables the stats stage (``count_nans``
    adds the ``nan_days`` row). ``rank_names``: table variables to rank.
    ``det_mask_np``: (C,) bool, cells where it is False are excluded from
    detection (NaN thresholds and seasonal means, so no events and NaN
    categories, while their day stats still compute). ``mesh``: only an
    explicit cell mesh splits the blocks, as in the JAX package (no
    ``use_mesh``); ``block``: cells per step over the whole mesh.

    Returns (th, se, tables, n_events, extras) where extras holds numpy
    "block"/"day"/"rank" dicts for the enabled stages.
    """
    mesh = resolve_mesh(mesh, False, device)
    T, C = ts_np.shape
    if ts_clim_np is None:
        ts_clim_np, doy_clim_np = ts_np, doy_np
    same_clim = ts_clim_np is ts_np
    kernels = use_kernels_for(ts_np.dtype, mesh[0], use_kernels)
    kclim, rmax, tables = _clim_tables(doy_clim_np, w, ndoy, kernels, mesh)

    def cap(k):
        return min(k, int(k_cap)) if k_cap is not None else k

    det_kw = dict(min_duration=min_duration, join_gaps=join_gaps,
                  max_gap=max_gap, day0_fillna_quirk=day0_fillna_quirk,
                  use_kernels=kernels)
    doy_pos = replicated(mesh, torch.from_numpy(
        np.asarray(doy_pos_np, np.int32)))
    ybod = (replicated(mesh, torch.from_numpy(np.asarray(ybod_np,
                                                         np.int32)))
            if nbins else dict.fromkeys(mesh))
    out_t = np.empty((ndoy, C), ts_np.dtype)
    out_s = np.empty((ndoy, C), ts_np.dtype)
    n_events = np.zeros(C, np.int32)
    ev_tables = _Tables(C)
    extras = _Extras(C)
    dropped = 0
    K = cap(_round_k(int(k_min))) if k_min else None
    B = _block_size(C, block, len(mesh))
    nan = float("nan")

    def shard_in(d, a, b):
        """One shard's series on its device and its climatology: (x, th,
        se, doy_pos) for detection, and the day series."""
        # the main series carries the clim kernel's NaN tail rows when it
        # also feeds the climatology, so one upload serves both stages
        x_pad = upload(ts_np, a, b, d, pad_rows=rmax if same_clim else 0)
        xc = x_pad if same_clim else upload(ts_clim_np, a, b, d,
                                            pad_rows=rmax)
        x_day = (upload(ts_day_np, a, b, d) if ts_day_np is not None
                 else x_pad[:T])
        if cold_spells:
            x_pad = -x_pad
            xc = x_pad if same_clim else -xc
        th, se = _clim_block(xc, tables[d], kclim, ndoy, pctile, smooth,
                             smooth_w, patch_feb29)
        if det_mask_np is not None:
            m = torch.from_numpy(np.ascontiguousarray(
                det_mask_np[a:b])).to(d)
            th = torch.where(m[None, :], th, nan)
            se = torch.where(m[None, :], se, nan)
        return (x_pad[:T], th, se, doy_pos[d]), x_day

    for lo in range(0, C, B):
        shards = cell_sharding(mesh, lo, min(lo + B, C))
        ins, days = zip(*(shard_in(*s) for s in shards))
        if K is None:
            K = cap(_round_k(_count_k(ins, min_duration, join_gaps, max_gap,
                                      day0_fillna_quirk, kernels)))
        outs, K = _detect_retry(ins, K, cap, False, det_kw)
        sts = [fused_stats(tbl, x_day, th, se, pos, ybod[d], nbins,
                           day_edges, count_nans, tuple(rank_names),
                           cold_spells, kernels)
               if nbins or rank_names else {}
               for (tbl, _, _), x_day, (_, th, se, pos), (d, _, _)
               in zip(outs, days, ins, shards)]
        for (_, a, b), (_, th, se, _), (tbl, nev, _), st in zip(
                shards, ins, outs, sts):
            parts = {("clim", "th"): th, ("clim", "se"): se,
                     ("nev", "nev"): nev}
            parts.update({("tbl", k): v for k, v in tbl.items()})
            for part, dd in st.items():
                parts.update({(part, k): v for k, v in dd.items()})
            fetched = fetch_rows(parts)
            nev = fetched[("nev", "nev")]
            dropped += int(np.maximum(nev - K, 0).sum())
            n_events[a:b] = np.minimum(nev, K)
            out_t[:, a:b] = fetched[("clim", "th")]
            out_s[:, a:b] = fetched[("clim", "se")]
            ev_tables.put({k: fetched[("tbl", k)] for k in tbl}, a, b, K)
            extras.put({part: {k: fetched[(part, k)] for k in dd}
                        for part, dd in st.items()}, a, b)
    _warn_dropped(dropped, k_cap)
    return out_t, out_s, ev_tables.arrays, n_events, extras.parts
