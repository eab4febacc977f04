#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (xmhw_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one or more lines each:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: nvcc builds every kernel of xmhw_tpu_torch/csrc into one library;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the main path's shapes (40 daily years, T = 14,610; 4,096 cells;
   K = 128 event slots), with CUDA-event times of both. The running-bound
   kernel (run_bound), which no path calls, is driven here only. The
   event scan runs again on events that cross every one of its time
   segments' edges;
4. reference: threshold() + detect() on a small grid, on the card (float32
   kernels) against the plain torch code on the CPU;
5. slice: threshold(climatologyPeriod=[1983, 2012]) then detect() over a
   synthetic 40-year grid of 4,096 ocean cells; every kernel's launch
   counter must advance, events must be found and no event may be lost;
6. stats: block_average() (one-year blocks with the ts/thresh/seas day
   series, and 5-year blocks) and mhw_rank() of the slice on the card,
   against the host numpy path;
7. fused: run_fused on the same data, with its stats stage, must
   reproduce the slice, its block_average and its mhw_rank;
8. stream steps: the device steps only the streamed stages run
   (stream_block_average's float64 event and day statistics of one stripe,
   stream_rank's batched ranks), on the slice's events, on the card
   against the CPU;
9. cli: ``python -m xmhw_tpu_torch warmup`` (in process): the kernels and
   the standard shapes on the card; every kernel's launch counter must
   advance;
10. stream: the streamed pipelines file to file, which read and write
   NetCDF through h5py. Where h5py is installed: a 160 x 64 grid (10,240
   cells, ~20 % land, 40 daily years, float32, ~600 MB) through stream_run
   (3 stripes) and through the staged chain stream_threshold ->
   stream_detect -> stream_block_average -> stream_rank, which must agree,
   and whose climatology and events must equal one in-memory run_fused
   over the grid; launch counters must advance in both runs; then the CLI's
   ``run`` on a small grid in a subprocess. Where h5py is missing, one line
   says that the phase did not run and why.

Then a JSON line with one entry per kernel, and last the line
{"ok": true, "device": {...}}. Any failure raises and exits non-zero; so
does a machine without a visible CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

T0, T1 = "1982-01-01", "2022-01-01"  # 40 daily years, T = 14,610
CLIM_YEARS = [1983, 2012]
CELLS = 4096
K = 128
REPS = 5
DEV = "cuda"
TOL = {"thresh": 1e-6, "seas": 1e-5, "scan": 2e-3}  # atol; scan also rtol
# stats against the host numpy path: day statistics are float64 on both
# sides (rtol); event statistics are float32 tables summed in float32 on
# the card and in float64 on the host (rtol = atol); counts and ranks exact
STATS_TOL = {"day": 1e-9, "event": 1e-5}
STREAM_GRID = (160, 64)  # 10,240 cells; the default stripe is 71 rows
DAY_STATS = ("ts_mean", "ts_max", "ts_min")
RANKED = ("intensity_max", "duration")


def log(msg):
    print(msg, flush=True)


def synth(T, n, seed, land=0):
    """(T, n) float32: seasonal cycle plus 15-day-smoothed noise (the TPU
    benchmark's recipe), with ``land`` all-NaN cells chosen at random."""
    rng = np.random.default_rng(seed)
    day = np.arange(T, dtype=np.float64)[:, None]
    noise = rng.normal(0.0, 1.0, (T + 14, n))
    cs = np.concatenate([np.zeros((1, n)), np.cumsum(noise, axis=0)])
    sm = (cs[15:15 + T] - cs[:T]) / 15.0
    ts = (15 + 3 * np.sin(2 * np.pi * day / 365.25) + 2.5 * sm)
    ts = ts.astype(np.float32)
    ts[:, rng.permutation(n)[:land]] = np.nan
    return ts


def daily(t0, t1):
    return np.arange(t0, t1, dtype="datetime64[D]").astype("datetime64[ns]")


def grid(t, nlat, nlon, seed, land):
    from xmhw_tpu_torch.xrlite import Coord, DataArray

    ts = synth(len(t), nlat * nlon, seed, land).reshape(len(t), nlat, nlon)
    return DataArray(
        ts, ("time", "lat", "lon"),
        {"time": Coord(("time",), t),
         "lat": Coord(("lat",), np.linspace(-45.0, -30.0, nlat)),
         "lon": Coord(("lon",), np.linspace(140.0, 160.0, nlon))},
        {"units": "degree_C"})


def cuda_ms(fn, reps=REPS):
    """Median CUDA-event time of ``fn`` in ms, after one warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_err(a, b, what, atol, rtol=0.0):
    """Max |a - b| over finite entries; raises when the NaN patterns differ
    or an entry is outside atol + rtol * |b|."""
    import torch

    a, b = a.double(), b.double()
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb):
        raise AssertionError(f"{what}: NaN patterns differ at "
                             f"{int((fa != fb).sum())} entries")
    d = (a[fa] - b[fb]).abs()
    if d.numel() and bool((d > atol + rtol * b[fb].abs()).any()):
        raise AssertionError(f"{what}: max |diff| {float(d.max()):.3g} "
                             f"exceeds atol {atol} rtol {rtol}")
    return float(d.max()) if d.numel() else 0.0


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible")
    return card


def phase_build():
    from xmhw_tpu_torch.ops import _build

    t = time.perf_counter()
    so = _build.build()
    _build.library()
    log(f"build: {time.perf_counter() - t:.2f} s -> {so.name}")


def phase_kernels(card):
    """Each kernel against its plain version at the main path's shapes.
    Returns the rows of the kernels JSON line (launches filled later)."""
    import torch

    from xmhw_tpu_torch.core.calendar import build_window_ranges, compute_doy
    from xmhw_tpu_torch.core.clim import finish_clim
    from xmhw_tpu_torch.ops import detect_scan, doy_quantile, rle, run_bound
    from xmhw_tpu_torch.xrlite import TimeIndex

    t = daily(T0, T1)
    T = len(t)
    doy, ndoy = compute_doy(TimeIndex(t))
    starts, lens, ny, rmax = build_window_ranges(doy, 5, ndoy)
    ts = synth(T, CELLS, seed=1)
    ts[1000:1040, 5] = np.nan  # a NaN run inside a pool
    ts[:, 9] = np.nan          # an all-NaN cell
    x = torch.full((T + rmax, CELLS), float("nan"), device=DEV)
    x[:T] = torch.from_numpy(ts).to(DEV)
    st = torch.from_numpy(starts.reshape(-1)).to(DEV)
    ln = torch.from_numpy(lens.reshape(-1)).to(DEV)
    args1 = (x, st, ln, ndoy, ny, rmax)
    rows = []

    def row(name, src, replaces, err, fn, plain):
        ms, pms = cuda_ms(fn), cuda_ms(plain)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": 0,
                     "max_abs_err": err, "ms": ms, "plain_ms": pms})
        log(f"kernels: {name}: max |err| {err:.3g}, kernel {ms:.3f} ms, "
            f"plain {pms:.3f} ms  [{card}]")

    thk, sek = doy_quantile.doy_quantile(*args1)
    thp, sep = doy_quantile.doy_quantile_plain(*args1)
    err = max(max_err(thk, thp, "doy_quantile thresh", TOL["thresh"]),
              max_err(sek, sep, "doy_quantile seas", TOL["seas"]))
    row("doy_quantile", "xmhw_tpu_torch/csrc/doy_quantile.cu",
        "xmhw_tpu/ops/pallas/doy_quantile.py:299", err,
        lambda: doy_quantile.doy_quantile(*args1),
        lambda: doy_quantile.doy_quantile_plain(*args1))

    th, se = finish_clim(thk, sek)
    pos = torch.from_numpy((doy - 1).astype(np.int32)).to(DEV)
    xt = x[:T]
    bthresh = xt > th.index_select(0, pos.long())
    fk = rle.mhw_filter(bthresh)
    fp = rle.mhw_filter_plain(bthresh)
    for k in fp:
        if not torch.equal(fk[k], fp[k]):
            raise AssertionError(f"rle {k}: kernel != plain")
    nmax = int(fp["n_events"].max())
    log(f"kernels: rle: {int(fp['n_events'].sum())} events, at most "
        f"{nmax} in a cell (K = {K})")
    if nmax > K:
        raise AssertionError(f"{nmax} events in a cell overflow K = {K}")
    row("rle", "xmhw_tpu_torch/csrc/rle.cu",
        "xmhw_tpu/ops/pallas/rle.py:179", 0.0,
        lambda: rle.mhw_filter(bthresh, full=False),
        lambda: rle.mhw_filter_plain(bthresh, full=False))

    # run_bound: no path calls it, so its launches are this check's
    nb = ~bthresh
    run_bound.run_bound.launches = 0
    for mask in (bthresh, nb):
        for fwd in (True, False):
            if not torch.equal(run_bound.run_bound(mask, fwd),
                               run_bound.run_bound_plain(mask, fwd)):
                raise AssertionError(f"run_bound forward={fwd}: kernel != "
                                     "plain")
    launched = run_bound.run_bound.launches
    row("run_bound", "xmhw_tpu_torch/csrc/run_bound.cu",
        "xmhw_tpu/ops/pallas/run_bound.py:88", 0.0,
        lambda: (run_bound.run_bound(nb, True),
                 run_bound.run_bound(nb, False)),
        lambda: (run_bound.run_bound_plain(nb, True),
                 run_bound.run_bound_plain(nb, False)))
    rows[-1].update(launches=launched, path="kernels phase only")
    log("kernels: run_bound: forward and backward on the mask and its "
        "negation equal the plain version; times are one forward + "
        "backward pair")

    args3 = (xt, th, se, pos, fk["event_day"], fk["is_start"], K)
    Fk, Ik = detect_scan.event_stats(*args3)
    Fp, Ip = detect_scan.event_stats_plain(*args3)
    if not torch.equal(Ik, Ip):
        raise AssertionError("event_scan positions: kernel != plain")
    err = max_err(Fk, Fp, "event_scan floats", TOL["scan"], TOL["scan"])
    row("detect_scan", "xmhw_tpu_torch/csrc/detect_scan.cu",
        "xmhw_tpu/ops/pallas/detect_scan.py:336", err,
        lambda: detect_scan.event_stats(*args3),
        lambda: detect_scan.event_stats_plain(*args3))
    scan_edges(card, xt, th, se, pos)
    return rows


def edge_mask(T, C, warps):
    """(T, C) bool: a run across every segment edge of the event-scan
    kernel (warps segments of ceil(T / warps) days) in every cell, starting
    1-5 days before the edge, and a run over three segments in every 64th
    cell."""
    L = -(-T // warps)
    m = np.zeros((T, C), bool)
    c = np.arange(C)
    for e in range(L, T, L):
        s, n = e - 1 - c % 5, 6 + c % 13
        for d in range(n.max()):
            ok = (d < n) & (s + d < T)
            m[(s + d)[ok], c[ok]] = True
    m[L // 2:L // 2 + int(3.3 * L), ::64] = True
    return m


def scan_edges(card, xt, th, se, pos):
    """The event scan on events that cross every segment edge of the
    kernel, at the main path's shapes: kernel against plain, and times."""
    import torch

    from xmhw_tpu_torch.ops import detect_scan, rle

    cfg = detect_scan.launch_config()
    T, C = xt.shape
    L = -(-T // cfg["warps"])
    log(f"kernels: detect_scan launch: {cfg['warps']} warps (time "
        f"segments of {L} days) per block, {cfg['threads']} threads, "
        f"{cfg['smem_bytes']} B of dynamic shared memory, {-(-C // 32)} "
        "blocks")
    th_t = th.index_select(0, pos.long())
    m = torch.from_numpy(edge_mask(T, C, cfg["warps"])).to(DEV)
    xe = torch.where(m, torch.maximum(xt, th_t) + 0.3, xt)
    f = rle.mhw_filter_plain(xe > th_t, full=False)
    day = f["event_day"]
    E = torch.arange(L, T, L, device=DEV)
    live = ~torch.isnan(xt).all(dim=0)
    if not bool((day[E - 1] & day[E])[:, live].all()):
        raise AssertionError("segment-edge mask: an edge without an event")
    args = (xe, th, se, pos, day, f["is_start"], K)
    Fk, Ik = detect_scan.event_stats(*args)
    Fp, Ip = detect_scan.event_stats_plain(*args)
    if not torch.equal(Ik, Ip):
        raise AssertionError("event_scan edges positions: kernel != plain")
    err = max_err(Fk, Fp, "event_scan edges floats", TOL["scan"],
                  TOL["scan"])
    ms = cuda_ms(lambda: detect_scan.event_stats(*args))
    pms = cuda_ms(lambda: detect_scan.event_stats_plain(*args))
    log(f"kernels: detect_scan on events across all {len(E)} segment edges "
        f"of {int(live.sum())} cells ({int(f['n_events'].sum())} events, "
        f"at most {int(f['n_events'].max())} in a cell, K = {K}): positions "
        f"equal, max |err| {err:.3g}, kernel {ms:.3f} ms, plain {pms:.3f} "
        f"ms  [{card}]")


def ocean_of(da):
    """(lat, lon) bool mask of cells that are not all-NaN."""
    return ~np.isnan(da.data).all(axis=0)


def tables_close(a, b, what):
    """Compare two compact event Datasets variable by variable: times
    exactly, floats within the event-scan tolerance."""
    for k in a.keys():
        x, y = np.asarray(a[k].data), np.asarray(b[k].data)
        if x.shape != y.shape:
            raise AssertionError(f"{what} {k}: shapes {x.shape} {y.shape}")
        if np.issubdtype(x.dtype, np.datetime64):
            if not np.array_equal(x.astype("i8"), y.astype("i8")):
                raise AssertionError(f"{what} {k}: not equal")
            continue
        max_err(_t(x), _t(y), f"{what} {k}", TOL["scan"], TOL["scan"])


def phase_reference(card):
    """threshold()+detect() on a small grid: the card's float32 kernels
    against the plain torch code on the CPU."""
    import xmhw_tpu_torch as xt

    da = grid(daily("2000-01-01", "2010-01-01"), 6, 8, seed=2, land=8)
    out = {}
    for dev in (DEV, "cpu"):
        clim = xt.threshold(da, device=dev)
        mhw = xt.detect(da, clim["thresh"], clim["seas"], device=dev,
                        events_layout="compact")
        out[dev] = clim, mhw
    (cg, mg), (cc, mc) = out[DEV], out["cpu"]
    e1 = max_err(*(_t(c["thresh"].data) for c in (cg, cc)),
                 "reference thresh", TOL["thresh"])
    e2 = max_err(*(_t(c["seas"].data) for c in (cg, cc)),
                 "reference seas", TOL["seas"])
    tables_close(mg, mc, "reference")
    n = int(np.isfinite(mg["duration"].data).sum())
    log(f"reference: 40 cells x 10 years, card vs CPU: thresh {e1:.3g}, "
        f"seas {e2:.3g}, {n} events agree  [{card}]")
    if n == 0:
        raise AssertionError("reference grid found no events")


def _t(a):
    import torch

    return torch.from_numpy(np.asarray(a))


def reset_launches():
    from xmhw_tpu_torch.ops import detect_scan, doy_quantile, rle

    for fn in (doy_quantile.doy_quantile, rle.mhw_filter,
               detect_scan.event_stats):
        fn.launches = 0


def read_launches():
    from xmhw_tpu_torch.ops import detect_scan, doy_quantile, rle

    return {"doy_quantile": doy_quantile.doy_quantile.launches,
            "rle": rle.mhw_filter.launches,
            "detect_scan": detect_scan.event_stats.launches}


def phase_slice(card, da):
    """The main path: threshold() then detect(), as a user calls them."""
    import torch

    import xmhw_tpu_torch as xt

    reset_launches()
    t0 = time.perf_counter()
    clim = xt.threshold(da, climatologyPeriod=CLIM_YEARS, device=DEV)
    t1 = time.perf_counter()
    mhw = xt.detect(da, clim["thresh"], clim["seas"], device=DEV,
                    events_layout="compact")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_launches()
    ocean = ocean_of(da)
    C = int(ocean.sum())
    wall = t2 - t0
    log(f"slice: threshold+detect of {C} cells x {da.sizes['time']} days "
        f"in {wall:.3f} s (threshold {t1 - t0:.3f} s, detect "
        f"{t2 - t1:.3f} s) = {C / wall:.1f} cells/s; launches {launches}  "
        f"[{card}]")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the slice: {missing}")
    th = clim["thresh"].data[:, ocean]
    if th.shape != (366, C) or not np.isfinite(th).all():
        raise AssertionError(f"thresholds: shape {th.shape} or non-finite")
    dur = mhw["duration"].data[:, ocean]
    n_table = np.isfinite(dur).sum(axis=0)
    n_raw = raw_counts(da, clim, ocean)
    if not np.array_equal(n_table, n_raw):
        raise AssertionError("event tables lost events (K overflow)")
    log(f"slice: {int(n_table.sum())} events, {int(n_table.max())} at most "
        f"in a cell, table holds every one")
    if n_table.sum() == 0:
        raise AssertionError("the slice found no events")
    return clim, mhw, launches


def raw_counts(da, clim, ocean):
    """Events per ocean cell by the plain RLE on the card (independent of
    the event table), from the slice's own climatology."""
    import torch

    from xmhw_tpu_torch.core.calendar import compute_doy
    from xmhw_tpu_torch.ops import rle
    from xmhw_tpu_torch.xrlite import TimeIndex

    doy, _ = compute_doy(TimeIndex(np.asarray(da.coords["time"].values)))
    ts = torch.from_numpy(np.ascontiguousarray(da.data[:, ocean])).to(DEV)
    th = torch.from_numpy(
        np.ascontiguousarray(clim["thresh"].data[:, ocean])).to(DEV)
    pos = torch.from_numpy(doy - 1).to(DEV)
    f = rle.mhw_filter_plain(ts > th[pos], full=False)
    return f["n_events"].cpu().numpy()


def day_series(da, clim):
    """The dstime of block_average as detect's intermediate gives it: ts,
    and thresh and seas on the time axis."""
    from xmhw_tpu_torch.core.calendar import compute_doy
    from xmhw_tpu_torch.xrlite import Dataset, TimeIndex

    for d in ("lat", "lon"):
        if not np.array_equal(clim["thresh"].coords[d].values,
                              da.coords[d].values):
            raise AssertionError(f"clim {d} differs from the series'")
    doy, _ = compute_doy(TimeIndex(np.asarray(da.coords["time"].values)))
    ds = Dataset()
    ds["ts"] = da
    for v in ("thresh", "seas"):
        ds[v] = da.copy(data=clim[v].data[doy - 1])
    return ds


def stats_agree(got, want, what):
    """Card vs host statistics: the same variables and NaN patterns,
    counts exactly equal, floats within STATS_TOL. Returns the largest
    |difference| of each kind."""
    if sorted(got.keys()) != sorted(want.keys()):
        raise AssertionError(f"{what}: variables {sorted(got.keys())} != "
                             f"{sorted(want.keys())}")
    errs = {"count": 0.0, "day": 0.0, "event": 0.0}
    for k in want.keys():
        a, b = _t(got[k].data), _t(want[k].data)
        if k == "ecount" or k.endswith("_days"):
            kind, atol, rtol = "count", 0.0, 0.0
        elif k in DAY_STATS:
            kind, atol, rtol = "day", 0.0, STATS_TOL["day"]
        else:
            kind, atol = "event", STATS_TOL["event"]
            rtol = atol
        errs[kind] = max(errs[kind], max_err(a, b, f"{what} {k}", atol,
                                             rtol))
    return errs


def phase_stats(card, da, clim, mhw):
    """block_average() and mhw_rank() of the slice on the card against the
    host numpy path (device=False), as a user calls them."""
    import torch

    import xmhw_tpu_torch as xt

    dstime = day_series(da, clim)
    out = {}
    for label, kw in (("years", dict(dstime=dstime)),
                      ("5-year", dict(period=[1982, 2021], blockLength=5))):
        t = time.perf_counter()
        dev = xt.block_average(mhw, device=DEV, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        host = xt.block_average(mhw, device=False, **kw)
        t2 = time.perf_counter()
        errs = stats_agree(dev, host, f"block_average {label}")
        log(f"stats: block_average {label} blocks {dev['ecount'].shape}: "
            f"card {t1 - t:.3f} s, host {t2 - t1:.3f} s; max |diff| "
            f"counts {errs['count']:.3g}, day {errs['day']:.3g}, event "
            f"{errs['event']:.3g}  [{card}]")
        out[label] = dev
    t = time.perf_counter()
    rank, ret = xt.mhw_rank(mhw, device=DEV)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    hrank, hret = xt.mhw_rank(mhw, device=False)
    t2 = time.perf_counter()
    for k in hrank.keys():
        for a, b, what in ((rank, hrank, "rank"), (ret, hret, "return")):
            if not np.array_equal(a[k].data, b[k].data, equal_nan=True):
                raise AssertionError(f"mhw_rank {what} {k}: card != host")
    log(f"stats: mhw_rank of {len(hrank.keys())} variables: card "
        f"{t1 - t:.3f} s, host {t2 - t1:.3f} s; ranks and return periods "
        f"equal  [{card}]")
    if not np.nansum(out["years"]["ecount"].data) > 0:
        raise AssertionError("block_average counted no events")
    out["rank"] = rank
    return out


def phase_fused(card, da, clim, mhw, stats):
    """run_fused (one upload per block) with its stats stage must
    reproduce the slice, its block_average and its mhw_rank."""
    from xmhw_tpu_torch.core.calendar import compute_doy
    from xmhw_tpu_torch.core.features_scan import TABLE_VARS
    from xmhw_tpu_torch.core.pipeline import run_fused
    from xmhw_tpu_torch.core.stats import day_block_edges
    from xmhw_tpu_torch.xrlite import TimeIndex

    ocean = ocean_of(da)
    tvals = np.asarray(da.coords["time"].values)
    doy, _ = compute_doy(TimeIndex(tvals))
    years = tvals.astype("datetime64[Y]").astype(int) + 1970
    sel = (years >= CLIM_YEARS[0]) & (years <= CLIM_YEARS[1])
    bins = np.arange(years[0], years[-1] + 2)
    ts = np.ascontiguousarray(da.data[:, ocean])
    reset_launches()
    t = time.perf_counter()
    th, se, tables, nev, extras = run_fused(
        ts, doy, (doy - 1).astype(np.int32), ts_clim_np=ts[sel],
        doy_clim_np=doy[sel], ybod_np=(years - bins[0]).astype(np.int32),
        nbins=len(bins) - 1, day_edges=day_block_edges(years, bins),
        count_nans=True, rank_names=RANKED, device=DEV)
    wall = time.perf_counter() - t
    launches = read_launches()
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched by run_fused: {missing}")
    for name, a in (("thresh", th), ("seas", se)):
        if not np.array_equal(a, clim[name].data[:, ocean], equal_nan=True):
            raise AssertionError(f"fused {name} != slice")
    kmax = mhw["duration"].sizes["ev"]
    if not np.array_equal(nev, np.isfinite(
            mhw["duration"].data[:, ocean]).sum(axis=0)):
        raise AssertionError("fused n_events != slice")
    for k in TABLE_VARS:
        if k.startswith("time_"):
            continue
        a = tables[k][:kmax].astype(np.float64)
        b = np.asarray(mhw[k].data[:, ocean], np.float64)
        if not np.array_equal(a, b, equal_nan=True):
            raise AssertionError(f"fused table {k} != slice")
    errs = fused_stats_agree(extras, stats, ocean, ts, years, bins, kmax)
    log(f"fused: run_fused reproduces the slice bit for bit and its "
        f"block_average/mhw_rank (max |diff| {errs:.3g}; {ts.shape[1]} "
        f"cells, {len(bins) - 1} year blocks, ranks of {list(RANKED)} in "
        f"{wall:.3f} s; launches {launches})  [{card}]")


def fused_stats_agree(extras, stats, ocean, ts, years, bins, kmax):
    """run_fused's extras against block_average/mhw_rank of the slice:
    counts and ranks exactly equal, floats within rtol = atol = 1e-5 (the
    fused stage reduces float32 on the card, the reference float64).
    Returns the largest float |difference|."""
    tol = STATS_TOL["event"]
    ref = stats["years"]
    worst = 0.0
    for part in ("block", "day"):
        for k, v in extras[part].items():
            if k == "nan_days":
                want = np.stack([np.isnan(ts[(years >= lo) & (years < hi)])
                                 .sum(axis=0) for lo, hi in
                                 zip(bins[:-1], bins[1:])])
            else:
                want = np.asarray(ref[k].data)[:, ocean]
            if k == "ecount" or k.endswith("_days"):
                if not np.array_equal(v, want):
                    raise AssertionError(f"fused {part} {k} != reference")
                continue
            worst = max(worst, max_err(_t(v), _t(want), f"fused {part} {k}",
                                       tol, tol))
    missing = set(ref.keys()) - set(extras["block"]) - set(extras["day"])
    if missing:
        raise AssertionError(f"fused stats lack {sorted(missing)}")
    for k in RANKED:
        r = extras["rank"][k]
        want = np.asarray(stats["rank"][k].data)[:, ocean]
        if not (np.array_equal(r[:kmax], want, equal_nan=True)
                and np.isnan(r[kmax:]).all()):
            raise AssertionError(f"fused rank {k} != mhw_rank")
    return worst


def phase_stream_steps(card, da, clim, mhw):
    """stream_block_average's per-stripe device step (float64 year-block
    event and day statistics) and stream_rank's batched ranks, on the
    slice's events as one stripe: the card against the CPU. Counts and
    ranks exact; float64 statistics within rtol 1e-9 (sums in another
    order)."""
    import torch

    from xmhw_tpu_torch.core.calendar import compute_doy
    from xmhw_tpu_torch.core.features_scan import RANK_VARS
    from xmhw_tpu_torch.core.stats import EVENT_VARS, day_block_edges
    from xmhw_tpu_torch.stream import _block_stats_step, _rank_stack
    from xmhw_tpu_torch.xrlite import TimeIndex

    ocean = ocean_of(da)
    tvals = np.asarray(da.coords["time"].values)
    years = tvals.astype("datetime64[Y]").astype(int) + 1970
    bins = np.arange(years[0], years[-1] + 2)
    nbins = len(bins) - 1
    doy, _ = compute_doy(TimeIndex(tvals))
    tab = {v: np.asarray(mhw[v].data[:, ocean]) for v in
           set(EVENT_VARS) | set(RANK_VARS) | {"time_start"}}
    vals = np.stack([tab[v].astype(np.float64) for v in EVENT_VARS])
    start = tab["time_start"]
    valid = ~np.isnat(start)
    ev_years = start.astype("datetime64[Y]").astype(int) + 1970
    bin_idx = np.clip(np.searchsorted(bins, ev_years, side="right") - 1, 0,
                      nbins - 1)
    ts = np.ascontiguousarray(da.data[:, ocean], np.float64)
    th, se = (np.ascontiguousarray(clim[v].data[:, ocean], np.float64)
              for v in ("thresh", "seas"))
    edges = day_block_edges(years, bins)
    stack = np.stack([tab[v].astype(np.float64) for v in RANK_VARS])
    out = []
    for dev in (DEV, "cpu"):
        dev = torch.device(dev)
        pos = torch.from_numpy((doy - 1).astype(np.int64)).to(dev)
        t0 = time.perf_counter()
        ev, day = _block_stats_step(vals, bin_idx, valid, nbins, dev, ts,
                                    th, se, pos, edges, True)
        t1 = time.perf_counter()
        ranks = _rank_stack(torch.from_numpy(stack).to(dev)).cpu().numpy()
        t2 = time.perf_counter()
        out.append(({**ev, **day}, ranks, t1 - t0, t2 - t1))
    (got, rk, bs, rs), (want, hrk, hbs, hrs) = out
    worst = 0.0
    for k, v in want.items():
        if k == "ecount" or k.endswith("_days"):
            if not np.array_equal(got[k], v):
                raise AssertionError(f"stream block step {k}: card != CPU")
            continue
        worst = max(worst, max_err(_t(got[k]), _t(v), f"stream block step "
                                   f"{k}", 0.0, STATS_TOL["day"]))
    if not np.array_equal(rk, hrk, equal_nan=True):
        raise AssertionError("stream rank step: card != CPU")
    if not np.nansum(got["ecount"]) > 0:
        raise AssertionError("stream block step counted no events")
    log(f"stream steps: block statistics of {ts.shape[1]} cells x "
        f"{ts.shape[0]} days, {nbins} year blocks, {vals.shape[1]} event "
        f"slots (float64): card {bs:.3f} s, CPU {hbs:.3f} s, max |diff| "
        f"{worst:.3g}; ranks of a {stack.shape} stack: card {rs:.3f} s, "
        f"CPU {hrs:.3f} s, equal  [{card}]")


def phase_cli(card):
    """``python -m xmhw_tpu_torch warmup``, in process: build (the cached
    library) and the standard shapes on the card (40 daily years, one
    4,096-cell block, K = 32, 64, 128); every kernel must launch."""
    from xmhw_tpu_torch.__main__ import main as cli

    reset_launches()
    t = time.perf_counter()
    if cli(["warmup"]) != 0:
        raise AssertionError("warmup returned non-zero")
    wall = time.perf_counter() - t
    launches = read_launches()
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched by warmup: {missing}")
    log(f"cli: warmup in {wall:.3f} s; launches {launches}  [{card}]")


def phase_stream(card):
    """The streamed pipelines file to file, where h5py is installed."""
    import importlib.util
    import tempfile

    if importlib.util.find_spec("h5py") is None:
        log("stream: did not run: no h5py on this machine, and the streamed "
            "functions read and write NetCDF through it; "
            "tests/test_torch_stream*.py carry their parity with xmhw_tpu "
            "on the CPU")
        return
    with tempfile.TemporaryDirectory(prefix="xmhw_stream_") as d:
        stream_files(card, Path(d), DEV, *STREAM_GRID, daily(T0, T1))


def exact(part, k):
    """The variables of an output file that two runs must write equal:
    thresholds, event positions, counts and categories, ranks."""
    if part == "mhw":
        return (k in ("event", "category") or
                k.startswith(("duration", "index_", "time_")))
    return (part == "rank" or (part, k) == ("clim", "thresh")
            or (part, k) == ("block", "ecount"))


def files_agree(a, b, part):
    """Two output files of the port: the same variables and shapes, the
    same NaN patterns, the ``exact`` variables equal, category-day counts
    within 1 (stream_run computes a day's category in float32, the staged
    block_average in float64: a day on a category edge may fall on either
    side), other floats within rtol = atol = 2e-3. Returns the largest
    float |difference|."""
    import xmhw_tpu_torch as xt

    da, db = xt.open_dataset(a), xt.open_dataset(b)
    what = f"stream {part}"
    if sorted(da.keys()) != sorted(db.keys()):
        raise AssertionError(f"{what}: variables differ")
    worst = 0.0
    for k in db.keys():
        x, y = np.asarray(da[k].data), np.asarray(db[k].data)
        if x.shape != y.shape:
            raise AssertionError(f"{what} {k}: shapes {x.shape} {y.shape}")
        if x.dtype.kind == "M":
            x, y = x.astype("i8"), y.astype("i8")
        if part == "block" and k.endswith("_days"):
            max_err(_t(x), _t(y), f"{what} {k}", 1.0)
            continue
        if exact(part, k) or x.dtype.kind == "i":
            if not np.array_equal(x, y, equal_nan=x.dtype.kind == "f"):
                raise AssertionError(f"{what} {k}: not equal")
            continue
        worst = max(worst, max_err(_t(x), _t(y), f"{what} {k}", TOL["scan"],
                                   TOL["scan"]))
    return worst


def stream_files(card, d, dev, nlat, nlon, t):
    """stream_run and the staged chain over one grid file; their files
    must agree, and stream_run's climatology and events must equal one
    in-memory run_fused over the grid. Then the CLI's ``run``."""
    import xmhw_tpu_torch as xt
    from xmhw_tpu_torch.core.calendar import compute_doy
    from xmhw_tpu_torch.core.features_scan import TABLE_VARS
    from xmhw_tpu_torch.core.pipeline import run_fused
    from xmhw_tpu_torch.stream import _auto_stripe
    from xmhw_tpu_torch.xrlite import Dataset, TimeIndex

    n = nlat * nlon
    ds = Dataset()
    ds["sst"] = grid(t, nlat, nlon, seed=5, land=n // 5)
    src = str(d / "sst.nc")
    w = time.perf_counter()
    xt.save_dataset(ds, src)
    w = time.perf_counter() - w
    rows = _auto_stripe(len(t), (nlat, nlon))
    log(f"stream: wrote {n} cells x {len(t)} days ({ds['sst'].data.nbytes} "
        f"B) in {w:.3f} s; stripes of {rows} rows: "
        f"{-(-nlat // rows)}  [{card}]")
    runs = {}
    for how in ("stream_run", "staged"):
        p = {k: str(d / f"{how}_{k}.nc") for k in ("clim", "mhw", "block",
                                                   "rank")}
        reset_launches()
        t0 = time.perf_counter()
        if how == "stream_run":
            out = xt.stream_run(src, "sst", p["clim"], p["mhw"],
                                block_path=p["block"], rank_path=p["rank"],
                                device=dev)
        else:
            xt.stream_threshold(src, "sst", p["clim"], device=dev)
            xt.stream_detect(src, "sst", p["clim"], p["mhw"], device=dev)
            xt.stream_block_average(p["mhw"], p["block"], dstime_path=src,
                                    dstime_var="sst", clim_path=p["clim"],
                                    device=dev)
            out = dict(p, **{"return": xt.stream_rank(
                p["mhw"], p["rank"], device=dev)[1]})
        wall = time.perf_counter() - t0
        launches = read_launches()
        missing = [k for k, v in launches.items() if v == 0]
        if missing:
            raise AssertionError(f"kernels not launched by {how}: {missing}")
        runs[how] = out
        log(f"stream: {how} file to file in {wall:.3f} s = "
            f"{n / wall:.1f} cells/s (land included); launches {launches}"
            f"  [{card}]")
    worst = max(files_agree(runs["stream_run"][k], runs["staged"][k], k)
                for k in runs["staged"])
    clim = xt.open_dataset(runs["stream_run"]["clim"])
    mhw = xt.open_dataset(runs["stream_run"]["mhw"])
    ocean = ~np.isnan(ds["sst"].data).all(axis=0)
    doy, _ = compute_doy(TimeIndex(t))
    th, se, tables, nev, _ = run_fused(
        np.ascontiguousarray(ds["sst"].data[:, ocean]), doy,
        (doy - 1).astype(np.int32), device=dev)
    for k, v in (("thresh", th), ("seas", se)):
        if not np.array_equal(clim[k].data[:, ocean], v, equal_nan=True):
            raise AssertionError(f"stream {k} != in-memory run_fused")
    K = mhw["event"].sizes["ev"]
    if tables["event"].shape[0] > K or not np.array_equal(
            np.isfinite(mhw["duration"].data[:, ocean]).sum(axis=0), nev):
        raise AssertionError("stream event counts != in-memory run_fused")
    for k in TABLE_VARS:
        if k.startswith("time_"):
            continue
        a = np.asarray(mhw[k].data[:, ocean], np.float64)
        b = np.full(a.shape, np.nan)
        b[:tables[k].shape[0]] = tables[k]
        if not np.array_equal(a, b, equal_nan=True):
            raise AssertionError(f"stream {k} != in-memory run_fused")
    log(f"stream: stream_run and the staged chain agree (max |diff| "
        f"{worst:.3g}); clim and {int(nev.sum())} events equal one "
        f"in-memory run_fused  [{card}]")
    small = Dataset()
    small["sst"] = grid(t, 8, 8, seed=6, land=8)
    xt.save_dataset(small, str(d / "small.nc"))
    c = [str(d / f"cli_{k}.nc") for k in ("c", "m", "b", "r")]
    r = subprocess.run(
        [sys.executable, "-m", "xmhw_tpu_torch", "--device", str(dev), "run",
         str(d / "small.nc"), "sst", c[0], c[1], "--block", c[2], "--rank",
         c[3]], capture_output=True, text=True, timeout=600,
        cwd=Path(__file__).resolve().parent)
    if r.returncode != 0 or not all(Path(f).exists() for f in c):
        raise AssertionError(f"python -m xmhw_tpu_torch run failed: "
                             f"{r.stderr[-2000:]}")
    log(f"stream: python -m xmhw_tpu_torch run on 64 cells wrote "
        f"{len(r.stdout.splitlines())} files  [{card}]")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible "
              "(torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    import xmhw_tpu_torch  # noqa: F401  (fails outside a checkout)

    card = phase_device()
    phase_build()
    rows = phase_kernels(card)
    phase_reference(card)
    da = grid(daily(T0, T1), 64, 80, seed=3, land=64 * 80 - CELLS)
    clim, mhw, launches = phase_slice(card, da)
    stats = phase_stats(card, da, clim, mhw)
    phase_fused(card, da, clim, mhw, stats)
    phase_stream_steps(card, da, clim, mhw)
    phase_cli(card)
    phase_stream(card)
    for r in rows:
        if r["name"] in launches:  # run_bound: counted in phase_kernels
            r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
