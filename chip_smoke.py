#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (xmhw_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one or more lines each:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: nvcc builds every kernel of xmhw_tpu_torch/csrc into one library;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the main path's shapes (40 daily years, T = 14,610; 4,096 cells;
   K = 128 event slots), with CUDA-event times of both;
4. reference: threshold() + detect() on a small grid, on the card (float32
   kernels) against the plain torch code on the CPU;
5. slice: threshold(climatologyPeriod=[1983, 2012]) then detect() over a
   synthetic 40-year grid of 4,096 ocean cells; every kernel's launch
   counter must advance, events must be found and no event may be lost;
6. fused: run_fused on the same data must reproduce the slice.

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

import numpy as np

T0, T1 = "1982-01-01", "2022-01-01"  # 40 daily years, T = 14,610
CLIM_YEARS = [1983, 2012]
CELLS = 4096
K = 128
REPS = 5
DEV = "cuda"
TOL = {"thresh": 1e-6, "seas": 1e-5, "scan": 2e-3}  # atol; scan also rtol


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
    from xmhw_tpu_torch.ops import detect_scan, doy_quantile, rle
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
    return rows


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


def phase_fused(card, da, clim, mhw):
    """run_fused (one upload per block) must reproduce the slice."""
    from xmhw_tpu_torch.core.calendar import compute_doy
    from xmhw_tpu_torch.core.features_scan import TABLE_VARS
    from xmhw_tpu_torch.core.pipeline import run_fused
    from xmhw_tpu_torch.xrlite import TimeIndex

    ocean = ocean_of(da)
    tvals = np.asarray(da.coords["time"].values)
    doy, _ = compute_doy(TimeIndex(tvals))
    years = tvals.astype("datetime64[Y]").astype(int) + 1970
    sel = (years >= CLIM_YEARS[0]) & (years <= CLIM_YEARS[1])
    ts = np.ascontiguousarray(da.data[:, ocean])
    t = time.perf_counter()
    th, se, tables, nev, _ = run_fused(
        ts, doy, (doy - 1).astype(np.int32), ts_clim_np=ts[sel],
        doy_clim_np=doy[sel], device=DEV)
    wall = time.perf_counter() - t
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
    log(f"fused: run_fused reproduces the slice bit for bit "
        f"({ts.shape[1]} cells in {wall:.3f} s)  [{card}]")


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
    phase_fused(card, da, clim, mhw)
    for r in rows:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
