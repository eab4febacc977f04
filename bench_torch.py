#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port (xmhw_tpu_torch) on NVIDIA GPUs.

    python3 bench_torch.py --seed 0                 # the five one-card cells
    python3 bench_torch.py --seed 0 --cell global_fused \\
        --cell global_fused_mesh4                   # four cards

The port's counterpart of bench.py, in bench.py's configurations. Each
cell is a closed loop of one caller. Its inputs are made from ``--seed``
(numpy on the host, or a torch.Generator seeded from it on the card) and
are all the program under test receives. A cell runs its set-up (the
kernels are built once before any cell), a cold run, warm-up runs, the
timed runs with tracing off (their median, sample count and spread:
(max - min) / median), one separate traced run (torch.profiler, with
spans that this file records around its calls into each layer) and, for
the API cells, one run under cProfile; then it checks its outputs,
outside the timed window. ``tools/torch_bench_bounds.py`` turns the
``--detail`` files of repeated runs into regression bounds.

Cells (``CELLS``; the first five take one card):

* global_fused: bench.py:129-338 on the card. T = 14,610 (daily
  1982-2021), 4,096-cell blocks, K = 128; 152 blocks (622,592 cells)
  rotating over 4 blocks made on the card with bench.py's recipe
  (seasonal cycle + 15-day smoothed noise, the ``rmax`` NaN tail). The
  step: ``_clim_tables`` once, then ``pipeline._clim_block`` +
  ``features_scan.detect_kernel`` per block, a digest each; no raw count
  may exceed K. Then the with-stats step (year-bin event statistics and
  the ranks of five properties) over as many blocks (at least 8) as keep
  it under a minute.
* tasman_regional: bench.py:628-687. A 50 x 50 grid, 30 % land, 40
  daily years, float32: ``threshold()`` + ``detect()`` (union layout).
* monthly_tstep: bench.py:690-730. 50 x 50, 30 % land, 480 monthly
  steps, ``tstep=True``, ``minDuration=3``, ``maxGap=1``.
* stats_pipeline: bench.py:733-771. 50 x 50, 30 % land, 40 years:
  ``threshold`` + ``detect(events_layout="compact")`` +
  ``block_average(period, device)`` + ``mhw_rank``.
* single_point: bench.py:597-625. One cell, daily 1992-2021, the host
  point path (core/point.py).
* global_fused_mesh4: global_fused over a cell mesh of four cards:
  16,384-cell blocks, one 4,096-cell shard a card, 38 blocks (622,592
  cells); every shard of a block is issued on its card before one host
  wait per block, as the mesh path of ``run_fused`` issues them.

bench.py's global_streamed is left out: it reads and writes NetCDF
through h5py, which the H100 machine does not have; there the streamed
path runs through the numpy stand-in (tools/h5py_standin, chip_smoke.py),
whose raw files would misstate HDF5's cost.

Every cell reports ``cells_per_sec`` (ocean cells over the warm wall,
host clock ending in ``torch.cuda.synchronize()``); the per-layer
metrics come from the traced run (and cProfile); each cell prints its
breakdown: the 10 device operations with the most total time and the 5
longest device-idle gaps, each with the innermost bench span open at
its middle. ``--detail`` gets every number as JSON, ``--trace-dir`` the
profiler traces. The last line is short JSON: ``metric``, ``value``,
``unit`` and ``vs_target``, the rate over the users' target of 620,000
cells in 60 s on 8 devices (1,291.7 cells/s a device), a target and not
a measurement.

The run exits non-zero without a CUDA device, when a cell fails (after
printing what was measured) and when ``--budget-s`` runs out. Imports
neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import cProfile
import functools
import json
import math
import os
import pstats
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GLOBAL_CELLS = 620_000  # ocean cells of the 0.25-degree OISST grid
TARGET = GLOBAL_CELLS / 60 / 8  # cells/s a device: 620k cells, 60 s, 8 devices
RANKED = ("intensity_max", "duration", "intensity_cumulative",
          "severity_mean", "rate_onset")
KERNELS = {"k1": "doy_quantile_kernel", "k2": "rle_kernel",
           "k3": "event_scan_kernel"}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SAMPLED = 16  # ocean cells checked against the plain versions
F64 = {"rtol": 1e-9, "atol": 1e-12}  # tests/test_point_host.py:54,101


def smoke():
    """chip_smoke.py: the bars (``TOL``, ``STATS_TOL``), their comparisons
    and the card's peak rate, shared with the smoke test."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke


def dryrun():
    """tools/torch_multiproc_dryrun.py: ``against_plain``/``within_bars``
    hold a fused step against its plain version at the smoke test's bars."""
    sys.path.insert(0, str(ROOT / "tools"))
    import torch_multiproc_dryrun

    return torch_multiproc_dryrun


# ---------------------------------------------------------------- reports

class Report:
    """One cell's results: metrics by name with their unit (a value of
    None is "not measured"), the timed samples, the breakdown and the
    checks."""

    def __init__(self, cell, card):
        self.cell, self.card = cell, card
        self.metrics = {}
        self.info = {}

    def add(self, name, value, unit):
        self.metrics[name] = (value, unit)

    def timed(self, name, cells, walls):
        """``name`` = cells / median wall of the timed runs, its sample
        count and its spread ((max - min) / median of the rates)."""
        rates = [cells / w for w in walls]
        med = statistics.median(rates)
        self.add(name, med, "cells/s")
        self.add(f"{name}_runs", len(rates), "runs")
        self.add(f"{name}_spread", (max(rates) - min(rates)) / med,
                 "fraction of the median")
        self.add(f"{name.replace('cells_per_sec', 'wall')}_s",
                 statistics.median(walls), "s")
        self.info.setdefault("samples", {})[name] = rates

    def lines(self):
        out = []
        for name, (v, unit) in self.metrics.items():
            txt = "not measured" if v is None else _fmt(v)
            out.append(f"{self.cell}: {name} = {txt} {unit}  [{self.card}]")
        br = self.info.get("breakdown")
        if br is None:
            return out
        if not br["ops"]:
            out.append(f"{self.cell}: breakdown: not measured (no device "
                       "activity traced)")
        for i, (name, ms, n) in enumerate(br["ops"], 1):
            out.append(f"{self.cell}: top device op {i}: {ms:.3f} ms in {n} "
                       f"calls: {name}")
        for i, g in enumerate(br["gaps"], 1):
            out.append(f"{self.cell}: idle gap {i}: {g['ms']:.3f} ms on "
                       f"device {g['device']} at +{g['at_ms']:.1f} ms of "
                       f"the traced run, bench span open: {g['span']}")
        return out

    def detail(self):
        return {"card": self.card,
                "metrics": {k: {"value": v, "unit": u}
                            for k, (v, u) in self.metrics.items()},
                **self.info}


def _fmt(v):
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_fmt(x) for x in v) + "]"
    return str(v)


# ----------------------------------------------------- timing and tracing

class Tracer:
    """Spans around the calls this file makes into each layer, recorded
    in the traced run only (a no-op otherwise)."""

    def __init__(self, on=False):
        self.on = on

    def span(self, name):
        if not self.on:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(f"bench/{name}")


OFF = Tracer(False)


def sync(devices):
    import torch

    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def walls(devices, fn, reps):
    """Host-clock walls of ``reps`` calls of ``fn()``, each ending in a
    synchronise of every device; returns (walls, the last output)."""
    out, ws = None, []
    for _ in range(reps):
        t = time.perf_counter()
        out = fn()
        sync(devices)
        ws.append(time.perf_counter() - t)
    return ws, out


@contextlib.contextmanager
def layer_spans(tracer, where):
    """Wrap functions of the port's modules in spans: ``where`` maps a
    span name to (module, attribute). Restored on exit."""
    saved = [(m, a, getattr(m, a)) for m, a in where.values()]

    def wrap(name, fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            with tracer.span(name):
                return fn(*args, **kw)
        return inner

    for name, (m, a) in where.items():
        setattr(m, a, wrap(name, getattr(m, a)))
    try:
        yield
    finally:
        for m, a, fn in saved:
            setattr(m, a, fn)


def traced(devices, cell, fn, trace_dir=None):
    """``fn(tracer)`` once under torch.profiler (CPU and CUDA activity on
    a card), inside the span ``bench/<cell>``. Returns (its output, the
    trace's events)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if any(d.type == "cuda" for d in devices):
        acts.append(ProfilerActivity.CUDA)
    tr = Tracer(True)
    with profile(activities=acts) as prof:
        with tr.span(cell):
            out = fn(tr)
            sync(devices)
    with tempfile.TemporaryDirectory() as d:
        path = Path(trace_dir or d) / f"{cell}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return out, events


def host_seconds(fn, where):
    """One call of ``fn()`` under cProfile: its wall and the cumulative
    seconds of the functions ``where`` names (label -> [(path suffix,
    function name), ...], summed over the pairs)."""
    pr = cProfile.Profile()
    t = time.perf_counter()
    pr.enable()
    try:
        fn()
    finally:
        pr.disable()
    wall = time.perf_counter() - t
    stats = pstats.Stats(pr).stats
    out = dict.fromkeys(where, 0.0)
    for (path, _, func), (_, _, _, cum, _) in stats.items():
        path = path.replace(os.sep, "/")
        for label, pairs in where.items():
            if any(func == f and path.endswith(s) for s, f in pairs):
                out[label] += cum
    return wall, out


def _merge(iv):
    iv = sorted(iv)
    out = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _short(name, n=110):
    name = str(name)
    return name if len(name) <= n else name[:n - 3] + "..."


def analyse(events, window, launch_spans=()):
    """Device activity of a chrome trace inside the span ``bench/<window>``:
    the busy share of each device (the union of its kernels, copies and
    sets over the span), time by operation, kernels 1-3 by name, copies
    by direction, the 5 longest idle gaps of any device with the innermost
    bench span open at each gap's middle, and the kernel launches the host
    issued inside each span of ``launch_spans``. Device entries are None
    when the trace holds no device activity."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("bench/")]
    win = next(s for s in spans if s["name"] == f"bench/{window}")
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    ops = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if b > a:
            ops.append((e, a, b))
    out = {"window_ms": (w1 - w0) / 1e3, "busy_share": None,
           "busy_share_by_device": {}, "ops": [], "gaps": [],
           "kernels_ms": dict.fromkeys(KERNELS), "copies": {},
           "launches": {}}
    for name in launch_spans:
        inside = [(float(s["ts"]), float(s["ts"]) + float(s["dur"]))
                  for s in spans if s["name"] == f"bench/{name}"]
        out["launches"][name] = sum(
            1 for e in events if e.get("cat") == "cuda_runtime"
            and "LaunchKernel" in str(e.get("name", ""))
            and any(a <= float(e["ts"]) <= b for a, b in inside))
    if not ops:
        return out
    by_dev = {}
    for e, a, b in ops:
        by_dev.setdefault(e.get("pid"), []).append((a, b))
    gaps = []
    for dev, iv in sorted(by_dev.items(), key=lambda x: str(x[0])):
        busy = _merge(iv)
        out["busy_share_by_device"][str(dev)] = (
            sum(b - a for a, b in busy) / (w1 - w0))
        edges = [w0] + [x for ab in busy for x in ab] + [w1]
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                gaps.append((b - a, a, dev))
    shares = list(out["busy_share_by_device"].values())
    out["busy_share"] = sum(shares) / len(shares)
    total = {}
    for e, a, b in ops:
        t = total.setdefault(_short(e.get("name")), [0.0, 0])
        t[0] += (b - a) / 1e3
        t[1] += 1
    out["ops"] = sorted(((n, ms, c) for n, (ms, c) in total.items()),
                        key=lambda x: -x[1])[:10]
    for k, sub in KERNELS.items():
        out["kernels_ms"][k] = sum((b - a) / 1e3 for e, a, b in ops
                                   if e.get("cat") == "kernel"
                                   and sub in str(e.get("name")))
    out["kernels_ms"]["all"] = sum((b - a) / 1e3 for e, a, b in ops
                                   if e.get("cat") == "kernel")
    for way in ("HtoD", "DtoH"):
        cp = [(e, a, b) for e, a, b in ops if e.get("cat") == "gpu_memcpy"
              and way in str(e.get("name"))]
        nb = [e.get("args", {}).get("bytes") for e, _, _ in cp]
        out["copies"][way] = {
            "ms": sum((b - a) / 1e3 for _, a, b in cp),
            "MB": (sum(nb) / 1e6 if all(x is not None for x in nb)
                   else None)}
    for length, a, dev in sorted(gaps, key=lambda g: -g[0])[:5]:
        mid = a + length / 2
        open_ = [s for s in spans if float(s["ts"]) <= mid
                 <= float(s["ts"]) + float(s["dur"])]
        inner = min(open_, key=lambda s: float(s["dur"]))["name"]
        out["gaps"].append({"ms": length / 1e3, "at_ms": (a - w0) / 1e3,
                            "device": str(dev), "span": inner})
    return out


def device_metrics(rep, br):
    """The traced run's device busy share, copies and breakdown."""
    rep.add("device_busy_share", br["busy_share"], "fraction of the "
            "traced wall")
    if len(br["busy_share_by_device"]) > 1:
        rep.add("device_busy_share_by_card",
                list(br["busy_share_by_device"].values()), "fraction")
    for way, label in (("HtoD", "h2d"), ("DtoH", "d2h")):
        c = br["copies"].get(way, {})
        rep.add(f"{label}_MB", c.get("MB"), "MB")
        rep.add(f"{label}_ms", c.get("ms"), "ms")
    rep.info["breakdown"] = {k: br[k] for k in ("ops", "gaps",
                                                 "window_ms")}


def peak_memory(rep, devices):
    import torch

    gb = [torch.cuda.max_memory_allocated(d) / 1e9 for d in devices
          if d.type == "cuda"]
    rep.add("peak_device_memory_GB", (gb[0] if len(gb) == 1 else gb or None),
            "GB")


def reset_peak(devices):
    import torch

    for d in devices:
        if d.type == "cuda":
            torch.zeros((), device=d)  # the allocator of d exists
            torch.cuda.reset_peak_memory_stats(d)


# ------------------------------------------------------------- the inputs

def daily(y0, y1):
    """Daily datetime64[ns] steps from y0-01-01 to y1-12-31."""
    return np.arange(f"{y0}-01-01", f"{y1 + 1}-01-01",
                     dtype="datetime64[D]").astype("datetime64[ns]")


def host_grid(t, ny, nx, seed, land=0.3, period=365.25, smooth=True):
    """(T, ny, nx) float32 DataArray made from ``seed``: a seasonal cycle
    of ``period`` steps plus unit noise (15-step moving mean, times 2.5,
    when ``smooth``: bench.py:105-114's recipe), ``land`` of the cells
    all-NaN."""
    from xmhw_tpu_torch.xrlite import Coord, DataArray

    rng = np.random.default_rng(seed)
    T, n = len(t), ny * nx
    step = np.arange(T, dtype=np.float64)[:, None]
    if smooth:
        cs = np.concatenate([np.zeros((1, n)), np.cumsum(
            rng.normal(0.0, 1.0, (T + 14, n)), axis=0)])
        noise = 2.5 * (cs[15:15 + T] - cs[:T]) / 15.0
    else:
        noise = rng.normal(0.0, 1.0, (T, n))
    ts = (15 + 3 * np.sin(2 * np.pi * step / period) + noise).astype(
        np.float32)
    ts[:, rng.random(n) < land] = np.nan
    return DataArray(
        ts.reshape(T, ny, nx), ("time", "lat", "lon"),
        {"time": Coord(("time",), t),
         "lat": Coord(("lat",), np.linspace(-45, -33, ny)),
         "lon": Coord(("lon",), np.linspace(147, 159, nx))},
        {"units": "degree_C"})


def ocean_cells(da):
    return int((~np.isnan(da.data).all(axis=0)).sum())


# ------------------------------------------------------- the fused cells

class FusedStep:
    """bench.py's fused step on one device: the clim tables made once
    (``_clim_tables``), then per block ``pipeline._clim_block`` +
    ``features_scan.detect_kernel`` at a fixed K, reduced to a digest on
    the device. Float32 on a card runs kernels 1-3; the CPU runs the
    plain versions."""

    def __init__(self, dev, t, K):
        import torch

        from xmhw_tpu_torch.core.calendar import compute_doy
        from xmhw_tpu_torch.core.pipeline import _clim_tables, use_kernels_for
        from xmhw_tpu_torch.xrlite import TimeIndex

        self.dev, self.K, self.T = dev, K, len(t)
        self.doy, self.ndoy = compute_doy(TimeIndex(t))
        self.kernels = use_kernels_for(torch.float32, dev)
        self.kclim, self.rmax, tabs = _clim_tables(
            self.doy, 5, self.ndoy, self.kernels, (dev,))
        self.tables = tabs[dev]
        self.pos = torch.from_numpy((self.doy - 1).astype(np.int32)).to(dev)
        years = t.astype("datetime64[Y]").astype(np.int64)
        self.year_of = torch.from_numpy(years - years[0]).to(dev)
        self.n_years = int(years[-1] - years[0]) + 1

    def stage(self, C, seed):
        """One (T + rmax, C) float32 block on the device from a generator
        seeded with ``seed``: bench.py:163-170's recipe, the rmax tail NaN."""
        import torch

        g = torch.Generator(device=self.dev)
        g.manual_seed(seed)
        day = torch.arange(self.T, dtype=torch.float32,
                           device=self.dev)[:, None]
        base = 15 + 3 * torch.sin(2 * math.pi * day / 365.25)
        noise = torch.randn((self.T, C), generator=g, device=self.dev)
        sm = sum(torch.roll(noise, k, 0) for k in range(-7, 8)) / 15.0
        x = torch.full((self.T + self.rmax, C), float("nan"),
                       device=self.dev)
        x[:self.T] = base + 2.5 * sm
        return x

    def core(self, x, tr=OFF):
        """(th, se, table, raw n_events) of one staged block."""
        from xmhw_tpu_torch.core.features_scan import detect_kernel
        from xmhw_tpu_torch.core.pipeline import _clim_block

        with tr.span("clim_block"):
            th, se = _clim_block(x, self.tables, self.kclim, self.ndoy, 90,
                                 True, 31, True)
        with tr.span("detect_kernel"):
            table, nev, _ = detect_kernel(x[:self.T], th, se, self.pos,
                                          self.K, use_kernels=self.kernels)
        return th, se, table, nev

    def step(self, x, tr=OFF):
        """bench.py:182-189: (digest, events, largest raw count)."""
        import torch

        _, _, table, nev = self.core(x, tr)
        with tr.span("digest"):
            digest = torch.stack([torch.nansum(v.float())
                                  for v in table.values()]).sum()
        return digest, nev.sum(), nev.max()

    def step_stats(self, x, tr=OFF):
        """bench.py:218-241: the step, then the year-bin event statistics
        and the ranks of five properties, reduced to a digest."""
        import torch

        from xmhw_tpu_torch.core.stats import (EVENT_VARS, binned_event_stats,
                                               rank_events_desc)

        _, _, table, nev = self.core(x, tr)
        with tr.span("stats"):
            tstart = table["time_start"]
            valid = tstart >= 0
            bins = self.year_of[torch.clamp(tstart, 0, self.T - 1).long()]
            vals = torch.stack([table[k].float() for k in EVENT_VARS])
            blk = binned_event_stats(vals, bins, valid, self.n_years)
            ranks = [rank_events_desc(table[k].float(), valid)
                     for k in RANKED]
            digest = (torch.stack([torch.nansum(v)
                                   for v in blk.values()]).sum()
                      + torch.stack([torch.nansum((self.n_years + 1.0) / r)
                                     for r in ranks]).sum())
        return digest, nev.sum(), nev.max()

    def against_plain(self, x):
        """The step's outputs on block ``x`` against
        ``fused_threshold_detect(use_kernels=False)`` on the same block:
        the largest differences of each kind (dryrun's ``against_plain``)."""
        from xmhw_tpu_torch.core.pipeline import fused_threshold_detect

        plain = fused_threshold_detect(x[:self.T], self.doy, self.pos,
                                       K=self.K, ndoy=self.ndoy,
                                       use_kernels=False)
        return dryrun().against_plain(self.core(x), plain)


def check_k(raw, K):
    if raw > K:
        raise RuntimeError(f"K = {K} overflowed: a cell had {raw} raw "
                           "events, so the tables would drop some")


def card_mark(dev):
    import torch

    if dev.type != "cuda":
        return None
    e = torch.cuda.Event(enable_timing=True)
    e.record(torch.cuda.current_stream(dev))
    return e


def fused_pass(steps, staged, n, kind="step", tr=OFF, wait_each=False,
               marks=None, waits=None):
    """``n`` blocks, block i on staged input i mod len: every device's
    shard is issued before the next block; with ``wait_each`` the host
    then waits once for the largest raw count of the block's shards (the
    K check of run_fused's mesh path). ``marks`` collects per device a
    pair of CUDA events around each shard, ``waits`` the host waits in s.
    Returns (events, largest raw count, digest), read once at the end."""
    import torch

    from xmhw_tpu_torch.core.pipeline import _max_over

    K = steps[0].K
    per = [[] for _ in steps]
    for i in range(n):
        for j, s in enumerate(steps):
            a = card_mark(s.dev) if marks is not None else None
            with tr.span(f"shard{j}"):
                per[j].append(getattr(s, kind)(staged[j][i % len(staged[j])],
                                                tr))
            if a is not None:
                marks[j].append((a, card_mark(s.dev)))
        if wait_each:
            t = time.perf_counter()
            with tr.span("wait"):
                raw = _max_over([p[-1][2] for p in per])
            if waits is not None:
                waits.append(time.perf_counter() - t)
            check_k(raw, K)
    total = sum(int(torch.stack([o[1] for o in p]).sum()) for p in per)
    raw = max(int(torch.stack([o[2] for o in p]).max()) for p in per)
    digest = sum(float(torch.stack([o[0] for o in p]).sum()) for p in per)
    check_k(raw, K)
    if not math.isfinite(digest):
        raise RuntimeError(f"the digest of {n} blocks is {digest}")
    return total, raw, digest


def kernel_bytes(s, C):
    """Bytes each kernel must move for one C-cell block (each input read
    once, each output written once), as PERF.md's bounds count them."""
    from xmhw_tpu_torch.ops import detect_scan

    T, nd, K, rmax = s.T, s.ndoy, s.K, s.rmax
    ny = s.tables["ny"] if s.kclim else 0
    clim = 2 * nd * C * 4
    return {
        "k1": (T + rmax) * C * 4 + 2 * nd * ny * 4 + clim,
        "k2": T * C + 2 * T * C + C * 4,  # mask in; event_day, is_start, n
        "k3": T * C * 4 + clim + T * 4 + 2 * T * C
        + (len(detect_scan.F_CHANNELS) + len(detect_scan.I_CHANNELS))
        * K * C * 4}


def fused_cell(name, devices, seed, card, *, years=40, cells=4096,
               blocks=152, K=128, staged=4, reps=5, trace_blocks=8,
               stats_blocks=None, stats_budget_s=45.0, trace_dir=None):
    """global_fused (one device) and global_fused_mesh4 (a block of
    ``cells`` per device, one shard a device, one host wait per block)."""
    from xmhw_tpu_torch.parallel import cell_mesh

    rep = Report(name, card)
    devices = cell_mesh(list(devices))
    reset_peak(devices)
    t = daily(1982, 1981 + years)
    steps = [FusedStep(d, t, K) for d in devices]
    data = [[s.stage(cells, seed * 1000 + 100 * j + i) for i in range(staged)]
            for j, s in enumerate(steps)]
    sync(devices)
    mesh = len(devices) > 1
    width = cells * len(devices)
    run = functools.partial(fused_pass, steps, data, wait_each=mesh)

    run(1)  # cold: kernel loads, allocations
    run(2 * staged)  # warm-up
    ws, (events, raw, _) = walls(devices, lambda: run(blocks), reps)
    rep.timed("cells_per_sec", blocks * width, ws)
    rep.add("blocks", blocks, "blocks")
    rep.add("cells", blocks * width, "cells")
    rep.add("events", events, "events")
    rep.add("max_raw_events_per_cell", raw, "events")
    rep.add("K", K, "slots")

    # the with-stats step: as many blocks (at least 8) as keep its three
    # timed passes under stats_budget_s
    one, _ = walls(devices, lambda: run(1, "step_stats"), 1)
    nst = stats_blocks or max(8, min(blocks, int(stats_budget_s
                                                 / (3 * one[0]))))
    ws, _ = walls(devices, lambda: run(nst, "step_stats"), 3)
    rep.timed("with_stats_cells_per_sec", nst * width, ws)
    rep.add("with_stats_blocks", nst, "blocks")

    # the traced run: per-layer numbers
    marks = [[] for _ in devices]
    waits = []
    smoke().reset_launches()
    _, events_ = traced(devices, name, lambda tr: run(
        trace_blocks, tr=tr, marks=marks, waits=waits), trace_dir)
    got = smoke().read_launches()
    launches = {"k1": got["doy_quantile"], "k2": got["rle"],
                "k3": got["detect_scan"]}
    br = analyse(events_, name)
    n = trace_blocks * len(devices)  # shards traced
    for k in KERNELS:
        rep.add(f"{k}_launches_per_block", launches[k] / n, "launches")
    moved = kernel_bytes(steps[0], cells)
    PEAK = smoke().PEAK_BYTES
    for k, label in (("k1", "kernel 1 (doy_quantile)"),
                     ("k2", "kernel 2 (rle)"),
                     ("k3", "kernel 3 (event scan)")):
        ms = br["kernels_ms"][k]
        ms = None if ms is None else ms / n
        bound = moved[k] / PEAK * 1e3 * max(launches[k] / n, 1)
        rep.add(f"{k}_ms_per_block", ms, f"ms ({label})")
        rep.add(f"{k}_bound_ms", bound, "ms (bytes over 3.35 TB/s)")
        rep.add(f"{k}_bound_share", None if not ms else bound / ms,
                "fraction of the bound")
    allk = br["kernels_ms"].get("all")
    glue = (None if allk is None else
            (allk - sum(br["kernels_ms"][k] for k in KERNELS)) / n)
    rep.add("glue_ms_per_block", glue, "ms (other kernels: torch glue)")
    rep.add("traced_wall_ms_per_block", br["window_ms"] / trace_blocks, "ms")
    step_ms = [statistics.median(a.elapsed_time(b) for a, b in m)
               if m else None for m in marks]
    rep.add("step_ms_per_card", step_ms if mesh else step_ms[0],
            "ms (CUDA events around a shard's step, median)")
    if mesh:
        rep.add("wait_ms_per_block", statistics.median(waits) * 1e3,
                "ms (host wait for the slowest card, median)")
    device_metrics(rep, br)

    # correctness: one block of each device against the plain step
    bars = dryrun().BARS
    for j, s in enumerate(steps):
        errs = s.against_plain(data[j][0])
        if not dryrun().within_bars(errs):
            raise AssertionError(f"{name} device {j}: the step against the "
                                 f"plain version {errs}, bars {bars}")
        rep.info.setdefault("checks", {})[f"device {j} against plain"] = errs
    worst = {k: max(rep.info["checks"][f"device {j} against plain"][k]
                    for j in range(len(steps)))
             for k in (*bars, "exact_differ")}
    for k, v in worst.items():
        rep.add(f"plain_max_{k}", v, "|diff| (events: / (1 + |plain|))"
                if k != "exact_differ" else "entries")
    peak_memory(rep, devices)
    return rep


def global_fused(devices, seed, card, **kw):
    return fused_cell("global_fused", devices[:1], seed, card, **kw)


def global_fused_mesh4(devices, seed, card, blocks=38, **kw):
    return fused_cell("global_fused_mesh4", devices[:4], seed, card,
                      blocks=blocks, **kw)


# --------------------------------------------------------- the API cells

def api_layers():
    """Spans of the traced run: the API's calls into its layers."""
    from xmhw_tpu_torch import api
    from xmhw_tpu_torch.core import pipeline

    return {"land_check": (api, "land_check"), "run_clim": (api, "run_clim"),
            "run_detect": (api, "run_detect"),
            "assembly": (api, "_assemble_events"),
            "assembly_compact": (api, "_assemble_events_compact"),
            "upload": (pipeline, "upload"),
            "fetch_rows": (pipeline, "fetch_rows")}


HOST_LAYERS = {  # cProfile label -> [(path suffix, function)]
    "land_check": [("xmhw_tpu_torch/api.py", "land_check")],
    "run_clim": [("xmhw_tpu_torch/core/pipeline.py", "run_clim")],
    "run_detect": [("xmhw_tpu_torch/core/pipeline.py", "run_detect")],
    "assembly": [("xmhw_tpu_torch/api.py", "_assemble_events"),
                 ("xmhw_tpu_torch/api.py", "_assemble_events_compact")],
}


def api_cell(rep, devices, call, cells, reps, host_layers, trace_dir,
             launch_spans=(), warm=3):
    """A cold run of ``call(tracer)``, ``warm`` untimed warm-up runs (with
    the union event layout the first calls run several times slower than
    the later ones), ``reps`` warm timed runs, the traced run and the
    cProfile run. Returns the last timed output."""
    reset_peak(devices)
    cold, _ = walls(devices, lambda: call(OFF), 1)
    rep.add("cold_s", cold[0], "s")
    ws, _ = walls(devices, lambda: call(OFF), warm)
    rep.add("warmup_s", ws, "s (untimed warm-up runs, in order)")
    ws, out = walls(devices, lambda: call(OFF), reps)
    rep.timed("cells_per_sec", cells, ws)
    rep.add("ocean_cells", cells, "cells")

    def spanned(tr):
        with layer_spans(tr, api_layers()):
            return call(tr)

    _, events = traced(devices, rep.cell, spanned, trace_dir)
    br = analyse(events, rep.cell, launch_spans)
    device_metrics(rep, br)
    for name, n in br["launches"].items():
        rep.add(f"{name}_launches", n if br["busy_share"] is not None
                else None, "kernel launches (host calls in the span)")
    wall, host = host_seconds(lambda: call(OFF), host_layers)
    rep.add("cprofile_wall_s", wall, "s (one warm run under cProfile)")
    for k, v in host.items():
        rep.add(f"host_s_{k}", v, "s (cProfile, cumulative)")
    peak_memory(rep, devices)
    return out


def sample_cells(da, seed, n=SAMPLED):
    """``n`` ocean cells of ``da`` picked from ``seed``: (lat index, lon
    index) pairs in grid order."""
    ocean = np.argwhere(~np.isnan(da.data).all(axis=0))
    rng = np.random.default_rng(seed)
    pick = np.sort(rng.choice(len(ocean), min(n, len(ocean)), replace=False))
    return ocean[pick]


def sub_grid(da, cells):
    """The sampled cells of ``da`` as a (time, 1, n) DataArray."""
    from xmhw_tpu_torch.xrlite import Coord, DataArray

    data = np.ascontiguousarray(da.data[:, cells[:, 0], cells[:, 1]])
    return DataArray(data[:, None, :], ("time", "lat", "lon"),
                     {"time": da.coords["time"],
                      "lat": Coord(("lat",), [0.0]),
                      "lon": Coord(("lon",), np.arange(len(cells),
                                                       dtype=float))},
                     dict(da.attrs))


def positions(ds, da, cells):
    """Indexes of the sampled cells of ``da`` on the (lat, lon) grid of an
    output Dataset (which holds only the ocean's rows and columns)."""
    ii, jj = [], []
    for (i, j) in cells:
        for dim, k, out in (("lat", i, ii), ("lon", j, jj)):
            grid = np.asarray(ds.coords[dim].values)
            want = da.coords[dim].values[k]
            out.append(int(np.flatnonzero(grid == want)[0]))
    return np.asarray(ii), np.asarray(jj)


def cells_dataset(ds, lead, ii, jj):
    """Variables of ``ds`` (dims (lead, lat, lon)) at the cells (ii, jj),
    as a Dataset of (lead, 1, n) variables."""
    from xmhw_tpu_torch.xrlite import Coord, DataArray, Dataset

    out = Dataset()
    for k in ds.keys():
        v = np.asarray(ds[k].data)[:, ii, jj]
        out[k] = DataArray(
            v[:, None, :], (lead, "lat", "lon"),
            {lead: Coord((lead,), ds[k].coords[lead].values),
             "lat": Coord(("lat",), [0.0]),
             "lon": Coord(("lon",), np.arange(len(ii), dtype=float))},
            dict(ds[k].attrs))
    return out


def cell_events(data, keep):
    """The rows of one cell's event variables where ``keep``."""
    return {k: np.asarray(v)[keep] for k, v in data.items()}


def events_agree(a, b, what, rtol, atol):
    """Two cells' event rows: the same count and times, floats within
    atol + rtol * |b| (NaN patterns equal). Returns the largest |diff|."""
    from xmhw_tpu_torch.core.features_scan import TABLE_VARS

    worst = 0.0
    for k in TABLE_VARS:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.shape != y.shape:
            raise AssertionError(f"{what} {k}: {x.shape} events against "
                                 f"{y.shape}")
        if np.issubdtype(x.dtype, np.datetime64):
            if not np.array_equal(x.astype("i8"), y.astype("i8")):
                raise AssertionError(f"{what} {k}: times differ")
            continue
        x, y = x.astype(np.float64), y.astype(np.float64)
        if not np.array_equal(np.isfinite(x), np.isfinite(y)):
            raise AssertionError(f"{what} {k}: NaN patterns differ")
        f = np.isfinite(x)
        d = np.abs(x[f] - y[f])
        if d.size and (d > atol + rtol * np.abs(y[f])).any():
            raise AssertionError(f"{what} {k}: max |diff| {d.max():.3g} "
                                 f"past atol {atol}, rtol {rtol}")
        worst = max(worst, float(d.max()) if d.size else 0.0)
    return worst


def grid_cell(mhw, i, j):
    """One cell's events from a grid event Dataset (union or compact)."""
    keep = np.isfinite(np.asarray(mhw["event"].data)[:, i, j])
    return cell_events({k: np.asarray(mhw[k].data)[:, i, j]
                        for k in mhw.keys()}, keep)


def check_api(rep, dev, da, clim, mhw, seed, thr_kw, det_kw):
    """16 sampled ocean cells of the timed float32 output against the
    port's plain versions on the CPU at chip_smoke.py's reference bars;
    the same cells in float64 on ``dev`` against core/point.py (the host
    point path) in float64 at rtol 1e-9, atol 1e-12."""
    import xmhw_tpu_torch as xt

    cs = smoke()
    cells = sample_cells(da, seed)
    sub = sub_grid(da, cells)
    ii, jj = positions(clim, da, cells)
    ei, ej = positions(mhw, da, cells)
    cc = xt.threshold(sub, device="cpu", **thr_kw)
    mc = xt.detect(sub, cc["thresh"], cc["seas"], device="cpu",
                   events_layout="compact", **det_kw)
    err = {"thresh": 0.0, "seas": 0.0, "events": 0.0}
    n_ev = 0
    for c in range(len(cells)):
        for v in ("thresh", "seas"):
            a = np.asarray(clim[v].data)[:, ii[c], jj[c]]
            b = np.asarray(cc[v].data)[:, 0, c]
            err[v] = max(err[v], cs.max_err(cs._t(a), cs._t(b),
                                            f"{rep.cell} {v}", cs.TOL[v]))
        got, want = grid_cell(mhw, ei[c], ej[c]), grid_cell(mc, 0, c)
        n_ev += len(want["event"])
        err["events"] = max(err["events"], events_agree(
            got, want, f"{rep.cell} cell {c} events", cs.TOL["scan"],
            cs.TOL["scan"]))
    # float64 on the device against the host point path
    g = xt.threshold(sub, device=dev, dtype=np.float64, **thr_kw)
    m = xt.detect(sub, g["thresh"], g["seas"], device=dev, dtype=np.float64,
                  events_layout="compact", **det_kw)
    for c in range(len(cells)):
        pt = sub.isel(lat=0, lon=c)
        p = xt.threshold(pt, device=dev, dtype=np.float64, **thr_kw)
        pm = xt.detect(pt, p["thresh"], p["seas"], device=dev,
                       dtype=np.float64, **det_kw)
        want = {v: p[v].data for v in ("thresh", "seas")}
        keep = np.isfinite(np.asarray(pm["event"].data))
        rows = cell_events({k: pm[k].data for k in pm.keys()}, keep)
        for v, w in want.items():
            np.testing.assert_allclose(
                np.asarray(g[v].data)[:, 0, c], w, equal_nan=True,
                err_msg=f"{rep.cell} float64 {v} cell {c}", **F64)
        events_agree(grid_cell(m, 0, c), rows, f"{rep.cell} float64 cell "
                     f"{c}", F64["rtol"], F64["atol"])
    if n_ev == 0:
        raise AssertionError(f"{rep.cell}: the sampled cells hold no event")
    for k, v in err.items():
        rep.add(f"plain_max_{k}", v, f"|diff| ({len(cells)} cells, "
                "float32, against the CPU)")
    rep.add("checked_events", n_ev, f"events ({len(cells)} cells; float64 "
            "also against the point path)")
    return cells, ei, ej


def tasman_regional(devices, seed, card, *, years=40, grid=50, reps=5,
                    trace_dir=None):
    """bench.py:628-687: threshold() + detect() (union layout) of a
    grid x grid region, 30 % land, daily, float32."""
    import xmhw_tpu_torch as xt

    dev = devices[0]
    rep = Report("tasman_regional", card)
    da = host_grid(daily(2022 - years, 2021), grid, grid, seed=[seed, 2])

    def call(tr):
        with tr.span("threshold"):
            clim = xt.threshold(da, device=dev)
        with tr.span("detect"):
            mhw = xt.detect(da, clim["thresh"], clim["seas"], device=dev)
        return clim, mhw

    clim, mhw = api_cell(rep, devices, call, ocean_cells(da), reps,
                         HOST_LAYERS, trace_dir)
    rep.add("events", int(np.isfinite(mhw["event"].data).sum()), "events")
    check_api(rep, dev, da, clim, mhw, seed, {}, {})
    return rep


def monthly_tstep(devices, seed, card, *, years=40, grid=50, reps=5,
                  trace_dir=None):
    """bench.py:690-730: monthly steps through the tstep path."""
    import xmhw_tpu_torch as xt

    dev = devices[0]
    rep = Report("monthly_tstep", card)
    t = np.array([np.datetime64(f"{1982 + m // 12:04d}-{m % 12 + 1:02d}-15",
                                "ns") for m in range(12 * years)])
    da = host_grid(t, grid, grid, seed=[seed, 4], period=12, smooth=False)
    det_kw = dict(tstep=True, minDuration=3, maxGap=1)

    def call(tr):
        with tr.span("threshold"):
            clim = xt.threshold(da, tstep=True, device=dev)
        with tr.span("detect"):
            mhw = xt.detect(da, clim["thresh"], clim["seas"], device=dev,
                            **det_kw)
        return clim, mhw

    clim, mhw = api_cell(rep, devices, call, ocean_cells(da), reps,
                         HOST_LAYERS, trace_dir)
    rep.add("steps", len(t), "months")
    rep.add("events", int(np.isfinite(mhw["event"].data).sum()), "events")
    check_api(rep, dev, da, clim, mhw, seed, {"tstep": True}, det_kw)
    return rep


def stats_pipeline(devices, seed, card, *, years=40, grid=50, reps=5,
                   trace_dir=None):
    """bench.py:733-771: threshold + detect(compact) + block_average on
    the device + mhw_rank."""
    import xmhw_tpu_torch as xt

    dev = devices[0]
    rep = Report("stats_pipeline", card)
    y0 = 2022 - years
    da = host_grid(daily(y0, 2021), grid, grid, seed=[seed, 5])

    def call(tr):
        with tr.span("threshold"):
            clim = xt.threshold(da, device=dev)
        with tr.span("detect"):
            mhw = xt.detect(da, clim["thresh"], clim["seas"], device=dev,
                            events_layout="compact")
        with tr.span("block_average"):
            block = xt.block_average(mhw, period=[y0, 2021], device=dev)
        with tr.span("mhw_rank"):
            rank, _ = xt.mhw_rank(mhw, device=dev)
        return clim, mhw, block, rank

    layers = dict(HOST_LAYERS,
                  block_average=[("xmhw_tpu_torch/stats_api.py",
                                  "block_average")],
                  mhw_rank=[("xmhw_tpu_torch/stats_api.py", "mhw_rank")])
    clim, mhw, block, rank = api_cell(
        rep, devices, call, ocean_cells(da), reps, layers, trace_dir,
        launch_spans=("block_average", "mhw_rank"))
    cells, ei, ej = check_api(rep, dev, da, clim, mhw, seed, {}, {})
    # the stats of the sampled cells against the host numpy path on the
    # same cells of the timed event tables
    cs = smoke()
    sub = cells_dataset(mhw, "ev", ei, ej)
    host = xt.block_average(sub, period=[y0, 2021], device=False)
    errs = cs.stats_agree(cells_dataset(block, "years", ei, ej), host,
                          f"{rep.cell} block_average")
    hrank, _ = xt.mhw_rank(sub, device=False)
    for k in hrank.keys():
        if not np.array_equal(np.asarray(rank[k].data)[:, ei, ej],
                              np.asarray(hrank[k].data)[:, 0, :],
                              equal_nan=True):
            raise AssertionError(f"{rep.cell} mhw_rank {k}: card != host")
    rep.add("block_vars", len(list(block.keys())), "variables")
    rep.add("ranked_vars", len(list(rank.keys())), "variables")
    rep.add("stats_max_event_diff", errs["event"],
            f"|diff| ({len(cells)} cells, against the host path)")
    return rep


def single_point(devices, seed, card, *, years=30, reps=20, trace_dir=None):
    """bench.py:597-625: one daily series through the public API, which
    runs it on the host (core/point.py)."""
    import xmhw_tpu_torch as xt

    dev = devices[0]
    rep = Report("single_point", card)
    da = host_grid(daily(2022 - years, 2021), 1, 1, seed=[seed, 1], land=0.0)
    pt = da.isel(lat=0, lon=0)

    def call(tr):
        with tr.span("threshold"):
            clim = xt.threshold(pt, device=dev)
        with tr.span("detect"):
            mhw = xt.detect(pt, clim["thresh"], clim["seas"], device=dev)
        return clim, mhw

    layers = {"point_clim": [("xmhw_tpu_torch/core/point.py", "point_clim")],
              "point_detect": [("xmhw_tpu_torch/core/point.py",
                                "point_detect")],
              "assembly": HOST_LAYERS["assembly"]}
    clim, mhw = api_cell(rep, devices, call, 1, reps, layers, trace_dir)
    rep.add("events", int(np.isfinite(mhw["event"].data).sum()), "events")
    # the timed float32 output against the same path in float64 at
    # chip_smoke.py's bars (the point path computes in float64 and rounds
    # its outputs once); float64 against the grid path on the device
    cs = smoke()
    p = xt.threshold(pt, device=dev, dtype=np.float64)
    pm = xt.detect(pt, p["thresh"], p["seas"], device=dev, dtype=np.float64)
    keep = np.isfinite(np.asarray(pm["event"].data))
    if not keep.any():
        raise AssertionError("single_point: no event in the series")
    p_rows = cell_events({k: pm[k].data for k in pm.keys()}, keep)
    for v in ("thresh", "seas"):
        rep.add(f"f64_max_{v}", cs.max_err(
            cs._t(clim[v].data), cs._t(p[v].data), f"single_point {v}",
            cs.TOL[v]), "|diff| (float32 against float64)")
    keep32 = np.isfinite(np.asarray(mhw["event"].data))
    rep.add("f64_max_events", events_agree(
        cell_events({k: mhw[k].data for k in mhw.keys()}, keep32), p_rows,
        "single_point events", cs.TOL["scan"], cs.TOL["scan"]),
        "|diff| (float32 against float64)")
    g = xt.threshold(da, device=dev, dtype=np.float64)
    gm = xt.detect(da, g["thresh"], g["seas"], device=dev, dtype=np.float64,
                   events_layout="compact")
    for v in ("thresh", "seas"):
        np.testing.assert_allclose(np.asarray(g[v].data)[:, 0, 0],
                                   p[v].data, equal_nan=True, **F64)
    events_agree(grid_cell(gm, 0, 0), p_rows, "single_point float64",
                 F64["rtol"], F64["atol"])
    return rep


CELLS = {  # name -> (cards, function)
    "global_fused": (1, global_fused),
    "tasman_regional": (1, tasman_regional),
    "monthly_tstep": (1, monthly_tstep),
    "stats_pipeline": (1, stats_pipeline),
    "single_point": (1, single_point),
    "global_fused_mesh4": (4, global_fused_mesh4),
}
ONE_CARD = [k for k, (n, _) in CELLS.items() if n == 1]
LEFT_OUT = {"global_streamed": (
    "bench.py's file-to-file config reads and writes NetCDF through h5py, "
    "which the H100 machine does not have; its numpy stand-in's raw files "
    "would misstate HDF5's cost")}


# ------------------------------------------------------------------ main

def cards():
    """nvidia-smi's name and power limit of each visible card."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return [ln.strip() for ln in r.stdout.strip().splitlines()]


def headline(reports):
    """The short last line: the one-card fused rate (or the four-card
    one, per card), else the first cell's rate."""
    if "global_fused" in reports or "global_fused_mesh4" in reports:
        mesh = "global_fused" not in reports
        rate = reports["global_fused_mesh4" if mesh else "global_fused"
                       ].metrics["cells_per_sec"][0] / (4 if mesh else 1)
        return {"metric": "threshold_detect_cells_per_sec_per_chip",
                "value": round(rate, 1), "unit": "cells/s",
                "vs_target": round(rate / TARGET, 2)}
    name, rep = next(iter(reports.items()))
    return {"metric": f"{name}_cells_per_sec",
            "value": round(rep.metrics["cells_per_sec"][0], 1),
            "unit": "cells/s"}


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cell", action="append", choices=list(CELLS),
                   help="a cell to run (repeatable); default: the five "
                        "one-card cells")
    p.add_argument("--detail", default="bench_torch_detail.json",
                   help="where to write every number as JSON")
    p.add_argument("--trace-dir", default=None,
                   help="keep each cell's profiler trace here")
    p.add_argument("--budget-s", type=int, default=1800,
                   help="stop, and exit non-zero, after this many seconds")
    return p.parse_args(argv)


def main(argv=None):
    args = parse(sys.argv[1:] if argv is None else argv)
    import torch

    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device visible "
              "(torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from xmhw_tpu_torch.ops import _build

    names = args.cell or ONE_CARD
    smi = cards()
    for ln in smi:
        print(ln, flush=True)
    need = max(CELLS[n][0] for n in names)
    if len(smi) < need:
        print(f"bench_torch: {names} need {need} cards, {len(smi)} visible",
              file=sys.stderr)
        return 1
    t = time.perf_counter()
    _build.library()
    print(f"set-up: kernels built and loaded in {time.perf_counter() - t:.1f}"
          f" s; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    def spent(signum, frame):
        raise TimeoutError(f"the budget of {args.budget_s} s is spent")

    signal.signal(signal.SIGALRM, spent)
    signal.alarm(args.budget_s)
    reports, failed = {}, {}
    devices = [torch.device("cuda", i) for i in range(len(smi))]
    try:
        for name in names:
            n, fn = CELLS[name]
            card = smi[0] if n == 1 else "; ".join(smi[:n])
            t = time.perf_counter()
            try:
                rep = fn(devices[:n], args.seed, card,
                         trace_dir=args.trace_dir)
            except Exception:  # noqa: BLE001 — recorded, the run fails
                failed[name] = traceback.format_exc()
                print(f"{name}: FAILED\n{failed[name]}", flush=True)
                if "budget" in failed[name]:
                    break
                continue
            reports[name] = rep
            for ln in rep.lines():
                print(ln, flush=True)
            print(f"{name}: done in {time.perf_counter() - t:.1f} s",
                  flush=True)
    finally:
        signal.alarm(0)
    with open(args.detail, "w") as f:
        json.dump({"cards": smi, "torch": torch.__version__,
                   "seed": args.seed,
                   "cells": {k: r.detail() for k, r in reports.items()},
                   "failed": failed, "left_out": LEFT_OUT}, f, indent=1)
    not_run = [n for n in names if n not in reports and n not in failed]
    if failed or not_run:
        print(f"bench_torch: FAILED {sorted(failed)}; not run {not_run}",
              file=sys.stderr)
        return 1
    print(json.dumps(headline(reports)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
