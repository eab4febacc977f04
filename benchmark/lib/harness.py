"""One run of one cell: set-up, the measured window, the judge, the metrics
and the result line.

:func:`execute` takes everything a run reads as arguments, so a test can
drive a whole run at a small size on the CPU; :func:`main` reads them
from BENCHMARK.json and the files it names, and first looks for the
cards the cell asks for.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field

import numpy as np

from . import guard, inputs, spec, trace, work
from ..reference.judge import Setup, judge, verdict


@dataclass
class Run:
    """What a run knows; the metric readers read it."""
    cell: str
    cfg: dict
    traffic: dict
    seed: int
    devices: list
    setup_s: float = 0.0
    window_s: float = 0.0
    steps: int = 0
    cells_per_step: int = 0
    cells: int = 0
    trace: dict | None = None
    traced_steps: int = 0
    work: work.Recorder | None = None
    counters: dict = field(default_factory=dict)
    peaks: dict | None = None
    kind: str = ""
    power_limit: str | None = None

    def blocks_traced(self):
        """Cell blocks of the program's width in the traced steps."""
        return (self.traced_steps * self.cells_per_step
                / self.traffic["cells_per_block"])

    def sync(self):
        import torch

        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)


class Reservoir:
    """A uniform sample of ``k`` of the window's steps, drawn from ``rng``
    as the steps come (reservoir sampling), so that it needs no count of
    the steps in advance."""

    def __init__(self, k, rng):
        self.k, self.rng, self.slots = k, rng, []

    def offer(self, i):
        """(keep step i, the step it evicts or None)."""
        if len(self.slots) < self.k:
            self.slots.append(i)
            return True, None
        j = int(self.rng.integers(0, i + 1))
        if j >= self.k:
            return False, None
        old, self.slots[j] = self.slots[j], i
        return True, old


def counters():
    """The port's launch counters (program counters), as numbers."""
    from xmhw_tpu_torch.ops import detect_scan, doy_quantile, rle

    return {"doy_quantile.tile": doy_quantile.doy_quantile.by_route["tile"],
            "doy_quantile.long": doy_quantile.doy_quantile.by_route["long"],
            "rle": rle.mhw_filter.launches,
            "event_scan": detect_scan.event_stats.launches}


def card(devices):
    """(name, power limit) of the first card; the CPU's type otherwise."""
    import torch

    if devices[0].type != "cuda":
        return devices[0].type, None
    name = torch.cuda.get_device_name(devices[0])
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader", "-i",
                            str(devices[0].index or 0)],
                           capture_output=True, text=True, timeout=60)
        limit = r.stdout.strip() or None
    except (OSError, subprocess.TimeoutExpired):
        limit = None
    return name, limit


def execute(cell, cfg, traffic, lim, metric_defs, seed, seconds, traced,
            devices, t0):
    """One run; returns the result line's dict and the compared numbers as
    [(name, reading, limit)]."""
    import torch

    run = Run(cell, cfg, traffic, seed, devices)
    run.kind, run.power_limit = card(devices)
    run.peaks = work.peaks(run.kind)
    entry_mod = spec.module("entries", traffic["entry"])
    e = entry_mod.Entry(run)
    e.warm()
    s = traffic["sample"]
    sample = Reservoir(s["calls"], np.random.default_rng([seed, 7]))
    tr = traffic["trace"]
    stretch = (trace.Stretch(tr["first"], tr["steps"], run.sync) if traced
               else None)
    if traced:
        run.work = work.Recorder(tr["kernels"], lambda: stretch.active)
    spans = entry_mod.spans() if traced else {}
    before = counters()
    recording = run.work.wrapped() if run.work else contextlib.nullcontext()
    gc_s = [0.0, 0.0]  # seconds in the collector, start of the current

    def gc_clock(phase, info):
        if phase == "start":
            gc_s[1] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - gc_s[1]
    gc.callbacks.append(gc_clock)
    with trace.layer_spans(spans, traced), recording:
        t_w0 = time.perf_counter()
        run.setup_s = t_w0 - t0
        deadline = t_w0 + seconds
        i = 0
        ends = []
        # a traced run goes on past the deadline until its stretch is
        # profiled: it reports no end-to-end metric
        while (i == 0 or time.perf_counter() < deadline
               or (stretch and stretch.events is None)):
            if stretch:
                stretch.before(i)
            with trace.span("step", traced):
                e.step(i)
            keep, drop = sample.offer(i)
            if keep:
                e.keep_last(drop)
            if stretch:
                stretch.after(i)
            ends.append(time.perf_counter())
            i += 1
        run.sync()
        run.window_s = time.perf_counter() - t_w0
        if stretch:
            stretch.close()
    gc.callbacks.remove(gc_clock)
    walls = np.diff([t_w0] + ends)
    slow = [(int(k), round(float(walls[k]), 3))
            for k in np.flatnonzero(walls > 2 * np.median(walls))[:8]]
    print(f"benchmark: {gc_s[0]:.3f} s of the window in Python's garbage "
          f"collector; steps over twice the median wall: {slow}",
          file=sys.stderr)
    print(f"benchmark: {i} steps; host wall a step (issue to return, the "
          f"device may still run): median {np.median(walls):.4f} s, p90 "
          f"{np.quantile(walls, 0.9):.4f} s, max {walls.max():.4f} s",
          file=sys.stderr)
    after = counters()
    run.counters = {k: after[k] - before[k] for k in after}
    run.steps = i
    run.cells_per_step = e.cells_per_step
    run.cells = i * e.cells_per_step
    if stretch and stretch.events is not None:
        run.trace = trace.analyse(stretch.events)
        run.traced_steps = stretch.steps
        stretch.events = None
    peak = max((torch.cuda.max_memory_allocated(d) for d in devices
                if d.type == "cuda"), default=0)
    failed = e.failed()
    cases = e.cases(np.random.default_rng([seed, 11]),
                    s["cells_per_call"])
    e.free()
    del e
    gc.collect()
    if devices[0].type == "cuda":
        torch.cuda.empty_cache()
    bins = traffic.get("year_bins")
    setup = Setup.of(cfg, inputs.dates(cfg["record"]), bins)
    t = time.perf_counter()
    readings = judge(cases, setup, lim["clim_gap"])
    print(f"benchmark: the reference judged {len(cases)} cells in "
          f"{time.perf_counter() - t:.1f} s", file=sys.stderr)
    correct, rows = verdict(readings.values, lim)
    metrics = {}
    for m in metric_defs:
        v = spec.module("metrics", m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if devices[0].type == "cuda" else
           devices[0].type, "kind": run.kind, "count": len(devices),
           "memory_peak_bytes": int(peak), "power_limit": run.power_limit}
    out = {"correct": bool(correct), "attempted": run.steps,
           "failed": failed, "metrics": metrics, "device": dev}
    if run.trace is not None:
        busy = run.trace["busy_s"]
        dev["busy_s"] = sum(busy.values()) / len(devices)
        dev["window_s"] = run.trace["window_s"]
        out["breakdown"] = trace.breakdown(run.trace)
    out["worst_cells"] = readings.worst
    out["checks"] = {name: {"value": _number(r), "limit": lim_}
                     for name, r, lim_ in rows}
    return out, rows


def _number(v):
    """A reading for JSON: inf (a NaN where a number was due) as a
    string."""
    return v if v is None or np.isfinite(v) else str(v)


def parse(argv):
    p = argparse.ArgumentParser(
        description="Run one cell of BENCHMARK.json once and print its "
                    "result as the last line of standard output.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0):
    args = parse(argv)
    b = spec.bench()
    c = spec.cell(args.workload, b)
    import torch

    if not torch.cuda.is_available():
        print("benchmark: no CUDA device (torch.cuda.is_available() is "
              "False); the benchmark does not run on the CPU",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < c["chips"]:
        print(f"benchmark: {c['name']} needs {c['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    devices = [torch.device("cuda", k) for k in range(c["chips"])]
    defs = spec.metrics_of(c["name"], "per_layer" if args.trace
                           else "end_to_end", b)
    out, rows = execute(c["name"], spec.config(c["config"], b),
                        spec.traffic(c["traffic"]), spec.limits(c["name"]),
                        defs, args.seed, args.seconds, bool(args.trace),
                        devices, t0)
    bad = guard.forbidden()
    if bad:
        print(f"benchmark: the run imported {bad}; the port must not load "
              "JAX or the JAX package", file=sys.stderr)
        return 3
    for name, r, lim in rows:
        print(f"check {name}: {r} (limit {lim})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
