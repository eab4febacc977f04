#!/usr/bin/env python3
"""The notebook workflow cell at full size: step times by box size, and
one step's whole box held against the reference (the benchmark's own
runs judge a sample; this tool does not run in them):

    python3 benchmark/workflow_check.py --seed <n> [--sides 50,40,...] \\
        [--steps <n>] [--check] [--workers <n>] [--block <cells>] \\
        [--workload tasman_workflow] [--device cuda:0]

For each side in ``--sides`` (default: the configuration's own box), the
cell's configuration with the centred square sub-box of that many cells
a side of its source's box (``source_grid``), at the configuration's
land share; its inputs made from
the seed, the entry's warm-up, then ``--steps`` timed steps (the four
calls and one synchronisation). One JSON line each: the box, its ocean
cells, the warm-up's and the steps' walls and the program's intermediate
counters, and the host seconds a step of each call and of the stages
``detect`` adds for the intermediate series (``inter_store``,
``assemble_inter``).

With ``--check``, the last step of the last side is held whole against
the float64 reference, in blocks of cells on ``--workers`` processes:
every ocean cell's climatology, events, union rows and year-block event
statistics by the cell's judge (``reference/judge.py``, the cell's
limits), and its 15 intermediate series, day statistics, ranks and
return periods by ``reference/workflow.py`` (its :data:`LIMITS`, and the
cell's ``clim_gap`` and ``event_gap`` for the intermediate series). One
JSON line: the readings beside their limits and ``correct``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import multiprocessing  # noqa: E402
import sys  # noqa: E402
from concurrent.futures import ProcessPoolExecutor  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parent.parent)

import numpy as np  # noqa: E402

from benchmark.lib import harness, inputs, spec  # noqa: E402
from benchmark.reference import workflow  # noqa: E402
from benchmark.reference.judge import Setup, verdict  # noqa: E402
from benchmark.whole_step import judge_block, merge  # noqa: E402

SUMMED = ("inter_days_off", "day_counts_off", "rank_off")


def sub_box(cfg, side):
    """``cfg`` with its source's box (``source_grid``, where the
    configuration cut it, else ``grid``) cut to the centred square of
    ``side`` cells a side (even, as the box's), the land share kept."""
    g = cfg.get("source_grid", cfg["grid"])
    n = int(round((g["lat"][1] - g["lat"][0]) / g["step"])) + 1
    if side > n or (n - side) % 2:
        raise ValueError(f"no centred {side}-cell sub-box of {n} cells")
    off = (n - side) // 2 * g["step"]
    last = (side - 1) * g["step"]
    out = dict(cfg)
    out["grid"] = {"lat": [g["lat"][0] + off, g["lat"][0] + off + last],
                   "lon": [g["lon"][0] + off, g["lon"][0] + off + last],
                   "step": g["step"]}
    out["ocean_cells"] = side * side - round(cfg["land_share"] * side * side)
    return out


@contextlib.contextmanager
def call_clocks():
    """Host seconds of the workflow's calls and of the stages inside
    ``detect`` that it adds, summed by name while the context is open."""
    import xmhw_tpu_torch as xt
    from xmhw_tpu_torch import api, stats_api
    from xmhw_tpu_torch.core import pipeline

    where = {"threshold": (xt, "threshold"), "detect": (xt, "detect"),
             "inter_store": (pipeline, "_store_inter"),
             "assemble_inter": (api, "_assemble_inter"),
             "block_average": (stats_api, "block_average"),
             "mhw_rank": (stats_api, "mhw_rank")}
    secs = dict.fromkeys(where, 0.0)
    saved = [(m, a, getattr(m, a)) for m, a in where.values()]

    def clock(name, fn):
        def inner(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                secs[name] += time.perf_counter() - t
        return inner

    for name, (m, a) in where.items():
        setattr(m, a, clock(name, getattr(m, a)))
    try:
        yield secs
    finally:
        for m, a, fn in saved:
            setattr(m, a, fn)


def check_block(cases, cells, setup, lim):
    """The judge's and the workflow comparison's readings of a block."""
    jv, jw, _ = judge_block(cases, setup, lim["clim_gap"])
    wv, ww, ref, products = workflow.check(cells, setup, lim["clim_gap"],
                                           lim["event_gap"])
    return jv, jw, wv, ww, workflow.event_span(ref), products


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="tasman_workflow")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--sides", default="")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--check", action="store_true")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--block", type=int, default=32)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    import torch

    from xmhw_tpu_torch import utils

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("workflow_check: no CUDA device", file=sys.stderr)
        return 2
    b = spec.bench()
    c = spec.cell(args.workload, b)
    cfg0, tr = spec.config(c["config"], b), spec.traffic(c["traffic"])
    lim = spec.limits(c["name"])
    sides = [int(s) for s in args.sides.split(",") if s] or [None]
    for side in sides:
        cfg = cfg0 if side is None else sub_box(cfg0, side)
        e = None  # the last side's outputs go before this side's inputs
        run = harness.Run(c["name"], cfg, tr, args.seed, [dev])
        e = spec.module("entries", tr["entry"]).Entry(run)
        t = time.perf_counter()
        e.warm()
        warm_s = time.perf_counter() - t
        before = utils.counts()
        walls = []
        with call_clocks() as secs:
            for i in range(args.steps):
                t = time.perf_counter()
                e.step(len(e.warm_walls) + i)
                walls.append(time.perf_counter() - t)
        after = utils.counts()
        print(json.dumps({
            "workload": c["name"], "seed": args.seed, "side": side,
            "grid": cfg["grid"], "ocean_cells": e.cells_per_step,
            "warm_walls_s": e.warm_walls, "warm_s": warm_s,
            "step_walls_s": walls, "step_median_s": float(np.median(walls)),
            "call_s_per_step": {k: v / args.steps for k, v in secs.items()},
            "counters": {k: v - before.get(k, 0) for k, v in after.items()
                         if k.startswith(("inter", "union"))},
            "device": harness.card([dev]),
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))
            if dev.type == "cuda" else 0}), flush=True)
    if not args.check:
        return 0
    t = time.perf_counter()
    cases, cells = e.workflow_cells()
    e.free()
    setup = Setup.of(cfg, inputs.dates(cfg["record"]), tr["year_bins"])
    k = args.block
    parts = [(cases[a:a + k], cells[a:a + k])
             for a in range(0, len(cases), k)]
    del cases, cells
    with ProcessPoolExecutor(
            args.workers,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        got = list(pool.map(check_block, *zip(*parts),
                            [setup] * len(parts), [lim] * len(parts)))
    values, worst = merge([(jv, jw, None) for jv, jw, *_ in got])
    for _, _, wv, ww, _, _ in got:
        for name, v in wv.items():
            if name in SUMMED:
                values[name] = values.get(name, 0) + v
                if v:
                    worst[name] = ww.get(name)
            elif name not in values or v > values[name]:
                values[name] = v
                worst[name] = ww.get(name)
    spans = [s for *_, s, _ in got if s is not None]
    nyears = workflow.n_years(setup.dates, (
        min(a for a, _ in spans), max(b for _, b in spans)) if spans
        else None)
    values["return_period_gap"] = workflow.return_period_gap(
        [p for *_, p in got], nyears)
    limits = {**lim, **workflow.LIMITS, "inter_clim_gap": lim["clim_gap"],
              "inter_gap": lim["event_gap"]}
    correct, rows = verdict(values, limits)
    print(json.dumps({
        "workload": c["name"], "seed": args.seed, "cells": e.cells_per_step,
        "correct": bool(correct),
        "checks": {n: {"value": r, "limit": x} for n, r, x in rows},
        "worst_cells": worst, "nyears": nyears,
        "check_s": time.perf_counter() - t,
        "process_s": time.perf_counter() - T0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
