#!/usr/bin/env python3
"""One whole step of an API cell at full size, every ocean cell judged
(the benchmark's own runs judge a sample; this tool does not run in
them):

    python3 benchmark/whole_step.py --workload <cell> --seed <n> \\
        [--workers <n>] [--block <cells>] [--device cuda]

Makes the cell's inputs from the seed, runs one step (``threshold()``
then ``detect()`` in the traffic's layout) on the first card (or on
``--device``), and holds
every ocean cell's climatology and events, and their rows of the events
coordinate, against the float64 reference (``reference/judge.py``), in
blocks of cells on ``--workers`` processes. The events coordinate is
also compared with the reference's own: the sorted distinct start days
of the reference's events over all cells. Prints one JSON line: the
readings beside the cell's limits, ``correct``, the coordinate's rows,
those it has and the reference lacks and the reverse, the step's wall
and the program's union counters.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import multiprocessing  # noqa: E402
import sys  # noqa: E402
from concurrent.futures import ProcessPoolExecutor  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parent.parent)

import numpy as np  # noqa: E402

from benchmark.lib import harness, inputs, spec  # noqa: E402
from benchmark.reference import calendar  # noqa: E402
from benchmark.reference.clim import clim_many  # noqa: E402
from benchmark.reference.judge import Setup, judge, verdict  # noqa: E402
from benchmark.reference.oracle import events_oracle  # noqa: E402

SUMMED = ("event_cells_off", "event_fields_off")


def judge_block(cases, setup, limit):
    """(readings, worst cells, the reference's start days) of a block."""
    r = judge(cases, setup, limit)
    doy, ndoy = calendar.rows(setup.dates, setup.tstep)
    x = np.stack([np.asarray(c.ts, np.float64) for c in cases], axis=1)
    th, se = clim_many(x, doy, ndoy, setup.w, setup.pctile, setup.smooth,
                       setup.smooth_w, feb29=not setup.tstep)
    starts = set()
    for j in range(x.shape[1]):
        for e in events_oracle(x[:, j], th[doy - 1, j], se[doy - 1, j],
                               setup.min_duration, setup.join_gaps,
                               setup.max_gap):
            starts.add(int(e["index_start"]))
    return r.values, r.worst, starts


def merge(parts):
    values, worst = {}, {}
    for v, w, _ in parts:
        for k, x in v.items():
            if k in SUMMED:
                values[k] = values.get(k, 0) + x
            elif k not in values or x > values[k]:
                values[k] = x
                worst[k] = w.get(k)
    return values, worst


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--block", type=int, default=64)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("whole_step: no CUDA device", file=sys.stderr)
        return 2
    b = spec.bench()
    c = spec.cell(args.workload, b)
    cfg, tr = spec.config(c["config"], b), spec.traffic(c["traffic"])
    lim = spec.limits(c["name"])
    from xmhw_tpu_torch import utils

    run = harness.Run(c["name"], cfg, tr, args.seed, [dev])
    e = spec.module("entries", tr["entry"]).Entry(run)
    before = utils.counts()
    t = time.perf_counter()
    e.step(0)
    run.sync()
    wall = time.perf_counter() - t
    after = utils.counts()
    counters = {k: v - before.get(k, 0) for k, v in after.items()
                if k.startswith("union")}
    i, clim, mhw = e.last
    coord = np.asarray(mhw.coords["events"].values).astype(np.int64)
    # the entry's sample of every ocean cell: its cases in full
    tr["sample"]["cells_per_call"] = e.cells_per_step
    cases = e._sample(i, clim, mhw)
    e.free()
    setup = Setup.of(cfg, inputs.dates(cfg["record"]), tr.get("year_bins"))
    blocks = [cases[k:k + args.block]
              for k in range(0, len(cases), args.block)]
    t = time.perf_counter()
    with ProcessPoolExecutor(
            args.workers,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        parts = list(pool.map(judge_block, blocks,
                              [setup] * len(blocks),
                              [lim["clim_gap"]] * len(blocks)))
    judged_s = time.perf_counter() - t
    values, worst = merge(parts)
    correct, rows = verdict(values, lim)
    ref = np.array(sorted(set().union(*(s for _, _, s in parts))),
                   np.int64)
    out = {"workload": c["name"], "seed": args.seed,
           "cells": len(cases), "correct": bool(correct),
           "checks": {n: {"value": r, "limit": x} for n, r, x in rows},
           "worst_cells": worst,
           "events_rows": len(coord), "reference_rows": len(ref),
           "rows_not_in_reference": np.setdiff1d(coord, ref).tolist(),
           "reference_rows_missing": np.setdiff1d(ref, coord).tolist(),
           "step_wall_s": wall, "judge_s": judged_s,
           "union_counters": counters,
           "device": harness.card([dev]),
           "process_s": time.perf_counter() - T0}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
