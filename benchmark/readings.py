#!/usr/bin/env python3
"""The readings that a cell's limits are set from, many seeds in one
process (the benchmark's own runs do not run this):

    python3 benchmark/readings.py --workload <cell> --seconds <s> \\
        --seeds <n>,<n>,... [--control-seeds <n>,<n>,...]

For each seed of ``--seeds`` a whole run of the cell (set-up, a window of
``--seconds``, the judge) and its readings, the program's lower ones. For
each seed of ``--control-seeds``, the control (the reference in
bfloat16, ``reference/control.py``) in the program's place on the cells
a run of that seed samples, at the cell's own size: the upper readings.
One JSON line each; the largest program and the smallest control reading
of each number at the end.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parent.parent)

import numpy as np  # noqa: E402

from benchmark.lib import harness, inputs, spec  # noqa: E402
from benchmark.reference import control  # noqa: E402
from benchmark.reference.judge import Setup, judge  # noqa: E402


def control_readings(c, cfg, tr, lim, seed, devices):
    run = harness.Run(c["name"], cfg, tr, seed, devices)
    e = spec.module("entries", tr["entry"]).Entry(run)
    e.warm()
    # as many steps and cells as a run judges: its sampled steps' and
    # its last's
    for i in range(tr["sample"]["calls"] + 1):
        e.step(i)
        e.keep_last(None)
    run.sync()
    cases = e.cases(np.random.default_rng([seed, 11]),
                    tr["sample"]["cells_per_call"])
    e.free()
    setup = Setup.of(cfg, inputs.dates(cfg["record"]), tr.get("year_bins"))
    ts = np.stack([np.asarray(k.ts) for k in cases], axis=1)
    cc = control.cases(ts, setup, with_stats=tr.get("year_bins") is not None)
    return judge(cc, setup, lim["clim_gap"]).values


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    b = spec.bench()
    c = spec.cell(args.workload, b)
    cfg, tr = spec.config(c["config"], b), spec.traffic(c["traffic"])
    lim = spec.limits(c["name"])
    devices = [torch.device("cuda", k) for k in range(c["chips"])]
    low, up = {}, {}
    for s in filter(None, args.seeds.split(",")):
        out, rows = harness.execute(c["name"], cfg, tr, lim, [], int(s),
                                    args.seconds, False, devices,
                                    time.perf_counter())
        vals = {n: r for n, r, _ in rows}
        print(json.dumps({"seed": int(s), "program": vals,
                          "correct": out["correct"],
                          "worst": out["worst_cells"]}), flush=True)
        for n, r in vals.items():
            low[n] = max(low.get(n, r), r)
    for s in filter(None, args.control_seeds.split(",")):
        vals = control_readings(c, cfg, tr, lim, int(s), devices)
        print(json.dumps({"seed": int(s), "control": vals}), flush=True)
        for n, r in vals.items():
            up[n] = min(up.get(n, r), r)
    print(json.dumps({"cell": c["name"], "program_max": low,
                      "control_min": up}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
