#!/usr/bin/env python3
"""One traced run of a cell, as ``run.py --trace 1`` makes it, reduced
also by the program's own ``xmhw/`` spans and counters:

    python3 benchmark/program_trace.py --workload <cell> --seed <n> \\
        --seconds <s> [--out <file.json>]

Prints ``run.py``'s result line, with ``breakdown`` naming each idle gap
by the innermost program span open at it, as the last line of standard
output; ``--out`` gets the whole reduction: :func:`lib.program.analyse`
of the stretch, the program's counters over the window and over the
stretch, the traced steps' walls, and per call or block the readings
that the program's spans give (``land_check``, ``assemble``,
``clim_tables`` and ``upload`` walls; copies and detection passes). The
harness reads none of this yet: the tool wraps its ``counters``, ``Run``
and ``trace.analyse`` for the run.
"""

import contextlib
import json
import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from benchmark.lib import harness, program, trace  # noqa: E402

COUNTERS = ("h2d_bytes", "d2h_bytes", "detect_passes", "detect_blocks")


def _program_counts():
    from xmhw_tpu_torch import utils

    read = getattr(utils, "counts", None)
    c = read() if read is not None else {}
    return {k: c.get(k, 0) for k in COUNTERS}


@contextlib.contextmanager
def capture():
    """Wrap the harness while the context is open; yields the dict the
    wrappers fill: ``run``, ``out`` (the result line), ``program`` (the
    reduction of the stretch's program spans) and ``stretch_counts``
    (the program's counters as the stretch opened and closed)."""
    got = {"stretch_counts": []}
    saved = [(harness, "counters"), (harness, "Run"), (harness, "execute"),
             (trace, "analyse"), (trace.Stretch, "before"),
             (trace.Stretch, "close")]
    saved = [(o, a, getattr(o, a)) for o, a in saved]
    counters, make_run, execute, analyse, before, close = (
        f for _, _, f in saved)

    def all_counters():
        return {**counters(), **_program_counts()}

    def run(*a, **kw):
        got["run"] = make_run(*a, **kw)
        return got["run"]

    def execute_kept(*a, **kw):
        got["out"], rows = execute(*a, **kw)
        return got["out"], rows

    def analyse_both(events):
        got["program"] = program.analyse(events)
        return analyse(events)

    def stretch_before(self, i):
        was = self.active
        before(self, i)
        if self.active and not was:
            got["stretch_counts"].append(_program_counts())

    def stretch_close(self):
        if self.active:
            self.sync()
            got["stretch_counts"].append(_program_counts())
        close(self)

    for (o, a, _), f in zip(saved, (all_counters, run, execute_kept,
                                    analyse_both, stretch_before,
                                    stretch_close)):
        setattr(o, a, f)
    try:
        yield got
    finally:
        for o, a, f in saved:
            setattr(o, a, f)


def reduce(got):
    """The readings of one captured run (see the module docstring)."""
    run, prog = got["run"], got.get("program")
    if prog is None or run.trace is None:
        return None
    steps = run.trace["spans"].get("step", [])
    blocks = (run.blocks_traced() if "cells_per_block" in run.traffic
              else None)
    wall = prog["wall_s"]
    c0, c1 = (got["stretch_counts"] + [None, None])[:2]
    stretch = ({k: c1[k] - c0[k] for k in COUNTERS} if c0 and c1
               else None)

    def per(x, n):
        return None if x is None or not n else x / n

    out = {"cell": run.cell, "seed": run.seed, "device": run.kind,
           "power_limit": run.power_limit,
           "traced_steps": run.traced_steps, "blocks_traced": blocks,
           "step_walls_s": [b - a for a, b in steps],
           "window_counts": {k: run.counters.get(k) for k in COUNTERS},
           "stretch_counts": stretch, "program": prog,
           "bench_spans_s": {k: sum(b - a for a, b in v)
                             for k, v in run.trace["spans"].items()}}
    host = (out["bench_spans_s"].get("step", 0.0)
            - out["bench_spans_s"].get("run_clim", 0.0)
            - out["bench_spans_s"].get("run_detect", 0.0))
    api_self = prog["self_s"].get("threshold", 0.0) + prog["self_s"].get(
        "detect", 0.0)
    r = {
        "api_land_check_ms_per_call": per(1e3 * wall.get("land_check", 0),
                                          len(steps)),
        "api_assemble_ms_per_call": per(1e3 * wall.get("assemble", 0),
                                        len(steps)),
        "clim_tables_ms_per_block": per(1e3 * wall.get("clim_tables", 0),
                                        blocks),
        "upload_ms_per_block": per(1e3 * wall.get("upload", 0), blocks),
        "api_host_ms_per_call": per(1e3 * host, len(steps)),
        "api_self_ms_per_call": per(1e3 * api_self, len(steps)),
    }
    if stretch:
        nb = stretch["detect_blocks"]
        r["h2d_mb_per_block"] = per(stretch["h2d_bytes"] / 1e6, nb)
        r["d2h_mb_per_block"] = per(stretch["d2h_bytes"] / 1e6, nb)
        r["detect_passes_per_block"] = per(stretch["detect_passes"], nb)
        r["h2d_counted_over_traced"] = per(
            stretch["h2d_bytes"], prog["copy_bytes"].get("HtoD"))
        r["d2h_counted_over_traced"] = per(
            stretch["d2h_bytes"], prog["copy_bytes"].get("DtoH"))
    out["readings"] = r
    return out


def main(argv):
    out_path = None
    if "--out" in argv:
        k = argv.index("--out")
        out_path = argv[k + 1]
        argv = argv[:k] + argv[k + 2:]
    with capture() as got:
        rc = harness.main(argv + ["--trace", "1"], T0)
    if rc or "out" not in got:
        return rc or 1
    red = reduce(got)
    if red is not None and "breakdown" in got["out"]:
        got["out"]["breakdown"] = program.breakdown(got["run"].trace,
                                                    red["program"])
    if out_path and red is not None:
        with open(out_path, "w") as f:
            json.dump(red, f, indent=1)
    print(json.dumps({**got["out"], "program_readings":
                      red["readings"] if red else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
