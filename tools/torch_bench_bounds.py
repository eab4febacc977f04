#!/usr/bin/env python3
"""Regression bounds of bench_torch.py's end-to-end metrics, from repeated runs.

    python3 tools/torch_bench_bounds.py run1.json run2.json run3.json

Each argument is the ``--detail`` file of one ``bench_torch.py`` run on
one kind of card. For each cell and each end-to-end metric (every metric
with a ``_spread``: ``cells_per_sec``, ``with_stats_cells_per_sec``) it
prints, as a Markdown table, each run's median and spread ((max - min) /
median of its timed runs), the reference (the median of the runs'
medians), the bound (twice the largest spread seen) and the floor: a
later run's median below reference / (1 + bound) is a regression. Higher
is better for every such metric. Reads only the files it is given.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys


def bounds(details):
    """{(cell, metric): {"medians", "spreads", "reference", "bound",
    "floor", "unit"}} over the cells and metrics every run holds."""
    cells = [d["cells"] for d in details]
    out = {}
    for cell in cells[0]:
        if not all(cell in c for c in cells):
            continue
        runs = [c[cell]["metrics"] for c in cells]
        for name in runs[0]:
            if not all(f"{name}_spread" in r for r in runs):
                continue
            med = [r[name]["value"] for r in runs]
            spread = [r[f"{name}_spread"]["value"] for r in runs]
            ref = statistics.median(med)
            bound = 2 * max(spread)
            out[(cell, name)] = {"medians": med, "spreads": spread,
                                 "reference": ref, "bound": bound,
                                 "floor": ref / (1 + bound),
                                 "unit": runs[0][name]["unit"]}
    return out


def table(details, b):
    cards = sorted({c for d in details for c in d["cards"]})
    lines = [f"cards: {'; '.join(cards)}; {len(details)} runs", "",
             "| cell | metric | medians | spreads | reference | bound | "
             "floor |", "|---|---|---|---|---|---|---|"]
    for (cell, name), v in b.items():
        lines.append(
            f"| {cell} | {name} ({v['unit']}) | "
            + ", ".join(f"{x:.1f}" for x in v["medians"]) + " | "
            + ", ".join(f"{x:.3f}" for x in v["spreads"])
            + f" | {v['reference']:.1f} | {v['bound']:.3f} | "
            f"{v['floor']:.1f} |")
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("detail", nargs="+", help="bench_torch.py --detail files")
    args = p.parse_args(argv)
    details = []
    for path in args.detail:
        with open(path) as f:
            details.append(json.load(f))
    print(table(details, bounds(details)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
