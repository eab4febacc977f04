"""Entry: ``core.pipeline.run_fused`` on host stripes without statistics,
a closed loop of one caller, on one card.

``run_fused.py``'s stripes, set-up and loop (the traffic file gives
``cells_per_stripe`` and ``stripes``; ``xrlite.alloc.tune_malloc()`` in
set-up; ``k_min`` the configuration's K), with the arguments
``stream_run`` passes for a stripe when it writes no block statistics:
the whole record's climatology and detection, no year bins and no
device ranks. A step uploads a stripe, runs the climatology and
detection, fetches the climatology and the event table, and stores
them.
"""

from __future__ import annotations

import numpy as np

from benchmark.entries import run_fused
from benchmark.lib import inputs
from benchmark.reference.judge import table_cases


def spans():
    from xmhw_tpu_torch.core import pipeline

    return {"upload": (pipeline, "upload"),
            "fetch_rows": (pipeline, "fetch_rows")}


class Entry(run_fused.Entry):
    def __init__(self, run):
        from xmhw_tpu_torch.core.calendar import compute_doy
        from xmhw_tpu_torch.xrlite import TimeIndex
        from xmhw_tpu_torch.xrlite.alloc import tune_malloc

        tune_malloc()
        cfg, tr = run.cfg, run.traffic
        d = cfg["definition"]
        self.run = run
        self.dates = inputs.dates(cfg["record"])
        self.doy, self.ndoy = compute_doy(TimeIndex(self.dates),
                                          keep_tstep=d["tstep"])
        self.kw = dict(
            w=d["windowHalfWidth"], ndoy=self.ndoy, pctile=d["pctile"],
            smooth=d["smoothPercentile"],
            smooth_w=d["smoothPercentileWidth"], patch_feb29=not d["tstep"],
            min_duration=d["minDuration"], join_gaps=d["joinGaps"],
            max_gap=d["maxGap"], rank_names=())
        self.dev = run.devices[0]
        self.cells_per_step = tr["cells_per_stripe"]
        self.stripes = [inputs.smoothed_seasonal(
            len(self.dates), self.cells_per_step,
            inputs.stream_seed(run.seed, k), self.dev).cpu().numpy()
            for k in range(tr["stripes"])]
        self.K = cfg["K"]
        self.kept = {}
        self.last = None

    def cases(self, rng, cells):
        kept = dict(self.kept)
        if self.last is not None:
            kept[self.last[0]] = self.last
        out = []
        for i, k, th, se, tables, nev, _ in (kept[j] for j in sorted(kept)):
            cols = np.sort(rng.choice(self.cells_per_step, cells,
                                      replace=False))
            out += table_cases(self.stripes[k], th, se, tables, nev, cols,
                               f"step {i} (stripe {k})")
        return out
