"""Entry: ``core.pipeline.run_fused`` on host stripes with year-bin
statistics, a closed loop of one caller, on one card.

The traffic file gives ``cells_per_stripe``, ``stripes`` and
``year_bins``. The stripes are made on the card from the seed and copied
to host memory once, in set-up, as the streamed job's read-ahead hands
them over. Step i runs stripe i mod ``stripes`` with the arguments that
``stream_run`` passes for a stripe: the whole record's climatology,
detection, the block statistics of one-year bins (``ybod``, ``nbins``,
``day_edges``), no device ranks, and ``k_min``, the event capacity a
call starts from: the configuration's K, where ``stream_run`` starts
its first stripe from the count of that stripe, so that the capacity,
and the size of every table, is the same whatever the seed (a call
still grows it if a cell counts more events). Set-up calls
``xrlite.alloc.tune_malloc()``, as ``stream_run`` does before its first
stripe.
"""

from __future__ import annotations

import numpy as np

from benchmark.lib import inputs
from benchmark.reference.judge import table_cases


def spans():
    from xmhw_tpu_torch.core import pipeline

    return {"fused_stats": (pipeline, "fused_stats"),
            "upload": (pipeline, "upload"),
            "fetch_rows": (pipeline, "fetch_rows")}


class Entry:
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
        years = self.dates.astype("datetime64[Y]").astype(np.int64) + 1970
        bins = np.arange(tr["year_bins"][0], tr["year_bins"][1] + 2)
        ybod = (np.searchsorted(bins, years, side="right") - 1).astype(
            np.int32)
        ybod[(ybod < 0) | (ybod >= len(bins) - 1)] = -1
        self.kw = dict(
            w=d["windowHalfWidth"], ndoy=self.ndoy, pctile=d["pctile"],
            smooth=d["smoothPercentile"],
            smooth_w=d["smoothPercentileWidth"], patch_feb29=not d["tstep"],
            min_duration=d["minDuration"], join_gaps=d["joinGaps"],
            max_gap=d["maxGap"], ybod_np=ybod, nbins=len(bins) - 1,
            day_edges=tuple(int(x) for x in np.searchsorted(
                years, bins, side="left")),
            rank_names=())
        self.dev = run.devices[0]
        self.cells_per_step = tr["cells_per_stripe"]
        self.stripes = [inputs.smoothed_seasonal(
            len(self.dates), self.cells_per_step,
            inputs.stream_seed(run.seed, k), self.dev).cpu().numpy()
            for k in range(tr["stripes"])]
        self.K = cfg["K"]
        self.kept = {}
        self.last = None

    def step(self, i):
        from xmhw_tpu_torch.core.pipeline import run_fused

        k = i % len(self.stripes)
        th, se, tables, nev, extras = run_fused(
            self.stripes[k], self.doy, self.doy - 1, k_min=self.K,
            device=self.dev, **self.kw)
        self.K = max(self.K, tables["event"].shape[0])
        self.last = (i, k, th, se, tables, nev, extras)

    def keep_last(self, drop):
        """Keep the last step's outputs for the judge, in place of step
        ``drop``'s."""
        self.kept[self.last[0]] = self.last
        self.kept.pop(drop, None)

    def warm(self):
        """Every stripe twice: the shapes of the window."""
        for i in range(2 * len(self.stripes)):
            self.step(i)
        self.run.sync()

    def failed(self):
        return 0

    def cases(self, rng, cells):
        kept = dict(self.kept)
        if self.last is not None:
            kept[self.last[0]] = self.last
        out = []
        for i, k, th, se, tables, nev, extras in (kept[j]
                                                   for j in sorted(kept)):
            cols = np.sort(rng.choice(self.cells_per_step, cells,
                                      replace=False))
            out += table_cases(self.stripes[k], th, se, tables, nev, cols,
                               "", block=extras["block"], day=extras["day"])
            for c, j in zip(out[-len(cols):], cols):
                c.where = f"step {i} (stripe {k}) column {j}"
        return out

    def free(self):
        self.stripes = self.kept = self.last = None
