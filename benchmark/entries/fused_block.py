"""Entry: ``core.pipeline.fused_threshold_detect`` on device-resident
blocks, a closed loop of one caller.

The traffic file gives ``cells_per_block`` and ``blocks``: that many
(T, C) float32 blocks are made on the card from the seed in set-up, and
step i runs block i mod ``blocks``: the climatology (kernel 1 and its
glue) and detection (kernels 2 and 3 and theirs) at the configuration's
fixed capacity K, the step each rank of the production job's
multi-process path runs on its own shards. Every step's raw counts are
kept, to find any cell with more events than K; the outputs of the
sampled steps are kept for the judge.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.lib import inputs
from benchmark.reference.judge import table_cases


def spans():
    """Spans around the port's functions: none beyond the harness's own
    span around each step."""
    return {}


class Entry:
    def __init__(self, run):
        from xmhw_tpu_torch.core.calendar import compute_doy
        from xmhw_tpu_torch.xrlite import TimeIndex

        cfg, tr = run.cfg, run.traffic
        self.run = run
        self.dev = run.devices[0]
        self.dates = inputs.dates(cfg["record"])
        self.doy, self.ndoy = compute_doy(TimeIndex(self.dates),
                                          keep_tstep=cfg["definition"]
                                          ["tstep"])
        self.pos = torch.from_numpy((self.doy - 1).astype(np.int32)).to(
            self.dev)
        d = cfg["definition"]
        self.kw = dict(pctile=d["pctile"], smooth=d["smoothPercentile"],
                       smooth_w=d["smoothPercentileWidth"],
                       patch_feb29=not d["tstep"], K=cfg["K"],
                       min_duration=d["minDuration"], join_gaps=d["joinGaps"],
                       max_gap=d["maxGap"], w=d["windowHalfWidth"],
                       ndoy=self.ndoy)
        self.K = cfg["K"]
        self.cells_per_step = tr["cells_per_block"]
        self.blocks = [inputs.smoothed_seasonal(
            len(self.dates), self.cells_per_step,
            inputs.stream_seed(run.seed, k), self.dev)
            for k in range(tr["blocks"])]
        self.nev = []
        self.kept = {}
        self.last = None

    def step(self, i):
        from xmhw_tpu_torch.core.pipeline import fused_threshold_detect

        k = i % len(self.blocks)
        th, se, table, nev = fused_threshold_detect(
            self.blocks[k], self.doy, self.pos, **self.kw)
        self.nev.append(nev)
        self.last = (i, k, th, se, table, nev)

    def keep_last(self, drop):
        """Keep the last step's outputs for the judge, in place of step
        ``drop``'s."""
        self.kept[self.last[0]] = self.last
        self.kept.pop(drop, None)

    def warm(self):
        """Every block once, then once more: the shapes of the window."""
        for i in range(2 * len(self.blocks)):
            self.step(i)
        self.run.sync()
        self.nev.clear()

    def failed(self):
        """Steps with a cell of more raw events than K (its table rows
        would drop some)."""
        if not self.nev:
            return 0
        top = torch.stack([n.max() for n in self.nev]).cpu().numpy()
        return int((top > self.K).sum())

    def cases(self, rng, cells):
        """Judge cases of ``cells`` cells drawn from ``rng`` in each kept
        step, and in the window's last step."""
        kept = dict(self.kept)
        if self.last is not None:
            kept[self.last[0]] = self.last
        out = []
        for i, k, th, se, table, nev in (kept[j] for j in sorted(kept)):
            cols = np.sort(rng.choice(self.cells_per_step, cells,
                                      replace=False))
            idx = torch.from_numpy(cols).to(self.dev)
            host = {name: v.index_select(1, idx).cpu().numpy()
                    for name, v in table.items()}
            out += table_cases(
                self.blocks[k].index_select(1, idx).cpu().numpy(),
                th.index_select(1, idx).cpu().numpy(),
                se.index_select(1, idx).cpu().numpy(), host,
                nev.index_select(0, idx).cpu().numpy(),
                range(len(cols)), "")
            for c, j in zip(out[-len(cols):], cols):
                c.where = f"step {i} (block {k}) column {j}"
        return out

    def free(self):
        self.blocks = self.kept = self.last = None
        self.nev = []
