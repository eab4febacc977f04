"""Entry: the documented notebook workflow on a regional daily box, a
closed loop of one caller.

The box is ``api_region``'s (:func:`api_region.box`). Each step is the
four calls of ``docs/gettingstarted.md`` "Workflow" on the whole box, on
the card, with the configuration's definition and its ``workflow``
arguments (``mhw_rank`` derives nYears from the data, as the
configuration states), then one synchronisation::

    clim = threshold(sst)
    mhw, inter = detect(sst, clim["thresh"], clim["seas"],
                        intermediate=True, events_layout=...)
    blk = block_average(mhw, dstime=inter)
    rank, return_period = mhw_rank(mhw)

``block_average`` and ``mhw_rank`` are the package's public functions,
called through ``stats_api`` so that the benchmark's spans can wrap them.
A step completes the box's ocean cells. The previous step's outputs are
let go as a step starts, so that the process holds one step's outputs,
as a caller's loop that rebinds its names does once the new values come.

The judge's sample is ``api_pair``'s: each sampled cell's climatology,
events and union rows, and the year-block event statistics of ``blk``
(``block``). ``blk``'s day statistics do not go to the judge: with
``dstime=inter`` they count category days over the days of events
alone (the intermediate ``cats`` is NaN elsewhere), where the judge
counts them over every day. They, the intermediate series and the ranks
are held by ``benchmark/workflow_check.py`` against
``reference/workflow.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.entries import api_pair, api_region
from benchmark.reference import stats, workflow


def spans():
    """``api_region``'s spans, and spans around the intermediate
    Dataset's assembly, ``block_average`` and ``mhw_rank``."""
    from xmhw_tpu_torch import api, stats_api

    return {**api_region.spans(),
            "assemble_inter": (api, "_assemble_inter"),
            "block_average": (stats_api, "block_average"),
            "mhw_rank": (stats_api, "mhw_rank")}


class Entry(api_region.Entry):
    def __init__(self, run):
        super().__init__(run)
        w = run.cfg["workflow"]
        self.det_kw["intermediate"] = w["detect"]["intermediate"]
        self.blk_kw = dict(w["block_average"])

    def step(self, i):
        import xmhw_tpu_torch as xt
        from xmhw_tpu_torch import stats_api

        self.last = None
        clim = xt.threshold(self.da, device=self.dev, **self.thr_kw)
        mhw, inter = xt.detect(self.da, clim["thresh"], clim["seas"],
                               device=self.dev, **self.det_kw)
        blk = stats_api.block_average(mhw, dstime=inter, device=self.dev,
                                      **self.blk_kw)
        rank, rp = stats_api.mhw_rank(mhw, device=self.dev)
        self.run.sync()
        self.last = (i, clim, mhw, inter, blk, rank, rp)

    def _sample(self, i, clim, mhw, inter, blk, rank, rp):
        """``api_pair``'s cases of step ``i``, each with its cell's
        year-block event statistics."""
        cases = super()._sample(i, clim, mhw)
        pick = self._pick(i)
        bi, bj = api_pair._positions(blk, self.lat, self.lon, pick)
        out = []
        for c, p, q in zip(cases, bi, bj):
            if min(p, q) >= 0:
                c = dataclasses.replace(c, block={
                    k: np.asarray(blk[k].data[:, p, q])
                    for k in stats.EVENT_STATS})
            out.append(c)
        return out

    def _pick(self, i):
        """The (lat, lon) indexes of step ``i``'s sampled ocean cells, as
        ``api_pair._sample`` draws them."""
        rng = np.random.default_rng([self.run.seed, 11, i])
        cells = self.tr["sample"]["cells_per_call"]
        return self.ocean[np.sort(rng.choice(len(self.ocean), cells,
                                             replace=False))]

    def workflow_cells(self, cells=None):
        """The last step's outputs of ``cells`` sampled ocean cells (all
        of them by default) as :func:`reference.workflow.check` takes
        them, beside the judge's cases of the same cells; the entry's
        later samples draw as many."""
        i, clim, mhw, inter, blk, rank, rp = self.last
        n = cells or len(self.ocean)
        # the sample's draw, of n cells
        self.tr["sample"]["cells_per_call"] = n
        cases = self._sample(i, clim, mhw, inter, blk, rank, rp)
        pick = self._pick(i)
        ei, ej = api_pair._positions(mhw, self.lat, self.lon, pick)
        ii, ij = api_pair._positions(inter, self.lat, self.lon, pick)
        di, dj = api_pair._positions(blk, self.lat, self.lon, pick)
        ev = np.asarray(mhw["event"].data)
        out = []
        for c, r, s, a, b, p, q in zip(cases, ei, ej, ii, ij, di, dj):
            rows = np.isfinite(ev[:, r, s])
            out.append({
                "ts": c.ts, "th": c.th, "se": c.se, "events": c.events,
                "inter": {k: np.asarray(inter[k].data[:, a, b])
                          for k in workflow.INTER_VARS},
                "day": {k: np.asarray(blk[k].data[:, p, q])
                        for k in workflow.DAY_STATS},
                "rank": {k: np.asarray(rank[k].data[:, r, s])[rows]
                         for k in rank.keys()},
                "rp": {k: np.asarray(rp[k].data[:, r, s])[rows]
                       for k in rp.keys()},
                "where": c.where})
        return cases, out
