"""Entry: the public API, ``threshold()`` then ``detect()`` on the whole
grid, a closed loop of one caller.

The configuration's grid (``grid``: ``lat`` and ``lon``) is made on the
host from the seed with its ``recipe``, ``land_share`` of the cells all
NaN, as a labelled (time, lat, lon) array; each step is one pair of calls
with the configuration's definition (``tstep`` and the rest), in the
traffic's event layout, on the card. A step completes the grid's ocean
cells.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from benchmark.lib import inputs
from benchmark.reference.judge import Case


def spans():
    from xmhw_tpu_torch import api

    # api.py imports them by name: its own bindings are the ones it calls
    return {"run_clim": (api, "run_clim"), "run_detect": (api, "run_detect")}


class Entry:
    def __init__(self, run):
        from xmhw_tpu_torch.xrlite import Coord, DataArray

        cfg, tr = run.cfg, run.traffic
        self.run = run
        self.tr = tr
        d = cfg["definition"]
        self.thr_kw = dict(pctile=d["pctile"], windowHalfWidth=d[
            "windowHalfWidth"], smoothPercentile=d["smoothPercentile"],
            smoothPercentileWidth=d["smoothPercentileWidth"],
            tstep=d["tstep"])
        self.det_kw = dict(minDuration=d["minDuration"],
                           joinGaps=d["joinGaps"], maxGap=d["maxGap"],
                           tstep=d["tstep"],
                           events_layout=tr["events_layout"])
        self.dates = inputs.dates(cfg["record"])
        g = cfg["grid"]
        self.lat = np.arange(g["lat"][0], g["lat"][1] + g["step"] / 2,
                             g["step"])
        self.lon = np.arange(g["lon"][0], g["lon"][1] + g["step"] / 2,
                             g["step"])
        self.field = inputs.ersst_like(self.dates, self.lat, self.lon,
                                       run.seed, cfg["land_share"],
                                       cfg["trend_c_per_decade"])
        self.ocean = np.argwhere(~np.isnan(self.field).all(axis=0))
        self.cells_per_step = len(self.ocean)
        self.da = DataArray(self.field, ("time", "lat", "lon"),
                            {"time": Coord(("time",), self.dates),
                             "lat": Coord(("lat",), self.lat),
                             "lon": Coord(("lon",), self.lon)},
                            {"units": "degree_C"})
        self.dev = str(run.devices[0])
        self.kept = {}
        self.rows = {}
        self.last = None
        self.warm_walls = []

    def step(self, i):
        import xmhw_tpu_torch as xt

        clim = xt.threshold(self.da, device=self.dev, **self.thr_kw)
        mhw = xt.detect(self.da, clim["thresh"], clim["seas"],
                        device=self.dev, **self.det_kw)
        self.last = (i, clim, mhw)

    def keep_last(self, drop):
        """Keep the judge's sample of the last step, in place of step
        ``drop``'s: its cells' inputs and outputs, copied out at once, so
        that the window holds no more of the program's outputs than a
        caller's loop does (a Dataset kept whole would make later calls
        map fresh memory)."""
        i = self.last[0]
        self.kept[i] = self._sample(*self.last)
        self.kept.pop(drop, None)

    def _sample(self, i, clim, mhw):
        """Judge cases of the configured number of cells of step ``i``,
        drawn from the seed and the step."""
        rng = np.random.default_rng([self.run.seed, 11, i])
        cells = self.tr["sample"]["cells_per_call"]
        pick = self.ocean[np.sort(rng.choice(len(self.ocean), cells,
                                             replace=False))]
        ci, cj = _positions(clim, self.lat, self.lon, pick)
        ei, ej = _positions(mhw, self.lat, self.lon, pick)
        rows = np.asarray(mhw.coords["events"].values)
        names = list(mhw.keys())
        data = {k: np.asarray(mhw[k].data) for k in names}
        th, se = (np.asarray(clim[k].data) for k in ("thresh", "seas"))
        out = []
        for (a, b), (p, q), (r, s) in zip(pick, zip(ci, cj), zip(ei, ej)):
            where = f"step {i} lat {self.lat[a]} lon {self.lon[b]}"
            if min(p, q, r, s) < 0:  # the output lost the cell
                out.append(Case(ts=self.field[:, a, b], th=np.zeros(0),
                                se=np.zeros(0), events={
                                    "index_start": np.zeros(0),
                                    "index_end": np.zeros(0)},
                                where=where))
                continue
            keep = np.isfinite(data["event"][:, r, s])
            out.append(Case(
                ts=self.field[:, a, b], th=th[:, p, q].copy(),
                se=se[:, p, q].copy(),
                events={k: v[:, r, s][keep] for k, v in data.items()},
                rows=rows[keep], where=where))
        self.rows[i] = len(rows)
        return out

    def warm(self):
        """Calls until one's wall is within ``settle`` of the one before
        (at least ``min_calls``, at most ``max_calls``): the first calls
        of the union layout run slower than the later ones."""
        w = self.tr["warmup"]
        for i in range(w["max_calls"]):
            t = time.perf_counter()
            self.step(i)
            self.run.sync()
            self.warm_walls.append(time.perf_counter() - t)
            if (i + 1 >= w["min_calls"] and abs(
                    self.warm_walls[-1] - self.warm_walls[-2])
                    <= w["settle"] * self.warm_walls[-2]):
                break

    def failed(self):
        return 0

    def cases(self, rng, cells):
        """The kept steps' cases and the last step's (``keep_last`` drew
        each step's cells; ``rng`` and ``cells`` go unused)."""
        kept = dict(self.kept)
        if self.last is not None and self.last[0] not in kept:
            kept[self.last[0]] = self._sample(*self.last)
        out = []
        for i in sorted(kept):
            most = max((len(c.events["index_start"]) for c in kept[i]),
                       default=0)
            print(f"benchmark: step {i}: {self.rows[i]} rows in the events "
                  f"layout, at most {most} events in a sampled cell",
                  file=sys.stderr)
            out += kept[i]
        return out

    def free(self):
        self.kept = self.last = None
        self.da = None


def _positions(ds, lat, lon, pick):
    """Indexes of the picked (lat, lon) cells on a Dataset's own grid,
    which holds the rows and columns with ocean; -1 where it lacks one."""
    out = []
    for dim, axis, col in (("lat", lat, 0), ("lon", lon, 1)):
        grid = np.asarray(ds.coords[dim].values)
        idx = np.full(len(pick), -1)
        for n, v in enumerate(axis[pick[:, col]]):
            hit = np.flatnonzero(grid == v)
            if hit.size:
                idx[n] = hit[0]
        out.append(idx)
    return out
