"""Entry: the public API on a regional daily box, ``threshold()`` then
``detect()`` on the whole box, a closed loop of one caller.

The configuration's box (``grid``: ``lat`` and ``lon``) holds
``ocean_cells`` ocean cells, chosen from the seed, and ``land_share`` of
its cells all NaN. The ocean series are made on the card from the seed
with the configuration's ``recipe`` (``smoothed_seasonal``) and scattered
into a host (time, lat, lon) array; each step is one pair of calls with
the configuration's definition, in the traffic's event layout, on the
card. Warm-up, the judge's sample and the rest are ``api_pair``'s.
"""

from __future__ import annotations

import numpy as np

from benchmark.entries import api_pair
from benchmark.lib import inputs


def spans():
    """``api_pair``'s spans, and spans around the API's land check and
    its union assembly (api.py calls them by its own bindings)."""
    from xmhw_tpu_torch import api

    return {**api_pair.spans(), "land_check": (api, "land_check"),
            "assemble": (api, "_assemble_events")}


def box(cfg, seed, device):
    """(lat, lon, field): the box's axes and its (T, lat, lon) float32
    host array, land all NaN."""
    g = cfg["grid"]
    lat = np.arange(g["lat"][0], g["lat"][1] + g["step"] / 2, g["step"])
    lon = np.arange(g["lon"][0], g["lon"][1] + g["step"] / 2, g["step"])
    n = len(lat) * len(lon)
    ocean = np.sort(np.random.default_rng([seed, 3]).permutation(n)[
        :cfg["ocean_cells"]])
    if len(ocean) != n - round(cfg["land_share"] * n):
        raise ValueError("ocean_cells and land_share disagree on the box")
    T = len(inputs.dates(cfg["record"]))
    field = np.full((T, n), np.nan, np.float32)
    field[:, ocean] = inputs.smoothed_seasonal(
        T, len(ocean), inputs.stream_seed(seed, 0), device).cpu().numpy()
    return lat, lon, field.reshape(T, len(lat), len(lon))


class Entry(api_pair.Entry):
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
        self.lat, self.lon, self.field = box(cfg, run.seed, run.devices[0])
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
