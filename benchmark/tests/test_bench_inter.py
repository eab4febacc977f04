"""``inter_card_share``: the share of ``detect(intermediate=True)`` calls
whose intermediate grids were built on the card, read from the program's
counters; nothing where the program has no such counters or made no such
call; and a call on the CPU device, whose grids are built on the host,
reads 0."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark.lib import spec


def read(monkeypatch, counts):
    from xmhw_tpu_torch import utils

    monkeypatch.setattr(utils, "_counts", dict(counts))
    return spec.module("metrics", "inter_card_share").read(None)


@pytest.mark.parametrize("counts, share", [
    ({"inter_calls": 4, "inter_card_calls": 4}, 1.0),
    ({"inter_calls": 4, "inter_card_calls": 1}, 0.25),
    ({"inter_calls": 4}, 0.0),
    ({"land_calls": 4}, None),
    ({"inter_calls": 0}, None)],
    ids=["card", "some", "none", "no_counters", "no_calls"])
def test_share_of_the_counters(monkeypatch, counts, share):
    assert read(monkeypatch, counts) == share


def test_a_cpu_detect_builds_its_grids_on_the_host(monkeypatch):
    import xmhw_tpu_torch as xt
    from xmhw_tpu_torch import utils
    from xmhw_tpu_torch.xrlite import Coord, DataArray

    monkeypatch.setattr(utils, "_counts", {})
    t = np.arange("1990-01-01", "1993-01-01", dtype="datetime64[D]")
    rng = np.random.default_rng(5)
    day = np.arange(len(t))[:, None, None]
    x = (15 + 3 * np.sin(2 * np.pi * day / 365.25)
         + rng.normal(0, 1, (len(t), 2, 3))).astype(np.float32)
    da = DataArray(x, ("time", "lat", "lon"),
                   {"time": Coord(("time",), t.astype("datetime64[ns]")),
                    "lat": Coord(("lat",), np.arange(2.0)),
                    "lon": Coord(("lon",), np.arange(3.0))})
    clim = xt.threshold(da, device="cpu")
    _, inter = xt.detect(da, clim["thresh"], clim["seas"],
                         intermediate=True, device="cpu")
    assert inter["ts"].dims == ("time", "lat", "lon")
    assert utils.counts()["inter_calls"] == 1
    assert "inter_card_calls" not in utils.counts()
    assert spec.module("metrics", "inter_card_share").read(None) == 0.0
