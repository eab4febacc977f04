"""``land_pinned_share``: the share of the API's land checks that wrote
the kept cells into page-locked memory, read from the program's
counters; nothing where the program has no such counters; and a whole
API step at a small size on the CPU, where nothing is pinned, reads 0."""

from __future__ import annotations

from benchmark.lib import spec
from benchmark.tests.test_bench_region import _hand_run


def read(monkeypatch, counts):
    return spec.module("metrics", "land_pinned_share").read(
        _hand_run(monkeypatch, counts))


def test_share_of_the_counters(monkeypatch):
    assert read(monkeypatch, {"land_calls": 8, "land_pinned_calls": 8}) == 1.0
    assert read(monkeypatch, {"land_calls": 8, "land_pinned_calls": 2}) == 0.25
    assert read(monkeypatch, {"land_calls": 4}) == 0.0


def test_nothing_without_the_counters(monkeypatch):
    assert read(monkeypatch, {"union_calls": 4}) is None
    assert read(monkeypatch, {"land_calls": 0}) is None


def test_a_cpu_step_pins_nothing(monkeypatch):
    import numpy as np

    import xmhw_tpu_torch as xt
    from xmhw_tpu_torch import utils
    from xmhw_tpu_torch.xrlite import Coord, DataArray

    monkeypatch.setattr(utils, "_counts", {})
    t = np.arange("2001-01-01", "2004-01-01", dtype="datetime64[D]")
    rng = np.random.default_rng(2)
    x = (15 + 3 * np.sin(2 * np.pi * np.arange(len(t)) / 365.25)[
        :, None, None] + rng.normal(0, 1, (len(t), 3, 4))).astype(np.float32)
    x[:, 0, 0] = np.nan
    da = DataArray(x, ("time", "lat", "lon"),
                   {"time": Coord(("time",), t.astype("datetime64[ns]")),
                    "lat": Coord(("lat",), np.arange(3.0)),
                    "lon": Coord(("lon",), np.arange(4.0))})
    clim = xt.threshold(da, device="cpu")
    xt.detect(da, clim["thresh"], clim["seas"], device="cpu")
    assert utils.counts()["land_calls"] == 4
    assert spec.module("metrics", "land_pinned_share").read(None) == 0.0
