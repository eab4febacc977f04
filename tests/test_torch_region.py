"""threshold() + detect() of the port, union layout, on a small regional
daily box with land, against the benchmark's float64 NumPy reference
(``benchmark/reference``: clim.py, oracle.py, judge.py; no JAX, no port).

The box: 6 x 8 cells of 0.25 degree, 30 % of them land (all NaN, chosen
from the seed), four years of daily series. Every ocean cell's
climatology and events are compared, and the ``events`` coordinate must
be the reference's union of start days over all cells. In float64 the
port must agree exactly in every event; in float32, the precision the
benchmark's configuration states, through the benchmark's judge, which
accepts either side of a decision that float32 rounding can move.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import xmhw_tpu_torch as xt  # noqa: E402
from benchmark.reference import calendar  # noqa: E402
from benchmark.reference.clim import clim_many  # noqa: E402
from benchmark.reference.judge import (Case, Setup, judge,  # noqa: E402
                                       verdict)
from benchmark.reference.oracle import events_oracle  # noqa: E402
from xmhw_tpu_torch.xrlite import Coord, DataArray  # noqa: E402

LIMITS = {"clim_gap": 1e-3, "event_cells_off": 0, "event_fields_off": 0,
          "event_gap": 3e-3}


def box(seed=17, ny=6, nx=8, years=4, land_share=0.3):
    """(DataArray, ocean (n, 2) indexes): seasonal cycle plus 15-day
    smoothed noise, land cells all NaN."""
    rng = np.random.default_rng(seed)
    t = np.arange("1990-01-01", f"{1990 + years}-01-01",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    T = len(t)
    noise = rng.normal(0, 1, (T + 14, ny, nx))
    sm = np.stack([noise[k:k + T] for k in range(15)]).mean(0)
    day = np.arange(T)[:, None, None]
    x = (15 + 3 * np.sin(2 * np.pi * day / 365.25) + 2.5 * sm).astype(
        np.float32)
    land = rng.permutation(ny * nx)[:round(land_share * ny * nx)]
    x.reshape(T, -1)[:, land] = np.nan
    lat = -44.875 + 0.25 * np.arange(ny)
    lon = 145.125 + 0.25 * np.arange(nx)
    da = DataArray(x, ("time", "lat", "lon"),
                   {"time": Coord(("time",), t), "lat": Coord(("lat",), lat),
                    "lon": Coord(("lon",), lon)}, {"units": "degree_C"})
    return da, np.argwhere(~np.isnan(x).all(axis=0))


def port(da, dtype):
    clim = xt.threshold(da, device="cpu", dtype=dtype)
    mhw = xt.detect(da, clim["thresh"], clim["seas"], device="cpu",
                    dtype=dtype, events_layout="union")
    return clim, mhw


def at(ds, da, i, j):
    """Indexes of box cell (i, j) on a Dataset's own (lat, lon) grid."""
    a = np.flatnonzero(np.asarray(ds.coords["lat"].values)
                       == da.coords["lat"].values[i])
    b = np.flatnonzero(np.asarray(ds.coords["lon"].values)
                       == da.coords["lon"].values[j])
    assert a.size == 1 and b.size == 1, (i, j)
    return a[0], b[0]


def cases(da, ocean, clim, mhw):
    """A judge case of each ocean cell: its climatology, its events and
    their rows of the events coordinate."""
    rows = np.asarray(mhw.coords["events"].values)
    data = {k: np.asarray(mhw[k].data) for k in mhw.keys()}
    th, se = (np.asarray(clim[k].data) for k in ("thresh", "seas"))
    out = []
    for i, j in ocean:
        p, q = at(clim, da, i, j)
        r, s = at(mhw, da, i, j)
        keep = np.isfinite(data["event"][:, r, s])
        out.append(Case(ts=np.asarray(da.data)[:, i, j], th=th[:, p, q],
                        se=se[:, p, q],
                        events={k: v[:, r, s][keep]
                                for k, v in data.items()},
                        rows=rows[keep], where=f"cell {i} {j}"))
    return out


def reference(da, ocean):
    """(thresh, seas, per-cell event lists) of the float64 reference, at
    Hobday et al. 2016's defaults over the whole record."""
    t = np.asarray(da.coords["time"].values)
    doy, ndoy = calendar.rows(t, False)
    x = np.stack([np.asarray(da.data, np.float64)[:, i, j]
                  for i, j in ocean], axis=1)
    th, se = clim_many(x, doy, ndoy)
    evs = [events_oracle(x[:, k], th[doy - 1, k], se[doy - 1, k])
           for k in range(x.shape[1])]
    return th, se, evs


@pytest.fixture(scope="module")
def region():
    da, ocean = box()
    assert len(ocean) == 34  # 48 cells, 14 land
    return da, ocean, reference(da, ocean)


def test_float64_matches_the_reference_exactly(region):
    da, ocean, (th_r, se_r, evs_r) = region
    clim, mhw = port(da, np.float64)
    got = cases(da, ocean, clim, mhw)
    for k, c in enumerate(got):
        np.testing.assert_allclose(c.th, th_r[:, k], rtol=0, atol=1e-9)
        np.testing.assert_allclose(c.se, se_r[:, k], rtol=0, atol=1e-9)
        starts = [e["index_start"] for e in evs_r[k]]
        np.testing.assert_array_equal(c.events["index_start"], starts)
        np.testing.assert_array_equal(c.events["index_end"],
                                      [e["index_end"] for e in evs_r[k]])
        np.testing.assert_array_equal(c.rows, starts)
    union = np.unique([e["index_start"] for ev in evs_r for e in ev])
    assert len(union) > 100
    np.testing.assert_array_equal(mhw.coords["events"].values, union)


def test_float32_passes_the_judge_and_the_union_is_every_start(region):
    da, ocean, (_, _, evs_r) = region
    clim, mhw = port(da, None)
    got = cases(da, ocean, clim, mhw)
    setup = Setup(dates=np.asarray(da.coords["time"].values))
    ok, rows = verdict(judge(got, setup, LIMITS["clim_gap"]).values, LIMITS)
    assert ok, rows
    # every row of the coordinate starts an event in some cell, and
    # every event of every cell has its row
    union = np.unique(np.concatenate([c.events["index_start"]
                                      for c in got]))
    np.testing.assert_array_equal(mhw.coords["events"].values, union)
    # no float32 decision moves a start day on this box
    np.testing.assert_array_equal(union, np.unique(
        [e["index_start"] for ev in evs_r for e in ev]))


def test_each_call_keeps_large_temporaries_in_the_heap(region, monkeypatch):
    """threshold() and detect() each ask for glibc's tuned heap first,
    so that a daily box's land check and gathers reuse resident pages."""
    from xmhw_tpu_torch import api
    from xmhw_tpu_torch.xrlite import alloc

    calls = []
    monkeypatch.setattr(api, "tune_malloc",
                        lambda: calls.append(alloc.tune_malloc()))
    da = region[0]
    port(da, None)
    assert len(calls) == 2
    assert alloc._malloc_tuned or alloc._libc is None
