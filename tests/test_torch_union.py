"""The union event grids built by the device route against the host route.

``detect(events_layout="union")`` builds its grids on the card when the
run's device is CUDA and their pinned host buffers fit
(``api._union_on_card``), and on the host otherwise. Here the device
route runs on CPU tensors (no pinned memory) by forcing the route, and
every output variable must equal the host route's bit for bit: same dims, coordinates, attributes,
dtype and values, NaN as NaN and NaT as NaT. Imports no JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import xmhw_tpu_torch as xt  # noqa: E402
from xmhw_tpu_torch import api, utils  # noqa: E402
from xmhw_tpu_torch.xrlite import Coord, DataArray, TimeIndex  # noqa: E402


def field(seed=3, years=3, days_a_year=365, ny=5, nx=8, amp=2.5):
    """Daily seasonal cycle plus smoothed noise on an ny x nx grid; row 0
    and column 5 are land (all NaN), and so are two other cells."""
    rng = np.random.default_rng(seed)
    T = days_a_year * years
    noise = rng.normal(0, 1, (T + 14, ny, nx))
    sm = np.stack([noise[k:k + T] for k in range(15)]).mean(0)
    day = np.arange(T)[:, None, None]
    ts = 15 + 3 * np.sin(2 * np.pi * day / days_a_year) + amp * sm
    ts[:, 0, :] = np.nan
    ts[:, :, 5] = np.nan
    ts[:, [2, 4], [1, 6]] = np.nan
    return ts


def grid(ts, calendar=None):
    T, ny, nx = ts.shape
    if calendar is None:
        t = (np.datetime64("2001-01-01", "ns")
             + np.arange(T) * np.timedelta64(1, "D"))
    else:
        t = TimeIndex(np.arange(T, dtype=np.float64) + 0.5,
                      calendar=calendar, units="days since 2001-01-01")
    return DataArray(
        ts, ("time", "lat", "lon"),
        {"time": Coord(("time",), t),
         "lat": Coord(("lat",), np.linspace(-40, -36, ny),
                      {"units": "degrees_north"}),
         "lon": Coord(("lon",), np.linspace(150, 157, nx))},
        {"units": "degree_C"})


def flat_calm(ts):
    """The same grid with no events: each ocean cell a constant."""
    out = np.where(np.isnan(ts), np.nan, 15.0)
    return out


# name: (series, calendar, detect keywords)
CASES = {
    "float32 tables, datetime64 times": (field(), None, {}),
    "float64 tables": (field(), None, dict(dtype=np.float64)),
    "synthetic calendar, float64 times": (field(), "noleap", {}),
    "360_day calendar, tstep": (field(days_a_year=360), "360_day",
                                dict(tstep=True)),
    "cold spells": (field(), None, dict(coldSpells=True)),
    "empty union": (flat_calm(field()), None, {}),
}


def same_bits(a, b, name):
    assert b.dtype == a.dtype, name
    assert b.shape == a.shape, name
    if a.dtype.kind in "Mm":  # NaT compared as NaT
        assert np.array_equal(a.view(np.int64), b.view(np.int64)), name
    else:
        assert np.array_equal(a, b, equal_nan=True), name


def same_ds(a, b):
    assert list(b.keys()) == list(a.keys())
    assert b.attrs == a.attrs
    for k in a.keys():
        x, y = a[k], b[k]
        assert y.dims == x.dims, k
        assert y.attrs == x.attrs, k
        assert sorted(y.coords) == sorted(x.coords), k
        for c in x.coords:
            same_bits(np.asarray(x.coords[c].values),
                      np.asarray(y.coords[c].values), (k, c))
            assert y.coords[c].attrs == x.coords[c].attrs, (k, c)
        same_bits(np.asarray(x.data), np.asarray(y.data), k)


@pytest.mark.parametrize("case", list(CASES))
def test_device_route_matches_host_route(case, monkeypatch):
    ts, calendar, kw = CASES[case]
    da = grid(ts, calendar)
    clim = xt.threshold(da, device="cpu", **{
        k: v for k, v in kw.items() if k in ("tstep", "dtype", "coldSpells")})
    args = (da, clim["thresh"], clim["seas"])
    before = utils.counts()
    host = xt.detect(*args, device="cpu", **kw)
    mid = utils.counts()
    assert mid.get("union_card_calls", 0) == before.get(
        "union_card_calls", 0)
    monkeypatch.setattr(api, "_union_on_card", lambda dev, nbytes: True)
    card = xt.detect(*args, device="cpu", **kw)
    after = utils.counts()

    same_ds(host, card)
    n_events = host["event"].shape[0]
    if case == "empty union":
        assert n_events == 0
    else:
        assert n_events > 0
        assert np.isfinite(np.asarray(host["event"].data)).any()
    assert after["union_calls"] - mid["union_calls"] == 1
    assert after["union_card_calls"] - mid.get("union_card_calls", 0) == 1
    grid_bytes = sum(np.asarray(host[k].data).nbytes for k in host.keys()
                     if "events" in host[k].dims)
    assert (after["union_card_bytes"] - mid.get("union_card_bytes", 0)
            == grid_bytes)
    for k in card.keys():
        assert np.asarray(card[k].data).flags.writeable, k


def test_route_is_chosen_from_device_and_size(monkeypatch):
    """The card route on a CUDA device alone, and only where the grids'
    pinned buffers, each rounded up to a power of two, fit in the host
    memory available."""
    assert not api._union_on_card(None, [1])
    assert not api._union_on_card(torch.device("cpu"), [1])
    assert not api._union_on_card("cpu", [1])
    assert api._host_available() > 0
    monkeypatch.setattr(api, "_host_available", lambda: 3 << 20)
    MiB = 1 << 20
    assert api._union_on_card(torch.device("cuda"), [1, MiB + 1, 0])
    assert api._union_on_card(torch.device("cuda", 1), [MiB, 2 * MiB])
    assert not api._union_on_card(torch.device("cuda"),
                                  [MiB + 1, MiB + 1])
    assert not api._union_on_card("cuda", [3 * MiB + 1])


@pytest.mark.parametrize("layout", ["point", "compact"])
def test_point_and_compact_layouts_keep_the_host_route(layout,
                                                       monkeypatch):
    da = grid(field())
    monkeypatch.setattr(api, "_union_on_card", lambda dev, nbytes: True)
    before = utils.counts().get("union_card_calls", 0)
    if layout == "point":
        p = da.isel(lat=2, lon=3)
        clim = xt.threshold(p, device="cpu")
        xt.detect(p, clim["thresh"], clim["seas"], device="cpu")
    else:
        clim = xt.threshold(da, device="cpu")
        xt.detect(da, clim["thresh"], clim["seas"], device="cpu",
                  events_layout="compact")
    assert utils.counts().get("union_card_calls", 0) == before
