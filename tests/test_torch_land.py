"""The land check's compaction (``api.land_check``) against the fancy-index
gather it replaced, and its route into page-locked memory.

``land_check`` finds the kept cells and gathers their columns by row
chunks on the process's torch threads; every case here must equal the
former ``ts.isel(cell=keep)`` result bit for bit: data, dtype, dims,
coordinates and attributes. ``threshold()`` and ``detect()`` hand the
land check their device and compute dtype: on a CUDA device the kept
cells go into page-locked memory where it fits (``api._land_pinned``),
which CPU tests force, the buffer then being plain memory. Imports no
JAX.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import xmhw_tpu_torch as xt  # noqa: E402
from test_torch_union import field, grid, same_bits  # noqa: E402
from xmhw_tpu_torch import api, identify, utils  # noqa: E402
from xmhw_tpu_torch.exception import XmhwException  # noqa: E402
from xmhw_tpu_torch.xrlite import Coord, DataArray, TimeIndex  # noqa: E402

MiB = 1 << 20


def fancy_land_check(temp, tdim="time", anynans=False):
    """The land check as it was: a full-size NaN mask, then numpy's
    fancy index over the kept cells."""
    dims = [d for d in temp.dims if d != tdim]
    ts = temp.stack_cell(dims, "cell")
    nan = np.isnan(ts.data)
    tax = ts.dims.index(tdim)
    drop = nan.all(axis=tax) if not anynans else nan.any(axis=tax)
    return ts.isel(cell=np.nonzero(~drop)[0])


def series(T=103, ny=6, nx=7, land="rows and columns", seed=5):
    """(T, ny, nx) float64 with land cells all NaN and, in ocean cells,
    a few NaN days (which ``anynans`` drops)."""
    rng = np.random.default_rng(seed)
    x = 15 + rng.normal(0, 2, (T, ny, nx))
    if land == "rows and columns":
        x[:, 0, :] = np.nan
        x[:, :, 4] = np.nan
    elif land == "random":
        x[:, rng.random((ny, nx)) < 0.3] = np.nan
    else:  # one ocean cell
        ocean = x[:, 2, 3].copy()
        x[:] = np.nan
        x[:, 2, 3] = ocean
    x[[1, 50], 3, 1] = np.nan
    x[T - 1, 5, 6] = np.nan
    return x


def labelled(x, order):
    T, ny, nx = x.shape
    t = (np.datetime64("1990-01-01", "ns")
         + np.arange(T) * np.timedelta64(1, "D"))
    coords = {"time": Coord(("time",), t, {"axis": "T"}),
              "lat": Coord(("lat",), np.linspace(-40, -35, ny),
                           {"units": "degrees_north"}),
              "lon": Coord(("lon",), np.linspace(150, 156, nx)),
              "depth": Coord((), 0.5)}
    if order == "lat, lon, time":
        x = np.moveaxis(x, 0, -1)
        return DataArray(x, ("lat", "lon", "time"), coords,
                         {"units": "degree_C"}, "sst")
    return DataArray(x, ("time", "lat", "lon"), coords,
                     {"units": "degree_C"}, "sst")


def same_da(a, b):
    """Two DataArrays equal bit for bit in data, dims, coordinates,
    attributes and name."""
    same_bits(a.data, b.data, "data")
    assert b.data.flags.c_contiguous
    assert b.dims == a.dims
    assert b.attrs == a.attrs and b.name == a.name
    assert sorted(b.coords) == sorted(a.coords)
    for k, c in a.coords.items():
        d = b.coords[k]
        assert d.dims == c.dims and d.attrs == c.attrs, k
        assert type(d.values) is type(c.values), k
        va, vb = (np.asarray(v.values if isinstance(v, TimeIndex) else v)
                  for v in (c.values, d.values))
        same_bits(va, vb, k)


@pytest.mark.parametrize("chunk_bytes", [api._CHUNK_BYTES, (2000, 1000)])
@pytest.mark.parametrize("order", ["time, lat, lon", "lat, lon, time"])
@pytest.mark.parametrize("land", ["rows and columns", "random",
                                  "one ocean cell"])
@pytest.mark.parametrize("anynans", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_compaction_equals_the_fancy_index(dtype, anynans, land, order,
                                           chunk_bytes, monkeypatch):
    """Every case bit-equal to the fancy-index gather; chunks of 1-2 kB
    are a few rows each, so T = 103 is no multiple of them."""
    monkeypatch.setattr(api, "_CHUNK_BYTES", chunk_bytes)
    da = labelled(series(land=land).astype(dtype), order)
    want = fancy_land_check(da, anynans=anynans)
    if anynans and land == "one ocean cell":
        assert want.sizes["cell"] == 1
    same_da(want, api.land_check(da, anynans=anynans))
    # the compute dtype, written in the same pass
    got = api.land_check(da, anynans=anynans, dtype=np.float32)
    same_bits(want.data.astype(np.float32), got.data, "float32")


def test_threads_split_the_rows(monkeypatch):
    """Row chunks on torch's thread count give the fancy-index result;
    the pool is made once for a thread count, and a series of one chunk
    stays on the calling thread."""
    x = series(T=400, ny=9, nx=11, land="random")
    da = labelled(x, "time, lat, lon")
    monkeypatch.setattr(api, "_CHUNK_BYTES", (64 * 99 * 8, 64 * 99 * 8))
    monkeypatch.setattr(api, "_POOLS", {})
    pools = []
    real = api.ThreadPoolExecutor

    def spy(n, prefix):
        pools.append(n)
        return real(n, prefix)

    monkeypatch.setattr(api, "ThreadPoolExecutor", spy)
    got = {}
    try:
        for nt in (4, 4, 1, 3):
            torch.set_num_threads(nt)
            got[nt] = api.land_check(da)
        one = api.land_check(da.isel(time=slice(0, 64)))  # one chunk
    finally:
        torch.set_num_threads(2)
    assert pools == [4, 3]
    assert list(api._POOLS) == [(os.getpid(), 3)]
    for out in got.values():
        same_da(fancy_land_check(da), out)
    same_da(fancy_land_check(da.isel(time=slice(0, 64))), one)


@pytest.mark.parametrize("anynans", [False, True])
def test_all_land_raises(anynans):
    x = series()
    x[:, :, :] = np.nan
    with pytest.raises(XmhwException,
                       match="All points of grid are either land or NaN"):
        api.land_check(labelled(x, "time, lat, lon"), anynans=anynans)
    # anynans drops a cell with one NaN day; here every cell has one
    y = series(land="one ocean cell")
    y[7] = np.nan
    if anynans:
        with pytest.raises(XmhwException, match="All points"):
            api.land_check(labelled(y, "time, lat, lon"), anynans=True)
    else:
        assert api.land_check(labelled(y, "time, lat, lon")).sizes[
            "cell"] == 1


def test_public_call_keeps_plain_memory_and_the_series_dtype():
    da = labelled(series(), "time, lat, lon")
    before = utils.counts()
    got = api.land_check(da)
    after = utils.counts()
    assert got.data.dtype == np.float64
    assert not isinstance(got.data.base, torch.Tensor)
    assert after["land_calls"] - before.get("land_calls", 0) == 1
    assert after.get("land_pinned_calls", 0) == before.get(
        "land_pinned_calls", 0)
    assert identify.land_check is api.land_check


def ds_bits(a, b):
    assert sorted(a.keys()) == sorted(b.keys())
    for k in a.keys():
        assert a[k].dims == b[k].dims, k
        for c in a[k].coords:
            same_bits(np.asarray(a[k].coords[c].values),
                      np.asarray(b[k].coords[c].values), (k, c))
        same_bits(np.asarray(a[k].data), np.asarray(b[k].data), k)


@pytest.mark.parametrize("kw", [{}, dict(dtype=np.float64),
                                dict(anynans=True),
                                dict(coldSpells=True, maxPadLength=2)],
                         ids=["float32", "float64", "anynans", "cold gaps"])
def test_api_outputs_equal_on_either_route(kw, monkeypatch):
    """threshold() + detect() with the pinned route forced on and off
    (on the CPU its buffer is plain memory): the same bits; the counters
    count the four land checks of a pair, and the forced route's."""
    x = field()
    x[[3, 9], 1, 2] = np.nan  # ocean gaps: maxPadLength fills them
    da = grid(x)
    runs = {}
    for route in (False, True):
        monkeypatch.setattr(api, "_land_pinned",
                            lambda dev, nbytes, r=route: r)
        before = utils.counts()
        clim = xt.threshold(da, device="cpu", **kw)
        mhw = xt.detect(da, clim["thresh"], clim["seas"], device="cpu",
                        **kw)
        after = utils.counts()
        assert after["land_calls"] - before.get("land_calls", 0) == 4
        assert after.get("land_pinned_calls", 0) - before.get(
            "land_pinned_calls", 0) == (4 if route else 0)
        runs[route] = clim, mhw
    for a, b in zip(runs[False], runs[True]):
        ds_bits(a, b)


@pytest.mark.parametrize("route", [False, True])
def test_the_kept_array_reaches_run_clim_uncopied(route, monkeypatch):
    """A float64 series with dtype=None: the land check writes float32,
    the compute dtype, and run_clim gets that very array, a view of the
    route's tensor where the route is taken."""
    monkeypatch.setattr(api, "_land_pinned", lambda dev, nbytes: route)
    kept, handed = [], []
    real_lc, real_clim = api.land_check, api.run_clim

    def land_check(*a, **kw):
        out = real_lc(*a, **kw)
        kept.append(out.data)
        return out

    def run_clim(ts_np, *a, **kw):
        handed.append(ts_np)
        return real_clim(ts_np, *a, **kw)

    monkeypatch.setattr(api, "land_check", land_check)
    monkeypatch.setattr(api, "run_clim", run_clim)
    da = grid(field())
    xt.threshold(da, device="cpu")
    (k,), (h,) = kept, handed
    assert h is k and h.dtype == np.float32
    base = h
    while isinstance(base, np.ndarray) and base.base is not None:
        base = base.base
    assert isinstance(base, torch.Tensor) == route


def test_route_is_chosen_from_device_and_size(monkeypatch):
    """The pinned route on a CUDA device alone, and only where the
    buffer, rounded up to a power of two, fits in the host memory
    available."""
    assert not api._land_pinned(None, 1)
    assert not api._land_pinned(torch.device("cpu"), 1)
    assert not api._land_pinned("cpu", 1)
    monkeypatch.setattr(api, "_host_available", lambda: 2 * MiB)
    assert api._land_pinned(torch.device("cuda"), MiB + 1)
    assert api._land_pinned("cuda:1", 2 * MiB)
    assert not api._land_pinned("cuda", 2 * MiB + 1)
    monkeypatch.setattr(api, "_host_available", lambda: 0)
    assert not api._land_pinned("cuda", 1)
