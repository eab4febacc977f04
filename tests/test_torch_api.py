"""Public API of the PyTorch port against the JAX package on a small grid.

threshold(), detect() and run_fused (with its stats stage) run on the
CPU (device="cpu", the plain torch code) and are compared with xmhw_tpu
on the same numpy data:
every output variable, its dims, coordinates and attributes. detect() is
fed the JAX package's climatology. Tolerances: climatology as in
test_torch_clim.py, event tables as in test_torch_detect.py (times,
positions and day counts exact).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import xmhw_tpu as xm  # noqa: E402
import xmhw_tpu_torch as xt  # noqa: E402
from xmhw_tpu.core import pipeline as jpipe  # noqa: E402
from xmhw_tpu.core.calendar import compute_doy  # noqa: E402
from xmhw_tpu.xrlite import Coord, DataArray, TimeIndex  # noqa: E402
from xmhw_tpu_torch.core import pipeline as tpipe  # noqa: E402

CLIM_TOL = {np.float64: dict(rtol=1e-12, atol=1e-12),
            np.float32: dict(rtol=0.0, atol=1e-5)}  # seas; thresh 1e-6
EVENT_TOL = {np.float64: 1e-8, np.float32: 2e-3}
EXACT = ("event", "index_", "time_", "duration", "category", "events",
         "bthresh")


@pytest.fixture(scope="module")
def grid():
    """3 daily years on a 4 x 10 grid: seasonal cycle + smoothed noise,
    5 land (all-NaN) cells and one cell with short NaN gaps."""
    t = np.arange("2001-01-01", "2004-01-01",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    T = len(t)
    rng = np.random.default_rng(21)
    noise = rng.normal(0, 1, (T + 14, 4, 10))
    sm = np.stack([noise[k:k + T] for k in range(15)]).mean(0)
    day = np.arange(T)[:, None, None]
    ts = 15 + 3 * np.sin(2 * np.pi * day / 365.25) + 2.5 * sm
    ts[:, [0, 1, 2, 3, 3], [0, 4, 9, 1, 2]] = np.nan
    for s in (30, 300, 700):
        ts[s:s + 2, 2, 5] = np.nan
    return DataArray(
        ts, ("time", "lat", "lon"),
        {"time": Coord(("time",), t),
         "lat": Coord(("lat",), np.linspace(-40, -37, 4),
                      {"units": "degrees_north"}),
         "lon": Coord(("lon",), np.linspace(150, 159, 10))},
        {"units": "degree_C"})


def same_ds(a, b, rtol=0.0, atol=0.0, exact=()):
    """Every variable of ``b`` (port) matches ``a`` (JAX): dims, coords,
    attrs, dtype, and data (NaN/NaT patterns equal)."""
    assert sorted(b.keys()) == sorted(a.keys())
    assert b.attrs == a.attrs
    for k in a.keys():
        x, y = a[k], b[k]
        assert y.dims == x.dims, k
        assert y.attrs == x.attrs, k
        assert sorted(y.coords) == sorted(x.coords), k
        for c in x.coords:
            np.testing.assert_array_equal(np.asarray(y.coords[c].values),
                                          np.asarray(x.coords[c].values))
            assert y.coords[c].attrs == x.coords[c].attrs, (k, c)
        xd, yd = np.asarray(x.data), np.asarray(y.data)
        assert yd.dtype == xd.dtype, k
        if not np.issubdtype(xd.dtype, np.floating) or any(
                k.startswith(e) for e in exact):
            np.testing.assert_array_equal(yd, xd, err_msg=k)
        else:
            np.testing.assert_array_equal(np.isnan(yd), np.isnan(xd),
                                          err_msg=k)
            np.testing.assert_allclose(yd, xd, rtol=rtol, atol=atol,
                                       equal_nan=True, err_msg=k)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_threshold_matches_jax(grid, dtype):
    kw = dict(dtype=dtype, climatologyPeriod=[2001, 2002])
    a = xm.threshold(grid, **kw)
    b = xt.threshold(grid, device="cpu", **kw)
    same_ds(a, b, **CLIM_TOL[dtype])
    if dtype == np.float32:  # thresh holds the tighter bar
        np.testing.assert_allclose(b["thresh"].data, a["thresh"].data,
                                   rtol=0.0, atol=1e-6, equal_nan=True)


@pytest.mark.parametrize("layout", ["union", "compact"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_detect_matches_jax(grid, layout, dtype):
    clim = xm.threshold(grid, dtype=dtype)
    a = xm.detect(grid, clim["thresh"], clim["seas"], dtype=dtype,
                  events_layout=layout)
    b = xt.detect(grid, clim["thresh"], clim["seas"], dtype=dtype,
                  events_layout=layout, device="cpu")
    assert np.isfinite(np.asarray(b["duration"].data)).sum() > 50
    tol = EVENT_TOL[dtype]
    same_ds(a, b, rtol=tol, atol=tol, exact=EXACT)


def test_detect_cold_maxpad_intermediate(grid):
    kw = dict(coldSpells=True, maxPadLength=3, dtype=np.float64)
    clim = xm.threshold(grid, **kw)
    a, ia = xm.detect(grid, clim["thresh"], clim["seas"], intermediate=True,
                      **kw)
    b, ib = xt.detect(grid, clim["thresh"], clim["seas"], intermediate=True,
                      device="cpu", **kw)
    same_ds(a, b, rtol=1e-8, atol=1e-8, exact=EXACT)
    same_ds(ia, ib, rtol=1e-12, atol=1e-12, exact=EXACT)
    # and the port's own climatology gives the same events
    c = xt.detect(grid, *(xt.threshold(grid, device="cpu", **kw)[v]
                          for v in ("thresh", "seas")), device="cpu", **kw)
    same_ds(a, c, rtol=1e-8, atol=1e-8, exact=EXACT)


def test_detect_reference_fixture(define_data, mhw_expected):
    """The reference's 9-day single-cell event (tests/conftest.py)."""
    ts, th, se = define_data
    mhw = xt.detect(ts, th, se, dtype=np.float64, device="cpu")
    assert list(mhw["events"].values) == [1]
    for k, v in mhw_expected.items():
        got = float(np.asarray(mhw[k].data).reshape(-1)[0])
        np.testing.assert_allclose(got, v, rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("cold", [False, True])
def test_run_fused_matches_jax(grid, cold):
    a = xm.land_check(grid)
    b = xt.land_check(grid)
    np.testing.assert_array_equal(b.data, a.data)
    ts = np.asarray(a.data, np.float64)
    tvals = np.asarray(grid.coords["time"].values)
    doy, _ = compute_doy(TimeIndex(tvals))
    sel = tvals < np.datetime64("2003-01-01")
    mask = np.ones(ts.shape[1], bool)
    mask[3] = False
    kw = dict(ts_clim_np=ts[sel], doy_clim_np=doy[sel], det_mask_np=mask,
              cold_spells=cold, block=16)
    ja = jpipe.run_fused(ts, doy, (doy - 1).astype(np.int32), **kw)
    tb = tpipe.run_fused(ts, doy, (doy - 1).astype(np.int32), device="cpu",
                         **kw)
    for x, y in zip(ja[:2], tb[:2]):
        np.testing.assert_allclose(y, x, rtol=1e-12, atol=1e-12,
                                   equal_nan=True)
    np.testing.assert_array_equal(tb[3], ja[3])
    assert tb[3][3] == 0 and tb[3].sum() > 50
    assert sorted(tb[2]) == sorted(ja[2])
    for k in ja[2]:
        np.testing.assert_allclose(tb[2][k], ja[2][k], rtol=1e-8, atol=1e-8,
                                   equal_nan=True, err_msg=k)


@pytest.mark.parametrize("cold", [False, True])
def test_run_fused_stats_matches_jax(grid, cold):
    """run_fused's stats stage (block and day statistics, ranks) against
    the JAX package's, float64: a raw day series beside the detection
    series, a period shorter than the record, a masked cell and several
    cell blocks. Tables to 1e-8, block and day stats rtol 1e-9, ranks
    exactly equal."""
    from xmhw_tpu.core.stats import day_block_edges

    ts = np.asarray(xm.land_check(grid).data, np.float64)
    tvals = np.asarray(grid.coords["time"].values)
    doy, _ = compute_doy(TimeIndex(tvals))
    years = tvals.astype("datetime64[Y]").astype(int) + 1970
    bins = np.arange(2001, 2004)     # 2003 lies outside the period
    ybod = np.where(years < bins[-1], years - bins[0], -1).astype(np.int32)
    ts_day = ts.copy()
    ts_day[200:230, 6] = np.nan
    mask = np.ones(ts.shape[1], bool)
    mask[3] = False
    kw = dict(ts_day_np=ts_day, ybod_np=ybod, nbins=len(bins) - 1,
              day_edges=day_block_edges(years, bins), count_nans=True,
              rank_names=("intensity_max", "duration", "rate_onset"),
              det_mask_np=mask, cold_spells=cold, block=16)
    pos = (doy - 1).astype(np.int32)
    ja = jpipe.run_fused(ts, doy, pos, **kw)
    tb = tpipe.run_fused(ts, doy, pos, device="cpu", **kw)
    np.testing.assert_array_equal(tb[3], ja[3])
    for k in ja[2]:
        np.testing.assert_allclose(tb[2][k], ja[2][k], rtol=1e-8, atol=1e-8,
                                   equal_nan=True, err_msg=k)
    assert sorted(tb[4]) == sorted(ja[4]) == ["block", "day", "rank"]
    for part, want in ja[4].items():
        got = tb[4][part]
        assert sorted(got) == sorted(want), part
        for k, v in want.items():
            assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
            if part == "rank" or k == "ecount" or k.endswith("_days"):
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:
                np.testing.assert_allclose(got[k], v, rtol=1e-9, atol=0,
                                           equal_nan=True, err_msg=k)
    assert np.nansum(tb[4]["block"]["ecount"]) > 20
    assert tb[4]["day"]["nan_days"][:, 6].sum() == 30


def test_flip_cold_and_validation(grid):
    ds = xt.threshold(grid, device="cpu")
    with pytest.raises(xt.XmhwException):
        xt.detect(grid, ds["thresh"], ds["seas"], minDuration=3, maxGap=3,
                  device="cpu")
    with pytest.raises(xt.XmhwException):
        xt.threshold(grid, smoothPercentileWidth=30, device="cpu")
    with pytest.raises(TypeError, match="mesh"):
        xt.threshold(grid, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="mesh"):
        xt.detect(grid, ds["thresh"], ds["seas"], mesh=[torch.device("cpu")],
                  device="cpu")
    # a mesh of three CPU entries gives the single-device climatology
    meshed = xt.threshold(grid, mesh=xt.parallel.cell_mesh(
        [torch.device("cpu")] * 3), device="cpu")
    same_ds(ds, meshed)
    mhw = xt.detect(grid, ds["thresh"], ds["seas"], device="cpu")
    flipped = xt.flip_cold(mhw.copy())
    np.testing.assert_array_equal(flipped["intensity_max"].data,
                                  -mhw["intensity_max"].data)
    np.testing.assert_array_equal(flipped["intensity_var"].data,
                                  mhw["intensity_var"].data)


def test_point_series_matches_jax(grid):
    """A time-only series takes the numpy point path in both packages."""
    pt = xm.land_check(grid).isel(cell=5)
    pt = DataArray(np.asarray(pt.data), ("time",),
                   {"time": pt.coords["time"]})
    a = xm.threshold(pt, dtype=np.float64)
    b = xt.threshold(pt, dtype=np.float64, device="cpu")
    same_ds(a, b, rtol=1e-12, atol=1e-12)
    ma = xm.detect(pt, a["thresh"], a["seas"], dtype=np.float64)
    mb = xt.detect(pt, a["thresh"], a["seas"], dtype=np.float64,
                   device="cpu")
    same_ds(ma, mb, rtol=1e-8, atol=1e-8, exact=EXACT)
