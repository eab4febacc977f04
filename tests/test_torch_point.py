"""The port's host point path (core/point.py) on monthly and daily series.

A series of 12 steps a year (``tstep=True``) smooths its climatology
over a 31-step window, wider than its 12 rows: the window wraps round the
year more than once, as the grid path's ``torch.roll`` does, and the
point path must give the grid path's 12 rows. Daily climatologies (365
and 366 rows, wider than the window) keep the JAX package's bits.
Tolerances: float64 against the grid path rtol 1e-12 (the same pools and
quantiles; the smoothing adds in another order), event floats rtol 1e-9,
atol 1e-12 (tests/test_point_host.py's bar); bit-equal against xmhw_tpu.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from xmhw_tpu.core import point as jpoint  # noqa: E402
import xmhw_tpu_torch as xt  # noqa: E402
from xmhw_tpu_torch.core import point as tpoint  # noqa: E402
from xmhw_tpu_torch.xrlite import Coord, DataArray  # noqa: E402
from test_torch_doy_edges import monthly_times  # noqa: E402


@pytest.fixture(scope="module")
def monthly():
    """(point, 1 x 1 grid) of one monthly cell: a seasonal cycle, noise
    and a warm spell of 4 months in year 20, with a NaN month."""
    t = monthly_times(1982, 2011)
    rng = np.random.default_rng(12)
    m = np.arange(len(t))
    x = 15 + 3 * np.sin(2 * np.pi * m / 12) + rng.normal(0, 0.6, len(t))
    x[240:244] += 3.0
    x[100] = np.nan
    point = DataArray(x, ("time",), {"time": Coord(("time",), t)})
    grid = DataArray(x[:, None, None], ("time", "lat", "lon"),
                     {"time": Coord(("time",), t),
                      "lat": Coord(("lat",), np.array([-40.0])),
                      "lon": Coord(("lon",), np.array([150.0]))})
    return point, grid


KW = dict(tstep=True, dtype=np.float64, device="cpu")


def test_monthly_point_climatology_equals_grid(monthly):
    point, grid = monthly
    p = xt.threshold(point, **KW)
    g = xt.threshold(grid, **KW)
    for v in ("thresh", "seas"):
        assert p[v].shape == (12,)
        assert np.isfinite(p[v].data).all()
        np.testing.assert_allclose(p[v].data, g[v].data[:, 0, 0],
                                   rtol=1e-12, atol=0, err_msg=v)
    np.testing.assert_array_equal(p["thresh"].coords["doy"].values,
                                  np.arange(1, 13))


def test_monthly_point_detect_runs(monthly):
    point, grid = monthly
    kw = dict(KW, minDuration=3, maxGap=1)
    p = xt.threshold(point, **KW)
    pm = xt.detect(point, p["thresh"], p["seas"], **kw)
    g = xt.threshold(grid, **KW)
    gm = xt.detect(grid, g["thresh"], g["seas"], events_layout="compact",
                   **kw)
    keep = np.isfinite(np.asarray(gm["duration"].data)[:, 0, 0])
    n = int(keep.sum())
    assert n >= 1 and len(pm["events"].values) == n
    for k in pm.keys():
        a = np.asarray(pm[k].data)
        b = np.asarray(gm[k].data)[:, 0, 0][keep]
        if np.issubdtype(a.dtype, np.datetime64) or k in ("event",
                                                          "duration"):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12,
                                       equal_nan=True, err_msg=k)


@pytest.mark.parametrize("ndoy", [365, 366])
def test_daily_point_clim_bit_equal_to_jax(ndoy):
    rng = np.random.default_rng(ndoy)
    T = 6 * ndoy
    doy = (np.arange(T) % ndoy + 1).astype(np.int32)
    x = (15 + 3 * np.sin(2 * np.pi * np.arange(T) / ndoy)
         + rng.normal(0, 1, T))[:, None]
    x[50:60] = np.nan
    kw = dict(pctile=90, smooth=True, smooth_w=31, patch_feb29=ndoy == 366)
    a = jpoint.point_clim(x, doy, 5, ndoy, **kw)
    b = tpoint.point_clim(x, doy, 5, ndoy, **kw)
    for u, v in zip(a, b):
        assert u.shape == (ndoy, 1)
        np.testing.assert_array_equal(u.view(np.int64), v.view(np.int64))


@pytest.mark.parametrize("rows", [12, 31, 360])
def test_runavg_circular_wraps_like_the_grid_path(rows):
    """The point path's smoothing against core.clim.runavg_circular (the
    grid path's torch.roll): equal within rounding at any row count, and
    bit-equal to the JAX package's copy where that one's padding fits
    (31 rows or more)."""
    from xmhw_tpu_torch.core.clim import runavg_circular

    x = np.random.default_rng(rows).normal(size=(rows, 3))
    x[3, 1] = np.nan
    got = tpoint.runavg_circular_np(x, 31)
    want = runavg_circular(torch.from_numpy(x), 31).numpy()
    assert got.shape == (rows, 3)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14,
                               equal_nan=True)
    if rows >= 31:
        old = jpoint.runavg_circular_np(x, 31)
        np.testing.assert_array_equal(got.view(np.int64), old.view(np.int64))
