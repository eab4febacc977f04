"""The reference-style shims of the PyTorch port (identify.py, xmhw.py,
stats.py, features.py) against the JAX package's, on the same seeded
numpy inputs. runavg and mhw_filter run the port's torch code on CPU
tensors; the rest is numpy copied from the JAX package. Tolerances: the
running mean rtol 1e-12 (float64; the port multiplies by the rounded
reciprocal of w where XLA may divide), calc_clim as the float64
climatology in test_torch_clim.py (1e-12); everything else exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import xmhw_tpu.features as jfeat  # noqa: E402
import xmhw_tpu.identify as jid  # noqa: E402
import xmhw_tpu.stats as jst  # noqa: E402
import xmhw_tpu.xmhw as jxm  # noqa: E402
import xmhw_tpu.xrlite as jx  # noqa: E402
import xmhw_tpu_torch.features as tfeat  # noqa: E402
import xmhw_tpu_torch.identify as tid  # noqa: E402
import xmhw_tpu_torch.stats as tst  # noqa: E402
import xmhw_tpu_torch.xmhw as txm  # noqa: E402
import xmhw_tpu_torch.xrlite as tx  # noqa: E402


def series(pkg, years=3, seed=0):
    """A daily single-cell series as a DataArray of ``pkg``'s xrlite."""
    t = np.arange("2001-01-01", f"{2001 + years}-01-01",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    rng = np.random.default_rng(seed)
    v = np.round(15 + 3 * np.sin(2 * np.pi * np.arange(len(t)) / 365.25)
                 + rng.normal(0, 1, len(t)), 2)
    v[100:103] = np.nan
    return pkg.DataArray(v, ("time",), {"time": pkg.Coord(("time",), t)})


def doy_clim(pkg, seed=1):
    rng = np.random.default_rng(seed)
    data = rng.normal(15, 2, (366, 3, 4))
    data[10:14, 1, 2] = np.nan
    return pkg.DataArray(data, ("doy", "lat", "lon"),
                         {"doy": pkg.Coord(("doy",), np.arange(1, 367))})


@pytest.mark.parametrize("w", [31, 5])
def test_runavg_matches_jax(w):
    a = jid.runavg(doy_clim(jx), w)
    b = tid.runavg(doy_clim(tx), w)
    assert b.dims == a.dims
    np.testing.assert_allclose(b.data, a.data, rtol=1e-12, atol=0,
                               equal_nan=True)
    with pytest.raises(tid.XmhwException):
        tid.runavg(doy_clim(tx), 4)


@pytest.mark.parametrize("shape", ["1d", "2d"])
@pytest.mark.parametrize("join_gaps", [True, False])
def test_mhw_filter_matches_jax(shape, join_gaps):
    rng = np.random.default_rng(3)
    b = rng.random((400, 6)) < 0.55
    b[0:7, 2] = True   # a run from day 0
    if shape == "1d":
        b = b[:, 2]
    kw = dict(min_duration=5, join_gaps=join_gaps, max_gap=2)
    a = jid.mhw_filter(b, **kw)
    t = tid.mhw_filter(b, **kw)
    assert sorted(t) == sorted(a)
    for k in a:
        np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(a[k]),
                                      err_msg=k)
    assert np.nansum(np.isfinite(np.asarray(a["events"]))) > 0
    q = jid.mhw_filter(b, day0_fillna_quirk=True, **kw)
    r = tid.mhw_filter(b, day0_fillna_quirk=True, **kw)
    for k in q:
        np.testing.assert_array_equal(np.asarray(r[k]), np.asarray(q[k]))


def test_window_roll_and_pooled_clim_match_jax():
    a = jid.window_roll(series(jx), 5)
    b = tid.window_roll(series(tx), 5)
    np.testing.assert_array_equal(b.data, a.data)
    np.testing.assert_array_equal(b.coords["doy"].values,
                                  a.coords["doy"].values)
    np.testing.assert_array_equal(
        tid.window_roll_index(series(tx), 5),
        jid.window_roll_index(series(jx), 5))
    for tstep in (False, True):
        for fa, fb in ((jid.calculate_thresh, tid.calculate_thresh),
                       (jid.calculate_seas, tid.calculate_seas)):
            x, y = fa(a, tstep=tstep), fb(b, tstep=tstep)
            np.testing.assert_array_equal(y.data, x.data)
            np.testing.assert_array_equal(y.coords["doy"].values,
                                          x.coords["doy"].values)


def test_add_doy_feb29_join_events_match_jax():
    a, b = jid.add_doy(series(jx)), tid.add_doy(series(tx))
    np.testing.assert_array_equal(b.coords["doy"].values,
                                  a.coords["doy"].values)
    np.testing.assert_array_equal(tid.feb29(doy_clim(tx)),
                                  jid.feb29(doy_clim(jx)))
    evs = np.where(np.arange(30) % 7 < 4, np.arange(30.0), np.nan)
    joined = {(1, 7), (15, 19)}
    np.testing.assert_array_equal(tid.join_events(evs, joined),
                                  jid.join_events(evs, joined))


def test_calc_clim_matches_jax():
    a = jxm.calc_clim(series(jx, years=4), skipna=True)
    b = txm.calc_clim(series(tx, years=4), skipna=True, device="cpu")
    for x, y in zip(a, b):
        assert y.dims == x.dims and y.name == x.name
        np.testing.assert_allclose(y.data, x.data, rtol=1e-12, atol=1e-12,
                                   equal_nan=True)


def test_stats_and_features_shims_match_jax():
    s = np.array([1, 2, 2, 4, 1, 1, np.nan])
    for cat in (1, 2, 3):
        assert tst.cat_days(s, cat) == jst.cat_days(s, cat)
    v = np.array([2.3, 1.2, 3.5, 2.4, 2.3])
    np.testing.assert_array_equal(tst.rank_variable(v),
                                  jst.rank_variable(v))
    args = (np.array([3.0, 1.5]), np.array([1.0, 0.5]), np.array([2.0, 4.0]))
    np.testing.assert_array_equal(tfeat.get_rate(*args),
                                  jfeat.get_rate(*args))
    np.testing.assert_array_equal(
        tfeat.get_edge(*args[:2], np.array([0, 3]), 0),
        jfeat.get_edge(*args[:2], np.array([0, 3]), 0))
    p = (np.array([0, 2.0]), np.array([9, 12.0]), np.array([0, 3.0]), 12)
    for x, y in zip(tfeat.get_period(*p), jfeat.get_period(*p)):
        np.testing.assert_array_equal(x, y)
