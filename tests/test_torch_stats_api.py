"""block_average() and mhw_rank() of the PyTorch port against xmhw_tpu.

A synthetic 4-year daily grid of 8 x 8 cells with land (all-NaN) cells
and short NaN gaps goes through the JAX package's threshold() + detect()
(float64, both event layouts); the resulting event Datasets feed
block_average/mhw_rank of both packages. The port's torch path on the CPU
(``device="cpu"``) is held against the JAX device path
(``device=True``), and the port's host path (``device=False``) against
the JAX host path. Bars, the JAX suite's own (tests/test_stats.py:
299-334): event statistics rtol 1e-12, per-day statistics rtol 1e-9,
counts and ranks exactly equal, return periods rtol 1e-12.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import xmhw_tpu as xm  # noqa: E402
import xmhw_tpu_torch as xt  # noqa: E402
from xmhw_tpu.xrlite import Coord, DataArray  # noqa: E402

DAY_STATS = ("ts_mean", "ts_max", "ts_min")
MODES = {
    "period": lambda ts, inter: dict(period=[2001, 2004]),
    "ts": lambda ts, inter: dict(dstime=ts),
    "cats": lambda ts, inter: dict(dstime=inter),
    "removeMissing": lambda ts, inter: dict(dstime=inter,
                                            removeMissing=True),
    "blockLength2": lambda ts, inter: dict(dstime=inter, blockLength=2),
    "split": lambda ts, inter: dict(period=[2001, 2004], split=True),
    "quirks": lambda ts, inter: dict(period=[2001, 2004],
                                     reference_quirks=True),
}


@pytest.fixture(scope="module")
def grid():
    t = np.arange("2001-01-01", "2005-01-01",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    T = len(t)
    rng = np.random.default_rng(8)
    noise = rng.normal(0, 1, (T + 14, 8, 8))
    sm = np.stack([noise[k:k + T] for k in range(15)]).mean(0)
    day = np.arange(T)[:, None, None]
    ts = 15 + 3 * np.sin(2 * np.pi * day / 365.25) + 2.5 * sm
    ts[:, [0, 3, 7, 7], [0, 5, 1, 2]] = np.nan      # land
    for s in (40, 400, 900):
        ts[s:s + 2, 2, 6] = np.nan                  # gaps
    return DataArray(
        ts, ("time", "lat", "lon"),
        {"time": Coord(("time",), t),
         "lat": Coord(("lat",), np.linspace(-40, -33, 8)),
         "lon": Coord(("lon",), np.linspace(150, 157, 8))})


@pytest.fixture(scope="module", params=["union", "compact"])
def events(request, grid):
    clim = xm.threshold(grid, dtype=np.float64)
    mhw, inter = xm.detect(grid, clim["thresh"], clim["seas"],
                           dtype=np.float64, intermediate=True,
                           events_layout=request.param)
    assert np.isfinite(np.asarray(mhw["duration"].data)).sum() > 50
    return mhw, inter


def same_stats(got, want, what):
    assert sorted(got.keys()) == sorted(want.keys()), what
    for k in want.keys():
        a, b = got[k], want[k]
        assert a.dims == b.dims, (what, k)
        for c in b.coords:
            np.testing.assert_array_equal(np.asarray(a.coords[c].values),
                                          np.asarray(b.coords[c].values))
        x, y = np.asarray(a.data), np.asarray(b.data)
        assert x.shape == y.shape and x.dtype == y.dtype, (what, k)
        np.testing.assert_array_equal(np.isnan(x), np.isnan(y),
                                      err_msg=f"{what} {k}")
        if k == "ecount" or k.endswith("_days"):
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {k}")
        rtol = 1e-9 if k in DAY_STATS else 1e-12
        np.testing.assert_allclose(x, y, rtol=rtol, atol=0, equal_nan=True,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_block_average_matches_jax(grid, events, mode):
    mhw, inter = events
    kw = MODES[mode](grid, inter)
    jax_dev = xm.block_average(mhw, device=True, **kw)
    same_stats(xt.block_average(mhw, device="cpu", **kw), jax_dev,
               f"{mode} torch")
    jax_host = xm.block_average(mhw, device=False, **kw)
    same_stats(xt.block_average(mhw, device=False, **kw), jax_host,
               f"{mode} host")
    assert np.nansum(jax_host["ecount"].data) > 50


@pytest.mark.parametrize("device", ["cpu", False])
def test_mhw_rank_matches_jax(events, device):
    mhw, _ = events
    rank_j, ret_j = xm.mhw_rank(mhw, device=bool(device))
    rank_t, ret_t = xt.mhw_rank(mhw, device=device)
    assert sorted(rank_t.keys()) == sorted(rank_j.keys())
    assert "intensity_max" in rank_t.keys()
    for k in rank_j.keys():
        assert rank_t[k].dims == rank_j[k].dims, k
        np.testing.assert_array_equal(rank_t[k].data, rank_j[k].data,
                                      err_msg=k)
        np.testing.assert_allclose(ret_t[k].data, ret_j[k].data, rtol=1e-12,
                                   atol=0, equal_nan=True, err_msg=k)


def test_default_device_is_the_card(events):
    """block_average()/mhw_rank() without ``device`` run on the card, so
    here, without a GPU, they raise; reference_quirks=True takes the host
    path whatever the device, as in the JAX package."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: nothing to refuse")
    mhw, _ = events
    with pytest.raises(RuntimeError, match="cuda"):
        xt.block_average(mhw, period=[2001, 2003])
    with pytest.raises(RuntimeError, match="cuda"):
        xt.mhw_rank(mhw)
    kw = dict(period=[2001, 2003], reference_quirks=True)
    same_stats(xt.block_average(mhw, **kw),
               xm.block_average(mhw, device=False, **kw), "quirks")


def test_block_average_device_argument(grid, events):
    """device=True is "cuda" (raises here without a GPU, in
    test_torch_port_guard.py); a torch.device names the device; the
    year-unsorted time axis falls back to the host day binning."""
    mhw, inter = events
    a = xt.block_average(mhw, dstime=inter, device=torch.device("cpu"))
    b = xt.block_average(mhw, dstime=inter, device="cpu")
    for k in b.keys():
        np.testing.assert_array_equal(a[k].data, b[k].data, err_msg=k)
    T = grid.sizes["time"]
    order = np.r_[0, np.random.default_rng(2).permutation(T - 2) + 1, T - 1]
    shuffled = grid.isel(time=order)
    c = xt.block_average(mhw, dstime=shuffled, device="cpu")
    d = xm.block_average(mhw, dstime=shuffled, device=False)
    same_stats(c, d, "unsorted")
