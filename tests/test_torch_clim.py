"""Climatology of the PyTorch port against the JAX package on the CPU.

Inputs are made with numpy from a seed and go through both packages.
Tolerances: float64 rtol 1e-12 (the same sort + interpolation), with atol
1e-12 for means of O(1) data that cancel to ~1e-17, where the two sum
orders differ in the last bits; float32 thresh atol 1e-6 and seas atol
1e-5 (the bar tests/test_pallas.py sets between the JAX package's own
engines).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from xmhw_tpu.core import clim as jclim  # noqa: E402
from xmhw_tpu.core import pipeline as jpipe  # noqa: E402
from xmhw_tpu.core.calendar import (build_window_index,  # noqa: E402
                                    build_window_ranges, compute_doy)
from xmhw_tpu.ops.pallas.doy_quantile import doy_clim_pallas  # noqa: E402
from xmhw_tpu.xrlite import TimeIndex  # noqa: E402
from xmhw_tpu_torch.core import clim as tclim  # noqa: E402
from xmhw_tpu_torch.core import pipeline as tpipe  # noqa: E402
from xmhw_tpu_torch.ops import doy_quantile as tdq  # noqa: E402

TOL = {np.float64: dict(thresh=dict(rtol=1e-12, atol=1e-12),
                        seas=dict(rtol=1e-12, atol=1e-12)),
       np.float32: dict(thresh=dict(rtol=0.0, atol=1e-6),
                        seas=dict(rtol=0.0, atol=1e-5))}


@pytest.fixture(scope="module")
def tables():
    t = np.arange("2001-01-01", "2005-01-01",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    doy, ndoy = compute_doy(TimeIndex(t))
    gidx, _ = build_window_index(doy, 5, ndoy)
    starts, lens, ny, rmax = build_window_ranges(doy, 5, ndoy)
    return len(t), doy, ndoy, gidx, starts, lens, ny, rmax


def series(T, C, dtype, seed=0):
    """The lanes of tests/test_pallas.py: 0.01-quantized values (ties),
    a NaN run, an all-NaN cell, a constant cell, a sign-crossing cell and
    a near-zero cell."""
    rng = np.random.default_rng(seed)
    ts = np.round(rng.normal(0, 3, (T, C)), 2)
    ts[100:160, 7] = np.nan
    ts[:, 11] = np.nan
    ts[:, 19] = 3.25
    ts[:, 23] = rng.normal(0.0, 5.0, T)
    ts[:, 31] = rng.normal(0.0, 1e-6, T)
    return ts.astype(dtype)


def check(a, b, tol, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=what)
    np.testing.assert_allclose(a, b, equal_nan=True, err_msg=what, **tol)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("pctile", [90, 87.5])
def test_clim_kernel_matches_jax(tables, dtype, pctile):
    T, doy, ndoy, gidx, *_ = tables
    ts = series(T, 40, dtype)
    ja = jclim.clim_kernel(jnp.asarray(ts), jnp.asarray(gidx), pctile=pctile)
    tb = tclim.clim_kernel(torch.from_numpy(ts), torch.from_numpy(gidx),
                           pctile=pctile)
    for name, a, b in zip(("thresh", "seas"), ja, tb):
        assert b.dtype == torch.from_numpy(ts).dtype
        check(b.numpy(), a, TOL[dtype][name], name)
    assert np.isnan(tb[0].numpy()[:, 11]).all()


def test_clim_no_smoothing_no_patch(tables):
    T, doy, ndoy, gidx, *_ = tables
    ts = series(T, 40, np.float32, seed=3)
    kw = dict(smooth=False, patch_feb29=False)
    ja = jclim.clim_kernel(jnp.asarray(ts), jnp.asarray(gidx), **kw)
    tb = tclim.clim_kernel(torch.from_numpy(ts), torch.from_numpy(gidx),
                           **kw)
    for name, a, b in zip(("thresh", "seas"), ja, tb):
        check(b.numpy(), a, TOL[np.float32][name], name)


def test_finish_bit_equal_float32():
    """feb29 patch + 31-day circular smoothing: same adds in the same
    order as the compiled JAX code, so float32 agrees to the bit."""
    import jax

    rng = np.random.default_rng(5)
    x = rng.normal(20, 3, (366, 40)).astype(np.float32)
    x[:, 3] = np.nan
    x[58:61, 4] = np.nan

    @jax.jit
    def jfinish(c):
        return jclim.runavg_circular(jclim.feb29_patch(c), 31)

    a = np.asarray(jfinish(jnp.asarray(x)))
    b = tclim.finish_clim(torch.from_numpy(x), torch.from_numpy(x))[0]
    np.testing.assert_array_equal(b.numpy(), a)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_doy_quantile_plain_matches_doy_clim(tables, dtype):
    """The kernel's plain version (range tables, rmax NaN tail) against
    the JAX gather path doy_clim."""
    T, doy, ndoy, gidx, starts, lens, ny, rmax = tables
    ts = series(T, 40, dtype, seed=1)
    ja = jclim.doy_clim(jnp.asarray(ts), jnp.asarray(gidx), 90)
    tsp = np.concatenate([ts, np.full((rmax, 40), np.nan, dtype)])
    tb = tdq.doy_quantile(torch.from_numpy(tsp),
                          torch.from_numpy(starts.reshape(-1)),
                          torch.from_numpy(lens.reshape(-1)),
                          ndoy, ny, rmax, 90)
    for name, a, b in zip(("thresh", "seas"), ja, tb):
        check(b.numpy(), a, TOL[dtype][name], name)


def test_doy_quantile_plain_matches_pallas_interpret(tables):
    """Kernel 1's plain version against the TPU kernel itself, run in
    interpret mode at the size tests/test_pallas.py runs it."""
    T, doy, ndoy, gidx, starts, lens, ny, rmax = tables
    ts = series(T, 130, np.float32, seed=0)
    ja = doy_clim_pallas(ts, starts, lens, ny, rmax, 90, interpret=True)
    tsp = np.concatenate([ts, np.full((rmax, 130), np.nan, np.float32)])
    before = tdq.doy_quantile.launches
    tb = tdq.doy_quantile(torch.from_numpy(tsp),
                          torch.from_numpy(starts.reshape(-1)),
                          torch.from_numpy(lens.reshape(-1)),
                          ndoy, ny, rmax, 90)
    assert tdq.doy_quantile.launches == before  # CPU: no kernel launch
    for name, a, b in zip(("thresh", "seas"), ja, tb):
        check(b.numpy(), a, TOL[np.float32][name], name)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_run_clim_matches_jax(tables, dtype):
    """run_clim over several cell blocks, ragged last block."""
    T, doy, ndoy, *_ = tables
    ts = series(T, 70, dtype, seed=2)
    args = (ts, doy, 5, ndoy, 90, True, 31, True)
    a = jpipe.run_clim(*args, block=32, use_mesh=False)
    b = tpipe.run_clim(*args, block=32, device="cpu")
    for name, x, y in zip(("thresh", "seas"), a, b):
        assert y.dtype == dtype
        check(y, x, TOL[dtype][name], name)


def test_run_clim_subdaily_gather_path():
    """Sub-daily data has duplicate (doy, year) window centres: the range
    tables cannot hold the pool, so run_clim takes the gather path even
    when kernels are asked for (a choice made by the data)."""
    t = np.arange("2001-01-01", "2003-01-01",
                  dtype="datetime64[6h]").astype("datetime64[ns]")
    doy, ndoy = compute_doy(TimeIndex(t))
    with pytest.raises(ValueError):
        build_window_ranges(doy, 5, ndoy)
    ts = series(len(t), 40, np.float32, seed=4)
    args = (ts, doy, 5, ndoy, 90, True, 31, True)
    a = jpipe.run_clim(*args, use_mesh=False)
    b = tpipe.run_clim(*args, use_kernels=True, device="cpu")
    for name, x, y in zip(("thresh", "seas"), a, b):
        check(y, x, TOL[np.float32][name], name)
