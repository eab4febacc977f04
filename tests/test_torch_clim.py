"""Climatology of the PyTorch port against the JAX package on the CPU.

Inputs are made with numpy from a seed and go through both packages.
Tolerances: float64 rtol 1e-12 (the same sort + interpolation), with atol
1e-12 for means of O(1) data that cancel to ~1e-17, where the two sum
orders differ in the last bits; float32 thresh atol 1e-6 and seas atol
1e-5 (the bar tests/test_pallas.py sets between the JAX package's own
engines). Over warm water (29-33 degC) and on the edge pools of
tests/test_torch_doy_edges.py, float64 is the judge of float32 seas: the
port's is correctly rounded and no further from the float64 mean than
the JAX package's engine, plus one ulp; thresholds are bit-equal.
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
import test_torch_doy_edges as edges  # noqa: E402

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


def padded(ts, rmax):
    return np.concatenate([ts, np.full((rmax, ts.shape[1]), np.nan,
                                       ts.dtype)])


def plain_clim(ts, starts, lens, ndoy, ny, rmax, pctile=90):
    """Kernel 1's plain version on a numpy series, as numpy arrays."""
    out = tdq.doy_quantile(torch.from_numpy(padded(ts, rmax)),
                           torch.from_numpy(starts.reshape(-1)),
                           torch.from_numpy(lens.reshape(-1)),
                           ndoy, ny, rmax, pctile)
    return tuple(a.numpy() for a in out)


def mean64(ts, gidx):
    """The pooled mean in float64 (numpy), NaN where a pool is empty."""
    ok = gidx >= 0
    v = ts.astype(np.float64)[np.where(ok, gidx, 0)]
    m = ok[..., None] & np.isfinite(v)
    n = m.sum(axis=1)
    with np.errstate(invalid="ignore"):
        return np.where(m, v, 0.0).sum(axis=1) / n


def bits_equal(a, b, what):
    """float32 arrays equal bit for bit (NaN patterns equal)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=what)
    ok = ~np.isnan(a)
    np.testing.assert_array_equal(a[ok].view(np.int32),
                                  b[ok].view(np.int32), err_msg=what)


def dist(a, judge):
    """Max |a - judge| over the entries where judge is finite."""
    ok = np.isfinite(judge)
    return float(np.abs(np.asarray(a, np.float64)[ok] - judge[ok]).max())


def assert_judged(port, other, judge, what):
    """float64 is the judge of a float32 seas: the port's is no further
    from it, in the max norm, than ``other`` is, plus one float32 ulp at
    the largest |seas|."""
    np.testing.assert_array_equal(np.isnan(port), np.isnan(judge),
                                  err_msg=what)
    if np.isnan(judge).all():
        return
    ulp = float(np.spacing(np.float32(np.nanmax(np.abs(judge)))))
    assert dist(port, judge) <= dist(other, judge) + ulp, what


def assert_rounded_once(port, judge, what):
    """Every finite float32 entry within 0.5 ulp (+1e-12) of the float64
    value: correctly rounded."""
    ok = np.isfinite(judge)
    half = 0.5 * np.spacing(np.abs(port[ok]).astype(np.float32))
    err = np.abs(port[ok].astype(np.float64) - judge[ok])
    assert (err <= half.astype(np.float64) + 1e-12).all(), what


@pytest.mark.parametrize("case", ("lanes",) + edges.KINDS)
def test_doy_quantile_plain_matches_pallas_interpret(tables, case):
    """Kernel 1's plain version against the TPU kernel itself, run in
    interpret mode: the lanes of tests/test_pallas.py at its size, and the
    edge pools of tests/test_torch_doy_edges.py, one kind per case. The
    Pallas kernel starts its radix select at the pools' common prefix, the
    plain version at bit 31, so equal thresholds show the skip changes no
    result. seas: the repo's bar on the lanes; float64 is the judge on the
    edge pools, some of which hold values near 1e30."""
    T, doy, ndoy, gidx, starts, lens, ny, rmax = tables
    if case == "lanes":
        ts = series(T, 130, np.float32, seed=0)
    else:
        ts = edges.edge_series(T, 40, seed=2, kinds=(case,))
    ja = [np.asarray(a) for a in
          doy_clim_pallas(ts, starts, lens, ny, rmax, 90, interpret=True)]
    before = tdq.doy_quantile.launches
    tb = plain_clim(ts, starts, lens, ndoy, ny, rmax)
    assert tdq.doy_quantile.launches == before  # CPU: no kernel launch
    bits_equal(tb[0], ja[0], "thresh")
    if case == "lanes":
        check(tb[1], ja[1], TOL[np.float32]["seas"], "seas")
        return
    judge = mean64(ts, gidx)
    assert_rounded_once(tb[1], judge, "seas")
    assert_judged(tb[1], ja[1], judge, "seas")


def warm_series(T, C, seed):
    """(T, C) float32 over warm water: a base of 29-33 degC, a seasonal
    cycle and 15-day-smoothed noise (chip_smoke.py's recipe)."""
    rng = np.random.default_rng(seed)
    day = np.arange(T, dtype=np.float64)[:, None]
    noise = rng.normal(0.0, 1.0, (T + 14, C))
    cs = np.concatenate([np.zeros((1, C)), np.cumsum(noise, axis=0)])
    sm = (cs[15:15 + T] - cs[:T]) / 15.0
    base = rng.uniform(29.0, 33.0, C)
    ts = base + np.sin(2 * np.pi * day / 365.25) + 0.5 * sm
    return ts.astype(np.float32)


def warm_engines(cells=64):
    """seas over warm cells and a 30-year climatology (1983-2012) from
    four engines: the JAX package's XLA gather path and its Pallas kernel
    (interpret mode), the port's plain version of kernel 1, and a float64
    numpy mean; raw, and after the Feb-29 patch and 31-day smoothing
    (the JAX package's functions for its engines, the port's finish_clim
    for the port and, in float64, for the judge). Thresholds too."""
    import jax

    t = np.arange("1983-01-01", "2013-01-01",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    doy, ndoy = compute_doy(TimeIndex(t))
    gidx, _ = build_window_index(doy, 5, ndoy)
    starts, lens, ny, rmax = build_window_ranges(doy, 5, ndoy)
    ts = warm_series(len(t), cells, seed=7)
    xla = [np.asarray(a) for a in
           jclim.doy_clim(jnp.asarray(ts), jnp.asarray(gidx), 90)]
    pal = [np.asarray(a) for a in
           doy_clim_pallas(ts, starts, lens, ny, rmax, 90, interpret=True)]
    port = plain_clim(ts, starts, lens, ndoy, ny, rmax)
    f64 = mean64(ts, gidx)
    jfinish = jax.jit(lambda c: jclim.runavg_circular(jclim.feb29_patch(c),
                                                      31))

    def tfinish(a):
        return tclim.finish_clim(torch.from_numpy(a),
                                 torch.from_numpy(a))[1].numpy()

    raw = {"xla": xla[1], "pallas": pal[1], "port": port[1], "f64": f64}
    smoothed = {"xla": np.asarray(jfinish(jnp.asarray(xla[1]))),
                "pallas": np.asarray(jfinish(jnp.asarray(pal[1]))),
                "port": tfinish(port[1]), "f64": tfinish(f64)}
    return {"raw": raw, "smoothed": smoothed,
            "thresh": (xla[0], pal[0], port[0])}


@pytest.fixture(scope="module")
def warm():
    return warm_engines(64)


@pytest.mark.parametrize("stage", ("raw", "smoothed"))
def test_seas_float32_warm_water(warm, stage):
    """float32 seas over warm water (29-33 degC, one ulp 1.9e-6 to
    3.8e-6), where the JAX package's own two engines are more than 1e-5
    apart: float64 is the judge. The port's raw mean is correctly rounded
    (it sums in float64 and rounds once), and raw and smoothed it is no
    further from float64 than the XLA engine, plus one ulp. Thresholds
    equal bit for bit across the three engines."""
    s = warm[stage]
    if stage == "raw":
        assert_rounded_once(s["port"], s["f64"], "raw seas")
        xla, pal, port = warm["thresh"]
        bits_equal(port, xla, "thresh vs XLA")
        bits_equal(port, pal, "thresh vs Pallas")
    assert_judged(s["port"], s["xla"], s["f64"], f"{stage} seas")


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


if __name__ == "__main__":
    # the table of the warm-water case: max |difference| of seas between
    # the engines, raw and smoothed, at 64 and 256 cells
    pairs = (("xla", "pallas"), ("xla", "port"), ("xla", "f64"),
             ("pallas", "f64"), ("port", "f64"))
    out = {c: warm_engines(c) for c in (64, 256)}
    print("| pair | max |d raw seas| (64 / 256 cells) | max |d smoothed "
          "seas| (64 / 256 cells) |")
    for a, b in pairs:
        cols = [" / ".join(f"{dist(out[c][st][a], out[c][st][b]):.3g}"
                           for c in (64, 256))
                for st in ("raw", "smoothed")]
        print(f"| {a} vs {b} | {cols[0]} | {cols[1]} |")
    for c in (64, 256):
        th = [a.view(np.int32) for a in out[c]["thresh"]]
        same = all(np.array_equal(th[0], x) for x in th[1:])
        print(f"{c} cells: thresholds bit-equal across the engines: {same}")
