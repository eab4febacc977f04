"""Event detection + the 31-variable table: the PyTorch port against the
JAX package's XLA engine, features_scan.detect_kernel(use_pallas_scan=
False), which the JAX suite holds to the TPU kernels.

On a CPU tensor the port runs the plain versions of the RLE and of the
event scan (a per-event segmented reduction). Counts, positions and day
counts are exact. Other floats: rtol = atol = 1e-8 in float64, since the
port sums each event directly where the JAX engine takes differences of
per-cell-shifted prefix sums; rtol = atol = 2e-3 in float32, the bar
tests/test_pallas.py sets between the JAX package's engines.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from xmhw_tpu.core import features_scan as jfs  # noqa: E402
from xmhw_tpu_torch.core import features_scan as tfs  # noqa: E402
from xmhw_tpu_torch.ops import detect_scan  # noqa: E402

EXACT = {"event", "index_start", "index_end", "index_peak", "time_start",
         "time_end", "time_peak", "duration", "duration_moderate",
         "duration_strong", "duration_severe", "duration_extreme",
         "category"}
TOL = {np.float64: 1e-8, np.float32: 2e-3}


def run_both(ts, th, se, doy_pos, K, intermediate=False, **kw):
    a, na, ia = jfs.detect_kernel(
        jnp.asarray(ts), jnp.asarray(th), jnp.asarray(se),
        jnp.asarray(doy_pos), K=K, intermediate=intermediate,
        use_pallas_scan=False, **kw)
    before = detect_scan.event_stats.launches
    b, nb, ib = tfs.detect_kernel(
        torch.from_numpy(ts), torch.from_numpy(th), torch.from_numpy(se),
        torch.from_numpy(doy_pos), K, intermediate=intermediate,
        use_kernels=True, **kw)
    assert detect_scan.event_stats.launches == before  # CPU: plain version
    return (a, na, ia), (b, nb, ib)


def compare(ja, tb, dtype):
    (a, na, ia), (b, nb, ib) = ja, tb
    assert nb.dtype == torch.int32
    np.testing.assert_array_equal(nb.numpy(), np.asarray(na))
    assert sorted(b) == sorted(a) == sorted(tfs.TABLE_VARS)
    tol = TOL[dtype]
    for k in a:
        x = np.asarray(a[k], np.float64)
        y = b[k].numpy().astype(np.float64)
        assert x.shape == y.shape, k
        assert b[k].numpy().dtype == np.asarray(a[k]).dtype, k
        m = np.isfinite(x)
        np.testing.assert_array_equal(np.isfinite(y), m, err_msg=k)
        if k in EXACT:
            np.testing.assert_array_equal(y[m], x[m], err_msg=k)
        else:
            np.testing.assert_allclose(y[m], x[m], rtol=tol, atol=tol,
                                       err_msg=k)
    assert sorted(ib) == sorted(ia)
    for k in ia:
        np.testing.assert_array_equal(
            np.nan_to_num(ib[k].numpy().astype(np.float64), nan=-9e9),
            np.nan_to_num(np.asarray(ia[k], np.float64), nan=-9e9),
            err_msg=k)


def walk(T=700, C=128, D=40, seed=3):
    """tests/test_pallas.py's random-walk series with a NaN hole."""
    rng = np.random.default_rng(seed)
    doy_pos = (np.arange(T) % D).astype(np.int32)
    ts = (15 + 3 * np.sin(2 * np.pi * np.arange(T) / 365)[:, None]
          + np.cumsum(rng.normal(0, .6, (T, C)), 0) * 0.3)
    ts[50:60, 3] = np.nan
    th = 16.5 + rng.normal(0, .2, (D, C))
    se = 15 + rng.normal(0, .1, (D, C))
    return ts, th, se, doy_pos


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_detect_random_walk(dtype):
    ts, th, se, doy_pos = walk()
    ts, th, se = (x.astype(dtype) for x in (ts, th, se))
    ja, tb = run_both(ts, th, se, doy_pos, K=64, intermediate=True)
    assert int(tb[1].sum()) > 100
    compare(ja, tb, dtype)


def test_detect_day0_quirk_no_join():
    ts, th, se, doy_pos = walk(seed=8)
    # every cell starts in an event on day 0
    ts[:12] = 30.0 + np.random.default_rng(9).normal(0, .5, (12, 128))
    ja, tb = run_both(ts, th, se, doy_pos, K=64, join_gaps=False,
                      day0_fillna_quirk=True)
    compare(ja, tb, np.float64)


@pytest.mark.parametrize("min_duration,max_gap,join_gaps", [
    (5, 2, True), (3, 1, False), (2, 2, True), (9, 4, True)])
def test_detect_dense_phases(min_duration, max_gap, join_gaps):
    """Events at exactly the minimal separation, phase-shifted per cell
    (the dense latch-phase pattern of tests/test_pallas.py:157-206)."""
    sep = min_duration + (max_gap + 1 if join_gaps else 1)
    T, C, D = 700, 128, 40
    doy_pos = (np.arange(T) % D).astype(np.int32)
    th = np.full((D, C), 0.5, np.float32)
    se = np.zeros((D, C), np.float32)
    rng = np.random.default_rng(7)
    ts = np.zeros((T, C), np.float32)
    for c in range(C):
        for s in range(c % (2 * sep), T - min_duration, sep):
            ts[s:s + min_duration, c] = 1.0 + 0.1 * rng.random(
                min_duration).astype(np.float32)
    ts[256:260, 5] = np.nan
    ja, tb = run_both(ts, th, se, doy_pos, K=128, min_duration=min_duration,
                      max_gap=max_gap, join_gaps=join_gaps)
    compare(ja, tb, np.float32)


def test_detect_k_overflow_raw_counts():
    """K smaller than the events of a cell: the table holds the first K
    events and n_events stays the RAW count, so callers can retry."""
    ts, th, se, doy_pos = walk(seed=5)
    ja, tb = run_both(ts, th, se, doy_pos, K=4)
    assert int(tb[1].max()) > 4
    assert tb[0]["event"].shape == (4, ts.shape[1])
    compare(ja, tb, np.float64)


def test_detect_nan_seas_on_start_day():
    """seas NaN but thresh finite on an event's first day: relSeas is NaN
    there, so the first finite relSeas is not the start. The port carries
    the start row explicitly, like the JAX package's XLA engine."""
    ts, th, se, doy_pos = walk()  # shapes and K of the random-walk case
    C, D = ts.shape[1], th.shape[0]
    th[:] = 16.0
    se[:] = 15.0
    ts[:] = 15.0
    ts[100:110] = 17.0 + np.arange(10)[:, None] * 0.1
    se[100 % D, :2] = np.nan  # the start day of the cell-0/1 events
    se[101 % D, 1] = np.nan   # and the day after it in cell 1
    ja, tb = run_both(ts, th, se, doy_pos, K=64, intermediate=True)
    compare(ja, tb, np.float64)
    b = tb[0]
    np.testing.assert_array_equal(b["time_start"][0].numpy(), [100] * C)
    assert np.isnan(b["intensity_max"][0].numpy()).sum() == 0
