"""core/stats.py of the PyTorch port against xmhw_tpu.core.stats.

The same seeded numpy inputs go through the JAX function (CPU, float64
enabled by tests/conftest.py) and its torch counterpart on the CPU.
Tolerances: float64 rtol 1e-12; float32 rtol = atol = 1e-5, since the
port sums over the event axis per bin where the JAX package sums a
(nbins, K, C) broadcast, a different order of float sums. Counts and
ranks exactly equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from xmhw_tpu.core import stats as jstats  # noqa: E402
from xmhw_tpu_torch.core import stats as tstats  # noqa: E402

TOL = {np.float64: dict(rtol=1e-12, atol=0.0),
       np.float32: dict(rtol=1e-5, atol=1e-5)}


def close(got, want, dtype, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                  err_msg=what)
    np.testing.assert_allclose(got, want, equal_nan=True, err_msg=what,
                               **TOL[dtype])


def event_inputs(dtype, K=9, C=37, nbins=4, seed=0):
    rng = np.random.default_rng(seed)
    vals = rng.normal(2.0, 3.0, (len(jstats.EVENT_VARS), K, C))
    vals[:, rng.random((K, C)) < 0.3] = np.nan      # empty slots
    vals[4, 1, :5] = np.inf                        # non-finite values
    vals[2, 2, 5:9] = -np.inf
    vals[2, :, 10] = 1.25                          # ties for the max
    bin_idx = rng.integers(0, nbins, (K, C)).astype(np.int32)
    bin_idx[:, 11] = 0                             # every other bin empty
    valid = rng.random((K, C)) < 0.85
    return vals.astype(dtype), bin_idx, valid


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_binned_event_stats_matches_jax(dtype):
    vals, bin_idx, valid = event_inputs(dtype)
    want = jstats.binned_event_stats(jnp.asarray(vals), jnp.asarray(bin_idx),
                                     jnp.asarray(valid), 4)
    got = tstats.binned_event_stats(torch.from_numpy(vals),
                                    torch.from_numpy(bin_idx),
                                    torch.from_numpy(valid), 4)
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k].numpy(), want[k], dtype, k)
    np.testing.assert_array_equal(got["ecount"].numpy(), want["ecount"])


def test_binned_event_stats_without_events():
    """An empty event axis (no heatwave in the region) and an empty year
    block, where the JAX kernels' max has no identity and raises: the port
    gives the host path's answer (xmhw_tpu.stats_api._binned_reduce):
    counts 0, total_icum 0.0, everything else NaN."""
    from xmhw_tpu.stats_api import _binned_reduce

    vals = np.zeros((len(jstats.EVENT_VARS), 0, 3))
    idx = np.zeros((0, 3), np.int32)
    ok = np.zeros((0, 3), bool)
    got = tstats.binned_event_stats(torch.from_numpy(vals),
                                    torch.from_numpy(idx),
                                    torch.from_numpy(ok), 2)
    for name, i, how in jstats.EVENT_AGGS:
        np.testing.assert_array_equal(
            got[name].numpy(), _binned_reduce(vals[i], idx, ok, 2, how),
            err_msg=name)
    # and a year block without days: NaN ts stats, zero day counts
    ts, cats, _, _ = day_inputs(np.float64, T=10, C=8)
    day = tstats.binned_day_stats(torch.from_numpy(ts), torch.from_numpy(cats),
                                  (0, 5, 5, 10), with_cats=True,
                                  count_nans=True)
    for k, v in day.items():
        row = v.numpy()[1]
        assert (np.isnan(row) if k.startswith("ts_") else row == 0).all(), k


def day_inputs(dtype, T=400, C=23, seed=1):
    rng = np.random.default_rng(seed)
    ts = rng.normal(15.0, 2.0, (T, C))
    ts[40:60, 3] = np.nan
    ts[:, 4] = np.nan                       # a land cell
    ts[:, 5] = 17.0                         # ties for max and min
    th = rng.normal(16.5, 0.5, (T, C))
    se = rng.normal(15.0, 0.3, (T, C))
    th[:, 6] = se[:, 6]                     # th == se: inf / NaN categories
    with np.errstate(divide="ignore", invalid="ignore"):
        cats = np.floor(1.0 + (ts - th) / (th - se))
    return ts.astype(dtype), cats.astype(dtype), th.astype(dtype), \
        se.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("with_cats,count_nans",
                         [(False, False), (True, False), (True, True),
                          (False, True)])
def test_binned_day_stats_matches_jax(dtype, with_cats, count_nans):
    ts, cats, _, _ = day_inputs(dtype)
    edges = (0, 31, 200, 365, 400)
    want = jstats.binned_day_stats(jnp.asarray(ts), jnp.asarray(cats), edges,
                                   with_cats=with_cats,
                                   count_nans=count_nans)
    got = tstats.binned_day_stats(torch.from_numpy(ts),
                                  torch.from_numpy(cats) if with_cats
                                  else None, edges, with_cats=with_cats,
                                  count_nans=count_nans)
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k].numpy(), want[k], dtype, k)
        if k.endswith("_days"):
            np.testing.assert_array_equal(got[k].numpy(), want[k], k)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_category_index_matches_jax_and_numpy(dtype):
    ts, _, th, se = day_inputs(dtype)
    want = np.asarray(jstats.category_index(jnp.asarray(ts), jnp.asarray(th),
                                            jnp.asarray(se)))
    got = tstats.category_index(*(torch.from_numpy(a) for a in (ts, th, se)))
    np.testing.assert_array_equal(got.numpy(), want)
    with np.errstate(divide="ignore", invalid="ignore"):
        np.testing.assert_array_equal(
            tstats.category_index(ts, th, se, xp=np),
            jstats.category_index(ts, th, se, xp=np))


def test_day_block_edges_matches_jax():
    years = np.repeat(np.arange(1990, 2000), 365)
    for bins in (np.arange(1990, 2001), np.arange(1985, 2010, 5),
                 np.array([1995, 1996])):
        assert (tstats.day_block_edges(years, bins)
                == jstats.day_block_edges(years, bins))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_rank_events_desc_matches_jax(dtype):
    """Ties (the earlier slot ranks higher), NaN, +-inf and invalid slots
    (NaN ranks), an all-invalid cell, and a cell of equal values."""
    rng = np.random.default_rng(5)
    K, C = 12, 40
    v = np.round(rng.normal(0.0, 1.0, (K, C)), 1)   # many ties
    v[rng.random((K, C)) < 0.15] = np.nan
    v[3, :8] = np.inf
    v[5, 4:12] = -np.inf
    v[:, 20] = 0.5
    valid = rng.random((K, C)) < 0.9
    valid[:, 21] = False
    v = v.astype(dtype)
    want = np.asarray(jstats.rank_events_desc(jnp.asarray(v),
                                              jnp.asarray(valid)))
    got = tstats.rank_events_desc(torch.from_numpy(v),
                                  torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got[:, 20], np.arange(K, 0, -1))
    assert np.isnan(got[:, 21]).all()
