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


# ---- ops/block_stats.py: the stats layer's dispatch ----------------------

from xmhw_tpu_torch import utils  # noqa: E402
from xmhw_tpu_torch.ops import block_stats  # noqa: E402


@pytest.fixture
def counters(monkeypatch):
    """Counters of this test alone, and the kernels' launch counts before
    it."""
    monkeypatch.setattr(utils, "_counts", {})
    return block_stats.event_bins.launches, block_stats.day_bins.launches


def no_kernel_ran(counters, calls):
    assert utils.counts().get("stats_calls") == calls
    assert utils.counts().get("stats_kernel_calls", 0) == 0
    assert (block_stats.event_bins.launches,
            block_stats.day_bins.launches) == counters


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("lut", [False, True])
@pytest.mark.parametrize("cold", [False, True])
def test_event_bins_plain_route_matches_jax(counters, dtype, lut, cold):
    """On the CPU the dispatch runs the plain route: slots out of bin
    order, a slot key through a year-bin table with days outside every bin
    (-1) and keys past its end (the fused stage's start days), or the
    bins themselves; negated variables (the cold flip) as the JAX package
    negates them before its aggregation."""
    vals, bin_idx, valid = event_inputs(dtype, K=11, C=29, nbins=5)
    rng = np.random.default_rng(3)
    neg = [2, 3, 4, 9] if cold else []
    want_vals = vals.copy()
    want_vals[neg] = -want_vals[neg]
    if lut:
        T = 50
        table = np.where(rng.random(T) < 0.2, -1,
                         rng.integers(0, 5, T)).astype(np.int32)
        table[-1] = 4
        key = rng.integers(-3, T + 6, bin_idx.shape).astype(np.int32)
        b = table[np.clip(key, 0, T - 1)]
        valid = (key >= 0) & (b >= 0)
        bin_idx = np.clip(b, 0, 4).astype(np.int32)
        lut_t = torch.from_numpy(table)
    else:
        key = np.where(valid, bin_idx, -1).astype(np.int32)
        lut_t = None
    want = jstats.binned_event_stats(jnp.asarray(want_vals),
                                     jnp.asarray(bin_idx),
                                     jnp.asarray(valid), 5)
    seq = [torch.from_numpy(v) for v in vals]
    got = block_stats.event_bins(seq, torch.from_numpy(key), 5, lut=lut_t,
                                 negate=neg)
    plain = tstats.binned_event_stats(torch.from_numpy(want_vals),
                                      torch.from_numpy(bin_idx),
                                      torch.from_numpy(valid), 5)
    assert list(got) == [name for name, _, _ in jstats.EVENT_AGGS]
    for k in want:
        close(got[k].numpy(), want[k], dtype, k)
        assert torch.equal(got[k].isnan(), plain[k].isnan()), k
        assert torch.equal(torch.nan_to_num(got[k]),
                           torch.nan_to_num(plain[k])), k
    no_kernel_ran(counters, 1)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("with_cats,count_nans",
                         [(False, False), (True, False), (True, True),
                          (False, True)])
def test_day_bins_plain_route_matches_jax(counters, dtype, with_cats,
                                          count_nans):
    """On the CPU the dispatch runs the plain route: the categories from
    the climatologies at each day's row, a bin without days (equal
    edges), an all-NaN cell."""
    ts, _, th, se = day_inputs(dtype, T=400, C=23)
    pos = np.random.default_rng(4).integers(0, 366, 400).astype(np.int32)
    th, se = th[:366], se[:366]
    with np.errstate(divide="ignore", invalid="ignore"):
        cats = np.floor(1.0 + (ts - th[pos]) / (th[pos] - se[pos]))
    # the JAX functions' max has no identity for a bin without days
    want = jstats.binned_day_stats(jnp.asarray(ts), jnp.asarray(cats),
                                   (0, 31, 200, 365, 400),
                                   with_cats=with_cats,
                                   count_nans=count_nans)
    clim = ((torch.from_numpy(th), torch.from_numpy(se),
             torch.from_numpy(pos)) if with_cats else (None, None, None))
    got = block_stats.day_bins(torch.from_numpy(ts),
                               (0, 31, 200, 200, 365, 400), *clim,
                               count_nans=count_nans)
    assert sorted(got) == sorted(want)
    for k in want:
        g = got[k].numpy()
        close(g[[0, 1, 3, 4]], want[k], dtype, k)
        if k.endswith("_days"):
            np.testing.assert_array_equal(g[[0, 1, 3, 4]], want[k], k)
        assert (np.isnan(g[2]) if k.startswith("ts_") else g[2] == 0).all()
    assert np.isnan(got["ts_mean"].numpy()[:, 4]).all()
    no_kernel_ran(counters, 1)


def fused_inputs():
    """A 10-cell, three-year series for run_fused's stats stage on the
    CPU: (ts, doy, keywords)."""
    rng = np.random.default_rng(8)
    T, C = 3 * 365, 10
    day = np.arange(T)
    ts = (15 + 3 * np.sin(2 * np.pi * day / 365.25))[:, None] \
        + np.cumsum(rng.normal(0, 0.3, (T, C)), 0) * 0.3
    years = 2001 + day // 365
    doy = (day % 365 + 1).astype(np.int32)
    bins = np.arange(2001, 2005)
    kw = dict(ybod_np=(years - 2001).astype(np.int32), nbins=3,
              day_edges=tstats.day_block_edges(years, bins), device="cpu")
    return ts, doy, kw


def test_fused_stats_counts_its_calls_and_runs_no_kernel_on_the_cpu(
        counters):
    """run_fused's stats stage calls the dispatch twice a block (the event
    and the day half), and on the CPU launches nothing, float32 or
    float64; its outputs are the plain functions' on the same tables."""
    from xmhw_tpu_torch.core import pipeline

    ts, doy, kw = fused_inputs()
    for i, dtype in enumerate((np.float32, np.float64)):
        out = pipeline.run_fused(ts.astype(dtype), doy, doy - 1, block=4,
                                 **kw)
        assert np.nansum(out[4]["block"]["ecount"]) > 5
        no_kernel_ran(counters, 2 * 3 * (i + 1))


@pytest.fixture
def routes(monkeypatch):
    """The ``kernels`` flag of every :func:`block_stats.bins_for` call."""
    seen = []
    real = block_stats.bins_for

    def spy(kernels):
        seen.append(kernels)
        return real(kernels)

    monkeypatch.setattr(block_stats, "bins_for", spy)
    return seen


@pytest.mark.parametrize("use_kernels", [None, False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_run_fused_stats_route_follows_use_kernels(counters, routes, dtype,
                                                   use_kernels):
    """run_fused's stats stage takes the route that ``use_kernels_for``
    gives its series, override included, as its clim and detect stages
    do; on the CPU even the kernel route runs the plain versions."""
    from xmhw_tpu_torch.core import pipeline

    ts, doy, kw = fused_inputs()
    out = pipeline.run_fused(ts.astype(dtype), doy, doy - 1, block=5,
                             use_kernels=use_kernels, **kw)
    want = pipeline.use_kernels_for(dtype, torch.device("cpu"), use_kernels)
    assert routes == [want, want]
    assert np.nansum(out[4]["block"]["ecount"]) > 5
    no_kernel_ran(counters, 4)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stream_block_step_route_follows_use_kernels(counters, routes,
                                                     dtype):
    """stream_block_average's device step picks each half's route by
    ``use_kernels_for`` (on the CPU: plain) and gives the plain
    functions' numbers."""
    from xmhw_tpu_torch.stream import _block_stats_step

    vals, bin_idx, valid = event_inputs(dtype, K=7, C=13, nbins=4)
    ts, _, th, se = day_inputs(dtype, T=400, C=13)
    th, se = th[:366], se[:366]
    pos = torch.from_numpy(np.arange(400) % 366)
    edges = (0, 100, 250, 400)
    ev, day = _block_stats_step(vals, bin_idx, valid, 4,
                                torch.device("cpu"), ts, th, se, pos,
                                edges, True)
    assert routes == [False, False]
    want = tstats.binned_event_stats(torch.from_numpy(vals),
                                     torch.from_numpy(bin_idx),
                                     torch.from_numpy(valid), 4)
    for k, v in want.items():
        np.testing.assert_array_equal(ev[k], v.numpy(), err_msg=k)
    assert sorted(day) == sorted(tstats.day_stat_names(True, True))
    no_kernel_ran(counters, 2)


def test_bins_for_names_the_route():
    """``bins_for`` gives the dispatchers for the kernel route and the
    plain versions otherwise."""
    assert block_stats.bins_for(True) == (block_stats.event_bins,
                                          block_stats.day_bins)
    assert block_stats.bins_for(False) == (block_stats.event_bins_plain,
                                           block_stats.day_bins_plain)
