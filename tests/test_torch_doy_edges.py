"""Day-of-year pools at the edges of the clim-percentile kernel's key
arithmetic, and checks that each input has the geometry its name promises.

``csrc/doy_quantile.cu`` selects each (doy, cell) pool's order statistic by
a radix select over order-preserving uint32 keys, and starts it at the
highest bit where the pool's smallest and largest keys differ (the
common-prefix skip of ``xmhw_tpu/ops/pallas/doy_quantile.py``). Every cell
of :func:`edge_series` is of one of KINDS: pools of one value (no bit
step), of both signs (no bit skipped), of -0.0 beside +0.0, of values near
1e-6 and near 1e30, of one and two valid values, of none, and pools broken
by NaN runs. :func:`largest_pool` gives range tables with the largest pool
the kernel stages in shared memory (LARGEST_Z rows); :func:`past_tile`
gives longer pools, which the kernel reads from the series instead: a
monthly record of ERSST v5's length, daily records of ERA5's at w = 11
and 15, and random tables of 1,817 and 6,400 rows.

``tests/test_torch_clim.py`` holds the plain version to the JAX package's
Pallas kernel (interpret mode) on these series, and so does this file's
past-tile test; ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold
the kernel to its plain version. This module imports neither JAX nor the
JAX package (the past-tile test imports them when it runs), so that the
card's tests can import it where JAX is not installed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xmhw_tpu_torch.core.calendar import (build_window_ranges,  # noqa: E402
                                          compute_doy)
from xmhw_tpu_torch.core.clim import _float_key  # noqa: E402
from xmhw_tpu_torch.ops import doy_quantile as dq  # noqa: E402
from xmhw_tpu_torch.ops.doy_quantile import gather_pool  # noqa: E402
from xmhw_tpu_torch.xrlite import TimeIndex  # noqa: E402

KINDS = ("sst", "all_equal", "sign_mix", "signed_zero", "tiny", "huge",
         "tiny_huge", "one_valid", "two_valid", "all_nan", "nan_run")
LARGEST_Z = 1816  # ny * rmax * 32 cells * 4 bytes = 232,448 B, the limit


def _cell(kind, T, rng):
    n = rng.normal(size=T)
    sst = 15 + 3 * np.sin(2 * np.pi * np.arange(T) / 365.25) + np.round(n, 2)
    if kind == "sst":
        return sst
    if kind == "all_equal":
        return np.full(T, 3.25)
    if kind == "sign_mix":
        return 5 * n
    if kind == "signed_zero":
        return np.where(n < 0, -0.0, 0.0)
    if kind == "tiny":
        return 1e-6 * (1 + 0.05 * n)
    if kind == "huge":
        return 1e30 * (1 + 0.05 * n)
    if kind == "tiny_huge":
        return np.where(rng.random(T) < 0.5, 1e-6, 1e30) * (1 + 0.05 * n)
    x = np.full(T, np.nan)
    if kind == "one_valid":
        x[T // 2] = 2.5
    elif kind == "two_valid":
        x[T // 2], x[T // 2 + 3] = 2.5, -1.25
    elif kind == "nan_run":
        x = np.where(rng.random(T) < 0.1, np.nan, sst)
        x[T // 3:T // 3 + 40] = np.nan
    elif kind != "all_nan":
        raise ValueError(kind)
    return x


def edge_series(T, C, seed=0, kinds=KINDS):
    """(T, C) float32; cell c is of kind ``kinds[c % len(kinds)]``."""
    rng = np.random.default_rng(seed)
    ts = np.empty((T, C), np.float32)
    for c in range(C):
        ts[:, c] = _cell(kinds[c % len(kinds)], T, rng)
    return ts


def random_pools(ny, rmax, T=3000, ndoy=16, seed=0):
    """Range tables (starts, lens, ny, rmax) with pools of up to ny * rmax
    rows over a (T + rmax)-row series: pool 0 takes every row of every
    range, the others random lengths."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, T - rmax, (ndoy, ny)).astype(np.int32)
    lens = rng.integers(0, rmax + 1, (ndoy, ny)).astype(np.int32)
    lens[0] = rmax
    return starts, lens, ny, rmax


def largest_pool(T=3000, ndoy=16, seed=0):
    """:func:`random_pools` of LARGEST_Z rows, the largest staged pool."""
    return random_pools(LARGEST_Z // 8, 8, T, ndoy, seed)


def monthly_times(y0, y1):
    """Mid-month datetime64[ns] steps of the years y0 .. y1."""
    return np.array([np.datetime64(f"{y:04d}-{m:02d}-15", "ns")
                     for y in range(y0, y1 + 1) for m in range(1, 13)])


# pools past the shared tile: name -> (Z, how the tables are made)
PAST_TILE = {
    "z1817": 1817,             # random tables, 79 years x 23 rows
    "ersst_v5_monthly": 1881,  # 1854-2024 monthly, tstep, w = 5
    "era5_w11": 1955,          # 1940-2024 daily, w = 11
    "era5_w15": 2635,          # 1940-2024 daily, w = 15
    "z6400": 6400,             # random tables, 800 years x 8 rows
}


def past_tile(name):
    """(T, starts, lens, ndoy, ny, rmax) of the PAST_TILE pool ``name``:
    build_window_ranges of a real calendar, or :func:`random_pools` over
    T = 3,000 rows."""
    if name == "z1817":
        return (3000, *random_pools(79, 23, seed=1)[:2], 16, 79, 23)
    if name == "z6400":
        return (3000, *random_pools(800, 8, seed=2)[:2], 16, 800, 8)
    if name == "ersst_v5_monthly":
        doy, ndoy = compute_doy(TimeIndex(monthly_times(1854, 2024)),
                                keep_tstep=True)
        w = 5
    else:
        t = np.arange("1940-01-01", "2025-01-01",
                      dtype="datetime64[D]").astype("datetime64[ns]")
        doy, ndoy = compute_doy(TimeIndex(t))
        w = 11 if name == "era5_w11" else 15
    starts, lens, ny, rmax = build_window_ranges(doy, w, ndoy)
    return (len(doy), starts, lens, ndoy, ny, rmax)


def skipped_steps(pool):
    """Radix steps the common-prefix skip saves per pool: 32 minus the
    bits at and below the highest bit where the smallest and largest
    valid keys differ; -1 for an empty pool. pool: (D, Z, C)."""
    ok = torch.isfinite(pool)
    key = _float_key(pool)  # the signed form: xor equals the unsigned one
    lo = torch.where(ok, key, 0x7FFFFFFF).amin(dim=1)
    hi = torch.where(ok, key, -0x80000000).amax(dim=1)
    x = (lo ^ hi).long() & 0xFFFFFFFF
    steps = torch.where(x > 0, torch.floor(torch.log2(x.double())).long() + 1,
                        0)
    return torch.where(ok.any(dim=1), 32 - steps, -1)


@pytest.fixture(scope="module")
def pools():
    T = 4 * 365 + 1
    rmax = 11
    ts = edge_series(T, 2 * len(KINDS), seed=1)
    x = torch.from_numpy(np.concatenate(
        [ts, np.full((rmax, ts.shape[1]), np.nan, np.float32)]))
    # a +-5-day window around each of 40 days per year, 4 years
    centre = np.arange(5, 365, 9)[:, None] + 365 * np.arange(4)[None, :]
    starts = torch.from_numpy((centre - 5).astype(np.int32).reshape(-1))
    lens = torch.full(starts.shape, rmax, dtype=torch.int32)
    return gather_pool(x, starts, lens, *centre.shape, rmax)


@pytest.mark.parametrize("kind", KINDS)
def test_edge_kind_geometry(pools, kind):
    p = pools[..., [c for c in range(pools.shape[2])
                    if KINDS[c % len(KINDS)] == kind]]
    n = torch.isfinite(p).sum(dim=1)
    saved = skipped_steps(p)
    if kind in ("one_valid", "two_valid"):
        want = 1 if kind == "one_valid" else 2
        assert int(n.max()) == want and bool((n == 0).any())
    elif kind == "all_nan":
        assert bool((n == 0).all()) and bool((saved == -1).all())
    elif kind == "nan_run":
        assert bool((n == 0).any() | (n < p.shape[1]).any())
        assert bool((n > 0).any())
    else:
        assert bool((n == p.shape[1]).all())
    if kind == "all_equal":
        assert bool((saved == 32).all())
    if kind in ("sign_mix", "signed_zero", "tiny_huge"):
        assert bool((saved[n > 1] <= 1).all())  # the sign or exponent differs
    if kind == "signed_zero":
        bits = p.view(torch.int32)
        assert bool(((bits == 0).any(dim=1) & (bits < 0).any(dim=1)).all())
    if kind in ("sst", "tiny", "huge"):
        assert int(saved.min()) >= 5  # sign, exponent and more in common


def test_largest_pool_tables():
    starts, lens, ny, rmax = largest_pool()
    assert ny * rmax == LARGEST_Z and LARGEST_Z * 32 * 4 == 232_448
    assert (lens[0] == rmax).all() and lens.max() == rmax
    assert (starts + rmax <= 3000).all()


@pytest.mark.parametrize("name", sorted(PAST_TILE))
def test_past_tile_tables(name):
    T, starts, lens, ndoy, ny, rmax = past_tile(name)
    assert ny * rmax == PAST_TILE[name] > dq.TILE_ROWS == LARGEST_Z
    assert dq.route(ny, rmax) == "long"
    assert starts.shape == lens.shape == (ndoy, ny)
    assert (starts >= 0).all() and (starts + lens <= T).all()
    assert lens.max() == rmax
    if name == "ersst_v5_monthly":
        assert (T, ndoy, ny, rmax) == (2052, 12, 171, 11)


@pytest.mark.parametrize("pctile", [90, 10])
def test_past_tile_plain_matches_pallas_interpret(pctile):
    """The plain version of kernel 1 against the JAX package's Pallas
    kernel (interpret mode) on ERSST v5's monthly pool (12 doys, 171
    years x 11 rows = 1,881 rows, past the tile) over two cells of every
    edge kind: thresholds bit-equal; the port's seas correctly rounded
    from the float64 pooled mean, and in the max norm no further from it
    than the Pallas kernel's (which sums in float32) plus one ulp."""
    pallas = pytest.importorskip("xmhw_tpu.ops.pallas.doy_quantile")
    T, starts, lens, ndoy, ny, rmax = past_tile("ersst_v5_monthly")
    ts = edge_series(T, 2 * len(KINDS), seed=3)
    ja = [np.asarray(a) for a in pallas.doy_clim_pallas(
        ts, starts, lens, ny, rmax, pctile, interpret=True)]
    x = torch.from_numpy(np.concatenate(
        [ts, np.full((rmax, ts.shape[1]), np.nan, np.float32)]))
    args = (x, torch.from_numpy(starts.reshape(-1)),
            torch.from_numpy(lens.reshape(-1)), ndoy, ny, rmax)
    th, se = (a.numpy() for a in dq.doy_quantile(*args, pctile=pctile))
    np.testing.assert_array_equal(np.isnan(th), np.isnan(ja[0]))
    ok = ~np.isnan(th)
    np.testing.assert_array_equal(th[ok].view(np.int32),
                                  ja[0][ok].view(np.int32))
    pool = gather_pool(x.double(), *args[1:])
    fin = torch.isfinite(pool)
    judge = (torch.where(fin, pool, 0.0).sum(dim=1)
             / fin.sum(dim=1)).numpy()
    ok = ~np.isnan(judge)
    assert bool(ok.any()) and bool((~ok).any())
    for got in (se, ja[1]):
        np.testing.assert_array_equal(np.isnan(got), ~ok)
    err = np.abs(se[ok] - judge[ok])
    assert (err <= 0.5 * np.spacing(np.abs(se[ok])).astype(np.float64)
            + 1e-12).all()
    ulp = float(np.spacing(np.float32(np.abs(judge[ok]).max())))
    assert err.max() <= np.abs(ja[1][ok] - judge[ok]).max() + ulp
