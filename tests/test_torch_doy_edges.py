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
the kernel's wrapper takes.

``tests/test_torch_clim.py`` holds the plain version to the JAX package's
Pallas kernel (interpret mode) on these series, ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` hold the kernel to its plain version. This file
imports neither JAX nor the JAX package.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xmhw_tpu_torch.core.clim import _float_key  # noqa: E402
from xmhw_tpu_torch.ops.doy_quantile import gather_pool  # noqa: E402

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


def largest_pool(T=3000, ndoy=16, seed=0):
    """Range tables (starts, lens, ny, rmax) with pools of up to
    LARGEST_Z = ny * rmax rows over a (T + rmax)-row series: pool 0 takes
    every row of every range, the others random lengths."""
    rmax, ny = 8, LARGEST_Z // 8
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, T - rmax, (ndoy, ny)).astype(np.int32)
    lens = rng.integers(0, rmax + 1, (ndoy, ny)).astype(np.int32)
    lens[0] = rmax
    return starts, lens, ny, rmax


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
