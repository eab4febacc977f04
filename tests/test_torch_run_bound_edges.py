"""Inputs that stress the time segments of the running-bound kernel, and
checks that each input has the geometry its name promises.

``csrc/run_bound.cu`` splits time into WARPS segments of L = ceil(T /
WARPS) days, one per warp; a warp's carry is the bound of the segments
before it (forward) or after it (backward). :func:`edge_mask` builds (T,
C) masks with True days placed against those edges. ``tests/
test_torch_cuda.py`` holds the kernel to its plain version on them (CASES'
card shapes, both directions, the mask and its negation), and the CPU
test below holds the plain version to the JAX package's Pallas kernel in
interpret mode (CASES' CPU shapes, C padded to its 128 lanes with False
columns). This module imports neither JAX nor the JAX package at import
time.
"""

from typing import NamedTuple

import numpy as np
import pytest

WARPS = 32  # time segments of csrc/run_bound.cu (kWarps)


class Case(NamedTuple):
    T_card: int
    T_cpu: int
    C_card: int
    C_cpu: int


CASES = {
    # True only on the first / the last day of some segments
    "first_row": Case(14610, 2000, 64, 40),
    "last_row": Case(14610, 2000, 64, 40),
    # True in a few segments only: carries cross runs of empty segments
    "empty_segments": Case(14610, 2000, 64, 40),
    "no_true": Case(14610, 2000, 64, 40),
    "all_true": Case(14610, 2000, 64, 40),
    "random": Case(14610, 1000, 64, 40),
    # T below WARPS: one-day segments and empty ones
    "T1": Case(1, 1, 64, 40),
    "T5": Case(5, 5, 64, 40),
    # T not a multiple of WARPS, with empty trailing segments (L = 2)
    "T33": Case(33, 33, 64, 40),
    # one cell; a block with one live lane of 32
    "C1": Case(14610, 2000, 1, 1),
    "C33": Case(14610, 2000, 33, 33),
    # a long series: 1,875-day segments on the card (the kernel keeps
    # nothing per day in shared memory, so any T runs)
    "long": Case(60000, 1500, 64, 40),
}


def segment_starts(T, warps=WARPS):
    """First days of every non-empty segment."""
    L = -(-T // warps)
    return [w * L for w in range(warps) if w * L < T]


def edge_mask(name, T, C, warps=WARPS, seed=0):
    """(T, C) bool mask of case ``name``. Column 0 holds no True day
    (but in the all-True case and for a single cell)."""
    rng = np.random.default_rng(seed)
    if name == "all_true":
        return np.ones((T, C), bool)
    m = np.zeros((T, C), bool)
    if name == "no_true":
        return m
    L = -(-T // warps)
    starts = segment_starts(T, warps)
    for c in range(C):
        if name == "first_row":
            m[[s for i, s in enumerate(starts) if (i + c) % 3 == 0], c] = True
        elif name == "last_row":
            m[[min(s + L, T) - 1 for i, s in enumerate(starts)
               if (i + c) % 3 != 1], c] = True
        elif name == "empty_segments":
            # a True day in 1-3 segments, far apart, at a random row of each
            picks = rng.choice(len(starts), size=min(len(starts),
                                                     1 + c % 3),
                               replace=False)
            for i in picks:
                m[starts[i] + rng.integers(0, min(L, T - starts[i])), c] = \
                    True
        else:  # random, T1/T5/T33, C1/C33, long
            m[:, c] = rng.random(T) < (0.02 if c % 2 else 0.4)
    if C > 1:
        m[:, 0] = False
    return m


def reference(m, forward):
    """numpy's running max/min of the masked day index."""
    T = m.shape[0]
    idx = np.arange(T)[:, None]
    if forward:
        return np.maximum.accumulate(np.where(m, idx, -1), axis=0)
    return np.minimum.accumulate(np.where(m, idx, T)[::-1], axis=0)[::-1]


def check_geometry(name, T, C):
    """Assert that case ``name`` at (T, C) holds what its name promises."""
    m = edge_mask(name, T, C)
    L = -(-T // WARPS)
    starts = segment_starts(T)
    days = set(np.flatnonzero(m.any(axis=1)))
    if C > 1 and name != "all_true":
        assert not m[:, 0].any()
    if name == "first_row":
        assert days == set(starts)
    elif name == "last_row":
        assert days == {min(s + L, T) - 1 for s in starts}
    elif name == "empty_segments":
        seg_has = np.stack([m[s:s + L].any(axis=0) for s in starts])
        # some cell has an empty segment between two with a True day
        between = [c for c in range(C) if np.flatnonzero(seg_has[:, c]).size
                   >= 2 and np.diff(np.flatnonzero(seg_has[:, c])).max() > 1]
        assert between and (~seg_has).sum() > seg_has.sum()
    elif name == "no_true":
        assert not m.any()
    elif name == "all_true":
        assert m.all()
    elif name in ("T1", "T5", "T33"):
        assert T < WARPS or len(starts) < WARPS  # empty segments
        assert T % WARPS != 0 or T == 0
        assert m[:, 1:].any() and not m[:, 1:].all()
    elif name in ("C1", "C33"):
        assert C == int(name[1:]) and m[:, -1].any()
    elif name == "long":
        assert m.any() and not m.all()


@pytest.mark.parametrize("where", ["card", "cpu"])
@pytest.mark.parametrize("name", list(CASES))
def test_cases_have_their_geometry(name, where):
    """Each case at each of its shapes holds what its name promises (at
    the card's T on 8 cells, but for C1 and C33)."""
    case = CASES[name]
    T = case.T_card if where == "card" else case.T_cpu
    C = case.C_card if where == "card" else case.C_cpu
    if where == "card":
        C = min(C, 8) if name not in ("C1", "C33") else C
    check_geometry(name, T, C)


@pytest.mark.parametrize("name", list(CASES))
def test_run_bound_plain_matches_pallas_on_edges(name):
    """The port's plain version equals numpy's running bound and the JAX
    package's Pallas kernel (interpret mode, C padded to 128 lanes) in
    both directions."""
    torch = pytest.importorskip("torch")
    jnp = pytest.importorskip("jax.numpy")
    from xmhw_tpu.ops.pallas.run_bound import run_bound as jax_run_bound
    from xmhw_tpu_torch.ops.run_bound import run_bound, run_bound_plain

    case = CASES[name]
    m = edge_mask(name, case.T_cpu, case.C_cpu)
    T, C = m.shape
    padded = np.zeros((T, 128), bool)
    padded[:, :C] = m
    for forward in (True, False):
        want = np.asarray(jax_run_bound(jnp.asarray(padded), forward,
                                        interpret=True))[:, :C]
        np.testing.assert_array_equal(want, reference(m, forward))
        got = run_bound_plain(torch.from_numpy(m), forward)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=forward)
        np.testing.assert_array_equal(
            run_bound(torch.from_numpy(m), forward).numpy(), want)
