"""run_bound_plain of the PyTorch port against the JAX package's Pallas
run_bound (xmhw_tpu/ops/pallas/run_bound.py), run in interpret mode on
the CPU as tests/test_pallas.py runs it. Exactly equal in both
directions, with T not a multiple of the TPU kernel's 1,024-row tiles,
masks that are all False or all True, and T = 1. The TPU kernel needs C
to be a multiple of 128; the port's does not (a ragged width is held
against numpy's running max/min).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from xmhw_tpu.ops.pallas.run_bound import run_bound as jax_run_bound  # noqa
from xmhw_tpu_torch.ops.run_bound import run_bound, run_bound_plain  # noqa

CASES = {
    "T3001_C128": (3001, 128, "random"),
    "T3001_C256": (3001, 256, "random"),
    "all_false": (1500, 128, "false"),
    "all_true": (1500, 128, "true"),
    "T1": (1, 128, "random"),
}


def mask_of(T, C, kind, seed=0):
    if kind == "false":
        return np.zeros((T, C), bool)
    if kind == "true":
        return np.ones((T, C), bool)
    m = np.random.default_rng(seed).random((T, C)) > 0.6
    m[:, 3] = False
    m[:, 4] = True
    return m


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_bound_plain_matches_pallas(case):
    T, C, kind = CASES[case]
    m = mask_of(T, C, kind)
    for forward in (True, False):
        want = np.asarray(jax_run_bound(jnp.asarray(m), forward,
                                        interpret=True))
        got = run_bound_plain(torch.from_numpy(m), forward)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=forward)
        # the wrapper takes the plain version on a CPU tensor
        np.testing.assert_array_equal(
            run_bound(torch.from_numpy(m), forward).numpy(), want)


def test_run_bound_plain_ragged_width():
    T, C = 777, 37
    m = mask_of(T, C, "random", seed=4)
    idx = np.arange(T)[:, None]
    fwd = np.maximum.accumulate(np.where(m, idx, -1), axis=0)
    bwd = np.minimum.accumulate(np.where(m, idx, T)[::-1], axis=0)[::-1]
    t = torch.from_numpy(m)
    np.testing.assert_array_equal(run_bound_plain(t, True).numpy(), fwd)
    np.testing.assert_array_equal(run_bound_plain(t, False).numpy(), bwd)
