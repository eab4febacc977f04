"""Event identification of the PyTorch port against the JAX package.

The RLE's plain version (xmhw_tpu_torch.ops.rle on a CPU tensor, which is
xmhw_tpu_torch.core.events.mhw_filter) must equal
xmhw_tpu.core.events.mhw_filter bit for bit, on the trials that
tests/test_pallas.py holds the TPU kernel to.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from xmhw_tpu.core import events as jev  # noqa: E402
from xmhw_tpu_torch.core import events as tev  # noqa: E402
from xmhw_tpu_torch.ops import rle  # noqa: E402

# (T, minDuration, joinGaps, maxGap, day0 quirk): tests/test_pallas.py:270
TRIALS = [(700, 5, True, 2, False), (700, 5, True, 2, True),
          (513, 3, True, 4, False), (1030, 5, False, 2, False),
          (64, 2, True, 1, False)]


@pytest.mark.parametrize("trial", range(len(TRIALS)))
def test_mhw_filter_bit_equal(trial):
    T, md, jg, mg, qk = TRIALS[trial]
    rng = np.random.default_rng(11 + trial)
    b = rng.random((T, 128)) < 0.45
    b[0] = trial % 2 == 0  # runs touching day 0 ...
    b[-1] = True           # ... and day T-1
    kw = dict(min_duration=md, join_gaps=jg, max_gap=mg,
              day0_fillna_quirk=qk)
    a = jev.mhw_filter(jnp.asarray(b), **kw)
    before = rle.mhw_filter.launches
    p = rle.mhw_filter(torch.from_numpy(b), **kw)
    assert rle.mhw_filter.launches == before  # CPU: plain version
    assert set(p) == set(a)
    for k in a:
        assert p[k].dtype == (torch.bool if a[k].dtype == bool
                              else torch.int32), k
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(a[k]),
                                      err_msg=f"{k} trial={trial}")
    short = rle.mhw_filter(torch.from_numpy(b), full=False, **kw)
    assert set(short) == {"event_day", "is_start", "slot", "n_events"}


def test_filter_fixture(filter_data):
    """The reference's 29-day pattern: minDuration=5, then maxGap=3."""
    a, exp, exp_joined = filter_data
    b = torch.from_numpy(a[:, None])
    f = tev.mhw_filter(b, min_duration=5, join_gaps=False)
    np.testing.assert_array_equal(f["event_id"].numpy()[:, 0], exp)
    f = tev.mhw_filter(b, min_duration=5, join_gaps=True, max_gap=3)
    np.testing.assert_array_equal(f["event_id"].numpy()[:, 0], exp_joined)
    assert int(f["n_events"][0]) == 2


@pytest.mark.parametrize("max_gap", [None, 3])
def test_interpolate_na_matches_jax(max_gap):
    rng = np.random.default_rng(2)
    ts = rng.normal(15, 2, (300, 40))
    for c in range(40):
        s = rng.integers(0, 290)
        ts[s:s + rng.integers(1, 8), c] = np.nan
    ts[:4, 1] = np.nan   # leading run: not interior
    ts[-3:, 2] = np.nan  # trailing run: not interior
    a = np.asarray(jev.interpolate_na_device(jnp.asarray(ts), max_gap))
    b = tev.interpolate_na_device(torch.from_numpy(ts), max_gap).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12,
                               equal_nan=True)
    np.testing.assert_array_equal(np.isnan(b), np.isnan(a))


def test_run_geometry_matches_jax():
    rng = np.random.default_rng(4)
    b = rng.random((200, 64)) < 0.6
    for x, y in zip(jev.run_geometry(jnp.asarray(b)),
                    tev.run_geometry(torch.from_numpy(b))):
        np.testing.assert_array_equal(
            np.where(b, y.numpy(), 0), np.where(b, np.asarray(x), 0))
