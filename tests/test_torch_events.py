"""Event identification of the PyTorch port against the JAX package.

The RLE's plain version (xmhw_tpu_torch.ops.rle on a CPU tensor, which is
xmhw_tpu_torch.core.events.mhw_filter) must equal
xmhw_tpu.core.events.mhw_filter bit for bit, in every output mode, on the
trials that tests/test_pallas.py holds the TPU kernel to and on the
segment-edge cases of tests/test_torch_rle_edges.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from xmhw_tpu.core import events as jev  # noqa: E402
from xmhw_tpu.core import features_scan as jfs  # noqa: E402
from xmhw_tpu.ops.pallas.rle import pallas_mhw_filter  # noqa: E402
from xmhw_tpu_torch.core import events as tev  # noqa: E402
from xmhw_tpu_torch.core import features_scan as tfs  # noqa: E402
from xmhw_tpu_torch.ops import rle  # noqa: E402
import test_torch_rle_edges as edges  # noqa: E402

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


# each output mode: the function and its keywords
MODES = {"count": (rle.event_counts, {}),
         "days": (rle.mhw_filter, {"full": False, "slot": False}),
         "slots": (rle.mhw_filter, {"full": False}),
         "full": (rle.mhw_filter, {})}


def same_as_jax(b, kw, what):
    """Every output mode of the port's RLE on mask ``b`` (numpy) equals
    xmhw_tpu.core.events.mhw_filter's outputs bit for bit."""
    a = jev.mhw_filter(jnp.asarray(b), **kw)
    before = rle.mhw_filter.launches
    for mode, (fn, extra) in MODES.items():
        p = fn(torch.from_numpy(b), **kw, **extra)
        for k in p:
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(a[k]),
                                          err_msg=f"{k} {mode} {what}")
    assert rle.mhw_filter.launches == before  # CPU: plain versions
    return a


def test_output_modes_key_sets():
    b = torch.from_numpy(np.random.default_rng(1).random((90, 7)) < 0.5)
    keys = {"count": {"n_events"},
            "days": {"event_day", "is_start", "n_events"},
            "slots": {"event_day", "is_start", "slot", "n_events"},
            "full": {"event_day", "is_start", "slot", "n_events",
                     "event_id", "ev_start", "ev_end"}}
    for mode, (fn, extra) in MODES.items():
        assert set(fn(b, **extra)) == keys[mode], mode
    assert set(rle.event_counts_plain(b)) == keys["count"]
    assert set(rle.mhw_filter_plain(b, full=False, slot=False)) == keys[
        "days"]
    with pytest.raises(ValueError):
        rle.mhw_filter(b, slot=False)  # full needs slot


@pytest.mark.parametrize("trial", range(len(TRIALS)))
def test_event_counts_match_mhw_filter(trial):
    T, md, jg, mg, qk = TRIALS[trial]
    rng = np.random.default_rng(11 + trial)
    b = rng.random((T, 128)) < 0.45
    b[0] = trial % 2 == 0
    b[-1] = True
    kw = dict(min_duration=md, join_gaps=jg, max_gap=mg,
              day0_fillna_quirk=qk)
    n = rle.event_counts(torch.from_numpy(b), **kw)["n_events"]
    assert n.dtype == torch.int32
    np.testing.assert_array_equal(
        n.numpy(), np.asarray(jev.mhw_filter(jnp.asarray(b),
                                             **kw)["n_events"]))


@pytest.mark.parametrize("name", list(edges.CASES))
def test_rle_segment_edge_cases_bit_equal(name):
    """The segment-edge cases at their CPU shapes, every output mode."""
    case = edges.CASES[name]
    b = edges.edge_mask(name, case.T_cpu, case.C_cpu)
    same_as_jax(b, edges.kwargs(name), name)


def test_rle_edge_case_matches_pallas_interpret():
    """The 700 x 128 case also through the TPU kernel (interpret mode)."""
    name = "lanes128"
    case = edges.CASES[name]
    assert (case.T_cpu, case.C_cpu) == (700, 128)
    b = edges.edge_mask(name, case.T_cpu, case.C_cpu)
    kw = edges.kwargs(name)
    a = same_as_jax(b, kw, name)
    p = pallas_mhw_filter(jnp.asarray(b), interpret=True, **kw)
    for k in a:
        np.testing.assert_array_equal(np.asarray(p[k]), np.asarray(a[k]),
                                      err_msg=k)


@pytest.mark.parametrize("kw", [{}, {"join_gaps": False},
                                {"day0_fillna_quirk": True, "max_gap": 4}])
def test_detect_kernel_and_counts_through_the_modes(kw):
    """detect_kernel (days mode, or the full mode with the intermediate
    output) and count_events (count mode) give the JAX package's tables
    and counts on the CPU path."""
    rng = np.random.default_rng(8)
    T, C, D = 900, 40, 30
    pos = (np.arange(T) % D).astype(np.int32)
    ts = 15 + np.cumsum(rng.normal(0, .6, (T, C)), 0) * 0.3
    th = 15.5 + rng.normal(0, .2, (D, C))
    se = 15 + rng.normal(0, .1, (D, C))
    ts[:6, 0] = 20.0  # a run from day 0
    a, na, _ = jfs.detect_kernel(jnp.asarray(ts), jnp.asarray(th),
                                 jnp.asarray(se), jnp.asarray(pos), K=64,
                                 use_pallas_scan=False, **kw)
    assert int(np.asarray(na).sum()) > 50
    args = [torch.from_numpy(x) for x in (ts, th, se, pos)]
    for use in (False, True):
        n = tfs.count_events(args[0], args[1], args[3], use_kernels=use,
                             **kw)
        np.testing.assert_array_equal(n.numpy(), np.asarray(na))
        for inter in (False, True):
            b, nb, ib = tfs.detect_kernel(*args, 64, intermediate=inter,
                                          use_kernels=use, **kw)
            np.testing.assert_array_equal(nb.numpy(), np.asarray(na))
            assert bool(ib) == inter
            for k in a:
                x = np.asarray(a[k], np.float64)
                y = b[k].numpy().astype(np.float64)
                np.testing.assert_allclose(y, x, rtol=1e-8, atol=1e-8,
                                           equal_nan=True, err_msg=k)


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
