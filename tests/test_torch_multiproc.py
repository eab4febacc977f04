"""The multi-process path of the PyTorch port, on the CPU.

* ``core.pipeline.fused_threshold_detect`` against xmhw_tpu's on the same
  numpy inputs (2 daily years x 32 cells, K = 8): float32 thresholds
  within atol 1e-6 and means within 1e-5, counts and positions exact,
  event floats within rtol = atol = 2e-3 (tests/test_pallas.py:45-48,
  108-117); float64 at 1e-8.
* The global cell mesh: ``cell_mesh`` in a torch.distributed group,
  ``make_cell_array`` feeding only this process's entries, the block
  functions refusing a mesh with entries of other ranks, and
  ``resolve_mesh`` taking this process's GPU in a group.
* The two-process tools: tools/torch_multiproc_dryrun.py (every shard
  bit-equal to the unsharded run) and tools/torch_multiproc_stream.py
  (merged band files byte-equal to one process). Each runs in a
  subprocess with its own deadline; the tools kill a hung rank.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from test_torch_detect import compare  # noqa: E402
from xmhw_tpu.core.calendar import build_window_index  # noqa: E402
from xmhw_tpu.core.pipeline import (  # noqa: E402
    fused_threshold_detect as jax_fused)
from xmhw_tpu_torch.core import pipeline  # noqa: E402
from xmhw_tpu_torch.core.calendar import compute_doy  # noqa: E402
from xmhw_tpu_torch.parallel import (CellMesh, cell_mesh,  # noqa: E402
                                     make_cell_array)
from xmhw_tpu_torch.xrlite import TimeIndex  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TOOLS = ROOT / "tools"
CPU = torch.device("cpu")
sys.path.insert(0, str(TOOLS))
import torch_multiproc_dryrun as dryrun  # noqa: E402


def inputs(dtype, years=2, C=32, seed=3):
    t = np.arange("1983-01-01", f"{1983 + years}-01-01",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    doy, ndoy = compute_doy(TimeIndex(t))
    ts = dryrun.field(len(t), C, seed).astype(dtype)
    ts[:, 5] = np.nan           # an all-NaN cell
    ts[100:112, 9] = np.nan     # a NaN run
    return ts, doy, ndoy, (doy - 1).astype(np.int32)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fused_threshold_detect_matches_jax(dtype):
    ts, doy, ndoy, pos = inputs(dtype)
    gidx, _ = build_window_index(doy, 5, ndoy)
    th_j, se_j, tab_j, n_j = jax_fused(jnp.asarray(ts), jnp.asarray(gidx),
                                       jnp.asarray(pos), K=8)
    th, se, tab, n = pipeline.fused_threshold_detect(
        torch.from_numpy(ts), doy, pos, K=8, ndoy=ndoy)
    assert n.max() > 8  # the raw count, past K, as in JAX
    ta, tb = (1e-6, 1e-5) if dtype == np.float32 else (1e-12, 1e-12)
    np.testing.assert_allclose(th.numpy(), np.asarray(th_j), rtol=0,
                               atol=ta)
    np.testing.assert_allclose(se.numpy(), np.asarray(se_j), rtol=0,
                               atol=tb)
    compare((tab_j, n_j, {}), (tab, n, {}), dtype)


def test_fused_threshold_detect_defaults_follow_jax():
    import inspect

    ours = inspect.signature(pipeline.fused_threshold_detect).parameters
    theirs = inspect.signature(jax_fused.__wrapped__).parameters
    for k, p in theirs.items():
        if k not in ("ts", "gidx", "doy_pos"):
            assert ours[k].default == p.default, k
    assert list(ours)[:3] == ["ts", "doy", "doy_pos"]


def test_fused_threshold_detect_equals_the_block_functions():
    """The fused step's climatology and tables equal run_clim's and
    run_detect's on the same block (K fixed where run_detect counts)."""
    ts, doy, ndoy, pos = inputs(np.float64, C=12)
    th, se, tab, n = pipeline.fused_threshold_detect(
        torch.from_numpy(ts), doy, pos, K=64, ndoy=ndoy)
    th_r, se_r = pipeline.run_clim(ts, doy, 5, ndoy, 90, True, 31, True,
                                   device="cpu")
    tab_r, n_r, _ = pipeline.run_detect(ts, th_r, se_r, pos, 5, True, 2,
                                        first_k=64, device="cpu")
    np.testing.assert_array_equal(th.numpy(), th_r)
    np.testing.assert_array_equal(se.numpy(), se_r)
    np.testing.assert_array_equal(n.numpy(), n_r)
    for k, v in tab_r.items():
        np.testing.assert_array_equal(tab[k].numpy(), v, err_msg=k)


def test_make_cell_array_feeds_only_this_process():
    """Entries of rank 1 are neither filled nor returned in rank 0."""
    full = np.arange(3 * 16, dtype=np.float32).reshape(3, 16)
    seen = []

    def fill(idx):
        seen.append(idx[-1])
        return full[idx]

    mesh = CellMesh([CPU] * 4, ranks=(0, 1, 0, 1))
    parts = make_cell_array(mesh, full.shape, fill)
    assert seen == [slice(0, 4), slice(8, 12)]
    assert parts.ranges == [(0, 4), (8, 12)]
    np.testing.assert_array_equal(parts[1].numpy(), full[:, 8:12])
    with pytest.raises(ValueError, match="ranks"):
        CellMesh([CPU] * 2, ranks=(0,))


@pytest.mark.parametrize("fn", ["run_clim", "run_detect", "run_fused"])
def test_block_functions_refuse_a_mesh_of_other_ranks(fn):
    ts, doy, ndoy, pos = inputs(np.float64, C=12)
    mesh = CellMesh([CPU, CPU], ranks=(0, 1))
    th = np.zeros((ndoy, 12))
    call = {
        "run_clim": lambda: pipeline.run_clim(
            ts, doy, 5, ndoy, 90, True, 31, True, mesh=mesh),
        "run_detect": lambda: pipeline.run_detect(
            ts, th, th, pos, 5, True, 2, mesh=mesh),
        "run_fused": lambda: pipeline.run_fused(ts, doy, pos, mesh=mesh),
    }[fn]
    with pytest.raises(ValueError, match="make_cell_array.*"
                       "fused_threshold_detect"):
        call()


@pytest.fixture
def group():
    """A one-process gloo group, torn down after the test."""
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{dryrun.free_port()}",
        world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mesh_in_a_process_group(group, monkeypatch):
    """In a group: cell_mesh() gathers each rank's entries (here one rank,
    two CPU entries); resolve_mesh's un-indexed "cuda" with three GPUs
    visible takes only this process's GPU, cuda:(LOCAL_RANK % 3)."""
    mesh = cell_mesh(local_devices=[CPU, CPU])
    assert mesh == (CPU, CPU) and mesh.ranks == (0, 0) and mesh.is_local()
    parts = make_cell_array(mesh, (2, 6), lambda idx: np.ones((2, 3)))
    assert parts.ranges == [(0, 3), (3, 6)]
    with pytest.raises(ValueError, match="not both"):
        cell_mesh([CPU], local_devices=[CPU])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert pipeline.resolve_mesh(None, True, "cuda") == (
        torch.device("cuda", 0),)
    monkeypatch.setenv("LOCAL_RANK", "4")
    assert pipeline.resolve_mesh(None, True, "cuda") == (
        torch.device("cuda", 1),)
    # explicit devices and indexed names are unchanged in a group
    assert pipeline.resolve_mesh(None, True, "cuda:2") == (
        torch.device("cuda", 2),)


def test_a_local_mesh_belongs_to_the_process_that_uses_it(monkeypatch):
    """A mesh of one process, built before the group, is not rank 0's: in
    rank 1 it is local, and make_cell_array fills and returns every
    shard."""
    mesh = cell_mesh([CPU, CPU])
    assert mesh.ranks is None
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{dryrun.free_port()}",
        world_size=1, rank=0)
    try:
        monkeypatch.setattr(dist, "get_rank", lambda *a, **k: 1)
        assert mesh.is_local() and pipeline.check_mesh(mesh) is mesh
        parts = make_cell_array(mesh, (2, 6), lambda idx: np.ones((2, 3)))
        assert parts.ranges == [(0, 3), (3, 6)]
        assert not CellMesh([CPU, CPU], ranks=(0, 1)).is_local()
    finally:
        monkeypatch.undo()
        dist.destroy_process_group()


def test_local_devices_need_a_group():
    with pytest.raises(ValueError, match="group"):
        cell_mesh(local_devices=[CPU])


def run_tool(name, *args, timeout=240):
    r = subprocess.run([sys.executable, str(TOOLS / name), *args],
                       capture_output=True, text=True, timeout=timeout,
                       cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert r.returncode == 0, r.stdout + r.stderr[-4000:]
    return r.stdout


def test_two_process_dryrun():
    out = run_tool("torch_multiproc_dryrun.py", "--timeout", "200")
    assert "rank 0: OK" in out and "rank 1: OK" in out
    assert "torch multiproc dryrun: PASS" in out
    # 2 ranks x 2 entries over 32 cells: each rank fed its own two
    assert "fed 2 shards [(0, 8), (8, 16)]" in out
    assert "fed 2 shards [(16, 24), (24, 32)]" in out
    assert "backend gloo" in out
    assert out.count("against the plain version {'thresh': 0.0, 'seas': "
                     "0.0, 'events': 0.0, 'exact_differ': 0}") == 2


@pytest.mark.parametrize("kind", ["thresh", "seas", "events", "exact",
                                  "nan"])
def test_against_plain_catches_each_kind(kind):
    """The dryrun's check of the kernels against the plain version finds a
    difference of each kind past its bar, and none inside it."""
    ts, doy, ndoy, pos = inputs(np.float32, C=12)
    out = pipeline.fused_threshold_detect(torch.from_numpy(ts), doy, pos,
                                          K=8, ndoy=ndoy)
    errs = dryrun.against_plain(out, out)
    assert dryrun.within_bars(errs) and errs["exact_differ"] == 0
    th, se, tab, n = (v.clone() if torch.is_tensor(v) else
                      {k: t.clone() for k, t in v.items()} for v in out)
    cell = int(torch.argmax(n))
    if kind == "thresh":
        th[0, cell] += 4e-6
    elif kind == "seas":
        se[0, cell] += 4e-5
    elif kind == "events":
        tab["intensity_max"][0, cell] *= 1.01
    elif kind == "exact":
        tab["duration"][0, cell] += 1
    else:
        tab["intensity_mean"][0, cell] = float("nan")
    errs = dryrun.against_plain((th, se, tab, n), out)
    assert not dryrun.within_bars(errs)
    want = {"thresh": "thresh", "seas": "seas", "events": "events"}
    if kind in want:
        assert errs[want[kind]] > dryrun.BARS[want[kind]]
    else:
        assert errs["exact_differ"] == 1


def test_dryrun_fails_when_a_rank_fails():
    """A rank that cannot run (no GPU here) fails the run; the launcher
    kills the other rank instead of waiting for it."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: nothing fails")
    r = subprocess.run(
        [sys.executable, str(TOOLS / "torch_multiproc_dryrun.py"),
         "--device", "cuda", "--timeout", "100"],
        capture_output=True, text=True, timeout=150, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert r.returncode != 0
    assert "torch multiproc dryrun: FAIL" in r.stdout
    assert "is_available() is False" in r.stderr


def test_two_process_streamed_bands():
    pytest.importorskip("h5py")
    out = run_tool("torch_multiproc_stream.py", "--timeout", "200")
    assert "rank 0: OK" in out and "rank 1: band (5, 12)" in out
    assert "byte-equal" in out and "torch multiproc stream: PASS" in out
