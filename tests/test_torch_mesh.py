"""The cell mesh of the PyTorch port (xmhw_tpu_torch/parallel/mesh.py and
the mesh paths of core/pipeline.py), on a mesh of CPU entries.

The cases of tests/test_sharding.py: a run split over a mesh of
``[torch.device("cpu")] * 4`` (or 3) must equal the single-device run
bit for bit: threshold, detect, run_fused with its stats stage and
ranks, the streamed stages; a cell count that is not a multiple of the
mesh size; one shard holding far more events than the others (one K per
block, the same tables). One case holds the port's mesh run against
xmhw_tpu's 8-device mesh run in float64, at the float64 bars of
tests/test_torch_api.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import xmhw_tpu as xm  # noqa: E402
import xmhw_tpu_torch as xt  # noqa: E402
from test_torch_api import EXACT, grid, same_ds  # noqa: E402,F401
from xmhw_tpu.parallel import cell_mesh as jax_cell_mesh  # noqa: E402
from xmhw_tpu_torch.core import pipeline  # noqa: E402
from xmhw_tpu_torch.core.calendar import compute_doy  # noqa: E402
from xmhw_tpu_torch.core.stats import day_block_edges  # noqa: E402
from xmhw_tpu_torch.parallel import (CellMesh, cell_mesh,  # noqa: E402
                                     cell_sharding, make_cell_array,
                                     pad_cells, replicated)
from xmhw_tpu_torch.xrlite import TimeIndex  # noqa: E402

CPU = torch.device("cpu")


def cpu_mesh(n=4):
    return cell_mesh([CPU] * n)


@pytest.mark.parametrize("block", [None, 16])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_threshold_mesh_matches_single(grid, dtype, block):
    kw = dict(dtype=dtype, climatologyPeriod=[2001, 2002], cell_block=block,
              device="cpu")
    same_ds(xt.threshold(grid, **kw),
            xt.threshold(grid, mesh=cpu_mesh(), **kw))


@pytest.mark.parametrize("layout", ["compact", "union"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_detect_mesh_matches_single(grid, dtype, layout):
    clim = xt.threshold(grid, dtype=dtype, device="cpu")
    kw = dict(dtype=dtype, events_layout=layout, device="cpu")
    a, ia = xt.detect(grid, clim["thresh"], clim["seas"], intermediate=True,
                      **kw)
    b, ib = xt.detect(grid, clim["thresh"], clim["seas"], intermediate=True,
                      mesh=cpu_mesh(), cell_block=12, **kw)
    assert np.isfinite(np.asarray(a["duration"].data)).sum() > 50
    same_ds(a, b)
    same_ds(ia, ib)


@pytest.mark.parametrize("cold", [False, True])
def test_run_fused_stats_mesh_matches_single(grid, cold):
    ts = np.asarray(xt.land_check(grid).data, np.float64)
    tvals = np.asarray(grid.coords["time"].values)
    doy, _ = compute_doy(TimeIndex(tvals))
    years = tvals.astype("datetime64[Y]").astype(int) + 1970
    bins = np.arange(2001, 2005)
    mask = np.ones(ts.shape[1], bool)
    mask[3] = False
    kw = dict(ybod_np=(years - bins[0]).astype(np.int32),
              nbins=len(bins) - 1, day_edges=day_block_edges(years, bins),
              count_nans=True,
              rank_names=("intensity_max", "duration", "rate_onset"),
              det_mask_np=mask, cold_spells=cold, device="cpu")
    pos = (doy - 1).astype(np.int32)
    a = pipeline.run_fused(ts, doy, pos, **kw)
    b = pipeline.run_fused(ts, doy, pos, mesh=cpu_mesh(), block=20, **kw)
    for x, y in zip(a[:2], b[:2]):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a[3], b[3])
    assert sorted(a[2]) == sorted(b[2])
    for k in a[2]:
        np.testing.assert_array_equal(a[2][k], b[2][k], err_msg=k)
    assert sorted(a[4]) == sorted(b[4]) == ["block", "day", "rank"]
    for part, want in a[4].items():
        assert sorted(b[4][part]) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(b[4][part][k], v, err_msg=k)
    assert np.nansum(a[4]["block"]["ecount"]) > 20


def dense_events(T=1095, C=37, heavy=slice(28, 37)):
    """(ts, th, se, doy_pos): a few events in most cells and ~120 in the
    ``heavy`` ones (5 days above the threshold in every 8)."""
    rng = np.random.default_rng(9)
    ts = rng.normal(0.0, 0.3, (T, C))
    for c in range(C):
        ts[rng.integers(0, T - 10, 3)[:, None] + np.arange(6), c] = 1.0
    for c in range(*heavy.indices(C)):
        for s in range(c % 8, T - 5, 8):
            ts[s:s + 5, c] = 1.0 + 0.1 * rng.random(5)
    th = np.full((366, C), 0.5)
    se = np.zeros((366, C))
    pos = (np.arange(T) % 365).astype(np.int32)
    return ts, th, se, pos


@pytest.mark.parametrize("block", [None, 18])
def test_one_heavy_shard_same_k_and_tables(block):
    """The last cells hold ~120 events each, the others 1-3: the mesh
    run has the single run's K (128) and tables; with block=18 the first
    block fixes K = 32 and the heavy block's shards retry together. 37
    cells over 4 entries: a ragged split."""
    ts, th, se, pos = dense_events()
    runs = [pipeline.run_detect(ts, th, se, pos, 5, True, 2, block=block,
                                mesh=mesh, intermediate=True, device="cpu")
            for mesh in (None, cpu_mesh())]
    (ta, na, ia), (tb, nb, ib) = runs
    assert na.max() > 64 and np.median(na) < 8
    np.testing.assert_array_equal(na, nb)
    for k in ta:
        assert ta[k].shape == tb[k].shape == (128, 37), k
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)
    for k in ia:
        np.testing.assert_array_equal(ia[k], ib[k], err_msg=k)


def test_one_host_wait_per_stage(monkeypatch):
    """Each block waits for its shards once to fix K and once to check
    the detect pass for overflow (twice when it retries)."""
    ts, th, se, pos = dense_events()
    calls = []
    real = pipeline._max_over

    def spy(vals):
        calls.append(len(vals))
        return real(vals)

    monkeypatch.setattr(pipeline, "_max_over", spy)
    pipeline.run_detect(ts, th, se, pos, 5, True, 2, block=18,
                        mesh=cpu_mesh(), device="cpu")
    # block 1: count + detect; block 2: detect, retry; block 3 (1 cell)
    assert calls == [4, 4, 4, 4, 1]


def stream_grid(tmp_path_factory):
    from test_torch_stream import write_grid

    return write_grid(tmp_path_factory.mktemp("mesh") / "sst.nc")


@pytest.fixture(scope="module")
def grid_file(tmp_path_factory):
    return stream_grid(tmp_path_factory)


def test_stream_mesh_matches_single(grid_file, tmp_path):
    """stream_threshold, stream_detect and stream_run write the same
    files, bit for bit, with a mesh of three CPU entries and without."""
    from test_torch_stream import assert_files_match

    out = {}
    for label, mesh in (("single", None), ("mesh", cpu_mesh(3))):
        d = tmp_path / label
        d.mkdir()
        kw = dict(dtype=np.float64, stripe=5, mesh=mesh, device="cpu")
        c, m = str(d / "c.nc"), str(d / "m.nc")
        xt.stream_threshold(grid_file, "sst", c, **kw)
        xt.stream_detect(grid_file, "sst", c, m, cell_block=10, **kw)
        run = xt.stream_run(grid_file, "sst", str(d / "rc.nc"),
                            str(d / "rm.nc"), block_path=str(d / "rb.nc"),
                            rank_path=str(d / "rr.nc"), cell_block=10, **kw)
        out[label] = [c, m] + [run[k] for k in sorted(run)]
    for g, e in zip(out["mesh"], out["single"]):
        assert_files_match(g, e, f64_tol=0.0)


def test_mesh_matches_jax_mesh(grid):
    """The port's 4-entry CPU mesh against xmhw_tpu on its 8-device
    mesh, float64: climatology within 1e-12, events within 1e-8 (times,
    positions and counts exact)."""
    a = xm.threshold(grid, dtype=np.float64, mesh=jax_cell_mesh())
    b = xt.threshold(grid, dtype=np.float64, mesh=cpu_mesh(), device="cpu")
    same_ds(a, b, rtol=1e-12, atol=1e-12)
    ma = xm.detect(grid, a["thresh"], a["seas"], dtype=np.float64,
                   mesh=jax_cell_mesh())
    mb = xt.detect(grid, a["thresh"], a["seas"], dtype=np.float64,
                   mesh=cpu_mesh(), device="cpu")
    same_ds(ma, mb, rtol=1e-8, atol=1e-8, exact=EXACT)


def test_pad_cells():
    arr = np.ones((4, 10))
    padded, n = pad_cells(arr, 8)
    assert padded.shape == (4, 16) and n == 10
    assert np.isnan(padded[:, 10:]).all()
    same, n2 = pad_cells(arr, 5)
    assert same.shape == (4, 10)


def test_make_cell_array():
    """Each shard is filled from its own index slices, on its device, and
    the shards tile the global array in mesh order."""
    full = np.arange(4 * 10, dtype=np.float32).reshape(4, 10)
    seen = []

    def fill(idx):
        seen.append(idx)
        return full[idx]

    parts = make_cell_array(cpu_mesh(3), full.shape, fill)
    assert seen == [(slice(None), slice(0, 4)), (slice(None), slice(4, 8)),
                    (slice(None), slice(8, 10))]
    assert [tuple(p.shape) for p in parts] == [(4, 4), (4, 4), (4, 2)]
    assert all(p.device == CPU for p in parts)
    np.testing.assert_array_equal(torch.cat(parts, dim=1).numpy(), full)
    with pytest.raises(ValueError, match="shape"):
        make_cell_array(cpu_mesh(2), full.shape, lambda idx: full)


def test_cell_sharding_and_replicated():
    mesh = cpu_mesh(4)
    assert cell_sharding(mesh, 10, 20) == [(CPU, 10, 13), (CPU, 13, 16),
                                           (CPU, 16, 19), (CPU, 19, 20)]
    # the ragged tail of a small block leaves trailing entries empty
    assert cell_sharding(mesh, 0, 5) == [(CPU, 0, 2), (CPU, 2, 4),
                                         (CPU, 4, 5)]
    assert cell_sharding(CellMesh((CPU,)), 3, 9) == [(CPU, 3, 9)]
    t = torch.arange(5)
    copies = replicated(mesh, t)
    assert list(copies) == [CPU] and torch.equal(copies[CPU], t)


def test_cell_mesh_refuses():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        cell_mesh()  # no silent CPU mesh
    with pytest.raises(RuntimeError, match="cuda"):
        cell_mesh(["cuda:0", "cuda:0"])
    with pytest.raises(ValueError):
        cell_mesh([])
    with pytest.raises(ValueError, match="one device type"):
        cell_mesh(["cpu", "meta"])
    assert cell_mesh(["cpu", CPU]) == (CPU, CPU)


def test_resolve_mesh_rule(monkeypatch):
    """The JAX package's default: the un-indexed "cuda" with more than
    one visible GPU spans them all; "cuda:0", "cpu", use_mesh=False and
    a single GPU mean one device; an explicit mesh is used as given."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    m = pipeline.resolve_mesh(None, True, "cuda")
    assert m == tuple(torch.device("cuda", i) for i in range(3))
    assert isinstance(m, CellMesh)
    for mesh, use, dev in ((None, True, "cuda:0"), (None, True, "cpu"),
                           (None, False, "cuda")):
        assert pipeline.resolve_mesh(mesh, use, dev) == (torch.device(dev),)
    given = cpu_mesh(2)
    assert pipeline.resolve_mesh(given, True, "cuda") is given
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert pipeline.resolve_mesh(None, True, "cuda") == (
        torch.device("cuda"),)
    with pytest.raises(TypeError, match="mesh"):
        pipeline.resolve_mesh([CPU, CPU], True, "cpu")


def test_defaults_follow_the_jax_package():
    import inspect

    for fn, want in ((pipeline.run_clim, True), (pipeline.run_detect, True)):
        assert inspect.signature(fn).parameters["use_mesh"].default is want
    assert "use_mesh" not in inspect.signature(pipeline.run_fused).parameters
