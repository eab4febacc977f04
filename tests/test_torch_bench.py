"""bench_torch.py, the port's benchmark, on the CPU at toy sizes.

* Every cell's function, with ``device="cpu"`` passed here, returns its
  metrics by name and unit, leaves every device metric "not measured"
  (None) and passes its own correctness check.
* global_fused's core step on one seeded numpy block against
  ``xmhw_tpu.core.pipeline.fused_threshold_detect``: counts and positions
  exact, event floats within rtol = atol = 2e-3, thresholds within 1e-6
  and means within 1e-5 (tests/test_pallas.py:45-48, 108-117).
* The K-overflow check, the trace analysis on a synthetic device trace,
  the last line, and the exit code without a GPU.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from test_torch_detect import compare  # noqa: E402
from xmhw_tpu.core.calendar import build_window_index  # noqa: E402
from xmhw_tpu.core.pipeline import (  # noqa: E402
    fused_threshold_detect as jax_fused)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import bench_torch as bench  # noqa: E402

CPU = torch.device("cpu")
FUSED = dict(years=2, cells=48, blocks=3, K=32, staged=2, reps=2,
             trace_blocks=1, stats_blocks=1)
TOY = {
    "global_fused": FUSED,
    "global_fused_mesh4": dict(FUSED, cells=16),
    "tasman_regional": dict(years=2, grid=8, reps=2),
    "monthly_tstep": dict(years=6, grid=8, reps=2),
    "stats_pipeline": dict(years=2, grid=8, reps=2),
    "single_point": dict(years=3, reps=2),
}
DEVICE_METRICS = ("device_busy_share", "h2d_MB", "h2d_ms", "d2h_MB",
                  "d2h_ms", "peak_device_memory_GB")


def test_every_cell_has_a_toy_size():
    assert sorted(TOY) == sorted(bench.CELLS)
    assert bench.ONE_CARD == ["global_fused", "tasman_regional",
                              "monthly_tstep", "stats_pipeline",
                              "single_point"]


@pytest.mark.parametrize("name", list(TOY))
def test_cell_at_toy_size(name):
    cards, fn = bench.CELLS[name]
    rep = fn([CPU] * cards, 3, "cpu", **TOY[name])
    m = rep.metrics
    assert m["cells_per_sec"][1] == "cells/s" and m["cells_per_sec"][0] > 0
    assert m["cells_per_sec_runs"] == (2, "runs")
    assert m["cells_per_sec_spread"][0] >= 0
    if not name.startswith("global_fused"):
        assert len(m["warmup_s"][0]) == 3
    for k in DEVICE_METRICS:
        assert m[k][0] is None, k  # a CPU run measures no device
    for k, (v, unit) in m.items():
        assert isinstance(unit, str) and unit, k
    assert all(ln.startswith(f"{name}: ") for ln in rep.lines())
    json.dumps(rep.detail())
    if name.startswith("global_fused"):
        assert m["with_stats_cells_per_sec"][0] > 0
        assert m["max_raw_events_per_cell"][0] <= 32
        assert m["plain_max_exact_differ"] == (0, "entries")
        for k in ("k1", "k2", "k3"):
            assert m[f"{k}_ms_per_block"][0] is None
            assert m[f"{k}_bound_ms"][0] > 0
        assert ("wait_ms_per_block" in m) == (cards == 4)
    elif name == "single_point":
        assert m["f64_max_thresh"][0] <= 1e-6
    else:
        assert m["checked_events"][0] > 0
        assert m["host_s_run_clim"][0] > 0
        if name == "stats_pipeline":
            assert m["block_average_launches"][0] is None
            assert m["host_s_block_average"][0] > 0


def test_fused_step_matches_jax():
    """The core step (``_clim_block`` + ``detect_kernel`` through the
    tables made once) on a seeded numpy block, against the JAX package's
    fused step on the same block."""
    t = bench.daily(1990, 1992)
    step = bench.FusedStep(CPU, t, K=16)
    da = bench.host_grid(t, 1, 40, seed=[7, 1], land=0.0)
    ts = np.ascontiguousarray(da.data[:, 0, :])
    ts[50:60, 3] = np.nan
    th, se, tab, n = step.core(torch.from_numpy(ts))
    gidx, _ = build_window_index(step.doy, 5, step.ndoy)
    th_j, se_j, tab_j, n_j = jax_fused(
        jnp.asarray(ts), jnp.asarray(gidx),
        jnp.asarray((step.doy - 1).astype(np.int32)), K=16)
    assert int(n.sum()) > 0
    np.testing.assert_allclose(th.numpy(), np.asarray(th_j), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(se.numpy(), np.asarray(se_j), rtol=0,
                               atol=1e-5)
    compare((tab_j, n_j, {}), (tab, n, {}), np.float32)


def test_k_overflow_raises():
    t = bench.daily(1990, 1991)
    steps = [bench.FusedStep(CPU, t, K=2)]
    data = [[steps[0].stage(32, seed=1)]]
    with pytest.raises(RuntimeError, match="K = 2 overflowed"):
        bench.fused_pass(steps, data, 1)
    with pytest.raises(RuntimeError, match="overflowed"):
        bench.fused_pass(steps, data, 1, wait_each=True)


def _x(name, ts, dur, cat, pid=0, **args):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
            "pid": pid, "args": args}


def test_analyse_a_device_trace():
    """Busy share, kernels by name, copies, idle gaps with the innermost
    span open at their middle, and launches inside a span."""
    ev = [
        _x("bench/cell", 0, 1000, "user_annotation"),
        _x("bench/detect", 100, 500, "user_annotation"),
        _x("bench/land_check", 150, 200, "user_annotation"),
        _x("void doy_quantile_kernel<12>(float const*)", 0, 100, "kernel"),
        _x("void rle_kernel<1>(Params)", 100, 50, "kernel"),
        _x("void event_scan_kernel(float const*)", 400, 100, "kernel"),
        _x("elementwise_kernel", 700, 100, "kernel"),
        _x("Memcpy HtoD (Pageable -> Device)", 900, 50, "gpu_memcpy",
           bytes=2_000_000),
        _x("cudaLaunchKernel", 120, 1, "cuda_runtime"),
        _x("cudaLaunchKernel", 700, 1, "cuda_runtime"),
        _x("gpu user annotation", 0, 1000, "gpu_user_annotation"),
    ]
    br = bench.analyse(ev, "cell", launch_spans=("detect",))
    assert br["window_ms"] == 1.0
    assert br["busy_share"] == pytest.approx(0.4)
    assert br["kernels_ms"] == pytest.approx(
        {"k1": 0.1, "k2": 0.05, "k3": 0.1, "all": 0.35})
    assert br["copies"]["HtoD"] == {"ms": 0.05, "MB": 2.0}
    assert br["copies"]["DtoH"] == {"ms": 0.0, "MB": 0.0}
    assert br["launches"] == {"detect": 1}
    # gaps: [150, 400) in land_check's and detect's time, [500, 700),
    # [800, 900), [950, 1000)
    assert [(g["ms"], g["span"]) for g in br["gaps"]] == [
        (0.25, "bench/land_check"), (0.2, "bench/detect"),
        (0.1, "bench/cell"), (0.05, "bench/cell")]
    assert br["ops"][0][1] == pytest.approx(0.1)
    rep = bench.Report("cell", "card")
    bench.device_metrics(rep, br)
    assert rep.metrics["h2d_MB"] == (2.0, "MB")
    assert any("idle gap 1: 0.250 ms" in ln for ln in rep.lines())


def test_analyse_without_device_activity():
    br = bench.analyse([_x("bench/cell", 0, 10, "user_annotation")],
                       "cell", launch_spans=("cell",))
    assert br["busy_share"] is None and br["ops"] == [] == br["gaps"]
    assert br["kernels_ms"]["k1"] is None


def test_headline():
    rep = bench.Report("global_fused", "card")
    rep.add("cells_per_sec", 2583.5, "cells/s")
    line = bench.headline({"global_fused": rep})
    assert line == {"metric": "threshold_detect_cells_per_sec_per_chip",
                    "value": 2583.5, "unit": "cells/s", "vs_target": 2.0}
    mesh = bench.Report("global_fused_mesh4", "card")
    mesh.add("cells_per_sec", 4 * 2583.5, "cells/s")
    assert bench.headline({"global_fused_mesh4": mesh})["value"] == 2583.5
    pt = bench.Report("single_point", "card")
    pt.add("cells_per_sec", 20.0, "cells/s")
    assert bench.headline({"single_point": pt})["metric"] == (
        "single_point_cells_per_sec")


def test_bounds_from_repeated_runs(tmp_path, capsys):
    """tools/torch_bench_bounds.py: the reference is the median of the
    runs' medians, the bound twice the largest spread, the floor the
    reference over 1 + bound; metrics without a spread are left out."""
    sys.path.insert(0, str(ROOT / "tools"))
    import torch_bench_bounds as tb

    paths = []
    for i, (med, spread) in enumerate([(100.0, 0.1), (120.0, 0.25),
                                       (90.0, 0.05)]):
        rep = bench.Report("cell", "card")
        rep.add("cells_per_sec", med, "cells/s")
        rep.add("cells_per_sec_spread", spread, "fraction of the median")
        rep.add("events", 7, "events")
        paths.append(tmp_path / f"r{i}.json")
        paths[-1].write_text(json.dumps({"cards": ["card"],
                                         "cells": {"cell": rep.detail()}}))
    assert tb.main([str(p) for p in paths]) == 0
    b = tb.bounds([json.loads(p.read_text()) for p in paths])
    assert list(b) == [("cell", "cells_per_sec")]
    v = b[("cell", "cells_per_sec")]
    assert v["reference"] == 100.0 and v["bound"] == 0.5
    assert v["floor"] == pytest.approx(100.0 / 1.5)
    assert "| cell | cells_per_sec (cells/s) | 100.0, 120.0, 90.0 |" in (
        capsys.readouterr().out)


def test_without_a_gpu_exits_non_zero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: nothing to refuse")
    r = subprocess.run([sys.executable, str(ROOT / "bench_torch.py"),
                        "--detail", str(tmp_path / "d.json")],
                       capture_output=True, text=True, timeout=120,
                       cwd=tmp_path,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert r.returncode != 0
    assert "is_available() is False" in r.stderr
    assert r.stdout == "" and not (tmp_path / "d.json").exists()
