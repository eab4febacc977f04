"""The program's own spans and counters in the benchmark: the reduction of
``xmhw/`` spans on a hand-made chrome trace (self time, launches, device
time, gap names, copy bytes), the benchmark's readings unchanged by them,
and traced runs of each cell at a small size on the CPU that give the
counter metrics and the span readings of ``program_trace.py``."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import program_trace
from benchmark.lib import harness, program, spec, trace
from benchmark.tests.test_bench_runs import CELLS, small
from benchmark.tests.test_bench_trace import X, hand_trace

NEW_COUNTER_METRICS = {"ersst_api": {"detect_passes_per_block"},
                       "oisst_stats": {"h2d_mb_per_block",
                                       "d2h_mb_per_block"},
                       "oisst_fused": set()}
SPAN_READINGS = {"ersst_api": ("api_land_check_ms_per_call",
                               "api_assemble_ms_per_call"),
                 "oisst_stats": ("upload_ms_per_block",),
                 "oisst_fused": ("clim_tables_ms_per_block",)}


def with_program_spans():
    """The hand trace with program spans inside its steps: run_fused
    (1000-1038) holding upload (1000.5-1003, around two launches) and
    land_check (1025-1037, over the middle of the 30 us gap), and
    fused_stats (1060.5-1079, around one launch and the 2 us gap); the
    host-to-device copy gives its bytes."""
    ev = hand_trace()
    for e in ev:
        if e["cat"] == "gpu_memcpy":
            e["args"]["bytes"] = 4096
    return ev + [
        X("xmhw/run_fused", "user_annotation", 1000, 38),
        X("xmhw/upload", "user_annotation", 1000.5, 2.5),
        X("xmhw/land_check", "user_annotation", 1025, 12),
        X("xmhw/fused_stats", "user_annotation", 1060.5, 18.5),
        # outside the stretch: left out
        X("xmhw/upload", "user_annotation", 1150, 10),
    ]


def test_program_spans_reduced():
    p = program.analyse(with_program_spans())
    assert p["wall_s"] == pytest.approx({
        "run_fused": 38e-6, "upload": 2.5e-6, "land_check": 12e-6,
        "fused_stats": 18.5e-6})
    assert p["self_s"] == pytest.approx({
        "run_fused": 23.5e-6, "upload": 2.5e-6, "land_check": 12e-6,
        "fused_stats": 18.5e-6})
    assert p["spans"]["upload"] == [(pytest.approx(0.5e-6),
                                     pytest.approx(3e-6))]
    assert p["launches"] == {"upload": 2, "fused_stats": 1}
    assert p["device_s"] == pytest.approx({"upload": 15e-6,
                                           "fused_stats": 8e-6})
    # gaps by the innermost program span at their middle, else the
    # benchmark's span, else none
    assert [n for _, n in p["gaps"]] == ["xmhw/land_check", "step",
                                         "xmhw/upload", None,
                                         "xmhw/fused_stats"]
    assert [d for d, _ in p["gaps"]] == pytest.approx(
        [30e-6, 21e-6, 5e-6, 5e-6, 2e-6])
    assert p["idle_s"] == pytest.approx({
        "xmhw/land_check": 30e-6, "step": 21e-6, "xmhw/upload": 5e-6,
        None: 5e-6, "xmhw/fused_stats": 2e-6})
    assert p["copy_bytes"] == {"HtoD": 4096}
    b = program.breakdown(trace.analyse(with_program_spans()), p)
    assert b["idle_gaps"][0] == ["xmhw/land_check", pytest.approx(30e-6)]
    assert b["idle_gaps"][3] == ["none", pytest.approx(5e-6)]
    assert b["device_ops"] == trace.breakdown(trace.analyse(
        hand_trace()))["device_ops"]


def test_program_spans_need_the_stretch():
    with pytest.raises(ValueError):
        program.analyse(with_program_spans()[1:])


def _hand_run(events):
    run = harness.Run("oisst_stats", {}, {"cells_per_block": 4096}, 0,
                      [torch.device("cpu")])
    run.trace = trace.analyse(events)
    run.traced_steps, run.cells_per_step = 2, 4096
    run.steps, run.cells, run.window_s = 2, 8192, 100e-6
    return run


def test_benchmark_readings_ignore_program_spans():
    plain, spanned = (_hand_run(hand_trace()),
                      _hand_run(with_program_spans()))
    assert spanned.trace["spans"] == plain.trace["spans"]
    assert spanned.trace["gaps"] == plain.trace["gaps"]
    assert trace.breakdown(spanned.trace) == trace.breakdown(plain.trace)
    names = sorted(p.stem for p in (spec.HERE / "metrics").glob("*.py"))
    names += ["device_idle_share.grid"]
    read = 0
    for name in names:
        mod = spec.module("metrics", name)
        a, b = mod.read(plain), mod.read(spanned)
        assert a == b, name
        read += a is not None
    assert read >= 5  # the trace readers found something to read


def _traced(cell, monkeypatch):
    from xmhw_tpu_torch import utils

    # the counters of a fresh process, as a run of the benchmark has
    monkeypatch.setattr(utils, "_counts", {})
    cfg, tr, lim, devs = small(cell)
    defs = spec.metrics_of(cell, "per_layer")
    with program_trace.capture() as got:
        out, _ = harness.execute(cell, cfg, tr, lim, defs, 4_000_000_321,
                                 0.5, True, devs, time.perf_counter())
    return out, program_trace.reduce(got)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_gives_the_program_readings(cell, monkeypatch):
    out, red = _traced(cell, monkeypatch)
    assert out["correct"], out["checks"]
    got = set(out["metrics"])
    assert NEW_COUNTER_METRICS[cell] <= got
    for name in NEW_COUNTER_METRICS[cell]:
        assert out["metrics"][name]["value"] > 0
    for name in SPAN_READINGS[cell]:
        assert red["readings"][name] > 0, name
    if cell == "ersst_api":
        # one block a call at this size: a counting pass and a detection
        assert out["metrics"]["detect_passes_per_block"]["value"] == 2.0
        self_ms = red["readings"]["api_self_ms_per_call"]
        assert 0 < self_ms < red["readings"]["api_host_ms_per_call"]
    if cell == "oisst_stats":
        assert red["stretch_counts"]["detect_blocks"] == red[
            "blocks_traced"]
    # the tool restores the harness
    assert harness.counters.__name__ == "counters"
    assert trace.analyse.__name__ == "analyse"
