"""The regional daily API cell (``tasman_api``) runs whole at a small
size on the CPU: a sound run comes out correct; the control (the
reference in bfloat16) and the program broken underneath come out not
correct; and the cell's new metric readers give their values on a
hand-made run."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from benchmark.entries import api_region
from benchmark.lib import harness, spec, trace
from benchmark.lib.inputs import dates
from benchmark.reference import control
from benchmark.reference.judge import Setup, judge, verdict
from benchmark.tests.test_bench_runs import fault, small
from benchmark.tests.test_bench_trace import X

CELL = "tasman_api"
NEW_METRICS = ("union_rows_per_call", "union_pinned_over_bytes",
               "region_ms_per_call.land_check", "region_ms_per_call.assemble",
               "region_ms_per_call.host")


def small_cell():
    """``test_bench_runs.small``'s cut (four years), and for the box, 8 x 8
    cells with its land share: 45 ocean cells."""
    cfg, tr, lim, devs = small(CELL)
    g = cfg["grid"]
    cfg["grid"] = {"lat": [g["lat"][0], g["lat"][0] + 7 * g["step"]],
                   "lon": [g["lon"][0], g["lon"][0] + 7 * g["step"]],
                   "step": g["step"]}
    cfg["ocean_cells"] = 64 - round(cfg["land_share"] * 64)
    return cfg, tr, lim, devs


def run(seed=4_000_000_457, traced=False):
    cfg, tr, lim, devs = small_cell()
    defs = spec.metrics_of(CELL, "per_layer") if traced else []
    out, _ = harness.execute(CELL, cfg, tr, lim, defs, seed, 0.5, traced,
                             devs, time.perf_counter())
    return out


def test_sound_run_is_correct():
    out = run()
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


def test_control_is_not_correct():
    cfg, tr, lim, _ = small_cell()
    setup = Setup.of(cfg, dates(cfg["record"]), tr.get("year_bins"))
    rng = np.random.default_rng(6)
    t = len(setup.dates)
    ts = (15 + 3 * np.sin(2 * np.pi * np.arange(t)[:, None] / 365.25)
          + rng.normal(0, 1, (t, 12))).astype(np.float32)
    ok, rows = verdict(judge(control.cases(ts, setup), setup,
                             lim["clim_gap"]).values, lim)
    assert not ok, rows


def _shifted_union(monkeypatch):
    """The events coordinate one day late: every cell's event rows are off
    though its values are right."""
    from xmhw_tpu_torch import api

    orig = api._union_geometry

    def late(labels):
        union, rows, cols, valid = orig(labels)
        return union + 1, rows, cols, valid
    monkeypatch.setattr(api, "_union_geometry", late)


# the fault, as test_bench_runs makes it for ersst_api, or the union's
# events coordinate shifted
FAULTS = ["half_batch", "answer", "union_rows"]


@pytest.mark.parametrize("kind", FAULTS)
def test_broken_program_is_not_correct(monkeypatch, kind):
    if kind == "union_rows":
        _shifted_union(monkeypatch)
    else:
        fault(monkeypatch, "ersst_api", kind)
    out = run()
    assert not out["correct"], out["checks"]


def test_box_has_its_ocean_cells_from_the_seed():
    cfg = spec.config("oisst_v21_tasman")
    cfg["record"] = {"start": "1982-01-01", "end": "1982-12-31",
                     "step": "day"}
    lat, lon, a = api_region.box(cfg, 5, torch.device("cpu"))
    _, _, b = api_region.box(cfg, 5, torch.device("cpu"))
    _, _, c = api_region.box(cfg, 6, torch.device("cpu"))
    assert a.shape == (365, 50, 50) and len(lat) == len(lon) == 50
    assert lat[0] == -44.875 and lat[-1] == -32.625
    assert lon[0] == 145.125 and lon[-1] == 157.375
    ocean = ~np.isnan(a).all(axis=0)
    assert ocean.sum() == cfg["ocean_cells"] == 1750
    assert not np.isnan(a[:, ocean]).any()
    np.testing.assert_array_equal(a, b)
    assert (ocean != ~np.isnan(c).all(axis=0)).any()


def _hand_run(monkeypatch, counts):
    """A run of the box whose trace holds two steps with the entry's
    spans, and whose program counted ``counts``."""
    from xmhw_tpu_torch import utils

    monkeypatch.setattr(utils, "_counts", dict(counts))
    events = [
        X("bench/stretch", "user_annotation", 1000, 1000),
        X("bench/step", "user_annotation", 1000, 400),
        X("bench/land_check", "user_annotation", 1010, 30),
        X("bench/run_clim", "user_annotation", 1050, 100),
        X("bench/land_check", "user_annotation", 1160, 20),
        X("bench/run_detect", "user_annotation", 1190, 80),
        X("bench/assemble", "user_annotation", 1280, 110),
        X("bench/step", "user_annotation", 1500, 500),
        X("bench/land_check", "user_annotation", 1510, 50),
        X("bench/run_clim", "user_annotation", 1570, 100),
        X("bench/run_detect", "user_annotation", 1700, 120),
        X("bench/assemble", "user_annotation", 1830, 150),
        X("Memcpy DtoH", "gpu_memcpy", 1300, 50, device=0, pid=0),
    ]
    run = harness.Run("tasman_api", {}, {}, 0, [torch.device("cpu")])
    run.trace = trace.analyse(events)
    run.traced_steps, run.steps = 2, 2
    return run


def test_metric_readers_on_a_hand_made_run(monkeypatch):
    run = _hand_run(monkeypatch, {
        "union_calls": 4, "union_rows": 4 * 14_321, "union_card_calls": 4,
        "union_card_bytes": 1000, "union_pinned_bytes": 1770})
    got = {n: spec.module("metrics", n).read(run) for n in NEW_METRICS}
    assert got == {
        "union_rows_per_call": 14_321.0,
        "union_pinned_over_bytes": pytest.approx(1.77),
        # ms per step: (30 + 20 + 50), (110 + 150), (900 - 400) us over 2
        "region_ms_per_call.land_check": pytest.approx(0.05),
        "region_ms_per_call.assemble": pytest.approx(0.13),
        "region_ms_per_call.host": pytest.approx(0.25)}
    assert spec.module("metrics", "region_ms_per_call").read(
        run) == pytest.approx(0.45)


def test_metric_readers_read_nothing_where_the_program_has_nothing(
        monkeypatch):
    """A program without the counters (an older one) or without a card
    route, and a run without a trace, read None and raise nothing."""
    run = _hand_run(monkeypatch, {"union_calls": 4, "union_card_calls": 0})
    for name in ("union_rows_per_call", "union_pinned_over_bytes"):
        assert spec.module("metrics", name).read(run) is None, name
    run.trace = None
    for name in NEW_METRICS[2:]:
        assert spec.module("metrics", name).read(run) is None, name


def test_traced_run_gives_the_new_metrics(monkeypatch):
    from xmhw_tpu_torch import utils

    # the counters of a fresh process, as a run of the benchmark has
    monkeypatch.setattr(utils, "_counts", {})
    out = run(traced=True)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    # no card here: the host route builds the grids, nothing is pinned
    assert got["union_card_share"]["value"] == 0.0
    assert "union_pinned_over_bytes" not in got
    assert got["union_rows_per_call"]["value"] > 100
    for part in ("land_check", "assemble", "host"):
        assert got[f"region_ms_per_call.{part}"]["value"] > 0, part
    assert (got["region_ms_per_call.assemble"]["value"]
            < got["region_ms_per_call.host"]["value"])
