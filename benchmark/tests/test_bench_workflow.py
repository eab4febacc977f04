"""The notebook workflow cell (``tasman_workflow``) and the bare host
stripes cell (``oisst_host``) run whole at a small size on the CPU: a
sound run comes out correct; the control (the reference in bfloat16) and
the program broken underneath come out not correct; the workflow's own
comparison (``reference/workflow.py``) holds a sound step and finds a
broken one; and the new metric readers give their values on a hand-made
run."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from benchmark.lib import harness, spec, trace
from benchmark.lib.inputs import dates
from benchmark.reference import control, stats, workflow
from benchmark.reference.judge import Setup, judge, verdict
from benchmark.tests.test_bench_runs import fault, small
from benchmark.tests.test_bench_trace import X

CELLS = ("tasman_workflow", "oisst_host")
NEW_METRICS = ("workflow_ms_per_call.assemble_inter",
               "workflow_ms_per_call.block_average",
               "workflow_ms_per_call.mhw_rank", "inter_mb_per_call")


def small_cell(cell):
    """``test_bench_runs.small``'s cut (four years, 64-cell stripes), and
    for the box, 8 x 8 cells with its land share: 45 ocean cells."""
    cfg, tr, lim, devs = small(cell)
    if "grid" in cfg and "lat" in cfg["grid"]:
        g = cfg["grid"]
        cfg["grid"] = {"lat": [g["lat"][0], g["lat"][0] + 7 * g["step"]],
                       "lon": [g["lon"][0], g["lon"][0] + 7 * g["step"]],
                       "step": g["step"]}
        cfg["ocean_cells"] = 64 - round(cfg["land_share"] * 64)
    return cfg, tr, lim, devs


def run(cell, seed=4_000_000_789, traced=False):
    cfg, tr, lim, devs = small_cell(cell)
    defs = spec.metrics_of(cell, "per_layer") if traced else []
    out, _ = harness.execute(cell, cfg, tr, lim, defs, seed, 0.5, traced,
                             devs, time.perf_counter())
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    if cell == "tasman_workflow":  # the year-block statistics judged
        assert out["checks"]["block_gap"]["value"] is not None


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    cfg, tr, lim, _ = small_cell(cell)
    setup = Setup.of(cfg, dates(cfg["record"]), tr.get("year_bins"))
    rng = np.random.default_rng(7)
    t = len(setup.dates)
    ts = (15 + 3 * np.sin(2 * np.pi * np.arange(t)[:, None] / 365.25)
          + rng.normal(0, 1, (t, 12))).astype(np.float32)
    cases = control.cases(ts, setup, with_stats=setup.bins is not None)
    if setup.bins is not None:  # the cell judges block statistics only
        for c in cases:
            c.day = None
    ok, rows = verdict(judge(cases, setup, lim["clim_gap"]).values, lim)
    assert not ok, rows


def _wrong_block_stat(monkeypatch):
    """One year-block event statistic of every cell off by 1 %."""
    from xmhw_tpu_torch import stats_api

    orig = stats_api.block_average

    def off(*a, **kw):
        blk = orig(*a, **kw)
        v = blk["intensity_mean"].data.copy()
        v[3] = v[3] * 1.01
        blk["intensity_mean"] = blk["intensity_mean"].copy(data=v)
        return blk
    monkeypatch.setattr(stats_api, "block_average", off)


def _wrong_cats_day(monkeypatch):
    """The intermediate ``cats`` one category high on the first event day
    of each cell."""
    from xmhw_tpu_torch import api

    orig = api._assemble_inter

    def off(inter, *a, **kw):
        cats = inter["cats"].copy()
        day = np.isfinite(cats)
        first = day.argmax(axis=0)
        cols = np.flatnonzero(day.any(axis=0))
        cats[first[cols], cols] += 1
        return orig({**inter, "cats": cats}, *a, **kw)
    monkeypatch.setattr(api, "_assemble_inter", off)


def _half_batch(monkeypatch):
    """Detection's answers, the intermediate series too, of the first half
    of the cells for all of them (``test_bench_runs``' ``half_batch`` for
    an API cell, which returns the first half's series alone)."""
    from xmhw_tpu_torch import api

    orig = api.run_detect

    def half(ts, th, se, *a, **kw):
        h, c = ts.shape[1] // 2, ts.shape[1]
        tab, n, inter = orig(ts[:, :h], th[:, :h], se[:, :h], *a, **kw)

        def twice(v):
            return np.concatenate([v, v, v], -1)[..., :c]
        return ({k: twice(v) for k, v in tab.items()}, twice(n),
                {k: twice(v) for k, v in inter.items()})
    monkeypatch.setattr(api, "run_detect", half)


@pytest.mark.parametrize("kind", ["block_stat", "half_batch", "answer"])
def test_broken_program_is_not_correct(monkeypatch, kind):
    if kind == "block_stat":
        _wrong_block_stat(monkeypatch)
    elif kind == "half_batch":
        _half_batch(monkeypatch)
    else:
        fault(monkeypatch, "ersst_api", kind)
    assert not run("tasman_workflow")["correct"]


@pytest.mark.parametrize("kind", ["stale", "half_batch", "answer"])
def test_broken_host_stripes_are_not_correct(monkeypatch, kind):
    if kind == "answer":  # the stripe's stats stage does not run here
        fault(monkeypatch, "oisst_fused", kind)
    else:
        fault(monkeypatch, "oisst_stats", kind)
    assert not run("oisst_host")["correct"]


def _step(seed=4_000_000_791):
    """One step of the cell at the small size, and its whole box as
    ``reference.workflow.check`` takes it."""
    cfg, tr, lim, devs = small_cell("tasman_workflow")
    r = harness.Run("tasman_workflow", cfg, tr, seed, devs)
    e = spec.module("entries", tr["entry"]).Entry(r)
    e.step(0)
    _, cells = e.workflow_cells()
    setup = Setup.of(cfg, dates(cfg["record"]), tr["year_bins"])
    return cells, setup, lim


def _readings(cells, setup, lim):
    vals, _, ref, products = workflow.check(cells, setup, lim["clim_gap"],
                                            lim["event_gap"])
    vals["return_period_gap"] = workflow.return_period_gap(
        [products], workflow.n_years(setup.dates, workflow.event_span(ref)))
    limits = {**workflow.LIMITS, "inter_clim_gap": lim["clim_gap"],
              "inter_gap": lim["event_gap"]}
    return verdict(vals, limits)


def test_workflow_comparison_holds_a_sound_step():
    cells, setup, lim = _step()
    assert len(cells) == 45
    ok, rows = _readings(cells, setup, lim)
    assert ok, rows


def _control_cells(cells, setup):
    """The cells as the control answers them: the reference on the
    series rounded to bfloat16, each answer rounded to bfloat16."""
    bf = control.bf16
    ts = np.stack([c["ts"] for c in cells], axis=1)
    cases = control.cases(ts, setup, with_stats=True)
    doy = setup.dates.astype("datetime64[D]")
    from benchmark.reference import calendar

    pos = calendar.rows(doy, setup.tstep)[0] - 1
    edges = stats.day_edges(calendar.years(setup.dates), setup.bins)
    out = []
    for c in cases:
        x = bf(c.ts)
        evs = [dict(zip(c.events, v)) for v in zip(*c.events.values())]
        inter = workflow.intermediate(x, c.th[pos], c.se[pos], evs)
        inter = {k: v if v.dtype == torch.bool else bf(v.numpy())
                 for k, v in inter.items()}
        r = {k: workflow.ranks(c.events[k]).numpy()
             for k in workflow.rank_names(c.events)}
        out.append({"ts": c.ts, "th": c.th, "se": c.se, "events": c.events,
                    "inter": inter,
                    "day": {k: bf(v) for k, v in workflow.day_stats(
                        {k: torch.as_tensor(np.asarray(v, np.float64))
                         for k, v in inter.items()}, edges).items()},
                    "rank": r, "rp": {k: 41.0 / v for k, v in r.items()},
                    "where": c.where})
    return out


def test_workflow_comparison_finds_the_control():
    cells, setup, lim = _step()
    ok, rows = _readings(_control_cells(cells[:12], setup), setup, lim)
    assert not ok, rows
    got = {n: r for n, r, _ in rows}
    # the intermediate series alone tell it from the program
    assert got["inter_clim_gap"] > lim["clim_gap"]
    assert got["inter_gap"] > lim["event_gap"]


def test_workflow_comparison_finds_a_wrong_cats_day(monkeypatch):
    _wrong_cats_day(monkeypatch)
    ok, rows = _readings(*_step())
    assert not ok, rows
    got = {n: r for n, r, _ in rows}
    assert got["inter_days_off"] > 0 and got["day_counts_off"] >= 0


def test_workflow_comparison_finds_a_wrong_block_stat_nowhere_else(
        monkeypatch):
    """The block statistics are the judge's: the workflow comparison
    leaves them to it and still holds."""
    _wrong_block_stat(monkeypatch)
    ok, rows = _readings(*_step())
    assert ok, rows


def _hand_run(monkeypatch, counts):
    """A run whose trace holds two steps with the entry's spans, and
    whose program counted ``counts``."""
    from xmhw_tpu_torch import utils

    monkeypatch.setattr(utils, "_counts", dict(counts))
    events = [
        X("bench/stretch", "user_annotation", 1000, 1000),
        X("bench/step", "user_annotation", 1000, 400),
        X("bench/assemble_inter", "user_annotation", 1010, 30),
        X("bench/block_average", "user_annotation", 1050, 100),
        X("bench/mhw_rank", "user_annotation", 1160, 200),
        X("bench/step", "user_annotation", 1500, 500),
        X("bench/assemble_inter", "user_annotation", 1510, 50),
        X("bench/block_average", "user_annotation", 1570, 120),
        X("bench/mhw_rank", "user_annotation", 1700, 260),
        X("Memcpy DtoH", "gpu_memcpy", 1300, 50, device=0, pid=0),
    ]
    r = harness.Run("tasman_workflow", {}, {}, 0, [torch.device("cpu")])
    r.trace = trace.analyse(events)
    r.traced_steps, r.steps = 2, 2
    return r


def test_metric_readers_on_a_hand_made_run(monkeypatch):
    r = _hand_run(monkeypatch, {"inter_calls": 4,
                                "inter_bytes": 4 * 1_150_537_500})
    got = {n: spec.module("metrics", n).read(r) for n in NEW_METRICS}
    assert got == {
        # ms per step: (30 + 50), (100 + 120), (200 + 260) us over 2
        "workflow_ms_per_call.assemble_inter": pytest.approx(0.04),
        "workflow_ms_per_call.block_average": pytest.approx(0.11),
        "workflow_ms_per_call.mhw_rank": pytest.approx(0.23),
        "inter_mb_per_call": pytest.approx(1150.5375)}


def test_metric_readers_read_nothing_where_the_program_has_nothing(
        monkeypatch):
    """A program without the counters (an older one) and a run without a
    trace read None and raise nothing."""
    r = _hand_run(monkeypatch, {"union_calls": 4})
    assert spec.module("metrics", "inter_mb_per_call").read(r) is None
    r.trace = None
    for name in NEW_METRICS[:3]:
        assert spec.module("metrics", name).read(r) is None, name


def test_traced_run_gives_the_new_metrics(monkeypatch):
    from xmhw_tpu_torch import utils

    # the counters of a fresh process, as a run of the benchmark has
    monkeypatch.setattr(utils, "_counts", {})
    out = run("tasman_workflow", traced=True)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    for name in NEW_METRICS[:3]:
        assert got[name]["value"] > 0, name
    # 45 cells x 1,461 days: ten float32 series and five flags
    assert got["inter_mb_per_call"]["value"] == pytest.approx(
        45 * 1461 * (10 * 4 + 5) / 1e6)
    assert got["union_card_share"]["value"] == 0.0
    assert got["land_pinned_share"]["value"] == 0.0


def test_the_cells_box_is_the_centred_sub_box_of_its_source():
    from benchmark.workflow_check import sub_box

    cfg = spec.config("oisst_v21_tasman_workflow")
    assert sub_box(cfg, 20)["grid"] == cfg["grid"]
    assert sub_box(cfg, 20)["ocean_cells"] == cfg["ocean_cells"] == 280
    whole = sub_box(cfg, 50)
    assert whole["grid"] == spec.config("oisst_v21_tasman")["grid"]
    assert whole["ocean_cells"] == cfg["source_ocean_cells"] == 1750
    with pytest.raises(ValueError):
        sub_box(cfg, 21)
