"""Whole runs of each cell at a small size on the CPU, past the look for
a card: a sound run comes out correct; the control (the reference in
bfloat16) and the program broken underneath come out not correct, once
for each fault the cell can have."""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark.lib import harness, spec
from benchmark.lib.inputs import dates
from benchmark.reference import control
from benchmark.reference.judge import Setup, judge, verdict

CELLS = ("oisst_fused", "ersst_api", "oisst_stats")


def small(cell):
    """The cell's configuration and traffic cut to 64 cells (121 for the
    grid) and, for daily records, four years; its limits; and CPU
    devices standing for its cards."""
    c = spec.cell(cell)
    cfg, tr = spec.config(c["config"]), spec.traffic(c["traffic"])
    if cfg["record"]["step"] == "day":
        cfg["record"] = {"start": "1982-01-01", "end": "1985-12-31",
                         "step": "day"}
    else:  # the whole record: a short monthly one holds few events
        cfg["grid"] = {"lat": [-10.0, 10.0], "lon": [0.0, 20.0], "step": 2.0}
    for k in ("cells_per_block", "cells_per_stripe"):
        if k in tr:
            tr[k] = 64
    for k in ("blocks", "stripes"):
        if k in tr:
            tr[k] = 2
    if "year_bins" in tr:
        tr["year_bins"] = [1982, 1985]
    return (cfg, tr, spec.limits(cell),
            [torch.device("cpu")] * c["chips"])


def run(cell, seed=4_000_000_123):
    cfg, tr, lim, devs = small(cell)
    out, _ = harness.execute(cell, cfg, tr, lim, [], seed,
                             0.5, False, devs, time.perf_counter())
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    cfg, tr, lim, _ = small(cell)
    setup = Setup.of(cfg, dates(cfg["record"]), tr.get("year_bins"))
    rng = np.random.default_rng(5)
    t = len(setup.dates)
    step = np.arange(t)[:, None]
    period = 12 if setup.tstep else 365.25
    ts = (15 + 3 * np.sin(2 * np.pi * step / period)
          + rng.normal(0, 1, (t, 12))).astype(np.float32)
    cases = control.cases(ts, setup, with_stats=setup.bins is not None)
    ok, rows = verdict(judge(cases, setup, lim["clim_gap"]).values, lim)
    assert not ok, rows


def _first_forever(fn):
    memo = []

    def stale(*a, **kw):
        if not memo:
            memo.append(fn(*a, **kw))
        return memo[0]
    return stale


def _cat(a, b, axis):
    if isinstance(a, dict):
        return {k: _cat(a[k], b[k], axis) for k in a}
    if isinstance(a, torch.Tensor):
        return torch.cat([a, b], dim=axis)
    if isinstance(a, tuple):
        return tuple(_cat(x, y, axis) for x, y in zip(a, b))
    return np.concatenate([a, b], axis=axis)


def fault(monkeypatch, cell, kind):
    """Break the program underneath the timed path."""
    from xmhw_tpu_torch import api
    from xmhw_tpu_torch.core import features_scan, pipeline

    if kind == "stale":  # a step that returns its state unchanged
        name = ("fused_threshold_detect" if cell == "oisst_fused"
                else "run_fused")
        monkeypatch.setattr(pipeline, name,
                            _first_forever(getattr(pipeline, name)))
    elif kind == "half_batch" and cell == "oisst_fused":
        orig = pipeline.fused_threshold_detect

        def half(ts, *a, **kw):  # the first half's answers for all
            h = orig(ts[:, :ts.shape[1] // 2].contiguous(), *a, **kw)
            th, se, tab, nev = (_cat(x, x, -1 if i < 3 else 0)
                                for i, x in enumerate(h))
            return th, se, tab, nev
        monkeypatch.setattr(pipeline, "fused_threshold_detect", half)
    elif kind == "half_batch" and cell == "ersst_api":
        orig = api.run_detect

        def half(ts, th, se, *a, **kw):
            h = ts.shape[1] // 2
            tab, n, inter = orig(ts[:, :h], th[:, :h], se[:, :h], *a, **kw)
            c = ts.shape[1]
            return ({k: np.concatenate([v, v], 1)[:, :c]
                     for k, v in tab.items()},
                    np.concatenate([n, n])[:c], inter)
        monkeypatch.setattr(api, "run_detect", half)
    elif kind == "half_batch":
        orig = pipeline.run_fused

        def half(ts, *a, **kw):
            h = orig(np.ascontiguousarray(ts[:, :ts.shape[1] // 2]), *a,
                     **kw)
            th, se, tab, nev, ex = h
            return (_cat(th, th, 1), _cat(se, se, 1), _cat(tab, tab, 1),
                    _cat(nev, nev, 0), _cat(ex, ex, 1))
        monkeypatch.setattr(pipeline, "run_fused", half)
    elif kind == "answer" and cell == "oisst_fused":
        orig = features_scan.event_table

        def table(*a, **kw):
            t = orig(*a, **kw)
            t["intensity_mean"] = t["intensity_mean"] + 0.01
            return t
        monkeypatch.setattr(features_scan, "event_table", table)
    elif kind == "answer" and cell == "ersst_api":
        orig = api.run_clim

        def clim(*a, **kw):
            th, se = orig(*a, **kw)
            return th + np.float32(0.01), se
        monkeypatch.setattr(api, "run_clim", clim)
    elif kind == "answer":
        orig = pipeline.fused_stats

        def stats(*a, **kw):
            out = orig(*a, **kw)
            out["block"]["intensity_mean"] = out["block"][
                "intensity_mean"] * 1.01
            return out
        monkeypatch.setattr(pipeline, "fused_stats", stats)
    else:
        raise ValueError(kind)


FAULTS = [("oisst_fused", "stale"), ("oisst_fused", "half_batch"),
          ("oisst_fused", "answer"), ("ersst_api", "half_batch"),
          ("ersst_api", "answer"), ("oisst_stats", "stale"),
          ("oisst_stats", "half_batch"), ("oisst_stats", "answer")]


@pytest.mark.parametrize("cell,kind", FAULTS)
def test_broken_program_is_not_correct(monkeypatch, cell, kind):
    fault(monkeypatch, cell, kind)
    out = run(cell)
    assert not out["correct"], out["checks"]


def test_run_without_a_card_fails_and_prints_nothing():
    r = subprocess.run([sys.executable, str(spec.HERE / "run.py"),
                        "--workload", "oisst_fused", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300,
                       cwd=spec.ROOT)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    assert r.returncode != 0 and r.stdout == ""
