"""The one-process-a-card cell ``oisst_mp4`` at a small size on the CPU,
two ranks: a whole run is correct and gives its readers; every rank's
cells reach the judge; the ranks' outputs are one process's
``run_fused`` on the same stripes, bit for bit; a rank with a broken
climatology makes the run not correct; a rank that dies fails the entry
at once and leaves no process behind; a checkout without the group's
functions fails before any rank starts; and the readers on hand-made
counters and traces."""

from __future__ import annotations

import re
import time

import numpy as np
import pytest
import torch

from benchmark.lib import harness, inputs, spec, trace
from benchmark.reference import judge as judge_mod
from benchmark.reference.judge import table_cases
from benchmark.tests.test_bench_runs import small
from benchmark.tests.test_bench_trace import hand_trace

CELL = "oisst_mp4"
SEED = 4_000_000_123
WHERE = re.compile(r"rank (\d+) step (\d+) \(stripe (\d+)\) cell (\d+)")


def cut(ranks=2):
    cfg, tr, lim, _ = small(CELL)
    tr["ranks"] = ranks
    return cfg, tr, lim, [torch.device("cpu")] * ranks


@pytest.fixture
def one_thread(monkeypatch):
    """One intra-op thread in this process and in the ranks it starts, so
    that their sums add in one order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(n)


def entry_module():
    return spec.module("entries", "rank_stripes")


def execute(monkeypatch):
    """A whole run; returns its result and the cases the judge saw."""
    seen = []

    def judge(cases, *a, **kw):
        seen.extend(cases)
        return judge_mod.judge(cases, *a, **kw)
    monkeypatch.setattr(harness, "judge", judge)
    cfg, tr, lim, devs = cut()
    defs = (spec.metrics_of(CELL, "per_layer")
            + spec.metrics_of(CELL, "end_to_end"))
    out, _ = harness.execute(CELL, cfg, tr, lim, defs, SEED, 0.5, False,
                             devs, time.perf_counter())
    return out, seen


def test_sound_run_is_correct_and_every_rank_is_judged(monkeypatch,
                                                       one_thread):
    out, seen = execute(monkeypatch)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    m = out["metrics"]
    assert 0 <= m["group_wait_share"]["value"] < 1
    assert m["host_copy_gbps"]["value"] > 0
    assert m["cells_per_s"]["value"] > 0
    ranks = {int(WHERE.match(c.where).group(1)) for c in seen}
    assert ranks == {0, 1}
    # the sample's steps and the last, ten cells each, from each rank
    by_rank = [sum(int(WHERE.match(c.where).group(1)) == r for c in seen)
               for r in (0, 1)]
    assert by_rank[0] == by_rank[1] >= 10
    assert not torch.distributed.is_initialized()


def test_ranks_equal_one_process_bit_for_bit(one_thread):
    cfg, tr, _, devs = cut()
    run = harness.Run(CELL, cfg, tr, SEED, devs)
    mod = entry_module()
    e = mod.Entry(run)
    try:
        e.warm()
        for i in range(3):
            e.step(i)
            e.keep_last(None)
        assert e.failed() == 0
        cases = e.cases(np.random.default_rng(3), 6)
    finally:
        e.free()
    assert len(cases) == 2 * 3 * 6
    assert sorted(run.rank_counts[1]) and run.rank_counts[1][
        "group_barriers"] == 3
    parts = {r: mod.Part(cfg, tr, SEED, r, torch.device("cpu"))
             for r in (0, 1)}
    outs = {}
    for c in cases:
        r, i, k, j = map(int, WHERE.match(c.where).groups())
        if (r, k) not in outs:
            parts[r].step(k)
            outs[r, k] = parts[r].last
        _, _, th, se, tables, nev, extras = outs[r, k]
        (want,) = table_cases(parts[r].stripes[k], th, se, tables, nev,
                              [j], "", block=extras["block"],
                              day=extras["day"])
        for name in ("ts", "th", "se", "n_raw"):
            assert np.asarray(getattr(c, name)).tobytes() == np.asarray(
                getattr(want, name)).tobytes(), (c.where, name)
        for part in ("events", "block", "day"):
            a, b = getattr(c, part), getattr(want, part)
            assert sorted(a) == sorted(b)
            for name in b:
                assert a[name].tobytes() == b[name].tobytes(), (
                    c.where, part, name)
    # rank 1's data is not rank 0's
    assert not np.array_equal(parts[0].stripes[0], parts[1].stripes[0])
    assert np.array_equal(parts[1].stripes[1], inputs.smoothed_seasonal(
        len(parts[1].dates), 64, inputs.stream_seed(SEED, 3),
        "cpu").numpy())


SITE = """
import os
if os.environ.get("RANK") == "1":
    from xmhw_tpu_torch.core import pipeline

    _clim_block = pipeline._clim_block

    def broken(*a, **kw):
        th, se = _clim_block(*a, **kw)
        return th + 0.01, se
    pipeline._clim_block = broken
"""


def test_a_rank_with_a_broken_climatology_is_not_correct(
        monkeypatch, tmp_path, one_thread):
    (tmp_path / "sitecustomize.py").write_text(SITE)
    monkeypatch.setenv("PYTHONPATH", f"{tmp_path}:{spec.ROOT}")
    out, seen = execute(monkeypatch)
    assert not out["correct"], out["checks"]
    assert out["checks"]["clim_gap"]["value"] > 0.005
    assert out["worst_cells"]["clim_gap"].startswith("rank 1 ")


def test_a_rank_that_dies_fails_the_entry_at_once(one_thread):
    cfg, tr, _, devs = cut()
    e = entry_module().Entry(harness.Run(CELL, cfg, tr, SEED, devs))
    procs = list(e.procs)
    e.warm()
    e.step(0)
    procs[0].kill()
    procs[0].wait(timeout=30)
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 exited"):
        e.step(1)
    assert time.monotonic() - t < entry_module().TIMEOUT_S
    assert all(p.poll() is not None for p in procs)
    assert not torch.distributed.is_initialized()
    e.free()  # after a failure, free() has nothing left to stop


def test_a_checkout_without_the_group_fails_before_any_rank(monkeypatch):
    from xmhw_tpu_torch import parallel

    monkeypatch.delattr(parallel, "gathered_counts")
    cfg, tr, _, devs = cut()
    spawned = []
    monkeypatch.setattr("subprocess.Popen",
                        lambda *a, **kw: spawned.append(a))
    with pytest.raises(ImportError):
        entry_module().Entry(harness.Run(CELL, cfg, tr, SEED, devs))
    assert spawned == [] and not torch.distributed.is_initialized()


def hand_run(devices=1, counters=None):
    run = harness.Run(CELL, {}, {"cells_per_block": 4096}, 0,
                      [torch.device("cpu")] * devices)
    run.trace = trace.analyse(hand_trace())
    if counters is not None:
        run.rank_counts = counters
    return run


def read(name, run):
    return spec.module("metrics", name).read(run)


def test_rank0_idle_share_reads_card_0_alone():
    # 37 us busy of a 100 us stretch, on the one card the process traces
    one, four = hand_run(1), hand_run(4)
    assert read("rank0_idle_share", one) == pytest.approx(63.0)
    assert read("rank0_idle_share", four) == pytest.approx(63.0)
    assert read("device_idle_share", four) == pytest.approx(
        100 * (1 - 37 / 400))
    four.trace = None
    assert read("rank0_idle_share", four) is None


def test_group_readers_on_gathered_counters(monkeypatch):
    from xmhw_tpu_torch import utils

    ranks = [{"group_wait_ns": 10, "group_step_ns": 100, "h2d_bytes": 300,
              "h2d_ns": 100, "d2h_bytes": 100, "d2h_ns": 100},
             {"group_wait_ns": 30, "group_step_ns": 100, "h2d_bytes": 600,
              "h2d_ns": 200, "d2h_bytes": 0, "d2h_ns": 0}]
    run = hand_run(counters=ranks)
    assert read("group_wait_share", run) == pytest.approx(0.2)
    assert read("host_copy_gbps", run) == pytest.approx(1000 / 400)
    # one card: this process's counters
    monkeypatch.setattr(utils, "_counts", {"h2d_bytes": 8, "h2d_ns": 2,
                                           "d2h_bytes": 4, "d2h_ns": 1})
    alone = hand_run()
    assert read("host_copy_gbps", alone) == pytest.approx(4.0)
    assert read("group_wait_share", alone) is None
    # a program without the walls, or a group that counted no step
    monkeypatch.setattr(utils, "_counts", {"h2d_bytes": 8, "d2h_bytes": 4})
    assert read("host_copy_gbps", alone) is None
    assert read("group_wait_share", hand_run(counters=[{}, {}])) is None
