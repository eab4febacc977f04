"""``stats_kernel_share``: the share of the stats layer's binned calls
that launched a kernel, read from the program's counters; nothing where
the program has no such counters; and a whole ``run_fused`` stats step at
a small size on the CPU, where only the plain route runs, reads 0."""

from __future__ import annotations

import numpy as np

from benchmark.lib import spec


def read(monkeypatch, counts):
    from xmhw_tpu_torch import utils

    monkeypatch.setattr(utils, "_counts", dict(counts))
    return spec.module("metrics", "stats_kernel_share").read(None)


def test_share_of_the_counters(monkeypatch):
    assert read(monkeypatch, {"stats_calls": 16,
                              "stats_kernel_calls": 16}) == 1.0
    assert read(monkeypatch, {"stats_calls": 16,
                              "stats_kernel_calls": 4}) == 0.25
    assert read(monkeypatch, {"stats_calls": 4}) == 0.0


def test_nothing_without_the_counters(monkeypatch):
    assert read(monkeypatch, {"land_calls": 4}) is None
    assert read(monkeypatch, {"stats_calls": 0}) is None


def test_a_cpu_stats_step_launches_no_kernel(monkeypatch):
    from xmhw_tpu_torch import utils
    from xmhw_tpu_torch.core import pipeline

    monkeypatch.setattr(utils, "_counts", {})
    rng = np.random.default_rng(2)
    day = np.arange(3 * 365)
    ts = (15 + 3 * np.sin(2 * np.pi * day / 365.25)[:, None]
          + rng.normal(0, 1, (len(day), 6))).astype(np.float32)
    years = 2001 + day // 365
    pipeline.run_fused(ts, day % 365 + 1, day % 365, device="cpu",
                       ybod_np=(years - 2001).astype(np.int32), nbins=3,
                       day_edges=(0, 365, 730, 1095))
    assert utils.counts()["stats_calls"] == 2
    assert spec.module("metrics", "stats_kernel_share").read(None) == 0.0
