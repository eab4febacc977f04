"""``rank_pinned_share``: the share of the stats API's ``mhw_rank`` calls
on a device whose ranks and return periods landed in page-locked memory,
read from the program's counters; nothing where the program has no such
counters or made no call; and a ``mhw_rank`` call on the CPU device, whose
results land in plain memory, reads 0."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark.lib import spec


def read(monkeypatch, counts):
    from xmhw_tpu_torch import utils

    monkeypatch.setattr(utils, "_counts", dict(counts))
    return spec.module("metrics", "rank_pinned_share").read(None)


@pytest.mark.parametrize("counts, share", [
    ({"rank_calls": 4, "rank_pinned_calls": 4}, 1.0),
    ({"rank_calls": 4, "rank_pinned_calls": 1}, 0.25),
    ({"rank_calls": 4}, 0.0),
    ({"land_calls": 4}, None),
    ({"rank_calls": 0}, None)],
    ids=["pinned", "some", "none", "no_counters", "no_calls"])
def test_share_of_the_counters(monkeypatch, counts, share):
    assert read(monkeypatch, counts) == share


def test_a_cpu_rank_call_lands_in_plain_memory(monkeypatch):
    from xmhw_tpu_torch import utils
    from xmhw_tpu_torch.stats_api import mhw_rank
    from xmhw_tpu_torch.xrlite import DataArray, Dataset

    monkeypatch.setattr(utils, "_counts", {})
    rng = np.random.default_rng(3)
    mhw = Dataset({"intensity_max": DataArray(
        rng.normal(2, 1, (40, 6)).astype(np.float32), ("events", "cell"))})
    rank, _ = mhw_rank(mhw, nYears=30.0, device="cpu")
    assert rank["intensity_max"].data.dtype == np.float64
    assert utils.counts() == {"rank_calls": 1}
    assert spec.module("metrics", "rank_pinned_share").read(None) == 0.0
