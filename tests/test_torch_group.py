"""One process a card (``xmhw_tpu_torch.parallel.group``) and the copies'
host walls, on the CPU.

* ``band_rows``: bands that cover the rows, inner edges on stripe
  multiples, sizes within one stripe; a refusal where a band would lack
  a whole stripe.
* ``barrier`` and ``gathered_counts`` in a two-rank ``gloo`` group of
  spawned processes: both ranks' counters reach rank 0, and the rank
  that waits counts its wait; outside a group, nothing to wait for.
* ``pipeline.upload``, ``fetch_rows`` and ``mesh.replicated`` count the
  host wall of their copies (``h2d_ns``, ``d2h_ns``) beside the bytes.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from xmhw_tpu_torch import utils  # noqa: E402
from xmhw_tpu_torch.core import pipeline  # noqa: E402
from xmhw_tpu_torch.parallel import (band_rows, barrier,  # noqa: E402
                                     gathered_counts, replicated)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
from torch_multiproc_dryrun import free_port  # noqa: E402

# (rows, ranks, stripe rows): the 0.25 degree grid at stream_run's stripe
# and at others, ERSST v5's 89 rows, the streamed two-process tool's grid
GRIDS = [(720, 4, 3), (720, 4, 7), (720, 3, 5), (89, 4, 3), (89, 2, 5),
         (89, 3, 7), (12, 2, 5), (12, 2, 6)]


@pytest.mark.parametrize("rows,world,stripe", GRIDS)
def test_bands_cover_the_rows_on_stripe_edges(rows, world, stripe):
    bands = band_rows(rows, world, stripe)
    assert len(bands) == world
    assert bands[0][0] == 0 and bands[-1][1] == rows
    for (_, hi), (lo, _) in zip(bands, bands[1:]):
        assert hi == lo and lo % stripe == 0
    sizes = [hi - lo for lo, hi in bands]
    assert min(sizes) >= stripe
    assert max(sizes) - min(sizes) <= stripe


def test_bands_of_the_deployments():
    assert band_rows(720, 4, 3) == [(0, 180), (180, 360), (360, 540),
                                    (540, 720)]
    assert band_rows(12, 2, 5) == [(0, 5), (5, 12)]  # the tool's bands
    assert band_rows(7, 1, 3) == [(0, 7)]


@pytest.mark.parametrize("rows,world,stripe", [(11, 4, 3), (9, 2, 5),
                                               (0, 1, 1), (12, 0, 5),
                                               (12, 2, 0)])
def test_bands_refuse_a_band_without_a_stripe(rows, world, stripe):
    with pytest.raises(ValueError):
        band_rows(rows, world, stripe)


def test_outside_a_group_nothing_to_wait_for():
    before = utils.counts()
    barrier()
    assert utils.counts() == before
    assert gathered_counts() == [before]


RANK = """
import datetime, json, sys, time
sys.path.insert(0, sys.argv[4])
import torch
import torch.distributed as dist
from xmhw_tpu_torch import utils
from xmhw_tpu_torch.parallel import barrier, gathered_counts

torch.set_num_threads(1)
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=60))
utils.count("probe", rank + 1)
if rank == 1:
    time.sleep(0.6)  # rank 0 waits for it at the barrier
barrier()
got = gathered_counts()
dist.destroy_process_group()
with open(out, "w") as f:
    json.dump(got, f)
"""


def test_barrier_and_gathered_counts_in_a_two_rank_group(tmp_path):
    port = free_port()
    outs = [tmp_path / f"r{r}.json" for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r),
                               str(port), str(outs[r]), str(ROOT)])
             for r in range(2)]
    try:
        codes = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert codes == [0, 0]
    got = [json.loads(o.read_text()) for o in outs]
    assert got[1] is None  # the counters reach rank 0 alone
    r0, r1 = got[0]
    assert (r0["probe"], r1["probe"]) == (1, 2)
    assert r0["group_barriers"] == r1["group_barriers"] == 1
    # rank 0 waited for rank 1's sleep; rank 1 arrived last
    assert r0["group_wait_ns"] >= 0.4e9
    assert r0["group_wait_ns"] > r1["group_wait_ns"]


def _delta(before):
    after = utils.counts()
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def test_copies_count_their_host_wall():
    x = np.arange(60, dtype=np.float32).reshape(10, 6)
    before = utils.counts()
    t = pipeline.upload(x, 1, 4, "cpu")
    got = _delta(before)
    assert got["h2d_bytes"] == x[:, 1:4].nbytes and got["h2d_ns"] > 0
    before = utils.counts()
    replicated([torch.device("cpu")], torch.arange(5))
    got = _delta(before)
    assert got["h2d_bytes"] == 40 and got["h2d_ns"] > 0
    before = utils.counts()
    pipeline.fetch_rows({"a": t, "b": torch.arange(3)})
    got = _delta(before)
    assert got["d2h_bytes"] == t.nbytes + 24 and got["d2h_ns"] > 0
    assert "h2d_ns" not in got


def test_run_fused_counts_the_walls_of_its_copies():
    rng = np.random.default_rng(4)
    day = np.arange(2 * 365)
    ts = (15 + 3 * np.sin(2 * np.pi * day / 365.25)[:, None]
          + rng.normal(0, 1, (len(day), 6))).astype(np.float32)
    before = utils.counts()
    pipeline.run_fused(ts, day % 365 + 1, day % 365, device="cpu")
    got = _delta(before)
    for name in ("h2d_bytes", "d2h_bytes", "h2d_ns", "d2h_ns"):
        assert got[name] > 0, name
