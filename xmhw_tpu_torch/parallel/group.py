"""One process a card: each rank's band of the grid, the group's barrier,
and every rank's counters in one place.

The streamed job runs on a host with several cards as one process a card
(``torchrun``): each rank takes its latitude band of grid rows
(:func:`band_rows`), runs ``stream_run(..., grid_rows=band)`` on its own
card (``parallel.mesh.process_device()``), waits at :func:`barrier` until
every band file is written, and rank 0 merges the band files
(``merge_grid_band_files``). The group only synchronises the ranks, so
``gloo`` serves whatever the device. :func:`gathered_counts` brings each
rank's counters (``utils.counts()``, one set a process) to rank 0.
"""

from __future__ import annotations

import time

import torch

from ..utils import count, counts, span
from .mesh import in_process_group


def band_rows(n_rows: int, world: int, stripe: int) -> list:
    """``world`` contiguous ``(lo, hi)`` bands that cover rows
    ``[0, n_rows)``: every inner edge on a multiple of ``stripe`` (so each
    stripe holds the same cells as in one process's run, and the merged
    outputs are bit-equal to it), sizes within one stripe of each other.
    The last band takes the partial stripe, and so a stripe more where the
    stripes do not divide evenly. Raises ValueError where ``n_rows <
    world * stripe``, which would leave a band without a whole stripe.

    >>> band_rows(720, 4, 3)
    [(0, 180), (180, 360), (360, 540), (540, 720)]
    """
    if world < 1 or stripe < 1:
        raise ValueError(f"band_rows needs world >= 1 and stripe >= 1, got "
                         f"world={world}, stripe={stripe}")
    if n_rows < world * stripe:
        raise ValueError(f"{n_rows} rows cannot give {world} bands a stripe "
                         f"of {stripe} rows each")
    q, extra = divmod(-(-n_rows // stripe), world)
    edges = [0]
    for r in range(world):
        edges.append(edges[-1] + (q + (r >= world - extra)) * stripe)
    edges[-1] = n_rows
    return list(zip(edges[:-1], edges[1:]))


def barrier() -> None:
    """The default group's barrier, inside the span ``group_barrier``.
    Counts ``group_barriers`` (calls) and ``group_wait_ns`` (nanoseconds
    this process spent inside it). Outside a group it returns at once and
    counts nothing."""
    if not in_process_group():
        return
    with span("group_barrier"):
        t0 = time.perf_counter_ns()
        torch.distributed.barrier()
        count("group_wait_ns", time.perf_counter_ns() - t0)
    count("group_barriers")


def gathered_counts():
    """Every rank's ``utils.counts()``, in rank order, on rank 0; None on
    the other ranks. A collective: every rank calls it (with ``nccl``,
    after ``torch.cuda.set_device``). Outside a group, ``[counts()]``."""
    if not in_process_group():
        return [counts()]
    dist = torch.distributed
    out = [None] * dist.get_world_size() if dist.get_rank() == 0 else None
    dist.gather_object(counts(), out, dst=0)
    return out
