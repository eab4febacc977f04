"""Entry: the 0.25 degree job's stripe step on every card of one host, one
process a card, a closed loop of one caller.

The harness's process is rank 0 and drives card 0. It starts ranks 1 to
``ranks - 1`` as child processes of this file with the environment
``torchrun`` gives its workers (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``); every rank joins a ``gloo`` group,
which only synchronises them, and runs on
``parallel.mesh.process_device()``. Rank 0 builds the CUDA kernel library
before a barrier, and the others load what it built. The configuration
gives each rank's band of the grid (``parallel.band_rows``); a rank's
stripes stand for its band.

Each rank holds ``stripes`` host stripes of ``cells_per_stripe`` cells,
rank r's stripe k made from ``inputs.stream_seed(seed, stripes * r +
k)``, so no two ranks hold the same data, and runs ``run_fused.py``'s
step on them (the whole record's climatology, detection, 40 one-year
bins, no device ranks, ``k_min`` the configuration's K, ``tune_malloc()``
in set-up). A step: rank 0 broadcasts its index, every rank runs stripe
i mod ``stripes``, and the step ends at ``parallel.barrier()``, which
every rank joins. A window step that raises on a rank fails there (the
rank still joins the barrier), and ``failed()`` counts the steps that
failed on any rank; a warm-up step that raises ends the run. The
window's steps count their walls, from the broadcast to the barrier's
end, as ``group_step_ns``; the warm-up's end at a plain barrier and
count nothing, so ``group_wait_ns`` and ``group_step_ns`` cover the
same steps.

With each command rank 0 passes on the harness's choice to keep the last
step for the judge. At ``cases()`` rank 0 draws the columns of every
rank's kept steps, each rank sends its cases and then its counters
(``parallel.gathered_counts()``), and the entry keeps the counters on the
run as ``run.rank_counts`` for the readers.

A child exits within a second of rank 0's death (it watches its
parent's pid), and a collective left waiting raises after ``TIMEOUT_S``.
Rank 0 fails at once when a child has exited, and kills the others;
``free()`` stops the ranks and kills any still alive after
``DEADLINE_S``.

    python3 benchmark/run.py --workload oisst_mp4 --seed <n> --seconds 20
"""

from __future__ import annotations

import atexit
import contextlib
import datetime
import json
import os
import socket
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np

if __name__ == "__main__":  # a child: the checkout's root, not this folder
    sys.path[0] = str(Path(__file__).resolve().parents[2])

from benchmark.entries import run_fused  # noqa: E402
from benchmark.lib import inputs  # noqa: E402
from benchmark.reference.judge import table_cases  # noqa: E402

TIMEOUT_S = 60   # a collective waits this long for the other ranks
DEADLINE_S = 30  # free() waits this long for the ranks to exit
STOP, WARM, STEP, FAILED, CASES = range(5)  # rank 0's commands


def spans():
    from xmhw_tpu_torch.parallel import group

    return dict(run_fused.spans(), group_barrier=(group, "barrier"))


class Part(run_fused.Entry):
    """One rank's stripes and steps: ``run_fused.Entry``'s set-up, step
    and kept outputs, on rank ``rank``'s stripes."""

    def __init__(self, cfg, tr, seed, rank, dev):
        import torch

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        # the time axis, the bins and the step's arguments, no stripes yet
        super().__init__(SimpleNamespace(
            cfg=cfg, traffic=dict(tr, stripes=0), seed=seed, devices=[dev],
            sync=sync))
        n = tr["stripes"]
        self.rank = rank
        self.stripes = [inputs.smoothed_seasonal(
            len(self.dates), self.cells_per_step,
            inputs.stream_seed(seed, n * rank + k), dev).cpu().numpy()
            for k in range(n)]
        self.failed_steps = set()

    def attempt(self, i):
        """Step ``i``; one that raises fails, its traceback on standard
        error, and leaves nothing to keep."""
        try:
            self.step(i)
        except Exception:  # the rank goes on to the step's barrier
            traceback.print_exc()
            self.failed_steps.add(i)
            self.last = None

    def keep_last(self, drop):
        if self.last is None:
            self.kept.pop(drop, None)
        else:
            super().keep_last(drop)

    def cases_of(self, cols):
        """Cases of the columns ``cols[i]`` of each step ``i`` this rank
        kept, and of its last."""
        kept = dict(self.kept)
        if self.last is not None:
            kept[self.last[0]] = self.last
        out = []
        for i in sorted(set(cols) & set(kept)):
            _, k, th, se, tables, nev, extras = kept[i]
            out += table_cases(self.stripes[k], th, se, tables, nev,
                               cols[i], f"rank {self.rank} step {i} "
                               f"(stripe {k})", block=extras["block"],
                               day=extras["day"])
        return out


def _set_up(cfg, tr, seed, rank):
    """This rank's part, on its card, once rank 0 has built the kernel
    library."""
    import torch
    import torch.distributed as dist
    from xmhw_tpu_torch.parallel.mesh import process_device

    dev = process_device()
    if dev.type == "cuda":
        from xmhw_tpu_torch.ops import _build

        torch.cuda.set_device(dev)
        if rank == 0:
            _build.library()
    dist.barrier()
    return Part(cfg, tr, seed, rank, dev)


def _timed_step(part, i):
    """Step ``i`` on this rank, ended at the group's barrier; its wall in
    ``group_step_ns``."""
    from xmhw_tpu_torch.parallel import group
    from xmhw_tpu_torch.utils import count

    t0 = time.perf_counter_ns()
    part.attempt(i)
    group.barrier()
    count("group_step_ns", time.perf_counter_ns() - t0)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Entry:
    def __init__(self, run):
        # a checkout without the group's functions fails here, before any
        # rank starts
        from xmhw_tpu_torch.parallel import (  # noqa: F401
            barrier, gathered_counts)
        import torch.distributed as dist

        cfg, tr = run.cfg, run.traffic
        self.run, self.world = run, tr["ranks"]
        self.marks = [time.monotonic()]  # set-up's phases on rank 0
        self.cells_per_step = self.world * tr["cells_per_stripe"]
        self.pending = (-1, -1)  # (step kept, step it evicts) to pass on
        self.last_i = -1
        self.procs = []
        self.part = None
        atexit.register(self._kill)
        port = _free_port()
        spec = json.dumps({"cfg": cfg, "traffic": tr, "seed": run.seed,
                           "parent": os.getpid()})
        try:
            for r in range(1, self.world):
                env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                           WORLD_SIZE=str(self.world),
                           MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
                self.procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), spec],
                    env=env))
            dist.init_process_group(
                "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                world_size=self.world,
                timeout=datetime.timedelta(seconds=TIMEOUT_S))
            self.marks.append(time.monotonic())
            self.part = _set_up(cfg, tr, run.seed, 0)
            self.marks.append(time.monotonic())
        except BaseException:
            self._abort()
            raise

    @contextlib.contextmanager
    def _collective(self):
        """Fail at once where a rank has exited; on any failure inside,
        kill the ranks and leave the group."""
        try:
            for r, p in enumerate(self.procs, 1):
                if p.poll() is not None:
                    raise RuntimeError(f"rank {r} exited with code "
                                       f"{p.returncode}")
            yield
        except BaseException:
            self._abort()
            raise

    def _command(self, cmd, i=-1):
        import torch
        import torch.distributed as dist

        kept, drop = self.pending
        self.pending = (-1, -1)
        dist.broadcast(torch.tensor([cmd, i, kept, drop]), src=0)

    def warm(self):
        """Every stripe twice on every rank: the shapes of the window."""
        import torch.distributed as dist

        for i in range(2 * len(self.part.stripes)):
            with self._collective():
                self._command(WARM, i)
                self.part.step(i)
                dist.barrier()
        self.run.sync()
        t = self.marks + [time.monotonic()]
        print(f"benchmark: rank 0's set-up: every rank in the group "
              f"{t[1] - t[0]:.2f} s, the kernel library and the stripes "
              f"{t[2] - t[1]:.2f} s, the warm-up {t[3] - t[2]:.2f} s",
              file=sys.stderr)

    def step(self, i):
        with self._collective():
            self._command(STEP, i)
            _timed_step(self.part, i)
        self.last_i = i

    def keep_last(self, drop):
        self.part.keep_last(drop)
        self.pending = (self.last_i, -1 if drop is None else drop)

    def failed(self):
        import torch.distributed as dist

        got = [None] * self.world
        with self._collective():
            self._command(FAILED)
            dist.gather_object(self.part.failed_steps, got, dst=0)
        return len(set().union(*got))

    def cases(self, rng, cells):
        import torch.distributed as dist
        from xmhw_tpu_torch.parallel import gathered_counts

        steps = sorted(set(self.part.kept) | {self.last_i})
        n = self.run.traffic["cells_per_stripe"]
        cols = {r: {i: np.sort(rng.choice(n, cells, replace=False))
                    for i in steps} for r in range(self.world)}
        got = [None] * self.world
        with self._collective():
            self._command(CASES)
            dist.broadcast_object_list([cols], src=0)
            dist.gather_object(self.part.cases_of(cols[0]), got, dst=0)
            self.run.rank_counts = gathered_counts()
        return [c for part in got for c in part]

    def free(self):
        import torch.distributed as dist

        try:
            if dist.is_initialized():
                with self._collective():
                    self._command(STOP)
            deadline = time.monotonic() + DEADLINE_S
            for p in self.procs:
                with contextlib.suppress(subprocess.TimeoutExpired):
                    p.wait(timeout=max(0.0, deadline - time.monotonic()))
        finally:
            self._abort()
            self.part = None

    def _kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def _abort(self):
        import torch.distributed as dist

        self._kill()
        if dist.is_initialized():
            dist.destroy_process_group()


def _watch(parent):
    """Exit when the parent (rank 0) has gone."""
    while os.getppid() == parent:
        time.sleep(1)
    os._exit(3)


def child(spec):
    """Ranks 1 and up: rank 0's commands until it says stop."""
    import torch
    import torch.distributed as dist
    from xmhw_tpu_torch.parallel import gathered_counts

    os.dup2(2, 1)  # standard output is the harness's result line alone
    threading.Thread(target=_watch, args=(spec["parent"],),
                     daemon=True).start()
    dist.init_process_group("gloo", init_method="env://",
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        part = _set_up(spec["cfg"], spec["traffic"], spec["seed"],
                       dist.get_rank())
        while True:
            t = torch.zeros(4, dtype=torch.int64)
            dist.broadcast(t, src=0)
            cmd, i, kept, drop = t.tolist()
            if kept >= 0:
                part.keep_last(None if drop < 0 else drop)
            if cmd == WARM:
                part.step(i)
                dist.barrier()
            elif cmd == STEP:
                _timed_step(part, i)
            elif cmd == FAILED:
                dist.gather_object(part.failed_steps, None, dst=0)
            elif cmd == CASES:
                cols = [None]
                dist.broadcast_object_list(cols, src=0)
                dist.gather_object(part.cases_of(cols[0][part.rank]), None,
                                   dst=0)
                gathered_counts()
            else:
                return
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    child(json.loads(sys.argv[1]))
