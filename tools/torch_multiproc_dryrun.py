#!/usr/bin/env python3
"""Multi-process dryrun of xmhw_tpu_torch's cell mesh over torch.distributed.

The counterpart of tools/multihost_dryrun.py (jax.distributed): N
processes join one torch.distributed group and build the GLOBAL cell mesh
(``parallel.mesh.cell_mesh(local_devices=...)``). Each rank feeds only
its own shards of a deterministic field (``make_cell_array``, the path a
multi-process deployment uses to read only its own cells), runs the
device-resident step ``core.pipeline.fused_threshold_detect`` on each of
them, and checks every output shard bit for bit against its own unsharded
run of the whole field: thresholds, means, raw event counts and every
event-table variable (NaN-aware). It also holds each shard's outputs
against the plain version of the step (``use_kernels=False``) at the
bars of ``BARS``: on a GPU that compares the CUDA kernels with plain
PyTorch on this path's own shards. The ranks then ``all_reduce`` their
event totals, which must equal the unsharded total.

    python tools/torch_multiproc_dryrun.py            # CPU: 2 gloo ranks
    python tools/torch_multiproc_dryrun.py --device cuda --years 40 \\
        --cells 4096 --K 128                          # the card's size
    python tools/torch_multiproc_dryrun.py [flags] RANK PORT   # one rank

CPU defaults: 2 years, 32 cells, K = 8, 2 mesh entries per rank (the JAX
tool gives each process 4 of 8 devices). On CUDA each rank holds one
entry. Backend: ``gloo`` on the CPU and where the ranks share a GPU (NCCL
refuses two ranks on one device), ``nccl`` where every rank has its own
GPU; a failed init raises, with no second try. Rank 0 builds the CUDA
kernels before a barrier, so the other ranks load its library.

Each rank prints ``rank r: OK ...`` and one ``procs {json}`` line (its
backend, devices, the ranges it fed, its kernel launches in the timed
step, the largest differences from the plain version, the walls of its
step and of the one-process step, the event totals); the launcher prints
PASS or FAIL. Every rank has a deadline
(``--timeout``): when one fails or the deadline passes, the launcher kills
the others and fails.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
START_YEAR = 1983  # 40 years from here hold 10 leap days: T = 14,610
SEED = 0
# the kernels against the plain version: |diff| of thresholds and means;
# |diff| / (1 + |plain|) of the event floats (rtol = atol = 2e-3);
# counts, positions and NaN patterns exact
BARS = {"thresh": 1e-6, "seas": 1e-5, "events": 2e-3}
EXACT = ("event", "index_", "time_", "duration", "category")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--years", type=int, default=2)
    p.add_argument("--cells", type=int, default=32)
    p.add_argument("--K", type=int, default=8)
    p.add_argument("--timeout", type=float, default=300.0,
                   help="seconds each rank may take")
    p.add_argument("rank", type=int, nargs="?")
    p.add_argument("port", type=int, nargs="?")
    return p.parse_args(argv)


def field(T, C, seed):
    """(T, C) float32: seasonal cycle plus 15-day-smoothed noise, made
    from ``seed``, so that every rank can make any shard of it."""
    rng = np.random.default_rng(seed)
    day = np.arange(T, dtype=np.float64)[:, None]
    noise = rng.normal(0.0, 1.0, (T + 14, C))
    cs = np.concatenate([np.zeros((1, C)), np.cumsum(noise, axis=0)])
    sm = (cs[15:15 + T] - cs[:T]) / 15.0
    return (15 + 3 * np.sin(2 * np.pi * day / 365.25)
            + 2.5 * sm).astype(np.float32)


def backend_and_device(device, ranks, rank):
    """The group's backend and this rank's device."""
    import torch

    if device == "cpu":
        return "gloo", torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is "
                           "False")
    n = torch.cuda.device_count()
    if n >= ranks:
        return "nccl", torch.device("cuda", rank)
    return "gloo", torch.device("cuda", rank % n)


def say(line):
    """Print ``line`` in one write, so that the lines of ranks sharing a
    pipe do not interleave (``print`` writes its text and its newline
    apart when the stream is unbuffered)."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def differing(a, b):
    """How many entries of two tensors of one shape and dtype differ bit
    for bit (NaN equals NaN; -0.0 differs from +0.0)."""
    import torch

    if not a.is_floating_point():
        return int((a != b).sum())
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    both_nan = torch.isnan(a) & torch.isnan(b)
    return int(((a.view(ints[a.dtype]) != b.view(ints[b.dtype]))
                & ~both_nan).sum())


def same_bits(a, b):
    """Two tensors equal bit for bit (:func:`differing`)."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and differing(a, b) == 0)


def np_same_bits(a, b):
    """Two numpy arrays equal bit for bit (NaN and NaT where the other has
    them; -0.0 apart from +0.0)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.kind == "f":
        a, b = (np.where(np.isnan(v), v.dtype.type(np.nan), v)
                .view(f"i{v.itemsize}") for v in (a, b))
    elif a.dtype.kind == "M":
        a, b = a.view("i8"), b.view("i8")
    return np.array_equal(a, b)


def against_plain(out, plain):
    """One shard's ``fused_threshold_detect`` outputs against the plain
    version's: the largest difference of each kind in ``BARS``, and
    ``exact_differ``, the count of entries that differ among the event
    counts, the counts and positions of the table and the NaN patterns."""
    import torch

    (th, se, tab, n), (thp, sep, tabp, n_p) = out, plain
    if sorted(tab) != sorted(tabp):
        raise AssertionError(f"table variables {sorted(tab)} != plain "
                             f"{sorted(tabp)}")
    worst = dict.fromkeys(BARS, 0.0)
    differ = int((n != n_p).sum())
    pairs = [("thresh", th, thp), ("seas", se, sep)]
    pairs += [("events", tab[k], v) for k, v in tabp.items()
              if not k.startswith(EXACT)]
    for what, a, b in pairs:
        a, b = a.double(), b.double()
        fa, fb = torch.isfinite(a), torch.isfinite(b)
        differ += int((fa != fb).sum())
        both = fa & fb
        d = (a - b).abs()[both]
        if what == "events":
            d = d / (1.0 + b.abs()[both])
        if d.numel():
            worst[what] = max(worst[what], float(d.max()))
    for k, v in tabp.items():
        if k.startswith(EXACT):
            differ += int((torch.nan_to_num(tab[k].double(), nan=-9.0)
                           != torch.nan_to_num(v.double(), nan=-9.0)).sum())
    return dict(worst, exact_differ=differ)


def within_bars(errs):
    """True when ``against_plain``'s differences are inside ``BARS``."""
    return errs["exact_differ"] == 0 and all(errs[k] <= BARS[k]
                                             for k in BARS)


def read_launches():
    from xmhw_tpu_torch.ops import detect_scan, doy_quantile, rle

    return {"doy_quantile": doy_quantile.doy_quantile.launches,
            "rle": rle.mhw_filter.launches,
            "rle_days": rle.mhw_filter.by_mode["days"],
            "detect_scan": detect_scan.event_stats.launches}


def reset_launches():
    from xmhw_tpu_torch.ops import detect_scan, doy_quantile, rle

    doy_quantile.doy_quantile.launches = 0
    detect_scan.event_stats.launches = 0
    rle.reset_launches()


def child(args):
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from xmhw_tpu_torch.core.calendar import compute_doy
    from xmhw_tpu_torch.core.pipeline import fused_threshold_detect
    from xmhw_tpu_torch.ops import _build
    from xmhw_tpu_torch.parallel import cell_mesh, make_cell_array
    from xmhw_tpu_torch.xrlite import TimeIndex

    torch.set_num_threads(2)
    rank = args.rank
    backend, dev = backend_and_device(args.device, args.ranks, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{args.port}",
        world_size=args.ranks, rank=rank,
        timeout=datetime.timedelta(seconds=args.timeout))
    try:
        if dev.type == "cuda":
            if rank == 0:
                _build.library()  # the others load what it built
            dist.barrier()
            _build.library()

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        mesh = cell_mesh(local_devices=[dev] * (2 if dev.type == "cpu"
                                                else 1))
        t = np.arange(f"{START_YEAR}-01-01",
                      f"{START_YEAR + args.years}-01-01",
                      dtype="datetime64[D]").astype("datetime64[ns]")
        doy, ndoy = compute_doy(TimeIndex(t))
        pos = (doy - 1).astype(np.int32)
        C = args.cells
        full = field(len(t), C, SEED)

        # this rank's entries, from the mesh's owners alone
        step = -(-C // len(mesh))
        mine = [(i * step, min((i + 1) * step, C))
                for i, r in enumerate(mesh.ranks)
                if r == rank and i * step < C]
        fed = []

        def fill(idx):
            fed.append((idx[-1].start, idx[-1].stop))
            return full[idx]

        shards = make_cell_array(mesh, full.shape, fill)
        if not fed == shards.ranges == mine:
            raise AssertionError(f"rank {rank} fed {fed}, got shards "
                                 f"{shards.ranges}, owns {mine}")

        def run(xs, **kw):
            out = [fused_threshold_detect(x, doy, pos, K=args.K, ndoy=ndoy,
                                          **kw) for x in xs]
            sync()
            return out

        run(shards)  # warm-up: tables, allocations, kernel loads
        reset_launches()
        t0 = time.perf_counter()
        outs = run(shards)
        wall = time.perf_counter() - t0
        launches = read_launches()
        n = len(shards) if dev.type == "cuda" else 0
        if launches != {"doy_quantile": n, "rle": n, "rle_days": n,
                        "detect_scan": n}:
            raise AssertionError(f"rank {rank} launches {launches}: want "
                                 f"{n} of each, one per shard")

        # the kernels against the plain version on this rank's shards
        errs = [against_plain(o, p) for o, p in
                zip(outs, run(shards, use_kernels=False))]
        plain = {k: max([e[k] for e in errs], default=0)
                 for k in (*BARS, "exact_differ")}
        if not within_bars(plain):
            raise AssertionError(f"rank {rank}: kernels against the plain "
                                 f"version {plain}, bars {BARS}")

        # the unsharded step over the whole field, on this rank's device
        whole = [torch.from_numpy(full).to(dev)]
        run(whole)
        t0 = time.perf_counter()
        ref_th, ref_se, ref_tab, ref_n = run(whole)[0]
        ref_wall = time.perf_counter() - t0
        for (a, b), (th, se, tab, nev) in zip(shards.ranges, outs):
            pairs = [("th", th, ref_th), ("se", se, ref_se),
                     ("n_events", nev, ref_n)]
            pairs += [(k, v, ref_tab[k]) for k, v in tab.items()]
            for name, got, want in pairs:
                if not same_bits(got, want[..., a:b]):
                    raise AssertionError(f"rank {rank} shard [{a}, {b}) "
                                         f"{name}: not bit-equal")
        local = sum(int(nev.sum()) for _, _, _, nev in outs)
        red = torch.tensor([local], dtype=torch.int64,
                           device=dev if backend == "nccl" else "cpu")
        dist.all_reduce(red)
        total, want = int(red.item()), int(ref_n.sum())
        if total != want:
            raise AssertionError(f"rank {rank}: {total} events across the "
                                 f"mesh, {want} in the unsharded run")
        say(f"rank {rank}: OK — backend {backend}, mesh "
              f"{[str(d) for d in mesh]} of ranks {list(mesh.ranks)}, fed "
              f"{len(fed)} shards {fed}; th, se, n_events and "
              f"{len(ref_tab)} table variables bit-equal to the unsharded "
              f"run; {total} events across the global mesh ({local} here, "
              f"at most {int(ref_n.max())} in a cell, K = {args.K}); "
              f"against the plain version {plain} (bars {BARS}); "
              f"launches {launches}; step {wall:.4f} s, one-process step "
              f"{ref_wall:.4f} s")
        say("procs " + json.dumps({
            "rank": rank, "backend": backend, "device": str(dev),
            "mesh": [str(d) for d in mesh], "ranks": list(mesh.ranks),
            "fed": fed, "launches": launches, "plain": plain,
            "step_s": wall,
            "one_process_step_s": ref_wall, "events": total,
            "T": len(t), "cells": C, "K": args.K}))
    finally:
        dist.destroy_process_group()


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_all(procs, timeout):
    """0 when every process exits 0 within ``timeout`` s; else kill the
    rest and return the first failure's code (124 at the deadline)."""
    deadline = time.monotonic() + timeout
    while True:
        codes = [p.poll() for p in procs]
        bad = [c for c in codes if c not in (None, 0)]
        late = time.monotonic() > deadline
        if bad or late:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            return bad[0] if bad else 124
        if all(c == 0 for c in codes):
            return 0
        time.sleep(0.1)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    if args.rank is not None:
        if args.port is None:
            raise SystemExit("one rank needs RANK and PORT")
        child(args)
        return 0
    port = free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               *argv, str(r), str(port)])
             for r in range(args.ranks)]
    rc = wait_all(procs, args.timeout)
    print("torch multiproc dryrun:", "PASS" if rc == 0 else "FAIL",
          flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
