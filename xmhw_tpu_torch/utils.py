"""Observability: timing, torch profiler traces, and the package logger.

Port of :mod:`xmhw_tpu.utils`:

* :func:`timed` — wall-clock timing context that synchronises the CUDA
  devices of the tensors it is handed before it stops the clock (CUDA
  launches return before the work is done);
* :func:`trace` — context manager around ``torch.profiler`` writing a
  Chrome trace (chrome://tracing, Perfetto) of the host and device ops;
* module logger — replaces the reference's bare prints
  (reference: identify.py:130, stats.py:154-158).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

logger = logging.getLogger("xmhw_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(name)s %(levelname)s: %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.WARNING)


def _sync(obj):
    """Synchronise every CUDA device that holds a tensor in ``obj`` (a
    tensor, or a dict/list/tuple nesting tensors); CPU tensors and other
    objects need nothing."""
    import torch

    devs = set()
    stack = [obj]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devs.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    for d in devs:
        torch.cuda.synchronize(d)


@contextlib.contextmanager
def timed(label: str, sync=None, log=True):
    """Time a block; the CUDA devices of the tensors in ``sync`` (or put
    in the holder as ``holder["sync"]``) are synchronised before the
    clock stops. Sets ``holder["seconds"]``.

    >>> with timed("detect") as t:
    ...     t["sync"] = run_something()
    """
    holder = {}
    t0 = time.perf_counter()
    try:
        yield holder
    finally:
        if sync is not None:
            _sync(sync)
        if "sync" in holder:
            _sync(holder["sync"])
        holder["seconds"] = time.perf_counter() - t0
        if log:
            logger.info("%s: %.3f s", label, holder["seconds"])


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA when a GPU
    is visible) and write its Chrome trace into ``logdir``; yields the
    profiler (``key_averages()`` gives the table)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"xmhw_trace_{os.getpid()}_{time.time_ns()}.json"))
