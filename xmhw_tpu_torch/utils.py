"""Observability: timing, torch profiler traces, spans, counters and the
package logger.

Port of :mod:`xmhw_tpu.utils`:

* :func:`timed` — wall-clock timing context that synchronises the CUDA
  devices of the tensors it is handed before it stops the clock (CUDA
  launches return before the work is done);
* :func:`trace` — context manager around ``torch.profiler`` writing a
  Chrome trace (chrome://tracing, Perfetto) of the host and device ops,
  with the package's own ``xmhw/`` spans among them;
* :func:`span` / :func:`in_span` — the package's named ranges at the
  boundaries of its layers (the public calls, the pipeline's
  uploads, fetches and range tables, the detection passes): profiler
  ranges while a torch profiler records, nothing otherwise;
* :func:`count` / :func:`counts` — in-process counters (bytes copied to
  and from the devices, detection passes and blocks);
* module logger — replaces the reference's bare prints
  (reference: identify.py:130, stats.py:154-158).
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import threading
import time

import torch
from torch.autograd import profiler as _profiler

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
def copy_wall(name: str, dev):
    """Add to the counter ``name`` the host wall, in nanoseconds, of the
    copy to or from ``dev`` inside. The work queued on ``dev``'s stream is
    waited for first, so the wall is the copy's alone."""
    dev = torch.device(dev)
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
    t0 = time.perf_counter_ns()
    yield
    count(name, time.perf_counter_ns() - t0)


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


SPAN_PREFIX = "xmhw/"
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """The range ``xmhw/<name>`` while a torch profiler records (it lands
    in the profiler's trace beside the kernels and copies it covers, on
    their clock); otherwise one shared do-nothing context.

    >>> with span("upload"):
    ...     x = host.to("cuda")
    """
    # torch.profiler.profile sets this plain module global while it
    # records; reading it costs tens of ns, where a record_function made
    # with no profiler running still costs ~10 us
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return _NO_SPAN


def in_span(name: str):
    """Decorator: every call of the function runs inside ``span(name)``;
    the function keeps its name, docstring and signature."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return inner
    return wrap


_counts: dict = {}
_counts_lock = threading.Lock()


def count(name: str, n=1):
    """Add ``n`` to the counter ``name``. Counters: ``h2d_bytes`` (bytes
    the pipeline stages onto its devices: ``pipeline.upload`` and
    ``parallel.mesh.replicated``), ``d2h_bytes`` (bytes
    ``pipeline.fetch_rows`` brings back), ``h2d_ns`` and ``d2h_ns`` (the
    host wall of those same copies alone, in nanoseconds: ``copy_wall``),
    ``group_barriers`` and ``group_wait_ns`` (``parallel.barrier()``'s
    calls and the nanoseconds this process waited in them;
    ``parallel.gathered_counts()`` brings every rank's counters to rank
    0), ``detect_passes`` (counting
    passes and detection runs, one per shard, reruns included),
    ``detect_blocks`` (shard-blocks detected by ``run_detect`` and
    ``run_fused``), ``union_calls`` (``detect()``'s union-layout
    assemblies), ``union_rows`` (the events rows of those assemblies,
    summed), ``union_card_calls`` (those whose grids were built on the
    card), ``union_card_bytes`` (the bytes of those grids copied down
    into page-locked host memory; not in ``d2h_bytes``) and
    ``union_pinned_bytes`` (the page-locked bytes those grids ask of the
    caching host allocator, each grid rounded up to a power of two),
    ``land_calls`` (``api.land_check``'s land checks of a grid),
    ``land_pinned_calls`` (those that wrote the kept cells into
    page-locked host memory), ``stats_calls`` (the stats layer's binned
    calls, ``ops.block_stats.event_bins`` and ``day_bins``),
    ``stats_kernel_calls`` (those that launched a kernel),
    ``inter_calls`` (``pipeline.run_detect`` calls with
    ``intermediate=True``), ``inter_bytes`` (the bytes of the
    intermediate arrays they fetch from the devices; also in
    ``d2h_bytes``), ``inter_grid_bytes`` (the bytes of the grids
    ``api._assemble_inter`` builds of them), ``rank_calls``
    (``stats_api.mhw_rank`` calls on a device) and ``rank_pinned_calls``
    (those whose ranks and return periods landed in page-locked host
    memory)."""
    with _counts_lock:
        _counts[name] = _counts.get(name, 0) + n


def counts() -> dict:
    """A copy of every counter since the process started; the difference
    of two copies counts what ran between them."""
    with _counts_lock:
        return dict(_counts)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA when the
    build and a GPU allow) and write its Chrome trace into ``logdir``; the
    trace holds the package's ``xmhw/`` spans (:func:`span`) with the
    host and device operations under them. Every visible CUDA device is
    synchronised before the profiler stops, so the block's device work is
    in the trace. Yields the profiler (``key_averages()`` gives the
    table)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if (torch.cuda.is_available() and ProfilerActivity.CUDA
            in torch.profiler.supported_activities()):
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)
    prof.export_chrome_trace(os.path.join(
        logdir, f"xmhw_trace_{os.getpid()}_{time.time_ns()}.json"))
