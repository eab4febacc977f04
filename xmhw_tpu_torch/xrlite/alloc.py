"""Large-array allocation for the host assembly paths.

The union event grids and unstacked climatologies allocate gigabytes per
detect() call. This host (a Firecracker microVM, 1 vCPU) supplies fresh
anonymous pages at only ~100-500 MB/s — every first touch exits to the
VMM — so allocation strategy dominates the host half of the pipeline.
Measured here (4.5 GB in 31 buffers):

* plain ``np.full``, fresh pages:             ~38 s
* ``madvise(MADV_POPULATE_WRITE)`` prefault:  slower still (~170 MB/s)
* ``MADV_HUGEPAGE`` before first touch:       ~18 s (512x fewer faults)
* re-filling already-resident pages:          ~1.5-2 s

So large buffers come from a process-level POOL of huge-page-advised
anonymous mmaps: when the numpy array dies, its backing region returns
to the pool (weakref finalizer) and the next allocation of similar size
reuses the still-resident pages — repeat pipeline calls run at memset
speed instead of VMM page-supply speed. Glibc's heap cannot be relied
on for this (mallopt retention benchmarked inconsistent here), and an
earlier round's ``MADV_POPULATE_WRITE`` prefault is 3x slower than
first-touch on this host despite being 25x faster on the previous
multi-core host — this module is the single place to re-measure.
"""

from __future__ import annotations

import ctypes
import mmap as _mmap
import threading
import weakref

import numpy as np

import os

# plain numpy below this size — pooling isn't worth it
_SMALL = 1 << 22
# drop regions beyond this much cached memory (resident pages);
# overridable for small-RAM hosts (the streaming working set is ~3
# stripes, so the default leaves generous headroom for size drift)
_POOL_CAP = int(float(os.environ.get("XMHW_POOL_CAP_GB", "12"))
                * (1 << 30))
# reuse a cached region only if it wastes < 2x the request
_WASTE = 2

_MADV_HUGEPAGE = 14

try:
    _libc = ctypes.CDLL("libc.so.6", use_errno=True)
    _libc.madvise.restype = ctypes.c_int
    _libc.madvise.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                              ctypes.c_int]
except OSError:  # non-glibc platform
    _libc = None

_pool: list[tuple[int, _mmap.mmap]] = []  # (size, region) free list
_pool_bytes = 0
# finalizers fire during GC on ANY thread; h5py / user threads also
# allocate — all free-list mutation goes through this lock (cheap next
# to the mmap/madvise syscalls it guards)
_pool_lock = threading.Lock()


def _advise_hugepage(buf: _mmap.mmap, nbytes: int) -> None:
    if _libc is None:
        return
    addr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
    _libc.madvise(ctypes.c_void_p(addr), ctypes.c_size_t(nbytes),
                  _MADV_HUGEPAGE)


def _take_region(nbytes: int) -> tuple[int, _mmap.mmap]:
    """Smallest cached region that fits without gross waste, or a new
    huge-page-advised anonymous mapping."""
    global _pool_bytes
    with _pool_lock:
        best = -1
        for i, (sz, _) in enumerate(_pool):
            if nbytes <= sz <= nbytes * _WASTE and (
                    best < 0 or sz < _pool[best][0]):
                best = i
        if best >= 0:
            ent = _pool.pop(best)
            _pool_bytes -= ent[0]
            return ent
    buf = _mmap.mmap(-1, nbytes)
    _advise_hugepage(buf, nbytes)
    return nbytes, buf


def _release_region(size: int, buf: _mmap.mmap) -> None:
    global _pool_bytes
    stale = []
    with _pool_lock:
        _pool.append((size, buf))
        _pool_bytes += size
        while _pool_bytes > _POOL_CAP and _pool:
            sz, old = _pool.pop(0)
            _pool_bytes -= sz
            stale.append(old)
    for old in stale:  # close() outside the lock (munmap syscall)
        old.close()


def pool_stats() -> dict:
    """Cached-region accounting (observability/tests)."""
    with _pool_lock:
        return {"regions": len(_pool), "bytes": _pool_bytes}


_malloc_tuned = False


def tune_malloc() -> None:
    """Keep LARGE glibc allocations in the (warm) main arena.

    The pool above covers this package's own buffers, but numpy/h5py
    internal temporaries (hyperslab reads, np.pad, argsort scratch,
    device fetches) still go through malloc, which mmaps anything big
    and unmaps it on free — every use pays the ~0.15 GB/s fresh-page
    fault cost again. Raising M_MMAP_THRESHOLD/M_TRIM_THRESHOLD keeps
    those in the brk arena, where the regular per-stripe allocation
    pattern of the streaming pipelines re-touches resident pages
    (measured here: a 1 GB read-compact-pad stripe pattern repeats at
    0.56 s vs 9.9 s). An earlier round benchmarked bare mallopt as
    inconsistent for the ASSEMBLY buffers (many coexisting sizes —
    hence the mmap pool); for the streaming temporaries the sizes are
    few and cyclic, which is the pattern the arena retains well.
    Called from the streaming entry points; idempotent; no-op without
    glibc."""
    global _malloc_tuned
    if _malloc_tuned or _libc is None:
        return
    _malloc_tuned = True
    try:
        _libc.mallopt(ctypes.c_int(-3), ctypes.c_int(1 << 30))  # M_MMAP_THRESHOLD
        _libc.mallopt(ctypes.c_int(-1), ctypes.c_int(1 << 30))  # M_TRIM_THRESHOLD
    except Exception:
        pass


class _MallInfo2(ctypes.Structure):
    """glibc ``mallinfo2`` (>= 2.33): all fields size_t."""

    _fields_ = [(n, ctypes.c_size_t) for n in (
        "arena", "ordblks", "smblks", "hblks", "hblkhd", "usmblks",
        "fsmblks", "uordblks", "fordblks", "keepcost")]


_trim_tick = 0
_have_mallinfo2 = False
if _libc is not None:
    try:
        _libc.mallinfo2.restype = _MallInfo2
        _libc.mallinfo2()
        _have_mallinfo2 = True
    except (AttributeError, OSError):
        pass


def arena_free_bytes() -> int:
    """Free (retained, reusable) bytes in the glibc malloc arena, or -1
    when mallinfo2 is unavailable.

    Main arena only: glibc's mallinfo2 does not count secondary
    per-thread arenas, so temporaries allocated on e.g. the
    write-behind thread can bloat without moving this number (the
    ``malloc_trim`` that ``maybe_trim_arena`` issues DOES cover all
    arenas). ``tune_malloc``'s 1 GB M_MMAP_THRESHOLD keeps the large
    streaming temporaries in heap arenas wherever they run, so the
    main-arena reading is a lower bound on total retained bloat."""
    if not _have_mallinfo2:
        return -1
    return int(_libc.mallinfo2().fordblks)


def maybe_trim_arena(min_free: int = 2 << 30) -> bool:
    """Release retained glibc-arena pages when bloat exceeds ``min_free``.

    ``tune_malloc`` deliberately stops glibc from ever returning freed
    pages (refaulting fresh pages costs ~0.15 GB/s on this class of
    host), which is right for the cyclic per-stripe allocation pattern —
    but allocation sizes that VARY across stripes (device-fetch buffers
    scale with each stripe's event count, h5py scratch with its chunk
    overlap) fragment the arena, and over a few hundred stripes the
    retained free space grows unboundedly (measured ~50 GB peak RSS on
    the 68 GB full-scale run against a ~3 GB working set).

    ``malloc_trim(0)`` walks the free bins and ``MADV_DONTNEED``s whole
    free pages — the POOL's mmap regions and all live allocations are
    untouched, so the warm working set survives; only the fragmented
    excess is dropped. Callers invoke this at stripe boundaries from the
    write-behind slot, where the (small) refault cost of re-touching
    the trimmed churn overlaps the next stripe's device step. The
    ``min_free`` guard keeps the steady small-run path trim-free;
    ``min_free=0`` means "trim unconditionally NOW" (used before
    resetting an RSS watermark between bench configs) and bypasses both
    the guard and the no-mallinfo2 tick cadence below.
    Returns True when a trim was issued."""
    global _trim_tick
    if _libc is None:
        return False
    forced = min_free <= 0
    free = arena_free_bytes()
    if not forced and free >= 0 and free < min_free:
        return False
    _trim_tick += 1
    if not forced and free < 0 and _trim_tick % 8:
        return False  # no mallinfo2: trim at a coarse cadence
        #               instead of blindly on every stripe
    try:
        _libc.malloc_trim(ctypes.c_size_t(0))
        return True
    except Exception:
        return False


def alloc_empty(shape, dtype) -> np.ndarray:
    """Uninitialized array backed by the warm-page pool when large."""
    dtype = np.dtype(dtype)
    nbytes = int(np.prod(shape)) * dtype.itemsize
    if nbytes < _SMALL:
        return np.empty(shape, dtype)
    size, buf = _take_region(nbytes)
    arr = np.frombuffer(buf, dtype=np.uint8, count=nbytes)
    out = arr.view(dtype).reshape(shape)
    # recycle the region (pages still resident) once the ROOT array is
    # collected — every numpy view holds a .base reference chain down to
    # `arr`, so the finalizer cannot fire while any view is alive
    weakref.finalize(arr, _release_region, size, buf)
    return out


def alloc_filled(shape, fill, dtype) -> np.ndarray:
    """``np.full`` replacement (see module docstring)."""
    out = alloc_empty(shape, dtype)
    out.fill(fill)
    return out
