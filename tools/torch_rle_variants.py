#!/usr/bin/env python3
"""Time variants of the port's event-RLE kernel
(``xmhw_tpu_torch/csrc/rle.cu``) against each other on one GPU.

    python3 tools/torch_rle_variants.py [label=path/to/source.cu ...]

Builds with nvcc, each into a library of its own: the kernel as it is in
the checkout ("kernel"); a cut-down copy that shows where its time goes
("load only" reads the mask into its bit words, writes each cell's count
of True days as n_events and stops: no run walks, no barriers, no
per-day output); the kernel with 32 warps a block instead of 16 ("32
warps"); and every source named on the command line (another design, or
an earlier commit's file from ``git show``). Prints each output mode's
registers and spills (``nvcc -Xptxas -v``), then times every variant in
the three output modes of the main path's shapes (the counting launch,
the detect launch, and slots, today's full=False) with CUDA events on
chip_smoke.py's 40-year, 4,096-cell exceedance mask and two rolled copies
of it in turn (180 MB, past the 50 MB L2), in turns (forward, then
backward): the median of 6 CUDA-event medians of 5. Every variant but the
cut-down one must equal the plain version bit for bit. Needs a GPU;
imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import ctypes
import itertools
import re
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
KERNEL = ROOT / "xmhw_tpu_torch" / "csrc" / "rle.cu"
WALK = "    int lead = 0, trail = 0, first = p.T, last = -1;\n"
WARPS16 = ("constexpr int kWarps = 32;", "constexpr int kWarps = 16;")


def rows(n):  # n rows (n / 32 bit words) in flight a lane
    return ("constexpr int kLoadWords = 1;",
            f"constexpr int kLoadWords = {n // 32};")


VARIANTS = {  # label: [(text of the kernel, its replacement), ...]
    "load only": [(WALK, "    if (p.max_gap > -2147483647) {\n"
                   "        int z = 0;\n"
                   "        for (int k = 0; k < nw; ++k) "
                   "z += __popc(bits[k]);\n"
                   "        if (live) p.nev[c] = z;\n"
                   "        return;\n    }\n" + WALK)],
    "16 warps": [WARPS16],
    "64 rows": [rows(64)],
    "128 rows": [rows(128)],
    "load only, 128 rows": [rows(128)],  # the first entry's text is added
}
VARIANTS["load only, 128 rows"] += VARIANTS["load only"]
CUT = ("load only", "load only, 128 rows")
MODES = ("count", "days", "slots")
INSTANCE = {"0": "count", "1": "days", "2": "slots", "3": "full"}


def build(label, src, out):
    """nvcc ``src`` into a library; returns (label, path, {mode:
    (registers, spill bytes)})."""
    from xmhw_tpu_torch.ops import _build

    so = out / f"{re.sub(r'[^a-z0-9]+', '_', label)}.so"
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas",
                        "-v", "-o", str(so), str(src)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"{label}: nvcc failed:\n{r.stderr[-3000:]}")
    figs, mode, spill = {}, None, 0
    for line in r.stderr.splitlines():
        m = re.search(r"Compiling entry function '\S*rle_kernelILi(\d)E",
                      line)
        if m:
            mode = INSTANCE[m.group(1)]
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and mode is not None:
            figs[mode] = (int(m.group(1)), spill)
            mode = None
    return label, so, figs


def exceedance_mask(card):
    """chip_smoke.py's main block: 40 daily years of 4,096 synthetic SST
    cells above the kernel-built 90th-percentile climatology."""
    import torch

    import chip_smoke as cs
    from xmhw_tpu_torch.core.calendar import build_window_ranges, compute_doy
    from xmhw_tpu_torch.core.clim import finish_clim
    from xmhw_tpu_torch.ops import doy_quantile as dq
    from xmhw_tpu_torch.xrlite import TimeIndex

    t = cs.daily(cs.T0, cs.T1)
    T = len(t)
    doy, ndoy = compute_doy(TimeIndex(t))
    starts, lens, ny, rmax = build_window_ranges(doy, 5, ndoy)
    x = torch.full((T + rmax, cs.CELLS), float("nan"), device="cuda")
    x[:T] = torch.from_numpy(cs.synth(T, cs.CELLS, seed=1)).cuda()
    th, _ = finish_clim(*dq.doy_quantile(
        x, torch.from_numpy(starts.reshape(-1)).cuda(),
        torch.from_numpy(lens.reshape(-1)).cuda(), ndoy, ny, rmax))
    pos = torch.from_numpy((doy - 1).astype(np.int64)).cuda()
    return x[:T] > th.index_select(0, pos)


def main(argv):
    import torch

    import chip_smoke as cs
    from xmhw_tpu_torch.ops import rle

    if not torch.cuda.is_available():
        print("torch_rle_variants: no CUDA device", file=sys.stderr)
        return 1
    card = cs.phase_device()
    out = Path(tempfile.mkdtemp(prefix="rle_variants_"))
    text = KERNEL.read_text()
    sources = {"kernel": KERNEL}
    for label, edits in VARIANTS.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"{label}: the kernel's text changed")
            src = src.replace(old, new)
        sources[label] = out / f"{re.sub(r'[^a-z0-9]+', '_', label)}.cu"
        sources[label].write_text(src)
    for a in argv:
        label, path = a.split("=", 1)
        sources[label] = Path(path)
    with ThreadPoolExecutor(len(sources)) as ex:
        built = list(ex.map(lambda kv: build(*kv, out), sources.items()))
    libs = {}
    for label, so, figs in built:
        print(f"{label}: " + "; ".join(
            f"{m}: {r} registers, {s} B spilled"
            for m, (r, s) in figs.items()), flush=True)
        lib = ctypes.CDLL(str(so))
        lib.xmhw_rle.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 6
                                 + [ctypes.c_void_p] * 9)
        lib.xmhw_rle.restype = ctypes.c_int
        lib.xmhw_rle_scratch.argtypes = [ctypes.c_int] * 2
        lib.xmhw_rle_scratch.restype = ctypes.c_longlong
        libs[label] = lib

    b0 = exceedance_mask(card)
    T, C = b0.shape
    masks = [b0] + [torch.roll(b0, (1000 * i, 7 * i), (0, 1)).contiguous()
                    for i in (1, 2)]
    keys = {"count": ("n_events",),
            "days": ("event_day", "is_start", "n_events"),
            "slots": ("event_day", "is_start", "slot", "n_events")}

    def run(label, mode, b):
        o = {k: torch.empty((C,) if k == "n_events" else (T, C),
                            dtype=torch.bool if k in ("event_day", "is_start")
                            else torch.int32, device="cuda")
             for k in keys[mode]}
        lib = libs[label]
        n = lib.xmhw_rle_scratch(T, C)
        scratch = torch.empty(n, dtype=torch.int32, device="cuda") if n \
            else None
        ptr = [o[k].data_ptr() if k in o else None
               for k in ("event_day", "is_start", "slot", "n_events")]
        err = lib.xmhw_rle(b.data_ptr(), T, C, 5, 1, 2, 0, *ptr, None, None,
                           None, None if scratch is None
                           else scratch.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{label} {mode}: CUDA error {err}")
        return o

    for mode in MODES:
        plain = rle.mhw_filter_plain(b0, full=False, slot=mode == "slots")
        for label in libs:
            got = run(label, mode, b0)
            torch.cuda.synchronize()
            if label in CUT:
                continue
            for k, v in got.items():
                if not torch.equal(v, plain[k]):
                    raise AssertionError(f"{label} {mode} {k} != plain")
        times = {label: [] for label in libs}
        for _ in range(3):
            for label in list(libs) + list(libs)[::-1]:
                it = itertools.cycle(masks)
                times[label].append(cs.cuda_ms(
                    lambda: run(label, mode, next(it))))
        for label, ms in times.items():
            print(f"{mode}: {label}: {statistics.median(ms):.3f} ms, median "
                  f"of {len(ms)} ({', '.join(f'{m:.3f}' for m in ms)})  "
                  f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
