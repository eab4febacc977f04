#!/usr/bin/env python3
"""Time variants of the port's running-bound kernel
(``xmhw_tpu_torch/csrc/run_bound.cu``) against each other on one GPU.

    python3 tools/torch_run_bound_variants.py [label=path/to/source.cu ...]

Builds with nvcc, each into a library of its own: the kernel as it is in
the checkout ("kernel": 32 warps a block, each word of 32 rows loaded
while the one before it is written, streaming stores); the kernel with 16
warps a block ("16 warps"); the kernel that loads a word only after the
one before it is written ("no lookahead"); the kernel with plain stores
("plain stores"); and every source named on the command line (another
design, or an earlier commit's file from ``git show``; its C interface
must be ``xmhw_run_bound``).
Prints each variant's registers and spills per instance (``nvcc -Xptxas
-v``), checks that every variant equals the plain version bit for bit in
both directions, then times each direction and the forward + backward
pair on chip_smoke.py's main-block shape (T = 14,610 x 4,096 cells) with
CUDA events: three 90 %-True masks in turn (180 MB, past the 50 MB L2),
variants in turns (forward order, then backward), the median of 6
CUDA-event medians of 5. Needs a GPU; imports neither JAX nor the JAX
package.
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

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
KERNEL = ROOT / "xmhw_tpu_torch" / "csrc" / "run_bound.cu"
LOOKAHEAD = ("            const uint32_t y = i + 1 < nw\n"
             "                ? load_word(col + (size_t)t1 * p.C, p.C, "
             "min(32, b - t1))\n                : 0u;\n")
VARIANTS = {  # label: [(text of the kernel, its replacement), ...]
    "16 warps": [("constexpr int kWarps = 32;", "constexpr int kWarps = 16;")],
    # each word loaded only after the one before it is written
    "no lookahead": [
        (LOOKAHEAD, ""),
        ("            x = y;\n",
         "            if (i + 1 < nw)\n"
         "                x = load_word(col + (size_t)t1 * p.C, p.C, "
         "min(32, b - t1));\n")],
    # plain stores instead of streaming (evict-first) ones
    "plain stores": [("{ __stcs(p, v); }", "{ *p = v; }")],
}
T, C = 14610, 4096


def build(label, src, out):
    """nvcc ``src`` into a library; returns (label, path, [(instance,
    registers, spill bytes)])."""
    from xmhw_tpu_torch.ops import _build

    so = out / f"{re.sub(r'[^a-z0-9]+', '_', label)}.so"
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas",
                        "-v", "-o", str(so), str(src)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"{label}: nvcc failed:\n{r.stderr[-3000:]}")
    figs, fn, spill = [], None, 0
    for line in r.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            figs.append((fn, int(m.group(1)), spill))
            fn = None
    return label, so, figs


def main(argv):
    import torch

    import chip_smoke as cs
    from xmhw_tpu_torch.ops import run_bound

    if not torch.cuda.is_available():
        print("torch_run_bound_variants: no CUDA device", file=sys.stderr)
        return 1
    card = cs.phase_device()
    out = Path(tempfile.mkdtemp(prefix="run_bound_variants_"))
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
            f"{fn}: {r} registers, {s} B spilled" for fn, r, s in figs),
            flush=True)
        lib = ctypes.CDLL(str(so))
        lib.xmhw_run_bound.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p, ctypes.c_void_p]
        lib.xmhw_run_bound.restype = ctypes.c_int
        libs[label] = lib

    g = torch.Generator(device="cuda").manual_seed(8)
    masks = [torch.rand((T, C), generator=g, device="cuda") < 0.9
             for _ in range(3)]
    masks[0][:, 5] = False
    masks[0][:, 6] = True

    def run(label, b, forward):
        o = torch.empty((T, C), dtype=torch.int32, device="cuda")
        err = libs[label].xmhw_run_bound(
            b.data_ptr(), T, C, int(forward), o.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{label}: CUDA error {err}")
        return o

    for forward in (True, False):
        plain = run_bound.run_bound_plain(masks[0], forward)
        for label in libs:
            if not torch.equal(run(label, masks[0], forward), plain):
                raise AssertionError(f"{label} forward={forward} != plain")
    moved = 2 * (T * C + 4 * T * C)
    bound_ms, _ = cs.bound(moved, 2 * T * C)
    shapes = {"forward": (True,), "backward": (False,),
              "pair": (True, False)}
    for shape, dirs in shapes.items():
        times = {label: [] for label in libs}
        for _ in range(3):
            for label in list(libs) + list(libs)[::-1]:
                it = itertools.cycle(masks)

                def step():
                    b = next(it)
                    for d in dirs:
                        run(label, b, d)
                times[label].append(cs.cuda_ms(step))
        print(f"{shape} ({T} x {C}, bound {bound_ms / (2 / len(dirs)):.4f}"
              f" ms): " + ", ".join(
                  f"{label} {statistics.median(v):.4f} ms"
                  for label, v in times.items()) + f"  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
