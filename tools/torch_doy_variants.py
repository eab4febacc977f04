#!/usr/bin/env python3
"""Time variants of the port's clim-percentile kernel
(``xmhw_tpu_torch/csrc/doy_quantile.cu``) against each other on one GPU.

    python3 tools/torch_doy_variants.py [label=path/to/source.cu ...]

Builds with nvcc, each into a library of its own: the kernel as it is in
the checkout ("kernel"); two cut-down copies of it that show where its
time goes ("stage only" returns once the block's pools are staged in
shared memory, "no steps" skips the radix steps); and every source named
on the command line (another design, or an earlier commit's file from
``git show``). Prints each template instance's registers and spills
(``nvcc -Xptxas -v``) and the resident warps per SM they imply at the
pools of 30 and 40 years, then times every variant with CUDA events at
chip_smoke.py's shapes (4,096 cells; 40 daily years, and the 30-year
climatology of its slice) and at two whose pools take the long route
(ERSST v5's 171 monthly years, Z = 1,881; 85 daily years at w = 11,
Z = 1,955; the cut-down copies only at the first two), in turns
(forward, then backward): the median of 6 CUDA-event medians of 5. A
source that refuses a shape (an earlier one's limit on Z) is named and
left out there. Every variant but the cut-down ones must give thresholds
bit-equal to the plain version (over 512 cells at the long shapes) and
means within one float32 ulp. Needs a GPU; imports neither JAX nor the
JAX package.
"""

from __future__ import annotations

import ctypes
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
KERNEL = ROOT / "xmhw_tpu_torch" / "csrc" / "doy_quantile.cu"
# the H100's per-SM limits: registers, shared memory (each block reserves
# 1 KB more), threads; a block of the kernel is 256 threads
REGS, SMEM, THREADS, BLOCK = 65536, 233472, 2048, 256
CUT = {  # cut-down copies: (text of the kernel, its replacement, count)
    "stage only": ("    __syncthreads();\n",
                   "    __syncthreads();\n    if (ny > 0) return;\n", 1),
    "no steps": ("for (; b >= 0; --b) {",
                 "for (; b >= 0 && ny < 0; --b) {", 2),
}


def resident_warps(regs, Z):
    """Warps per SM that ``regs`` registers a thread and a Z-row tile
    allow (registers are allocated per warp in units of 256)."""
    per_warp = -(-regs * 32 // 256) * 256
    blocks = min(REGS // (per_warp * BLOCK // 32),
                 SMEM // (Z * 128 + 1024), THREADS // BLOCK)
    return blocks * BLOCK // 32


def build(label, src, out):
    """nvcc ``src`` into a library; returns (label, path, {keys a lane:
    (registers, spill bytes)})."""
    from xmhw_tpu_torch.ops import _build

    so = out / f"{re.sub(r'[^a-z0-9]+', '_', label)}.so"
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas",
                        "-v", "-o", str(so), str(src)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"{label}: nvcc failed:\n{r.stderr[-3000:]}")
    figs, kpt, spill = {}, None, 0
    for line in r.stderr.splitlines():
        m = re.search(r"Compiling entry function '\S*doy_quantile_kernel"
                      r"(?:ILi(\d+)E)?", line)
        if m:
            kpt = int(m.group(1) or 0)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and kpt is not None:
            figs[kpt] = (int(m.group(1)), spill)
            kpt = None
    return label, so, figs


def main(argv):
    import torch

    import chip_smoke as cs
    from xmhw_tpu_torch.core.calendar import build_window_ranges, compute_doy
    from xmhw_tpu_torch.ops import doy_quantile as dq
    from xmhw_tpu_torch.xrlite import TimeIndex

    if not torch.cuda.is_available():
        print("torch_doy_variants: no CUDA device", file=sys.stderr)
        return 1
    card = cs.phase_device()
    out = Path(tempfile.mkdtemp(prefix="doy_variants_"))
    text = KERNEL.read_text()
    sources = {"kernel": KERNEL}
    for label, (old, new, count) in CUT.items():
        if text.count(old) != count:
            raise RuntimeError(f"{label}: the kernel's text changed")
        sources[label] = out / f"{label.replace(' ', '_')}.cu"
        sources[label].write_text(text.replace(old, new))
    for a in argv:
        label, path = a.split("=", 1)
        sources[label] = Path(path)
    with ThreadPoolExecutor(len(sources)) as ex:
        built = list(ex.map(lambda kv: build(*kv, out), sources.items()))
    fns = {}
    for label, so, figs in built:
        print(f"{label}: " + "; ".join(
            f"{f'{k} keys a lane' if k else 'the kernel'}: {r} registers, "
            f"{s} B spilled" for k, (r, s) in sorted(figs.items())),
            flush=True)
        for years, Z, kpt in ((30, 330, 11), (40, 440, 14)):
            if kpt in figs:
                print(f"{label}: {years} years (Z = {Z}): {Z * 128} B of "
                      f"shared memory a block, {figs[kpt][0]} registers: "
                      f"{resident_warps(figs[kpt][0], Z)} resident warps "
                      "per SM", flush=True)
        fn = ctypes.CDLL(str(so)).xmhw_doy_quantile
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[label] = fn

    t = cs.daily(cs.T0, cs.T1)
    ts = cs.synth(len(t), cs.CELLS, seed=1)
    years = t.astype("datetime64[Y]").astype(int) + 1970
    sel = (years >= cs.CLIM_YEARS[0]) & (years <= cs.CLIM_YEARS[1])
    era5 = cs.daily("1940-01-01", "2025-01-01")
    ersst = cs.doy_edges().monthly_times(1854, 2024)
    shapes = (("40 years", t, ts, 5, False),
              ("30-year climatology", t[sel], ts[sel], 5, False),
              ("ERSST v5 monthly, long route", ersst,
               cs.synth(len(ersst), cs.CELLS, seed=2), 5, True),
              ("ERA5 daily w = 11, long route", era5,
               cs.synth(len(era5), cs.CELLS, seed=3), 11, False))
    for what, tv, a, w, tstep in shapes:
        doy, ndoy = compute_doy(TimeIndex(tv), keep_tstep=tstep)
        starts, lens, ny, rmax = build_window_ranges(doy, w, ndoy)
        # the cut-down copies cut the tile route only
        labels = [k for k in fns if dq.route(ny, rmax) == "tile"
                  or k not in CUT]
        x = torch.full((len(tv) + rmax, cs.CELLS), float("nan"),
                       device="cuda")
        x[:len(tv)] = torch.from_numpy(np.ascontiguousarray(a)).cuda()
        st = torch.from_numpy(starts.reshape(-1)).cuda()
        ln = torch.from_numpy(lens.reshape(-1)).cuda()
        # the plain version over the cells its gathered pool can hold
        # (all 4,096 at Z = 1,955 would take ~12 GB and its select more)
        n = cs.CELLS if dq.route(ny, rmax) == "tile" else 512
        thp, sep = dq.doy_quantile_plain(x[:, :n].contiguous(), st, ln,
                                         ndoy, ny, rmax)

        def run(label):
            th = torch.empty((ndoy, cs.CELLS), device="cuda")
            se = torch.empty_like(th)
            err = fns[label](x.data_ptr(), st.data_ptr(), ln.data_ptr(),
                             th.data_ptr(), se.data_ptr(), cs.CELLS, ndoy,
                             ny, rmax, 90, float(np.float32(0.9)),
                             torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{label}: CUDA error {err}")
            return th, se

        for label in list(labels):
            try:
                th, se = run(label)
            except RuntimeError as e:  # an earlier source's limit on Z
                print(f"{what}: {label}: refused ({e})", flush=True)
                labels.remove(label)
                continue
            torch.cuda.synchronize()
            if label not in CUT:
                cs.same_bits(th[:, :n], thp, f"{label} {what} thresh")
                cs.ulps(se[:, :n], sep, f"{label} {what} seas")
        times = {label: [] for label in labels}
        for _ in range(3):
            for label in labels + labels[::-1]:
                times[label].append(cs.cuda_ms(lambda: run(label)))
        for label, ms in times.items():
            print(f"{what}: {label}: {statistics.median(ms):.3f} ms, median "
                  f"of {len(ms)} ({', '.join(f'{m:.3f}' for m in ms)})  "
                  f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
