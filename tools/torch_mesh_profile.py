#!/usr/bin/env python3
"""Where a cell mesh of one card spends its extra host time in run_fused.

    python3 tools/torch_mesh_profile.py [copies]

On one GPU: chip_smoke.py's 4,096-cell, 40-year slice through run_fused
with its stats stage (chip_smoke.fused_run), on one device and on a mesh
of [cuda:0, cuda:0]: six synchronised walls in turns, then one cProfile
of each, the top 24 functions by own time. ``copies`` (default 1) puts
the slice side by side that many times: at 1 the mesh halves the one
4,096-cell block, at 2 each device gets a 4,096-cell block.
cProfile adds cost to every Python call, so read its shares, not its
seconds. Needs a GPU; imports neither JAX nor the JAX package.
"""

import cProfile
import io
import pstats
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(copies=1):
    import torch

    import chip_smoke as cs
    from xmhw_tpu_torch.ops import _build
    from xmhw_tpu_torch.parallel import cell_mesh

    if not torch.cuda.is_available():
        print("torch_mesh_profile: no CUDA device", file=sys.stderr)
        return 1
    card = cs.phase_device()
    _build.library()
    da = cs.grid(cs.daily(cs.T0, cs.T1), 64, 80, seed=3,
                 land=64 * 80 - cs.CELLS)
    mesh = cell_mesh(["cuda:0", "cuda:0"])
    cs.fused_run(da, copies=copies)
    cs.fused_run(da, mesh=mesh, copies=copies)
    for who in ("single", "mesh", "mesh", "single", "single", "mesh"):
        _, w = cs.fused_run(da, mesh=mesh if who == "mesh" else None,
                            copies=copies)
        print(f"{who} {w:.4f} s  [{card}]", flush=True)
    for who in ("single", "mesh"):
        pr = cProfile.Profile()
        pr.enable()
        cs.fused_run(da, mesh=mesh if who == "mesh" else None,
                     copies=copies)
        pr.disable()
        s = io.StringIO()
        pstats.Stats(pr, stream=s).sort_stats("tottime").print_stats(24)
        print(who, s.getvalue()[-4500:])
    return 0


if __name__ == "__main__":
    sys.exit(main(*map(int, sys.argv[1:])))
