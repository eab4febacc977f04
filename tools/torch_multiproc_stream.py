#!/usr/bin/env python3
"""Multi-process dryrun of xmhw_tpu_torch's STREAMED file-to-file pipeline
over torch.distributed.

The counterpart of tools/multihost_stream.py: each rank runs
``stream_run(..., grid_rows=band)`` on its own latitude band of one
NetCDF file (the bands from ``parallel.band_rows``), the group's
``parallel.barrier()`` waits for every band file, and rank 0
merges the band files (``merge_grid_band_files(band_dim="lat")``),
derives ranks and return periods from the merged event tables with
``stream_rank`` (nYears is a record-span GLOBAL, so per-band rank files
would disagree), and runs the same pipeline in one process over the
whole grid. Every dataset of every output, its dtype, shape, fill value,
bytes and attributes, and every global attribute but ``history``, must
be equal: climatology, events, block statistics, ranks and return
periods.

The grid is the JAX tool's: 12 x 8 cells, 3 daily years, float32, ~20 %
land, stripes of 5 rows. ``band_rows(12, 2, 5)`` puts the band edge on a
stripe edge, row 5: each stripe then holds the same ocean cells in the
banded and the one-process runs, as a deployment whose bands tile the
stripe grid.

    python tools/torch_multiproc_stream.py           # on the card
    python tools/torch_multiproc_stream.py --device cpu   # 2 gloo ranks
    python tools/torch_multiproc_stream.py [flags] RANK PORT DIR   # one rank

The streamed functions read and write NetCDF4 through h5py, or on a
machine without it through the numpy stand-in tools/h5py_standin put
first on PYTHONPATH (as chip_smoke.py puts it; the ranks inherit it).
With neither the tool exits with a message and code 1. The launcher kills every rank
when one fails or ``--timeout`` passes, and prints PASS or FAIL.
"""

from __future__ import annotations

import argparse
import datetime
import importlib.util
import os
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_multiproc_dryrun import free_port, say, wait_all  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PROC = 2
NY, NX, YEARS = 12, 8, 3
STRIPE = 5
PARTS = ("clim", "mhw", "block")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    p.add_argument("--timeout", type=float, default=300.0,
                   help="seconds each rank may take")
    p.add_argument("rank", type=int, nargs="?")
    p.add_argument("port", type=int, nargs="?")
    p.add_argument("dir", nargs="?")
    return p.parse_args(argv)


def write_input(path):
    import h5py

    T = int(round(YEARS * 365.25))
    t = np.arange(T, dtype=np.float64)
    rng = np.random.default_rng(11)
    ts = (15 + 3 * np.sin(2 * np.pi * t / 365.25)[:, None, None]
          + rng.normal(0, 1.5, (T, NY, NX))).astype(np.float32)
    land = rng.random((NY, NX)) < 0.2
    ts[:, land] = np.nan
    with h5py.File(path, "w") as f:
        tn = f.create_dataset("time", data=t)
        tn.attrs["units"] = "days since 2000-01-01 00:00:00"
        tn.attrs["calendar"] = "standard"
        tn.make_scale("time")
        yn = f.create_dataset("lat", data=np.linspace(-40, -30, NY))
        yn.make_scale("lat")
        xn = f.create_dataset("lon", data=np.linspace(150, 157, NX))
        xn.make_scale("lon")
        v = f.create_dataset("sst", data=ts)
        v.attrs["units"] = "degree_C"
        for d, s in zip(v.dims, (tn, yn, xn)):
            d.attach_scale(s)


# the HDF5 dimension-scale bookkeeping holds object references, which
# differ between files; the scales a dataset is attached to are compared
# by name instead
SCALE_ATTRS = ("REFERENCE_LIST", "DIMENSION_LIST")


def _attrs(node, skip=("history",)):
    return {k: v for k, v in node.attrs.items()
            if k not in skip + SCALE_ATTRS}


def _scales(node):
    return [[s.name for s in dim.values()] for dim in node.dims]


def _same(a, b):
    """Attribute values or arrays equal, bytes for numbers."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind in "biufc" and b.dtype.kind in "biufc":
        return (a.dtype, a.shape) == (b.dtype, b.shape) and \
            a.tobytes() == b.tobytes()
    return a.shape == b.shape and bool(np.all(a == b))


def assert_files_equal(a_path, b_path):
    """Every dataset's dtype, shape, fill value, dimension scales,
    attributes and bytes, and every global attribute but ``history``."""
    import h5py

    with h5py.File(a_path, "r") as a, h5py.File(b_path, "r") as b:
        ga, gb = _attrs(a), _attrs(b)
        assert sorted(ga) == sorted(gb), (a_path, sorted(ga), sorted(gb))
        for k in gb:
            assert _same(ga[k], gb[k]), (a_path, k, ga[k], gb[k])
        assert sorted(a.keys()) == sorted(b.keys()), a_path
        for name in b:
            x, y = a[name], b[name]
            what = f"{os.path.basename(a_path)}:{name}"
            assert (x.shape, x.dtype) == (y.shape, y.dtype), what
            assert _same(x.fillvalue, y.fillvalue), what
            assert _scales(x) == _scales(y), what
            xa, ya = _attrs(x, ()), _attrs(y, ())
            assert sorted(xa) == sorted(ya), what
            for k in ya:
                assert _same(xa[k], ya[k]), (what, k)
            assert _same(x[()], y[()]), f"{what}: not byte-equal"


def child(rank, port, d, device, timeout):
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    import xmhw_tpu_torch as xt
    from xmhw_tpu_torch.parallel import band_rows, barrier

    torch.set_num_threads(2)
    dev = torch.device("cpu")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda but torch.cuda.is_available() "
                               "is False")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    # the group only synchronises the ranks: gloo, whatever the device
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=N_PROC,
        rank=rank, timeout=datetime.timedelta(seconds=timeout))
    try:
        src = os.path.join(d, "sst.nc")
        bands = band_rows(NY, N_PROC, STRIPE)
        paths = {k: os.path.join(d, f"{k}_r{rank}.nc") for k in PARTS}
        xt.stream_run(src, "sst", paths["clim"], paths["mhw"],
                      block_path=paths["block"], stripe=STRIPE,
                      grid_rows=bands[rank], device=dev)
        barrier()  # every band file is written before the merge
        if rank != 0:
            say(f"rank {rank}: band {bands[rank]} written on {dev}")
            return
        merged = {k: os.path.join(d, f"{k}_merged.nc") for k in PARTS}
        for k in PARTS:
            xt.merge_grid_band_files(
                [(os.path.join(d, f"{k}_r{r}.nc"), lo, hi)
                 for r, (lo, hi) in enumerate(bands)],
                merged[k], band_dim="lat")
        merged["rank"], merged["return"] = xt.stream_rank(
            merged["mhw"], os.path.join(d, "rank_merged.nc"), device=dev)
        ref = {k: os.path.join(d, f"{k}_ref.nc") for k in PARTS}
        xt.stream_run(src, "sst", ref["clim"], ref["mhw"],
                      block_path=ref["block"], stripe=STRIPE, device=dev)
        ref["rank"], ref["return"] = xt.stream_rank(
            ref["mhw"], os.path.join(d, "rank_ref.nc"), device=dev)
        for k in merged:
            assert_files_equal(merged[k], ref[k])
        say(f"rank 0: OK — band {bands[0]} written on {dev}; merged "
            f"{', '.join(os.path.basename(p) for p in merged.values())} "
            "byte-equal to the single-process run")
    finally:
        dist.destroy_process_group()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    if importlib.util.find_spec("h5py") is None:
        print("torch multiproc stream: needs h5py, which the streamed "
              "functions read and write NetCDF4 through; not installed "
              "(on a machine without it, put tools/h5py_standin first on "
              "PYTHONPATH)", file=sys.stderr)
        return 1
    if args.rank is not None:
        if args.dir is None:
            raise SystemExit("one rank needs RANK PORT DIR")
        child(args.rank, args.port, args.dir, args.device, args.timeout)
        return 0
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="xmhw_procs_") as d:
        write_input(os.path.join(d, "sst.nc"))
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *argv, str(r),
             str(port), d]) for r in range(N_PROC)]
        rc = wait_all(procs, args.timeout)
    print("torch multiproc stream:", "PASS" if rc == 0 else "FAIL",
          flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
