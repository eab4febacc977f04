"""Command-line interface for the streamed planet-scale pipelines.

Port of :mod:`xmhw_tpu.__main__`. The reference has no CLI — its
documented planet workflow is a hand-written script staging threshold ->
detect -> block_average through NetCDF files per manual grid block
(reference: docs/dask.rst:44-86, docs/gettingstarted.rst:158-188). This
exposes the streamed equivalents so production runs need no Python:

    python -m xmhw_tpu_torch run sst.nc sst clim.nc mhw.nc \\
        --block block.nc --rank rank.nc --resume
    python -m xmhw_tpu_torch threshold sst.nc sst clim.nc --pctile 90
    python -m xmhw_tpu_torch detect sst.nc sst clim.nc mhw.nc
    python -m xmhw_tpu_torch block-average mhw.nc block.nc \\
        --dstime sst.nc --dstime-var sst --clim clim.nc
    python -m xmhw_tpu_torch rank mhw.nc rank.nc
    python -m xmhw_tpu_torch warmup

Common flags: --stripe N (grid rows per stripe), --compress LEVEL
(gzip+shuffle outputs), --resume (pick up an interrupted run),
--f64 (float64 pipeline, the plain torch code), --device (a torch device,
default "cuda"; "cpu" runs the plain torch code on the host; a CUDA
device without a GPU raises).

The JAX package's CLI also turns on JAX's persistent compile cache. There
is nothing to enable here: the CUDA kernels are built once per checkout
into ``xmhw_tpu_torch/_build/`` (``warmup`` does it ahead of a run), and
torch compiles nothing else.
"""

import argparse
import sys


def _common(p, resume=True):
    p.add_argument("--stripe", type=int, default=None,
                   help="grid rows per stripe (default: ~256 MB reads)")
    p.add_argument("--compress", type=int, default=None, metavar="LVL",
                   help="gzip level 1-9 (+byte shuffle) for outputs")
    if resume:
        p.add_argument("--resume", action="store_true",
                       help="continue an interrupted run from its "
                            "per-stripe watermark")


def _shared_flags(p):
    p.add_argument("--cold-spells", action="store_true")
    p.add_argument("--anynans", action="store_true")
    p.add_argument("--max-pad-length", type=int, default=None)
    p.add_argument("--tstep", action="store_true")


def _detect_args(p):
    p.add_argument("--min-duration", type=int, default=5)
    p.add_argument("--max-gap", type=int, default=2)
    p.add_argument("--no-join-gaps", action="store_true")
    p.add_argument("--events-layout", choices=("compact", "union"),
                   default="compact")


def _thresh_args(p):
    p.add_argument("--pctile", type=int, default=90)
    p.add_argument("--window-half-width", type=int, default=5)
    p.add_argument("--no-smooth", action="store_true")
    p.add_argument("--smooth-width", type=int, default=31)
    p.add_argument("--clim-period", type=int, nargs=2, default=None,
                   metavar=("Y0", "Y1"))


def build_parser():
    ap = argparse.ArgumentParser(
        prog="python -m xmhw_tpu_torch",
        description="Marine heatwave detection in PyTorch and CUDA — "
                    "streamed file-to-file pipelines (Hobday et al. 2016)")
    ap.add_argument("--f64", action="store_true",
                    help="float64 pipeline (plain torch code, parity mode)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every step (default: cuda; cpu "
                         "runs the plain torch code on the host)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="fused single pass: climatology + "
                       "detect + block stats + ranks, ONE read/upload "
                       "per stripe")
    p.add_argument("input"), p.add_argument("var")
    p.add_argument("clim"), p.add_argument("mhw")
    p.add_argument("--block", default=None,
                   help="also write block_average to this path")
    p.add_argument("--rank", default=None,
                   help="also write ranks (+_return) to this path")
    p.add_argument("--block-length", type=int, default=1)
    p.add_argument("--remove-missing", action="store_true")
    _thresh_args(p)
    _detect_args(p)
    _shared_flags(p)
    _common(p)

    p = sub.add_parser("threshold", help="streamed climatology")
    p.add_argument("input"), p.add_argument("var"), p.add_argument("out")
    _thresh_args(p)
    _shared_flags(p)
    _common(p)

    p = sub.add_parser("detect", help="streamed event detection")
    p.add_argument("input"), p.add_argument("var")
    p.add_argument("clim"), p.add_argument("out")
    p.add_argument("--intermediate", action="store_true")
    _detect_args(p)
    _shared_flags(p)
    _common(p)

    p = sub.add_parser("block-average", help="streamed year-block stats")
    p.add_argument("mhw"), p.add_argument("out")
    p.add_argument("--dstime", default=None, help="original SST file")
    p.add_argument("--dstime-var", default=None)
    p.add_argument("--clim", default=None)
    p.add_argument("--period", type=int, nargs=2, default=None,
                   metavar=("Y0", "Y1"))
    p.add_argument("--block-length", type=int, default=1)
    p.add_argument("--remove-missing", action="store_true")
    _common(p)

    p = sub.add_parser("rank", help="streamed event ranks + return "
                       "periods")
    p.add_argument("mhw"), p.add_argument("rank")
    p.add_argument("--return-path", default=None)
    _common(p)

    p = sub.add_parser(
        "warmup",
        help="build the CUDA kernels (once per checkout) and run the "
             "standard shapes once on the device")
    p.add_argument("--days", type=int, default=None,
                   help="series length in days; default 40 years")
    p.add_argument("--like", default=None, metavar="FILE",
                   help="read the series length (and start date) from "
                        "this NetCDF file's time axis")
    p.add_argument("--tdim", default="time")
    p.add_argument("--point", action="store_true",
                   help="run only the single-point programs (fast)")
    p.add_argument("--cells", type=int, default=4096,
                   help="grid cell-block size to run (default 4096)")
    p.add_argument("--k", type=int, nargs="*", default=[32, 64, 128],
                   help="event-table capacities to run")
    return ap


def _warmup(a, dtype):
    """Build the CUDA kernels (ops/_build.py: one nvcc call, cached under
    xmhw_tpu_torch/_build/ for every later process of this checkout) and
    run the standard shapes once on the device, so that a first real run
    neither builds nor meets a launch error late. Without a GPU it raises
    with the device's message, without nvcc with the build's. An
    explicit ``--device cpu`` runs the shapes with the plain torch code
    and builds nothing, and says so."""
    import time

    import numpy as np

    import xmhw_tpu_torch as xm

    from .core.calendar import compute_doy
    from .core.pipeline import resolve_device, run_detect
    from .xrlite import Coord, DataArray, TimeIndex

    dev = resolve_device(a.device)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        from .ops import _build

        so = _build.build()
        _build.library()
        print(f"warm: CUDA kernels built ({so.name}) in "
              f"{time.perf_counter() - t0:.1f}s")
    else:
        print(f"warm: device {dev}: plain torch code, no kernels to build")
    start = np.datetime64("1982-01-01")
    T = a.days
    if a.like:
        ds = xm.open_dataset(a.like)
        tvals = np.asarray(ds[a.tdim].data)
        T = len(tvals)
        if np.issubdtype(tvals.dtype, np.datetime64):
            start = tvals[0].astype("datetime64[D]")
    T = T or int(round(40 * 365.25))
    t = (start + np.arange(T)).astype("datetime64[ns]")
    rng = np.random.default_rng(0)
    day = np.arange(T, dtype=np.float32)

    def series(n):
        base = 15 + 3 * np.sin(2 * np.pi * day / 365.25)[:, None]
        return (base + rng.normal(0, 1.5, (T, n))).astype(dtype)

    # point programs (the host numpy engine unless XMHW_POINT_HOST=0)
    t1 = time.perf_counter()
    da = DataArray(series(1)[:, 0], ("time",),
                   {"time": Coord(("time",), t)})
    clim = xm.threshold(da, device=dev)
    xm.detect(da, clim["thresh"], clim["seas"], device=dev)
    print(f"warm: point programs (T={T}) in "
          f"{time.perf_counter() - t1:.1f}s")
    if a.point:
        return
    # grid programs: one cell block at the requested width, each K
    ny = max(1, a.cells // 64)
    g = series(ny * 64).reshape(T, ny, 64)
    dag = DataArray(g, ("time", "lat", "lon"),
                    {"time": Coord(("time",), t),
                     "lat": Coord(("lat",), np.arange(ny, dtype=float)),
                     "lon": Coord(("lon",), np.arange(64, dtype=float))})
    t1 = time.perf_counter()
    clim = xm.threshold(dag, cell_block=a.cells, device=dev)
    print(f"warm: grid climatology ({ny * 64} cells) in "
          f"{time.perf_counter() - t1:.1f}s")
    doy, ndoy = compute_doy(TimeIndex(t))
    doy_pos = (doy - 1).astype(np.int32)
    th = np.asarray(clim["thresh"].data).reshape(ndoy, -1).astype(dtype)
    se = np.asarray(clim["seas"].data).reshape(ndoy, -1).astype(dtype)
    flat = g.reshape(T, -1).astype(dtype)
    for k in a.k:
        t2 = time.perf_counter()
        run_detect(flat, th, se, doy_pos, min_duration=5, join_gaps=True,
                   max_gap=2, block=a.cells, first_k=k, k_cap=k,
                   device=dev)
        print(f"warm: grid detect K={k} in "
              f"{time.perf_counter() - t2:.1f}s")


def main(argv=None):
    import numpy as np

    a = build_parser().parse_args(argv)
    dtype = np.float64 if a.f64 else np.float32
    if a.cmd == "warmup":
        _warmup(a, dtype)
        return 0
    from . import (stream_block_average, stream_detect, stream_rank,
                   stream_run, stream_threshold)

    common = dict(stripe=a.stripe, compress=a.compress, device=a.device)
    if a.cmd == "run":
        out = stream_run(
            a.input, a.var, a.clim, a.mhw, block_path=a.block,
            rank_path=a.rank,
            climatologyPeriod=list(a.clim_period or (None, None)),
            pctile=a.pctile, windowHalfWidth=a.window_half_width,
            smoothPercentile=not a.no_smooth,
            smoothPercentileWidth=a.smooth_width,
            maxPadLength=a.max_pad_length, coldSpells=a.cold_spells,
            tstep=a.tstep, anynans=a.anynans,
            minDuration=a.min_duration, joinGaps=not a.no_join_gaps,
            maxGap=a.max_gap, blockLength=a.block_length,
            removeMissing=a.remove_missing,
            events_layout=a.events_layout, dtype=dtype,
            resume=a.resume, **common)
        print("\n".join(f"{k}: {v}" for k, v in out.items()))
    elif a.cmd == "threshold":
        print(stream_threshold(
            a.input, a.var, a.out,
            climatologyPeriod=list(a.clim_period or (None, None)),
            pctile=a.pctile, windowHalfWidth=a.window_half_width,
            smoothPercentile=not a.no_smooth,
            smoothPercentileWidth=a.smooth_width,
            maxPadLength=a.max_pad_length, coldSpells=a.cold_spells,
            tstep=a.tstep, anynans=a.anynans, dtype=dtype,
            resume=a.resume, **common))
    elif a.cmd == "detect":
        out = stream_detect(
            a.input, a.var, a.clim, a.out,
            minDuration=a.min_duration, joinGaps=not a.no_join_gaps,
            maxGap=a.max_gap, maxPadLength=a.max_pad_length,
            coldSpells=a.cold_spells, intermediate=a.intermediate,
            anynans=a.anynans, tstep=a.tstep,
            events_layout=a.events_layout, dtype=dtype,
            resume=a.resume, **common)
        print(out if isinstance(out, str) else "\n".join(out))
    elif a.cmd == "block-average":
        print(stream_block_average(
            a.mhw, a.out, dstime_path=a.dstime,
            dstime_var=a.dstime_var, clim_path=a.clim,
            period=list(a.period) if a.period else None,
            blockLength=a.block_length,
            removeMissing=a.remove_missing, resume=a.resume, **common))
    elif a.cmd == "rank":
        rp, pp = stream_rank(a.mhw, a.rank,
                             return_path=a.return_path,
                             resume=a.resume, **common)
        print(rp)
        print(pp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
