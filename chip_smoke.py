#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (xmhw_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one or more lines each:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: nvcc builds every kernel of xmhw_tpu_torch/csrc into one library;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the main path's shapes (40 daily years, T = 14,610; 4,096 cells;
   K = 128 event slots), with CUDA-event times of both, the kernel's bound
   (the least time the card could take for its bytes or operations) and
   the time of one PyTorch call that computes the same function, where
   there is one. The clim percentile (doy_quantile) also runs at pctile
   90, 87.5 and 10 on the 40-year tables, the 30-year climatology's
   tables, a block of edge pools and the largest pool its shared tile holds
   (thresholds bit-equal, means within one float32 ulp), and the radix
   steps its common-prefix skip saves are counted. The running-bound
   kernel (run_bound), which no path calls, is driven here and in the
   mesh phase: bit for bit, forward and backward, on the main block and
   on the segment-edge cases of tests/test_torch_run_bound_edges.py (60,000
   days among them), timed per direction. The
   event RLE (rle) is checked bit for bit in its four output modes on the
   main block and on the segment-edge cases of
   tests/test_torch_rle_edges.py, and timed in three (the counting launch,
   the detect launch, today's full=False), each against its own bound. The
   event scan runs again on events that cross every one of its time
   segments' edges. Its plain version in float64, what the card runs for
   float64, must give the same bits in three runs and the CPU's bits but
   for the standard deviations (float64 ``torch.sqrt`` is not always
   correctly rounded on the CPU), and is timed (``f64_scan``, which also
   takes other versions of it to time in turns). The stats layer's two
   kernels (block_stats: the year-bin event and day statistics of the
   main block, 40 one-year bins) must equal their plain versions bit for
   bit, and are timed against their bound (one log line and the
   ``block_stats`` row of the JSON line);
4. reference: threshold() + detect() on a small grid, on the card (float32
   kernels) against the plain torch code on the CPU; then in float64 (the
   plain versions on the card) twice, which must give the same bits, and
   whether those bits equal the CPU's;
5. slice: threshold(climatologyPeriod=[1983, 2012]) then detect() over a
   synthetic 40-year grid of 4,096 ocean cells; every kernel's launch
   counter must advance (the RLE's by one counting and one detect launch),
   the stats kernels' must not, events must be found and no event may be
   lost;
6. stats: block_average() (one-year blocks with the ts/thresh/seas day
   series, and 5-year blocks) and mhw_rank() of the slice on the card,
   against the host numpy path; the event-bin kernel launches once a
   block_average(), the day-bin kernel not (its day path is float64);
7. fused: run_fused on the same data, with its stats stage, must
   reproduce the slice, its block_average and its mhw_rank; kernels 1-3
   launch, and each stats kernel once a block;
8. mesh: the slice's threshold() + detect() and run_fused (with its
   stats stage) over a cell mesh of [cuda:0, cuda:0], and of every GPU when
   more than one is visible: equal to the single-device runs bit for bit,
   every kernel launched once per shard (the stats kernels in run_fused
   only); the walls of one device and of
   the mesh, in turns, and the count of visible GPUs; run_fused over the
   slice twice side by side (8,192 cells: 4,096 a device), one device
   against the mesh, in turns and bit-equal; run_bound on the mesh's
   shards of the slice's exceedance mask (make_cell_array);
9. procs: tools/torch_multiproc_dryrun.py with two ranks of one
   torch.distributed group over the slice's size (40 daily years, 4,096
   cells, K = 128, float32): both on cuda:0 with gloo where one GPU is
   visible, one GPU a rank with nccl where two or more are. Each rank
   feeds its own shard of the global mesh (make_cell_array), runs
   fused_threshold_detect on it (kernels 1-3 once each: its launch
   counters must advance by one, the RLE's in its detect mode), its
   outputs must equal the one-process step bit for bit and the plain
   version's on its shard within the kernel bars; the ranks' all_reduced
   event total must equal the one-process step's. The backend, the devices and
   the walls of each rank's step and of the one-process step. Then
   tools/torch_multiproc_stream.py on the card: two ranks each stream_run
   their own latitude band of one file, rank 0 merges the band files
   (merge_grid_band_files) and holds them byte-equal to one process's run;
10. stream steps: the device steps only the streamed stages run
   (stream_block_average's float64 event and day statistics of one stripe,
   stream_rank's batched ranks), on the slice's events, on the card
   against the CPU;
11. options: threshold() + detect() in float32 with each public option of
   OPTIONS (coldSpells, windowHalfWidth 11 and 15, smoothPercentile=False,
   smoothPercentileWidth=11, climatologyPeriod=[1991, 2020], minDuration=3
   with maxGap=1, joinGaps=False, intermediate, anynans with skipna and
   maxPadLength=2 on a grid with NaN gaps, reference_quirks, the noleap
   and 360_day calendars, the union layout beside the compact one) over
   the slice's grid through the kernels (every kernel's launch counter
   must advance), held against the plain versions on the card on 13 of
   its lat rows: thresholds bit-equal, seas within 1e-5, event counts,
   positions, times and NaN patterns exact, event floats within 2e-3 of
   1 + |plain|. One line each: the kernels' wall and launches, the
   largest differences and the events compared. Then the same for two
   records whose pools pass kernel 1's shared tile (1,816 rows), at their
   real size: an ERSST-v5-shaped monthly grid (89 x 180, 1854-2024,
   tstep=True; pools of 171 years x 11 rows = 1,881) and a 4,096-cell
   block of daily 1940-2024 at windowHalfWidth=11 (85 x 23 = 1,955
   rows): kernel 1 must launch by its long route only. Each prints its
   Z, its wall, and kernel 1 alone at its shape (CUDA events) beside its
   bound, and on 1,024 cells beside its plain version and
   torch.nanquantile + torch.nanmean;
12. cli: ``python -m xmhw_tpu_torch warmup`` (in process): the kernels and
   the standard shapes on the card; every kernel's launch counter must
   advance;
13. stream: the streamed pipelines file to file. A 160 x 64 grid (10,240
   cells, ~20 % land, 40 daily years, float32, ~600 MB) through stream_run
   (3 stripes) and through the staged chain stream_threshold ->
   stream_detect -> stream_block_average -> stream_rank, which must agree,
   and whose climatology and events must equal one in-memory run_fused
   over the grid; kernels 1-3 must launch in both runs; the CLI's ``run``
   on a small grid in a subprocess, which must write its files. Then
   stream_detect stopped after its first stripe and resumed: the file must
   equal a fresh run's, and the resumed call must launch the kernels of
   the remaining stripes only. Then stream_run with maxPadLength=2 over a
   48 x 64 grid with NaN gaps (gap filling on the card from the read-ahead
   thread), once on the card and once over the mesh [cuda, cuda]: files
   byte-equal, and equal to one in-memory run_fused over the gaps filled
   on the main thread. Then the production width: a band of 24
   rows x 1,440 longitudes of the 0.25-degree grid (34,560 cells, 30 %
   land, 40 daily years, 2.0 GB) through stream_run alone, 8 stripes of 3
   rows, whose climatology and events must equal one in-memory run_fused
   over its ocean cells; its wall per stripe, cells/s, the device-step
   share (CUDA events around each stripe's run_fused over the wall) and
   the peak host RSS.

The streamed files go through h5py where it is installed. Where it is not
(the H100 machine), the script puts the numpy stand-in tools/h5py_standin
first on sys.path and on the PYTHONPATH of every subprocess it starts, and
says so in its first ``io:`` line: the files are then raw arrays behind an
HDF5 signature, and tests/test_torch_h5py_standin.py holds them against
real h5py's on the CPU.

Wherever a phase counts launches, the stats kernels (``event_bins``,
``day_bins``) must launch once per shard-block of a run_fused with a stats
stage (the ``detect_blocks`` counter) and nowhere else: not in threshold()
+ detect(), the options, the CLI's warmup, stream_run without block
statistics, or the staged chain (float64).

Then a JSON line with one entry per kernel (``launches``: in the slice;
kernel 1's ``long_records``: its rows at the options phase's long
records;
``mesh_launches``: in the mesh phase's run on [cuda:0, cuda:0];
``procs_launches``: each rank's in the procs phase; ``stream_launches``:
in the stream phase's production-width band; the event scan's
``plain_f64_ms``: its plain version in float64; the ``block_stats`` row's
launches are ``{"event_bins": n, "day_bins": n}``, with
``fused_launches`` from the fused phase and no procs count), and last the
line
{"ok": true, "device": {...}}. Any failure raises and exits non-zero; so
does a machine without a visible CUDA device.
"""

from __future__ import annotations

import gc
import itertools
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

T0, T1 = "1982-01-01", "2022-01-01"  # 40 daily years, T = 14,610
CLIM_YEARS = [1983, 2012]
CELLS = 4096
K = 128
REPS = 5
DEV = "cuda"
TOL = {"thresh": 1e-6, "seas": 1e-5, "scan": 2e-3}  # atol; scan also rtol
PCTILES = (90, 87.5, 10)
# the H100 SXM's peaks (NVIDIA's data sheet): HBM3 bytes per second, and
# float32 operations per second outside the tensor cores
PEAK_BYTES, PEAK_OPS = 3.35e12, 67e12
NO_LIBRARY = "none: no single PyTorch call computes it"
# stats against the host numpy path: day statistics are float64 on both
# sides (rtol); event statistics are float32 tables summed in float32 on
# the card and in float64 on the host (rtol = atol); counts and ranks exact
STATS_TOL = {"day": 1e-9, "event": 1e-5}
STREAM_GRID = (160, 64)  # 10,240 cells; the default stripe is 71 rows
# the production width: 24 rows of the 0.25-degree grid (1,440 longitudes),
# 30 % land; at 40 daily years the default stripe is 3 rows (~256 MB)
BAND = (24, 1440)
BAND_LAND = 0.3
STANDIN = Path(__file__).resolve().parent / "tools" / "h5py_standin"
DAY_STATS = ("ts_mean", "ts_max", "ts_min")
RANKED = ("intensity_max", "duration")


def log(msg):
    print(msg, flush=True)


def synth(T, n, seed, land=0):
    """(T, n) float32: seasonal cycle plus 15-day-smoothed noise (the TPU
    benchmark's recipe), with ``land`` all-NaN cells chosen at random."""
    rng = np.random.default_rng(seed)
    day = np.arange(T, dtype=np.float64)[:, None]
    noise = rng.normal(0.0, 1.0, (T + 14, n))
    cs = np.concatenate([np.zeros((1, n)), np.cumsum(noise, axis=0)])
    sm = (cs[15:15 + T] - cs[:T]) / 15.0
    ts = (15 + 3 * np.sin(2 * np.pi * day / 365.25) + 2.5 * sm)
    ts = ts.astype(np.float32)
    ts[:, rng.permutation(n)[:land]] = np.nan
    return ts


def daily(t0, t1):
    return np.arange(t0, t1, dtype="datetime64[D]").astype("datetime64[ns]")


def grid(t, nlat, nlon, seed, land):
    from xmhw_tpu_torch.xrlite import Coord, DataArray

    ts = synth(len(t), nlat * nlon, seed, land).reshape(len(t), nlat, nlon)
    return DataArray(
        ts, ("time", "lat", "lon"),
        {"time": Coord(("time",), t),
         "lat": Coord(("lat",), np.linspace(-45.0, -30.0, nlat)),
         "lon": Coord(("lon",), np.linspace(140.0, 160.0, nlon))},
        {"units": "degree_C"})


def cuda_ms(fn, reps=REPS):
    """Median CUDA-event time of ``fn`` in ms, after one warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_err(a, b, what, atol, rtol=0.0):
    """Max |a - b| over finite entries; raises when the NaN patterns differ
    or an entry is outside atol + rtol * |b|."""
    import torch

    a, b = a.double(), b.double()
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb):
        raise AssertionError(f"{what}: NaN patterns differ at "
                             f"{int((fa != fb).sum())} entries")
    d = (a[fa] - b[fb]).abs()
    if d.numel() and bool((d > atol + rtol * b[fb].abs()).any()):
        raise AssertionError(f"{what}: max |diff| {float(d.max()):.3g} "
                             f"exceeds atol {atol} rtol {rtol}")
    return float(d.max()) if d.numel() else 0.0


def bits():
    """tools/torch_multiproc_dryrun.py, whose bit-equality helpers
    (``same_bits`` and ``differing`` for tensors, ``np_same_bits`` for
    arrays) this script shares with the tests."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    import torch_multiproc_dryrun

    return torch_multiproc_dryrun


def doy_edges():
    """tests/test_torch_doy_edges.py: kernel 1's edge pools, the largest
    staged pool and the calendar helpers, shared with the tests."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import test_torch_doy_edges

    return test_torch_doy_edges


def same_bits(a, b, what):
    """Raises unless two tensors are equal bit for bit (-0.0 and +0.0
    differ), NaN patterns included."""
    if not bits().same_bits(a, b):
        raise AssertionError(f"{what}: not bit-equal")


def ulps(a, b, what):
    """Max |a - b| in float32 ulps of the larger magnitude; raises above
    one ulp or when the NaN patterns differ."""
    import torch

    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb):
        raise AssertionError(f"{what}: NaN patterns differ")
    if not bool(fa.any()):
        return 0.0
    big = torch.maximum(a[fa].abs(), b[fb].abs())
    ulp = torch.nextafter(big, torch.full_like(big, float("inf"))) - big
    r = float(((a[fa].double() - b[fb].double()).abs() / ulp.double()).max())
    if r > 1.0:
        raise AssertionError(f"{what}: {r:.3g} ulp apart (bar: 1)")
    return r


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved, ops):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move ``moved`` bytes (each input read once, each output written
    once) and to do ``ops`` operations, whichever is larger."""
    b, o = moved / PEAK_BYTES * 1e3, ops / PEAK_OPS * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def choose_h5py():
    """The library the streamed files go through: h5py where it is
    installed; else the numpy stand-in, first on sys.path and on the
    PYTHONPATH of every subprocess started later. Logs which."""
    import importlib.util

    if importlib.util.find_spec("h5py") is not None:
        import h5py

        log(f"io: h5py {h5py.__version__} is installed: the streamed files "
            f"are HDF5, read and written through it ({h5py.__file__})")
        return
    if not (STANDIN / "h5py" / "__init__.py").is_file():
        raise FileNotFoundError(f"no h5py, and no stand-in at {STANDIN}")
    sys.path.insert(0, str(STANDIN))
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(STANDIN)] + [p for p in os.environ.get("PYTHONPATH", "")
                          .split(os.pathsep) if p])
    import h5py

    if Path(h5py.__file__).resolve().parent.parent != STANDIN:
        raise AssertionError(f"import h5py found {h5py.__file__}")
    log("io: no h5py on this machine: the streamed files go through the "
        "numpy stand-in tools/h5py_standin (raw arrays behind an HDF5 "
        "signature, not HDF5; first on sys.path and on every subprocess's "
        "PYTHONPATH); tests/test_torch_h5py_standin.py holds its files "
        "against real h5py's on the CPU")


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible")
    return card


def phase_build():
    from xmhw_tpu_torch.ops import _build

    t = time.perf_counter()
    so = _build.build()
    _build.library()
    log(f"build: {time.perf_counter() - t:.2f} s -> {so.name}")


def phase_kernels(card):
    """Each kernel against its plain version at the main path's shapes.
    Returns the rows of the kernels JSON line (launches filled later)."""
    import torch

    from xmhw_tpu_torch.core.calendar import build_window_ranges, compute_doy
    from xmhw_tpu_torch.core.clim import finish_clim
    from xmhw_tpu_torch.ops import detect_scan, doy_quantile, rle, run_bound
    from xmhw_tpu_torch.xrlite import TimeIndex

    t = daily(T0, T1)
    T = len(t)
    doy, ndoy = compute_doy(TimeIndex(t))
    starts, lens, ny, rmax = build_window_ranges(doy, 5, ndoy)
    ts = synth(T, CELLS, seed=1)
    ts[1000:1040, 5] = np.nan  # a NaN run inside a pool
    ts[:, 9] = np.nan          # an all-NaN cell
    x = torch.full((T + rmax, CELLS), float("nan"), device=DEV)
    x[:T] = torch.from_numpy(ts).to(DEV)
    st = torch.from_numpy(starts.reshape(-1)).to(DEV)
    ln = torch.from_numpy(lens.reshape(-1)).to(DEV)
    args1 = (x, st, ln, ndoy, ny, rmax)
    rows = []

    def row(name, src, replaces, err, fn, plain, moved, ops,
            library=(NO_LIBRARY, None)):
        ms, pms = cuda_ms(fn), cuda_ms(plain)
        bms, by = bound(moved, ops)
        call, lib = library
        lms = cuda_ms(lib) if lib is not None else None
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": 0,
                     "max_abs_err": err, "ms": ms, "plain_ms": pms,
                     "bound_ms": bms, "bound_by": by, "library_ms": lms,
                     "library_call": call})
        lib_txt = "none" if lms is None else f"{lms:.3f} ms"
        log(f"kernels: {name}: max |err| {err:.3g}, kernel {ms:.3f} ms, "
            f"plain {pms:.3f} ms, bound {bms:.4f} ms ({by}: "
            f"{moved / 1e6:.1f} MB, {ops:.3g} op), library {lib_txt} "
            f"[{call}]  [{card}]")

    thk, sek, err, moved, ops, library = clim_kernel(card, t, ts, args1)
    row("doy_quantile", "xmhw_tpu_torch/csrc/doy_quantile.cu",
        "xmhw_tpu/ops/pallas/doy_quantile.py:299", err,
        lambda: doy_quantile.doy_quantile(*args1),
        lambda: doy_quantile.doy_quantile_plain(*args1), moved, ops,
        library)

    th, se = finish_clim(thk, sek)
    pos = torch.from_numpy((doy - 1).astype(np.int32)).to(DEV)
    xt = x[:T]
    bthresh = xt > th.index_select(0, pos.long())
    fk, masks, shapes = rle_kernel(card, bthresh)
    nmax = int(fk["n_events"].max())
    log(f"kernels: rle: {int(fk['n_events'].sum())} events, at most "
        f"{nmax} in a cell (K = {K})")
    if nmax > K:
        raise AssertionError(f"{nmax} events in a cell overflow K = {K}")
    # the detect launch (days mode) is the row's shape; the counting launch
    # and today's full=False shape go beside it, each with its own bound
    days = RLE_MODES["days"][2]
    row("rle", "xmhw_tpu_torch/csrc/rle.cu",
        "xmhw_tpu/ops/pallas/rle.py:179", 0.0,
        rotating(rle.mhw_filter, masks, **days),
        rotating(rle.mhw_filter_plain, masks, **days),
        nbytes(bthresh, *fk.values()), bthresh.numel())
    rows[-1]["shape"] = "days: event_day, is_start, n_events"
    rows[-1]["shapes"] = shapes

    # run_bound: no path calls it, so its launches are this check's
    nb = ~bthresh
    run_bound.run_bound.launches = 0
    for mask in (bthresh, nb):
        run_bound_same(mask, "main block")
    launched = run_bound.run_bound.launches
    run_bound_edges(card, T, CELLS)
    # the yardstick: cummax/cummin of the masked day index, with the where
    # and the flips outside the timed window
    tt = torch.arange(T, dtype=torch.int32, device=DEV).view(T, 1)
    fwd = torch.where(nb, tt, -1)
    bwd = torch.flip(torch.where(nb, tt, T), (0,))
    row("run_bound", "xmhw_tpu_torch/csrc/run_bound.cu",
        "xmhw_tpu/ops/pallas/run_bound.py:88", 0.0,
        lambda: (run_bound.run_bound(nb, True),
                 run_bound.run_bound(nb, False)),
        lambda: (run_bound.run_bound_plain(nb, True),
                 run_bound.run_bound_plain(nb, False)),
        2 * (nbytes(nb) + 4 * nb.numel()), 2 * nb.numel(),  # int32 out
        ("torch.cummax(where(mask, t, -1)) + torch.cummin(flipped "
         "where(mask, t, T))",
         lambda: (torch.cummax(fwd, 0), torch.cummin(bwd, 0))))
    rows[-1].update(launches=launched, path="kernels phase only")
    per = {d: cuda_ms(lambda: run_bound.run_bound(nb, d == "forward"))
           for d in ("forward", "backward")}
    rows[-1]["directions_ms"] = per
    log("kernels: run_bound: forward and backward on the mask and its "
        "negation equal the plain version; times are one forward + "
        f"backward pair (forward {per['forward']:.3f} ms, backward "
        f"{per['backward']:.3f} ms)  [{card}]")

    args3 = (xt, th, se, pos, fk["event_day"], fk["is_start"], K)
    Fk, Ik = detect_scan.event_stats(*args3)
    Fp, Ip = detect_scan.event_stats_plain(*args3)
    if not torch.equal(Ik, Ip):
        raise AssertionError("event_scan positions: kernel != plain")
    err = max_err(Fk, Fp, "event_scan floats", TOL["scan"], TOL["scan"])
    row("detect_scan", "xmhw_tpu_torch/csrc/detect_scan.cu",
        "xmhw_tpu/ops/pallas/detect_scan.py:336", err,
        lambda: detect_scan.event_stats(*args3),
        lambda: detect_scan.event_stats_plain(*args3),
        nbytes(*args3[:6], Fk, Ik),
        len(detect_scan.F_CHANNELS) * xt.numel())
    scan_edges(card, xt, th, se, pos)
    f64 = f64_scan(card)["this checkout"]
    if any(f64["repeats"]):
        raise AssertionError(f"float64 plain event scan: {f64['repeats']} "
                             "entries differ from its first run")
    if set(f64["cpu"]) - {c for c in detect_scan.F_CHANNELS
                          if c.startswith("std_")}:
        raise AssertionError(f"float64 plain event scan: channels "
                             f"{f64['cpu']} differ from the CPU's")
    rows[-1]["plain_f64_ms"] = f64["ms"]
    rows.append(block_stats_kernels(card, t, xt, th, se, pos, Fk, Ik,
                                    fk["n_events"]))
    return rows


def block_stats_kernels(card, t, xt, th, se, pos, F, I, n_events):
    """The stats layer's two kernels (ops/block_stats.py) against their
    plain versions at the main path's shapes, as run_fused's stats stage
    calls them: the main block's event table in 40 one-year bins (slots
    binned by their start day's year) and its series' day statistics with
    the categories and NaN days. Bit for bit; each timed beside the plain
    version, and both together against their bound. Returns the
    ``block_stats`` row of the kernels JSON line (launches filled
    later)."""
    from xmhw_tpu_torch.core.features_scan import event_table
    from xmhw_tpu_torch.core.stats import EVENT_VARS, day_block_edges
    from xmhw_tpu_torch.ops import block_stats as bs

    T = len(t)
    table = event_table(F, I, n_events, T)
    years = t.astype("datetime64[Y]").astype(int) + 1970
    bins = np.arange(years[0], years[-1] + 2)
    ybod = _t((np.searchsorted(bins, years, side="right") - 1)
              .astype(np.int32)).to(DEV)
    vals = [table[k] for k in EVENT_VARS]
    calls = {
        "event": (bs.event_bins, bs.event_bins_plain,
                  (vals, table["time_start"], len(bins) - 1),
                  {"lut": ybod}),
        "day": (bs.day_bins, bs.day_bins_plain,
                (xt, day_block_edges(years, bins), th, se, pos),
                {"count_nans": True})}
    moved, out = 0, {}
    for name, (fn, plain, args, kw) in calls.items():
        got, want = fn(*args, **kw), plain(*args, **kw)
        for k in want:
            same_bits(got[k], want[k], f"block_stats {name} {k}")
        ins = ([*vals, table["time_start"], ybod] if name == "event"
               else [xt, th, se, pos])
        moved += nbytes(*ins, *got.values())
        out[name] = (cuda_ms(lambda: fn(*args, **kw)),
                     cuda_ms(lambda: plain(*args, **kw)))
    bms, by = bound(moved, 0)
    log(f"kernels: block_stats: event and day bins equal the plain "
        f"versions bit for bit; event kernel {out['event'][0]:.3f} ms "
        f"(plain {out['event'][1]:.3f}), day kernel {out['day'][0]:.3f} ms "
        f"(plain {out['day'][1]:.3f}); bound of both {bms:.4f} ms ({by}: "
        f"{moved / 1e6:.1f} MB)  [{card}]")
    return {"name": "block_stats", "route": "cuda",
            "source": "xmhw_tpu_torch/csrc/block_stats.cu",
            "replaces": "xmhw_tpu_torch/core/stats.py binned_event_stats, "
                        "binned_day_stats (XLA in the JAX package)",
            "launches": {}, "max_abs_err": 0.0,
            "ms": out["event"][0] + out["day"][0],
            "plain_ms": out["event"][1] + out["day"][1],
            "kernels_ms": {"event_bins": out["event"][0],
                           "day_bins": out["day"][0]},
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "library_call": NO_LIBRARY}


def f64_scan_inputs():
    """(ts, th, se, doy_pos, event_day, is_start, K) of the float64 event
    scan at the main path's shapes (T = 14,610, 4,096 cells, K = 128),
    from the plain versions alone: the synthetic field of phase_kernels,
    its float64 climatology from fused_threshold_detect (which runs the
    plain versions in float64) and the RLE's plain detect mode."""
    import torch

    from xmhw_tpu_torch.core.calendar import compute_doy
    from xmhw_tpu_torch.core.pipeline import fused_threshold_detect
    from xmhw_tpu_torch.ops import rle
    from xmhw_tpu_torch.xrlite import TimeIndex

    doy, ndoy = compute_doy(TimeIndex(daily(T0, T1)))
    pos = torch.from_numpy((doy - 1).astype(np.int32)).to(DEV)
    x = torch.from_numpy(synth(len(doy), CELLS, seed=1)).to(DEV).double()
    th, se, _, _ = fused_threshold_detect(x, doy, pos, K=K, ndoy=ndoy)
    f = rle.mhw_filter_plain(x > th[pos.long()], full=False, slot=False)
    return x, th, se, pos, f["event_day"], f["is_start"], K


def f64_scan(card, fns=None, cpu_cells=256):
    """The plain event scan in float64, what the card runs for float64, at
    the main path's shapes. ``fns``: labelled ``event_stats_plain``
    versions (default: this checkout's ops.detect_scan), timed in turns
    (forward, then backward). For each: how many output entries of two
    more runs differ from the first run's bits, the channels whose bits
    differ from this checkout's version on the CPU over ``cpu_cells``
    cells (each cell's sums do not depend on the others), and the
    CUDA-event time, the median of its turns' medians. Also float64
    ``torch.sqrt`` on the card and on the CPU against numpy's correctly
    rounded one. Returns {label: {"ms", "repeats", "cpu"}}."""
    import torch

    from xmhw_tpu_torch.ops import detect_scan

    fns = fns or {"this checkout": detect_scan.event_stats_plain}
    args = f64_scan_inputs()
    cpu_args = [a[..., :cpu_cells].cpu().contiguous()
                if torch.is_tensor(a) and a.shape[-1] == CELLS else
                a.cpu() if torch.is_tensor(a) else a for a in args]
    F_cpu, I_cpu = detect_scan.event_stats_plain(*cpu_args)
    same, differing = bits().same_bits, bits().differing
    out = {}
    for label, fn in fns.items():
        F0, I0 = fn(*args)
        repeats = []
        for _ in range(2):
            F, I = fn(*args)
            repeats.append(differing(F, F0) + differing(I, I0))
        cpu = [c for i, c in enumerate(detect_scan.F_CHANNELS)
               if not same(F0[i, :, :cpu_cells].cpu(), F_cpu[i])]
        if not torch.equal(I0[..., :cpu_cells].cpu(), I_cpu):
            cpu.append("positions")
        out[label] = {"repeats": repeats, "cpu": cpu, "turns": []}
    for turn in range(3):
        for label in (list(fns) if turn % 2 == 0 else list(fns)[::-1]):
            out[label]["turns"].append(cuda_ms(lambda: fns[label](*args)))
    v = torch.from_numpy(np.random.default_rng(0).random(100000) * 10)
    ref = torch.from_numpy(np.sqrt(v.numpy()))
    roots = {w: differing(torch.sqrt(v.to(w)).cpu(), ref)
             for w in (DEV, "cpu")}
    for label, o in out.items():
        o["ms"] = statistics.median(o.pop("turns"))
        log(f"kernels: detect_scan plain, float64 ({label}): "
            f"{int(args[5].sum())} events, {int(args[4].sum())} event days; "
            f"entries that differ from its first run in two more runs "
            f"{o['repeats']}; channels whose bits differ from the CPU over "
            f"{cpu_cells} cells {o['cpu']}; {o['ms']:.3f} ms (median of 3 "
            f"medians of {REPS})  [{card}]")
    log(f"kernels: float64 torch.sqrt of {v.numel()} values against numpy's "
        f"correctly rounded root: {roots[DEV]} differ on the card, "
        f"{roots['cpu']} on the CPU")
    return out


def clim_kernel(card, t, ts, args):
    """Kernel 1 against its plain version: thresholds bit-equal, means
    within one float32 ulp (both round a float64 sum once, summed in
    another order), at pctile 90, 87.5 and 10 on the main path's 40-year
    block ``args``, on the 30-year climatology's tables the slice uses, on
    a block of edge pools and on the largest pool its shared tile holds. Also
    the radix steps the common-prefix skip saves over the 40-year block,
    and the yardstick torch.nanquantile + torch.nanmean on its gathered
    pool. Returns the 40-year pctile-90 outputs, the largest |err|, the
    bytes and operations of the bound and the yardstick."""
    import torch

    from xmhw_tpu_torch.core.calendar import build_window_ranges, compute_doy
    from xmhw_tpu_torch.ops import doy_quantile as dq
    from xmhw_tpu_torch.xrlite import TimeIndex

    edges = doy_edges()

    def tables(tv, w=5):
        doy, ndoy = compute_doy(TimeIndex(tv))
        starts, lens, ny, rmax = build_window_ranges(doy, w, ndoy)
        return starts, lens, ndoy, ny, rmax

    def padded(a, rmax):
        x = torch.full((a.shape[0] + rmax, a.shape[1]), float("nan"),
                       device=DEV)
        x[:a.shape[0]] = torch.from_numpy(a).to(DEV)
        return x

    def case(x, starts, lens, ndoy, ny, rmax):
        return (x, torch.from_numpy(starts.reshape(-1)).to(DEV),
                torch.from_numpy(lens.reshape(-1)).to(DEV), ndoy, ny, rmax)

    years = t.astype("datetime64[Y]").astype(int) + 1970
    sel = (years >= CLIM_YEARS[0]) & (years <= CLIM_YEARS[1])
    t30 = tables(t[sel])
    big = edges.largest_pool()
    blocks = {
        "40 years": args,
        "30-year climatology": case(padded(np.ascontiguousarray(ts[sel]),
                                           t30[4]), *t30),
        "edge pools": case(padded(edges.edge_series(len(t), CELLS, seed=4),
                                  args[5]), *tables(t)),
        "largest pool": case(padded(edges.edge_series(3000, CELLS, seed=5),
                                    big[3]), big[0], big[1], len(big[0]),
                             big[2], big[3]),
    }
    worst = 0.0
    for label, a in blocks.items():
        errs = []
        for p in PCTILES:
            thk, sek = dq.doy_quantile(*a, pctile=p)
            thp, sep = dq.doy_quantile_plain(*a, pctile=p)
            same_bits(thk, thp, f"doy_quantile {label} pctile {p} thresh")
            errs.append(ulps(sek, sep, f"doy_quantile {label} pctile {p} "
                                       "seas"))
            if a is args:  # max_abs_err of the JSON line: the main block
                worst = max(worst, max_err(sek, sep, "seas", float("inf")))
        ms = cuda_ms(lambda: dq.doy_quantile(*a))
        Z = a[4] * a[5]
        log(f"kernels: doy_quantile {label} ({a[3]} doys x {CELLS} cells, "
            f"pools of up to {Z} values): thresholds bit-equal, seas within "
            f"{max(errs):.2f} ulp at pctile {list(PCTILES)}; kernel "
            f"{ms:.3f} ms (pctile 90, median of {REPS})  [{card}]")

    x, st, ln, ndoy, ny, rmax = args
    pool = dq.gather_pool(*args)
    saved = torch.cat([edges.skipped_steps(pool[d:d + 61])
                       for d in range(0, ndoy, 61)])
    saved = saved[saved >= 0].float()
    log(f"kernels: doy_quantile common-prefix skip over the 40-year SST "
        f"block: radix steps saved per pool min {int(saved.min())}, median "
        f"{float(saved.median()):.0f}, mean {float(saved.mean()):.2f}, max "
        f"{int(saved.max())} of 32 ({saved.numel()} pools)")
    ops = 2 * int(torch.isfinite(pool).sum())  # a compare and an add each
    thk, sek = dq.doy_quantile(*args)

    def library():
        return (torch.nanquantile(pool, 0.9, dim=1, interpolation="linear"),
                torch.nanmean(pool, dim=1))

    lq, lm = library()
    log(f"kernels: doy_quantile yardstick torch.nanquantile + nanmean on "
        f"the gathered {tuple(pool.shape)} pool ({nbytes(pool) / 1e9:.2f} "
        f"GB, gathered outside the timed window): max |diff| from the "
        f"kernel thresh {max_err(lq, thk, 'nanquantile', float('inf')):.3g},"
        f" seas {max_err(lm, sek, 'nanmean', float('inf')):.3g} (its "
        f"float32 interpolation rounds otherwise; not asserted)")
    call = ("torch.nanquantile(pool, 0.9, dim=1, interpolation='linear') + "
            "torch.nanmean(pool, dim=1)")
    return thk, sek, worst, nbytes(*args[:3], thk, sek), ops, (call, library)


def run_bound_same(mask, what):
    """Kernel 4 equals its plain version bit for bit on ``mask``, forward
    and backward."""
    import torch

    from xmhw_tpu_torch.ops import run_bound

    for fwd in (True, False):
        if not torch.equal(run_bound.run_bound(mask, fwd),
                           run_bound.run_bound_plain(mask, fwd)):
            raise AssertionError(f"run_bound {what} forward={fwd}: kernel "
                                 "!= plain")


def run_bound_edges(card, T, C):
    """Kernel 4's launch shape at T days, and the kernel against its
    plain version on the segment-edge cases of
    tests/test_torch_run_bound_edges.py at their card shapes, on each mask
    and its negation."""
    import torch

    from xmhw_tpu_torch.ops import run_bound

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import test_torch_run_bound_edges as edges

    cfg = run_bound.launch_config(T)
    if cfg["warps"] != edges.WARPS:
        raise AssertionError(f"run_bound runs {cfg['warps']} warps, the "
                             f"edge cases assume {edges.WARPS}")
    log(f"kernels: run_bound launch: {cfg['warps']} warps (time segments "
        f"of {cfg['days']} days) per block, {cfg['threads']} threads, "
        f"{cfg['smem_bytes']} B of shared memory, {-(-C // 32)} blocks")
    for name, case in edges.CASES.items():
        m = torch.from_numpy(edges.edge_mask(name, case.T_card,
                                             case.C_card)).to(DEV)
        for mask in (m, ~m):
            run_bound_same(mask, name)
    log(f"kernels: run_bound on the {len(edges.CASES)} segment-edge cases "
        "(T = 14,610 x 64 cells; 1 and 33 cells; T = 1, 5, 33; 60,000 "
        "days), each mask and its negation: bit-equal to plain, forward and "
        "backward")


# the RLE's output modes: kernel wrapper, plain version, keywords
RLE_MODES = {
    "count": ("event_counts", "event_counts_plain", {}),
    "days": ("mhw_filter", "mhw_filter_plain", {"full": False,
                                                "slot": False}),
    "slots": ("mhw_filter", "mhw_filter_plain", {"full": False}),
    "full": ("mhw_filter", "mhw_filter_plain", {}),
}


def rotating(fn, masks, **kw):
    """fn on the next mask of ``masks`` at each call: timed launches read
    a mask that is not in the 50 MB L2."""
    it = itertools.cycle(masks)
    return lambda: fn(next(it), **kw)


def rle_same(b, kw, what):
    """Kernel 2 equals its plain version bit for bit on mask ``b`` in
    every output mode; returns the days mode's outputs."""
    import torch

    from xmhw_tpu_torch.ops import rle

    for mode, (kernel, plain, extra) in RLE_MODES.items():
        k = getattr(rle, kernel)(b, **kw, **extra)
        p = getattr(rle, plain)(b, **kw, **extra)
        if sorted(k) != sorted(p):
            raise AssertionError(f"rle {what} {mode}: keys {sorted(k)}")
        for name in p:
            if not torch.equal(k[name], p[name]):
                raise AssertionError(f"rle {what} {mode} {name}: kernel != "
                                     "plain")
        if mode == "days":
            out = k
    return out


def rle_kernel(card, bthresh):
    """Kernel 2 against its plain version, bit for bit in every output
    mode, on the main block and on the segment-edge cases of
    tests/test_torch_rle_edges.py at their card shapes (T = 14,610 x 64
    cells but for the short series); its launch shape; the times of the
    counting launch and of today's full=False shape (slots), each against
    its own bound, on three masks in turn (180 MB, past the L2). Returns
    the days mode's outputs on the main block, the masks and the shapes'
    times."""
    import torch

    from xmhw_tpu_torch.ops import rle

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import test_torch_rle_edges as edges

    T, C = bthresh.shape
    out = rle_same(bthresh, {}, "main block")
    cfg = rle.launch_config(T)
    log(f"kernels: rle launch: {cfg['warps']} warps (time segments of "
        f"{cfg['days']} days) per block, {cfg['threads']} threads, "
        f"{cfg['smem_bytes']} B of shared memory, {-(-C // 32)} blocks")
    for name, case in edges.CASES.items():
        b = torch.from_numpy(edges.edge_mask(name, case.T_card,
                                             case.C_card)).to(DEV)
        rle_same(b, edges.kwargs(name), name)
    log(f"kernels: rle on the {len(edges.CASES)} segment-edge cases "
        "(T = 14,610 x 64 cells; 33 and 128 cells; T = 1, 7, 15): bit-equal "
        f"to plain in the modes {list(RLE_MODES)}")
    masks = [bthresh] + [torch.roll(bthresh, (1000 * i, 7 * i), (0, 1))
                         .contiguous() for i in (1, 2)]
    shapes = {}
    for mode in ("count", "slots"):
        kernel, plain, extra = RLE_MODES[mode]
        kernel, plain = getattr(rle, kernel), getattr(rle, plain)
        moved = nbytes(bthresh, *kernel(bthresh, **extra).values())
        ms = cuda_ms(rotating(kernel, masks, **extra))
        pms = cuda_ms(rotating(plain, masks, **extra))
        bms, by = bound(moved, bthresh.numel())
        shapes[mode] = {"ms": ms, "plain_ms": pms, "bound_ms": bms,
                        "bound_by": by}
        log(f"kernels: rle {mode} shape: kernel {ms:.3f} ms, plain "
            f"{pms:.3f} ms, bound {bms:.4f} ms ({by}: {moved / 1e6:.1f} "
            f"MB)  [{card}]")
    return out, masks, shapes


def edge_mask(T, C, warps):
    """(T, C) bool: a run across every segment edge of the event-scan
    kernel (warps segments of ceil(T / warps) days) in every cell, starting
    1-5 days before the edge, and a run over three segments in every 64th
    cell."""
    L = -(-T // warps)
    m = np.zeros((T, C), bool)
    c = np.arange(C)
    for e in range(L, T, L):
        s, n = e - 1 - c % 5, 6 + c % 13
        for d in range(n.max()):
            ok = (d < n) & (s + d < T)
            m[(s + d)[ok], c[ok]] = True
    m[L // 2:L // 2 + int(3.3 * L), ::64] = True
    return m


def scan_edges(card, xt, th, se, pos):
    """The event scan on events that cross every segment edge of the
    kernel, at the main path's shapes: kernel against plain, and times."""
    import torch

    from xmhw_tpu_torch.ops import detect_scan, rle

    cfg = detect_scan.launch_config()
    T, C = xt.shape
    L = -(-T // cfg["warps"])
    log(f"kernels: detect_scan launch: {cfg['warps']} warps (time "
        f"segments of {L} days) per block, {cfg['threads']} threads, "
        f"{cfg['smem_bytes']} B of dynamic shared memory, {-(-C // 32)} "
        "blocks")
    th_t = th.index_select(0, pos.long())
    m = torch.from_numpy(edge_mask(T, C, cfg["warps"])).to(DEV)
    xe = torch.where(m, torch.maximum(xt, th_t) + 0.3, xt)
    f = rle.mhw_filter_plain(xe > th_t, full=False)
    day = f["event_day"]
    E = torch.arange(L, T, L, device=DEV)
    live = ~torch.isnan(xt).all(dim=0)
    if not bool((day[E - 1] & day[E])[:, live].all()):
        raise AssertionError("segment-edge mask: an edge without an event")
    args = (xe, th, se, pos, day, f["is_start"], K)
    Fk, Ik = detect_scan.event_stats(*args)
    Fp, Ip = detect_scan.event_stats_plain(*args)
    if not torch.equal(Ik, Ip):
        raise AssertionError("event_scan edges positions: kernel != plain")
    err = max_err(Fk, Fp, "event_scan edges floats", TOL["scan"],
                  TOL["scan"])
    ms = cuda_ms(lambda: detect_scan.event_stats(*args))
    pms = cuda_ms(lambda: detect_scan.event_stats_plain(*args))
    log(f"kernels: detect_scan on events across all {len(E)} segment edges "
        f"of {int(live.sum())} cells ({int(f['n_events'].sum())} events, "
        f"at most {int(f['n_events'].max())} in a cell, K = {K}): positions "
        f"equal, max |err| {err:.3g}, kernel {ms:.3f} ms, plain {pms:.3f} "
        f"ms  [{card}]")


def ocean_of(da):
    """(lat, lon) bool mask of cells that are not all-NaN."""
    return ~np.isnan(da.data).all(axis=0)


def tables_close(a, b, what):
    """Compare two compact event Datasets variable by variable: times
    exactly, floats within the event-scan tolerance."""
    for k in a.keys():
        x, y = np.asarray(a[k].data), np.asarray(b[k].data)
        if x.shape != y.shape:
            raise AssertionError(f"{what} {k}: shapes {x.shape} {y.shape}")
        if np.issubdtype(x.dtype, np.datetime64):
            if not np.array_equal(x.astype("i8"), y.astype("i8")):
                raise AssertionError(f"{what} {k}: not equal")
            continue
        max_err(_t(x), _t(y), f"{what} {k}", TOL["scan"], TOL["scan"])


def phase_reference(card):
    """threshold()+detect() on a small grid: the card's float32 kernels
    against the plain torch code on the CPU."""
    import xmhw_tpu_torch as xt

    da = grid(daily("2000-01-01", "2010-01-01"), 6, 8, seed=2, land=8)
    out = {}
    for dev in (DEV, "cpu"):
        clim = xt.threshold(da, device=dev)
        mhw = xt.detect(da, clim["thresh"], clim["seas"], device=dev,
                        events_layout="compact")
        out[dev] = clim, mhw
    (cg, mg), (cc, mc) = out[DEV], out["cpu"]
    e1 = max_err(*(_t(c["thresh"].data) for c in (cg, cc)),
                 "reference thresh", TOL["thresh"])
    e2 = max_err(*(_t(c["seas"].data) for c in (cg, cc)),
                 "reference seas", TOL["seas"])
    tables_close(mg, mc, "reference")
    n = int(np.isfinite(mg["duration"].data).sum())
    log(f"reference: 40 cells x 10 years, card vs CPU: thresh {e1:.3g}, "
        f"seas {e2:.3g}, {n} events agree  [{card}]")
    if n == 0:
        raise AssertionError("reference grid found no events")
    # float64 runs the plain versions on the card: the same bits each run
    runs = {}
    for label, dev in (("card", DEV), ("again", DEV), ("cpu", "cpu")):
        clim = xt.threshold(da, device=dev, dtype=np.float64)
        runs[label] = [clim, xt.detect(da, clim["thresh"], clim["seas"],
                                       device=dev, dtype=np.float64,
                                       events_layout="compact")]
    for what, a, b in zip(("clim", "events"), runs["card"], runs["again"]):
        same_data(a, b, f"reference float64 {what}, two runs on the card:")
    cpu = [bits_differ(a, b) for a, b in zip(runs["card"], runs["cpu"])]
    log(f"reference: float64 threshold+detect twice on the card: the same "
        f"bits; card vs CPU bits: clim "
        f"{'equal' if not cpu[0] else 'differ in ' + str(cpu[0])}, events "
        f"{'equal' if not cpu[1] else 'differ in ' + str(cpu[1])}  [{card}]")


def bits_differ(a, b):
    """The variables of two Datasets whose data differ bit for bit (NaN
    and NaT where the other has them; -0.0 apart from +0.0). Raises when
    they hold other variables."""
    if sorted(a.keys()) != sorted(b.keys()):
        raise AssertionError(f"variables {sorted(a.keys())} != "
                             f"{sorted(b.keys())}")
    same = bits().np_same_bits
    return [k for k in a.keys() if not same(a[k].data, b[k].data)]


def _t(a):
    import torch

    return torch.from_numpy(np.asarray(a))


STATS_KERNELS = ("event_bins", "day_bins")


def reset_launches():
    from xmhw_tpu_torch.ops import block_stats, detect_scan, doy_quantile, rle

    doy_quantile.reset_launches()
    detect_scan.event_stats.launches = 0
    rle.reset_launches()
    block_stats.event_bins.launches = 0
    block_stats.day_bins.launches = 0


def read_launches():
    from xmhw_tpu_torch.ops import block_stats, detect_scan, doy_quantile, rle

    return {"doy_quantile": doy_quantile.doy_quantile.launches,
            "rle": rle.mhw_filter.launches,
            "detect_scan": detect_scan.event_stats.launches,
            "event_bins": block_stats.event_bins.launches,
            "day_bins": block_stats.day_bins.launches}


def stats_part(launches):
    """The stats kernels' launches of a read_launches() dict."""
    return {k: launches.get(k, 0) for k in STATS_KERNELS}


def counts():
    """A copy of the port's counters (:func:`xmhw_tpu_torch.utils.counts`)."""
    from xmhw_tpu_torch.utils import counts as now

    return now()


def blocks_since(before):
    """The shard-blocks detected (``detect_blocks``) since the counters
    ``before``: one stats launch of each kernel apiece in a run_fused
    with a stats stage."""
    return counts().get("detect_blocks", 0) - before.get("detect_blocks", 0)


def check_launches(what, launches, stats=0):
    """Kernels 1-3 launched, and each stats kernel ``stats`` times (0: a
    path without a stats stage, or a float64 one)."""
    missing = [k for k, v in launches.items()
               if v == 0 and k not in STATS_KERNELS]
    got = stats_part(launches)
    if missing or got != dict.fromkeys(STATS_KERNELS, stats):
        raise AssertionError(f"{what}: kernels not launched: {missing}; "
                             f"stats kernels {got}: want {stats} each")


def phase_slice(card, da):
    """The main path: threshold() then detect(), as a user calls them."""
    import torch

    import xmhw_tpu_torch as xt

    reset_launches()
    t0 = time.perf_counter()
    clim = xt.threshold(da, climatologyPeriod=CLIM_YEARS, device=DEV)
    t1 = time.perf_counter()
    mhw = xt.detect(da, clim["thresh"], clim["seas"], device=DEV,
                    events_layout="compact")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_launches()
    ocean = ocean_of(da)
    C = int(ocean.sum())
    wall = t2 - t0
    log(f"slice: threshold+detect of {C} cells x {da.sizes['time']} days "
        f"in {wall:.3f} s (threshold {t1 - t0:.3f} s, detect "
        f"{t2 - t1:.3f} s) = {C / wall:.1f} cells/s; launches {launches}  "
        f"[{card}]")
    check_launches("slice", launches)
    from xmhw_tpu_torch.ops import rle

    # one block: the counting launch (no per-day output), then the detect
    # launch (event_day and is_start, no slot)
    by_mode = dict(rle.mhw_filter.by_mode)
    if by_mode != {"count": 1, "days": 1, "slots": 0, "full": 0}:
        raise AssertionError(f"rle launches by mode {by_mode}: want one "
                             "count and one days launch")
    log(f"slice: rle launches by output mode {by_mode}")
    th = clim["thresh"].data[:, ocean]
    if th.shape != (366, C) or not np.isfinite(th).all():
        raise AssertionError(f"thresholds: shape {th.shape} or non-finite")
    dur = mhw["duration"].data[:, ocean]
    n_table = np.isfinite(dur).sum(axis=0)
    n_raw = raw_counts(da, clim, ocean)
    if not np.array_equal(n_table, n_raw):
        raise AssertionError("event tables lost events (K overflow)")
    log(f"slice: {int(n_table.sum())} events, {int(n_table.max())} at most "
        f"in a cell, table holds every one")
    if n_table.sum() == 0:
        raise AssertionError("the slice found no events")
    return clim, mhw, launches


def raw_counts(da, clim, ocean):
    """Events per ocean cell by the plain RLE on the card (independent of
    the event table), from the slice's own climatology."""
    import torch

    from xmhw_tpu_torch.core.calendar import compute_doy
    from xmhw_tpu_torch.ops import rle
    from xmhw_tpu_torch.xrlite import TimeIndex

    doy, _ = compute_doy(TimeIndex(np.asarray(da.coords["time"].values)))
    ts = torch.from_numpy(np.ascontiguousarray(da.data[:, ocean])).to(DEV)
    th = torch.from_numpy(
        np.ascontiguousarray(clim["thresh"].data[:, ocean])).to(DEV)
    pos = torch.from_numpy(doy - 1).to(DEV)
    return rle.event_counts_plain(ts > th[pos])["n_events"].cpu().numpy()


def day_series(da, clim):
    """The dstime of block_average as detect's intermediate gives it: ts,
    and thresh and seas on the time axis."""
    from xmhw_tpu_torch.core.calendar import compute_doy
    from xmhw_tpu_torch.xrlite import Dataset, TimeIndex

    for d in ("lat", "lon"):
        if not np.array_equal(clim["thresh"].coords[d].values,
                              da.coords[d].values):
            raise AssertionError(f"clim {d} differs from the series'")
    doy, _ = compute_doy(TimeIndex(np.asarray(da.coords["time"].values)))
    ds = Dataset()
    ds["ts"] = da
    for v in ("thresh", "seas"):
        ds[v] = da.copy(data=clim[v].data[doy - 1])
    return ds


def stats_agree(got, want, what):
    """Card vs host statistics: the same variables and NaN patterns,
    counts exactly equal, floats within STATS_TOL. Returns the largest
    |difference| of each kind."""
    if sorted(got.keys()) != sorted(want.keys()):
        raise AssertionError(f"{what}: variables {sorted(got.keys())} != "
                             f"{sorted(want.keys())}")
    errs = {"count": 0.0, "day": 0.0, "event": 0.0}
    for k in want.keys():
        a, b = _t(got[k].data), _t(want[k].data)
        if k == "ecount" or k.endswith("_days"):
            kind, atol, rtol = "count", 0.0, 0.0
        elif k in DAY_STATS:
            kind, atol, rtol = "day", 0.0, STATS_TOL["day"]
        else:
            kind, atol = "event", STATS_TOL["event"]
            rtol = atol
        errs[kind] = max(errs[kind], max_err(a, b, f"{what} {k}", atol,
                                             rtol))
    return errs


def phase_stats(card, da, clim, mhw):
    """block_average() and mhw_rank() of the slice on the card against the
    host numpy path (device=False), as a user calls them."""
    import torch

    import xmhw_tpu_torch as xt

    dstime = day_series(da, clim)
    out = {}
    for label, kw in (("years", dict(dstime=dstime)),
                      ("5-year", dict(period=[1982, 2021], blockLength=5))):
        reset_launches()
        t = time.perf_counter()
        dev = xt.block_average(mhw, device=DEV, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        # float32 event tables: one event-bin launch; the day path is
        # float64 (plain)
        got = stats_part(read_launches())
        if got != {"event_bins": 1, "day_bins": 0}:
            raise AssertionError(f"block_average {label}: stats kernels "
                                 f"{got}: want one event-bin launch")
        host = xt.block_average(mhw, device=False, **kw)
        t2 = time.perf_counter()
        errs = stats_agree(dev, host, f"block_average {label}")
        log(f"stats: block_average {label} blocks {dev['ecount'].shape}: "
            f"card {t1 - t:.3f} s, host {t2 - t1:.3f} s; max |diff| "
            f"counts {errs['count']:.3g}, day {errs['day']:.3g}, event "
            f"{errs['event']:.3g}  [{card}]")
        out[label] = dev
    t = time.perf_counter()
    rank, ret = xt.mhw_rank(mhw, device=DEV)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    hrank, hret = xt.mhw_rank(mhw, device=False)
    t2 = time.perf_counter()
    for k in hrank.keys():
        for a, b, what in ((rank, hrank, "rank"), (ret, hret, "return")):
            if not np.array_equal(a[k].data, b[k].data, equal_nan=True):
                raise AssertionError(f"mhw_rank {what} {k}: card != host")
    log(f"stats: mhw_rank of {len(hrank.keys())} variables: card "
        f"{t1 - t:.3f} s, host {t2 - t1:.3f} s; ranks and return periods "
        f"equal  [{card}]")
    if not np.nansum(out["years"]["ecount"].data) > 0:
        raise AssertionError("block_average counted no events")
    out["rank"] = rank
    return out


def phase_fused(card, da, clim, mhw, stats):
    """run_fused (one upload per block) with its stats stage must
    reproduce the slice, its block_average and its mhw_rank. Returns its
    outputs, its wall and the stats kernels' launches."""
    from xmhw_tpu_torch.core.features_scan import TABLE_VARS

    ocean = ocean_of(da)
    tvals = np.asarray(da.coords["time"].values)
    years = tvals.astype("datetime64[Y]").astype(int) + 1970
    bins = np.arange(years[0], years[-1] + 2)
    ts = np.ascontiguousarray(da.data[:, ocean])
    reset_launches()
    before = counts()
    out, wall = fused_run(da)
    th, se, tables, nev, extras = out
    launches = read_launches()
    blocks = blocks_since(before)
    if blocks < 1:
        raise AssertionError(f"run_fused counted {blocks} detect blocks")
    check_launches("run_fused", launches, blocks)
    for name, a in (("thresh", th), ("seas", se)):
        if not np.array_equal(a, clim[name].data[:, ocean], equal_nan=True):
            raise AssertionError(f"fused {name} != slice")
    kmax = mhw["duration"].sizes["ev"]
    if not np.array_equal(nev, np.isfinite(
            mhw["duration"].data[:, ocean]).sum(axis=0)):
        raise AssertionError("fused n_events != slice")
    for k in TABLE_VARS:
        if k.startswith("time_"):
            continue
        a = tables[k][:kmax].astype(np.float64)
        b = np.asarray(mhw[k].data[:, ocean], np.float64)
        if not np.array_equal(a, b, equal_nan=True):
            raise AssertionError(f"fused table {k} != slice")
    errs = fused_stats_agree(extras, stats, ocean, ts, years, bins, kmax)
    log(f"fused: run_fused reproduces the slice bit for bit and its "
        f"block_average/mhw_rank (max |diff| {errs:.3g}; {ts.shape[1]} "
        f"cells, {len(bins) - 1} year blocks, ranks of {list(RANKED)} in "
        f"{wall:.3f} s; launches {launches}, {blocks} block(s))  [{card}]")
    return out, wall, stats_part(launches)


def fused_run(da, mesh=None, copies=1):
    """run_fused over the ocean cells of ``da`` (side by side ``copies``
    times) with the slice's climatology period and its stats stage
    (one-year blocks, nan_days, ranks of RANKED), as phase_fused drives
    it; ``mesh`` splits each block. Returns (its outputs, the wall in s,
    synchronised)."""
    import torch

    from xmhw_tpu_torch.core.calendar import compute_doy
    from xmhw_tpu_torch.core.pipeline import run_fused
    from xmhw_tpu_torch.core.stats import day_block_edges
    from xmhw_tpu_torch.xrlite import TimeIndex

    ocean = ocean_of(da)
    tvals = np.asarray(da.coords["time"].values)
    doy, _ = compute_doy(TimeIndex(tvals))
    years = tvals.astype("datetime64[Y]").astype(int) + 1970
    sel = (years >= CLIM_YEARS[0]) & (years <= CLIM_YEARS[1])
    bins = np.arange(years[0], years[-1] + 2)
    ts = np.ascontiguousarray(np.tile(da.data[:, ocean], (1, copies)))
    t = time.perf_counter()
    out = run_fused(
        ts, doy, (doy - 1).astype(np.int32), ts_clim_np=ts[sel],
        doy_clim_np=doy[sel], ybod_np=(years - bins[0]).astype(np.int32),
        nbins=len(bins) - 1, day_edges=day_block_edges(years, bins),
        count_nans=True, rank_names=RANKED, mesh=mesh, device=DEV)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def slice_run(da, **kw):
    """threshold() then detect() of ``da`` as phase_slice calls them, with
    the keywords ``kw`` (``mesh``, ``device``). Returns (clim, mhw, wall in
    s, synchronised)."""
    import torch

    import xmhw_tpu_torch as xt

    t = time.perf_counter()
    clim = xt.threshold(da, climatologyPeriod=CLIM_YEARS, **kw)
    mhw = xt.detect(da, clim["thresh"], clim["seas"], events_layout="compact",
                    **kw)
    torch.cuda.synchronize()
    return clim, mhw, time.perf_counter() - t


def same_data(a, b, what):
    """Two Datasets hold the same variables with equal data, bit for bit
    (:func:`bits_differ`)."""
    bad = bits_differ(a, b)
    if bad:
        raise AssertionError(f"{what} {bad}: not bit-equal")


def same_fused(a, b, what):
    """Two run_fused outputs are equal bit for bit."""
    for name, x, y in (("thresh", a[0], b[0]), ("seas", a[1], b[1]),
                       ("n_events", a[3], b[3])):
        if not np.array_equal(x, y, equal_nan=True):
            raise AssertionError(f"{what} {name}: not bit-equal")
    pairs = [(("tbl", k), a[2][k], b[2].get(k)) for k in a[2]]
    pairs += [((part, k), v, b[4].get(part, {}).get(k))
              for part, d in a[4].items() for k, v in d.items()]
    for key, x, y in pairs:
        if y is None or not np.array_equal(x, y, equal_nan=True):
            raise AssertionError(f"{what} {key}: not bit-equal")


def phase_mesh(card, da, clim, mhw, fused):
    """The slice over a cell mesh of [cuda:0, cuda:0] (and of every GPU
    when more than one is visible): threshold() + detect() and run_fused
    with its stats stage must equal the single-device runs bit for bit,
    and every kernel must launch once per shard. Walls of one device and
    of the mesh, in turns. Kernel 4 on the mesh's shards of the slice's
    exceedance mask (make_cell_array). Returns each kernel's launches in
    the mesh run of threshold() + detect() (kernel 4: on the shards; the
    stats kernels: in the [cuda:0, cuda:0] run_fused, as ``block_stats``)."""
    import torch

    from xmhw_tpu_torch.core.calendar import compute_doy
    from xmhw_tpu_torch.ops import rle, run_bound
    from xmhw_tpu_torch.parallel import cell_mesh, make_cell_array
    from xmhw_tpu_torch.xrlite import TimeIndex

    n_dev = torch.cuda.device_count()
    one = f"{DEV}:0" if DEV == "cuda" else DEV
    meshes = {"[cuda:0, cuda:0]": cell_mesh([one, one])}
    if n_dev > 1:
        meshes[f"all {n_dev} GPUs"] = cell_mesh()
    first_counts = stats = None
    for label, mesh in meshes.items():
        n = len(mesh)
        want = {"doy_quantile": n, "rle": 2 * n, "detect_scan": n,
                "event_bins": 0, "day_bins": 0}
        # run_fused: one step of n shards, each with its stats stage
        want_fused = dict(want, event_bins=n, day_bins=n)

        def mesh_slice():
            c, m, w = slice_run(da, mesh=mesh)
            for v in ("thresh", "seas"):
                if not np.array_equal(c[v].data, clim[v].data,
                                      equal_nan=True):
                    raise AssertionError(f"mesh {label} {v} != slice")
            same_data(m, mhw, f"mesh {label} events")
            return w

        # the first mesh run: its launches, one per shard (and a warm-up)
        reset_launches()
        first = mesh_slice()
        got = read_launches()
        by_mode = dict(rle.mhw_filter.by_mode)
        if got != want or by_mode["count"] != n:
            raise AssertionError(f"mesh {label} launches {got} (rle by mode "
                                 f"{by_mode}): want {want}, one per shard")
        first_counts = first_counts or got
        walls = {"one": [], "mesh": []}
        for who in ("one", "mesh", "mesh", "one"):
            walls[who].append(mesh_slice() if who == "mesh" else
                              slice_run(da, device=one)[2])
        reset_launches()
        out, w = fused_run(da, mesh=mesh)
        fused_got = read_launches()
        if fused_got != want_fused:
            raise AssertionError(f"mesh {label} run_fused launches "
                                 f"{fused_got}: want {want_fused}")
        stats = stats or stats_part(fused_got)
        same_fused(fused[0], out, f"mesh {label} run_fused")
        log(f"mesh: {label}: threshold+detect equal the single-device "
            f"slice bit for bit; first mesh run {first:.3f} s, then walls "
            f"in turns: one device {walls['one'][0]:.3f}, "
            f"{walls['one'][1]:.3f} s, mesh {walls['mesh'][0]:.3f}, "
            f"{walls['mesh'][1]:.3f} s; run_fused with stats and ranks "
            f"bit-equal in {w:.3f} s (one device {fused[1]:.3f} s, stats "
            f"kernels {stats_part(fused_got)}); "
            f"launches {got} (one per shard); {n_dev} CUDA device(s) "
            f"visible  [{card}]")
    # at twice the slice's width each device gets a 4,096-cell block, the
    # production width: the one-device run takes two blocks, the mesh one
    # step of two shards; one untimed run each first
    mesh = meshes["[cuda:0, cuda:0]"]
    wide = {"one device": [], "mesh": []}
    outs = {}
    for i, who in enumerate(("one device", "mesh") * 2 +
                            ("mesh", "one device")):
        outs[who], w = fused_run(da, mesh=mesh if who == "mesh" else None,
                                 copies=2)
        if i >= 2:
            wide[who].append(w)
    same_fused(outs["one device"], outs["mesh"], "mesh run_fused, twice "
               "the slice")
    one_w, mesh_w = wide["one device"], wide["mesh"]
    log(f"mesh: run_fused with stats over {len(outs['mesh'][3])} cells "
        f"(the slice twice; 4,096 cells a device), after one run each: one "
        f"device {one_w[0]:.3f}, {one_w[1]:.3f} s, mesh [cuda:0, cuda:0] "
        f"{mesh_w[0]:.3f}, {mesh_w[1]:.3f} s; bit-equal  [{card}]")
    # kernel 4 on the shards of the slice's exceedance mask
    ocean = ocean_of(da)
    doy, _ = compute_doy(TimeIndex(np.asarray(da.coords["time"].values)))
    above = (da.data[:, ocean] > clim["thresh"].data[:, ocean][doy - 1])
    shards = make_cell_array(mesh, above.shape, lambda idx: above[idx])
    run_bound.run_bound.launches = 0
    for mask in shards:
        run_bound_same(mask, "mesh shard")
    bounds = run_bound.run_bound.launches
    if bounds != 2 * len(mesh):
        raise AssertionError(f"run_bound launched {bounds} times on the "
                             "mesh's shards")
    log(f"mesh: run_bound on the {len(shards)} shards "
        f"{[tuple(t.shape) for t in shards]} of the slice's exceedance mask "
        f"(make_cell_array): bit-equal to plain, {bounds} launches  "
        f"[{card}]")
    return dict(first_counts, run_bound=bounds, block_stats=stats)


def phase_procs(card, years=40, cells=CELLS, k=K):
    """tools/torch_multiproc_dryrun.py with two ranks on the card at the
    slice's size: each rank's launch counters advance by one a kernel (the
    RLE's in its detect mode), its shard equals the one-process step bit
    for bit (checked by the tool), its kernels' outputs agree with the
    plain version's on its shard at TOL (counts and positions exact), and
    the all_reduced total equals the one-process step's. Then the streamed
    two-process tool on the card (banded stream_run, merged files
    byte-equal to one process's). Returns each kernel's launches per rank
    of the dryrun."""
    import torch

    root = Path(__file__).resolve().parent
    cmd = [sys.executable, str(root / "tools" / "torch_multiproc_dryrun.py"),
           "--device", DEV, "--years", str(years), "--cells", str(cells),
           "--K", str(k), "--timeout", "400"]
    t = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=450,
                       cwd=root)
    wall = time.perf_counter() - t
    if r.returncode != 0 or "torch multiproc dryrun: PASS" not in r.stdout:
        raise AssertionError(f"multi-process dryrun failed (exit "
                             f"{r.returncode}):\n{r.stdout[-3000:]}\n"
                             f"{r.stderr[-3000:]}")
    recs = sorted((json.loads(ln[len("procs "):]) for ln in
                   r.stdout.splitlines() if ln.startswith("procs {")),
                  key=lambda x: x["rank"])
    if [x["rank"] for x in recs] != [0, 1]:
        raise AssertionError(f"multi-process dryrun: ranks "
                             f"{[x['rank'] for x in recs]} reported")
    for x in recs:
        n = 1 if x["device"].startswith("cuda") else 0
        if x["launches"] != {"doy_quantile": n, "rle": n, "rle_days": n,
                             "detect_scan": n}:
            raise AssertionError(f"rank {x['rank']} launches "
                                 f"{x['launches']}: want {n} of each")
        if x["events"] != recs[0]["events"]:
            raise AssertionError("the ranks reduced other event totals")
        e = x["plain"]
        if not (e["exact_differ"] == 0 and e["thresh"] <= TOL["thresh"]
                and e["seas"] <= TOL["seas"] and e["events"] <= TOL["scan"]):
            raise AssertionError(f"rank {x['rank']}: kernels against the "
                                 f"plain version {e}, bars {TOL}")
        log(f"procs: rank {x['rank']} of 2 ({x['backend']}) on "
            f"{x['device']}, mesh {x['mesh']} of ranks {x['ranks']}: fed "
            f"cells {x['fed']}, {x['T']} days, K = {x['K']}; launches "
            f"{x['launches']}; kernels against plain on its shard: thresh "
            f"{e['thresh']:.3g}, seas {e['seas']:.3g}, event floats "
            f"{e['events']:.3g} (|diff| / (1 + |plain|)), "
            f"{e['exact_differ']} exact entries differ; its step "
            f"{x['step_s']:.4f} s, the "
            f"one-process step over {x['cells']} cells "
            f"{x['one_process_step_s']:.4f} s; bit-equal; "
            f"{x['events']} events across the mesh  [{card}]")
    log(f"procs: two processes, {torch.cuda.device_count()} CUDA device(s) "
        f"visible, in {wall:.1f} s (start-up, data and checks included)  "
        f"[{card}]")
    procs_stream(card)
    return {name: [x["launches"][name] for x in recs]
            for name in ("doy_quantile", "rle", "detect_scan")}


def procs_stream(card):
    """tools/torch_multiproc_stream.py on the card: two ranks each run
    stream_run over their own latitude band, rank 0 merges the band files
    and holds them byte-equal to one process's run."""
    root = Path(__file__).resolve().parent
    t = time.perf_counter()
    r = subprocess.run(
        [sys.executable, str(root / "tools" / "torch_multiproc_stream.py"),
         "--device", DEV, "--timeout", "400"], capture_output=True,
        text=True, timeout=450, cwd=root)
    wall = time.perf_counter() - t
    ok = [ln for ln in r.stdout.splitlines() if ln.startswith("rank 0: OK")]
    if (r.returncode != 0 or not ok
            or "torch multiproc stream: PASS" not in r.stdout):
        raise AssertionError(f"multi-process stream failed (exit "
                             f"{r.returncode}):\n{r.stdout[-3000:]}\n"
                             f"{r.stderr[-3000:]}")
    log(f"procs: tools/torch_multiproc_stream.py --device {DEV} in "
        f"{wall:.1f} s: {ok[-1]}  [{card}]")


def fused_stats_agree(extras, stats, ocean, ts, years, bins, kmax):
    """run_fused's extras against block_average/mhw_rank of the slice:
    counts and ranks exactly equal, floats within rtol = atol = 1e-5 (the
    fused stage reduces float32 on the card, the reference float64).
    Returns the largest float |difference|."""
    tol = STATS_TOL["event"]
    ref = stats["years"]
    worst = 0.0
    for part in ("block", "day"):
        for k, v in extras[part].items():
            if k == "nan_days":
                want = np.stack([np.isnan(ts[(years >= lo) & (years < hi)])
                                 .sum(axis=0) for lo, hi in
                                 zip(bins[:-1], bins[1:])])
            else:
                want = np.asarray(ref[k].data)[:, ocean]
            if k == "ecount" or k.endswith("_days"):
                if not np.array_equal(v, want):
                    raise AssertionError(f"fused {part} {k} != reference")
                continue
            worst = max(worst, max_err(_t(v), _t(want), f"fused {part} {k}",
                                       tol, tol))
    missing = set(ref.keys()) - set(extras["block"]) - set(extras["day"])
    if missing:
        raise AssertionError(f"fused stats lack {sorted(missing)}")
    for k in RANKED:
        r = extras["rank"][k]
        want = np.asarray(stats["rank"][k].data)[:, ocean]
        if not (np.array_equal(r[:kmax], want, equal_nan=True)
                and np.isnan(r[kmax:]).all()):
            raise AssertionError(f"fused rank {k} != mhw_rank")
    return worst


def phase_stream_steps(card, da, clim, mhw):
    """stream_block_average's per-stripe device step (float64 year-block
    event and day statistics) and stream_rank's batched ranks, on the
    slice's events as one stripe: the card against the CPU. Counts and
    ranks exact; float64 statistics within rtol 1e-9 (sums in another
    order)."""
    import torch

    from xmhw_tpu_torch.core.calendar import compute_doy
    from xmhw_tpu_torch.core.features_scan import RANK_VARS
    from xmhw_tpu_torch.core.stats import EVENT_VARS, day_block_edges
    from xmhw_tpu_torch.stream import _block_stats_step, _rank_stack
    from xmhw_tpu_torch.xrlite import TimeIndex

    ocean = ocean_of(da)
    tvals = np.asarray(da.coords["time"].values)
    years = tvals.astype("datetime64[Y]").astype(int) + 1970
    bins = np.arange(years[0], years[-1] + 2)
    nbins = len(bins) - 1
    doy, _ = compute_doy(TimeIndex(tvals))
    tab = {v: np.asarray(mhw[v].data[:, ocean]) for v in
           set(EVENT_VARS) | set(RANK_VARS) | {"time_start"}}
    vals = np.stack([tab[v].astype(np.float64) for v in EVENT_VARS])
    start = tab["time_start"]
    valid = ~np.isnat(start)
    ev_years = start.astype("datetime64[Y]").astype(int) + 1970
    bin_idx = np.clip(np.searchsorted(bins, ev_years, side="right") - 1, 0,
                      nbins - 1)
    ts = np.ascontiguousarray(da.data[:, ocean], np.float64)
    th, se = (np.ascontiguousarray(clim[v].data[:, ocean], np.float64)
              for v in ("thresh", "seas"))
    edges = day_block_edges(years, bins)
    stack = np.stack([tab[v].astype(np.float64) for v in RANK_VARS])
    out = []
    for dev in (DEV, "cpu"):
        dev = torch.device(dev)
        pos = torch.from_numpy((doy - 1).astype(np.int64)).to(dev)
        t0 = time.perf_counter()
        ev, day = _block_stats_step(vals, bin_idx, valid, nbins, dev, ts,
                                    th, se, pos, edges, True)
        t1 = time.perf_counter()
        ranks = _rank_stack(torch.from_numpy(stack).to(dev)).cpu().numpy()
        t2 = time.perf_counter()
        out.append(({**ev, **day}, ranks, t1 - t0, t2 - t1))
    (got, rk, bs, rs), (want, hrk, hbs, hrs) = out
    worst = 0.0
    for k, v in want.items():
        if k == "ecount" or k.endswith("_days"):
            if not np.array_equal(got[k], v):
                raise AssertionError(f"stream block step {k}: card != CPU")
            continue
        worst = max(worst, max_err(_t(got[k]), _t(v), f"stream block step "
                                   f"{k}", 0.0, STATS_TOL["day"]))
    if not np.array_equal(rk, hrk, equal_nan=True):
        raise AssertionError("stream rank step: card != CPU")
    if not np.nansum(got["ecount"]) > 0:
        raise AssertionError("stream block step counted no events")
    log(f"stream steps: block statistics of {ts.shape[1]} cells x "
        f"{ts.shape[0]} days, {nbins} year blocks, {vals.shape[1]} event "
        f"slots (float64): card {bs:.3f} s, CPU {hbs:.3f} s, max |diff| "
        f"{worst:.3g}; ranks of a {stack.shape} stack: card {rs:.3f} s, "
        f"CPU {hrs:.3f} s, equal  [{card}]")


# The options phase: each public option of threshold() and detect(), on a
# variant of the slice's grid ("daily": the slice's; "gaps": NaN gaps in a
# quarter of its ocean cells; "noleap" and "360_day": its values on those
# calendars), through the kernels on every cell and held against the
# plain versions on the first OPTION_LATS lat rows (the plain pool gather
# of all 4,096 cells at w = 15 would take ~7 GB and its select several
# times that). detect() uses events_layout="compact" unless the option
# names the layout.
OPTIONS = {
    "coldSpells=True": ("daily", dict(coldSpells=True),
                        dict(coldSpells=True)),
    "windowHalfWidth=11": ("daily", dict(windowHalfWidth=11), {}),
    "windowHalfWidth=15": ("daily", dict(windowHalfWidth=15), {}),
    "smoothPercentile=False": ("daily", dict(smoothPercentile=False), {}),
    "smoothPercentileWidth=11": ("daily", dict(smoothPercentileWidth=11),
                                 {}),
    "climatologyPeriod=[1991, 2020]": (
        "daily", dict(climatologyPeriod=[1991, 2020]), {}),
    "minDuration=3, maxGap=1": ("daily", {}, dict(minDuration=3, maxGap=1)),
    "joinGaps=False": ("daily", {}, dict(joinGaps=False)),
    "intermediate=True": ("daily", {}, dict(intermediate=True)),
    "anynans=True, skipna=True": ("gaps", dict(anynans=True, skipna=True),
                                  dict(anynans=True)),
    "maxPadLength=2": ("gaps", dict(maxPadLength=2), dict(maxPadLength=2)),
    "reference_quirks=True": ("daily", {}, dict(reference_quirks=True)),
    "noleap calendar": ("noleap", {}, {}),
    "360_day calendar": ("360_day", {}, dict(tstep=True)),
    "events_layout='union'": ("daily", {}, dict(events_layout="union")),
}
OPTION_LATS = 13  # 1,040 cells of the 64 x 80 grid (~830 ocean)
# the event variables held exactly: counts, positions, times
EXACT_VARS = ("event", "events", "duration", "index_start", "index_end",
              "index_peak")


def calendar_grid(da, calendar, days_a_year, years=40):
    """The first ``years`` * ``days_a_year`` days of ``da``'s values on a
    synthetic calendar (CF day offsets from 1982-01-01)."""
    from xmhw_tpu_torch.xrlite import Coord, DataArray, TimeIndex

    T = years * days_a_year
    ti = TimeIndex(np.arange(T, dtype=np.float64) + 0.5, calendar=calendar,
                   units="days since 1982-01-01")
    coords = {k: c.copy() for k, c in da.coords.items() if k != "time"}
    return DataArray(da.data[:T], da.dims,
                     {**coords, "time": Coord(("time",), ti)},
                     dict(da.attrs))


def gappy(da, seed=6):
    """``da`` with NaN gaps in a quarter of its ocean cells: runs of 1
    and 2 days (which maxPadLength=2 fills) and of 5 days."""
    x = np.array(da.data)
    cells = np.argwhere(ocean_of(da))
    rng = np.random.default_rng(seed)
    T = x.shape[0]
    for i, j in cells[rng.permutation(len(cells))[:len(cells) // 4]]:
        for length in (1, 2, 5, 1, 2):
            s = int(rng.integers(1, T - 6))
            x[s:s + length, i, j] = np.nan
    return da.copy(data=x)


def option_grids(da, years=40):
    """The grids OPTIONS name, from the daily grid ``da``; the synthetic
    calendars hold its first ``years`` years' worth of values."""
    return {"daily": da, "gaps": gappy(da),
            "noleap": calendar_grid(da, "noleap", 365, years),
            "360_day": calendar_grid(da, "360_day", 360, years)}


class plain_route:
    """Within the block, the port's block driver (core/pipeline) runs the
    plain versions for every dtype and device, as ``use_kernels=False``
    does: the yardstick the options phase holds the kernels to."""

    def __enter__(self):
        from xmhw_tpu_torch.core import pipeline

        self.rule = pipeline.use_kernels_for
        pipeline.use_kernels_for = lambda dtype, dev, override=None: False

    def __exit__(self, *exc):
        from xmhw_tpu_torch.core import pipeline

        pipeline.use_kernels_for = self.rule


def api_run(da, thr_kw, det_kw, dev=None):
    """threshold() then detect() of ``da`` with an option's keywords:
    [clim, mhw] (and the intermediate Dataset with intermediate=True)."""
    import xmhw_tpu_torch as xt

    dev = dev or DEV
    det_kw = {"events_layout": "compact", **det_kw}
    clim = xt.threshold(da, device=dev, **thr_kw)
    out = xt.detect(da, clim["thresh"], clim["seas"], device=dev, **det_kw)
    return [clim, *out] if isinstance(out, tuple) else [clim, out]


def on_cells(var, like):
    """``var``'s data at the (lat, lon) cells of ``like`` (a variable of a
    run over fewer cells), matched by coordinate value."""
    data = np.asarray(var.data)
    for d in ("lat", "lon"):
        have = {float(v): i for i, v in enumerate(var.coords[d].values)}
        pos = [have[float(v)] for v in like.coords[d].values]
        data = np.take(data, pos, axis=var.dims.index(d))
    return data


def outputs_agree(kern, plain, what):
    """A kernel run's Datasets against the plain run's, on the plain run's
    cells: the same variables; thresholds bit-equal, seas within TOL;
    event counts, positions, times and NaN patterns exact, the other
    floats within TOL["scan"] of 1 + |plain|. A compact table of the
    kernel run may hold more event slots (its cells' most events): those
    rows must be empty. Returns (max |seas diff|, max event float diff)."""
    errs = [0.0, 0.0]
    for part, a, b in zip(("clim", "mhw", "inter"), kern, plain):
        if sorted(a.keys()) != sorted(b.keys()):
            raise AssertionError(f"{what} {part}: variables differ")
        for k in b.keys():
            label = f"{what} {part} {k}"
            x, y = on_cells(a[k], b[k]), np.asarray(b[k].data)
            if a[k].dims[0] == "ev" and x.shape[0] > y.shape[0]:
                rest = x[y.shape[0]:]
                if not (np.isnat(rest) if rest.dtype.kind == "M"
                        else np.isnan(rest)).all():
                    raise AssertionError(f"{label}: events past the "
                                         "plain run's slots")
                x = x[:y.shape[0]]
            if x.shape != y.shape:
                raise AssertionError(f"{label}: shapes {x.shape} {y.shape}")
            if k == "thresh":
                if not bits().np_same_bits(x, y):
                    raise AssertionError(f"{label}: not bit-equal")
            elif k == "seas":
                errs[0] = max(errs[0], max_err(_t(x), _t(y), label,
                                               TOL["seas"]))
            elif y.dtype.kind in "Mmbiu" or k in EXACT_VARS:
                if y.dtype.kind in "Mm":  # NaT as its integer
                    x, y = x.view("i8"), y.view("i8")
                if not np.array_equal(x, y, equal_nan=y.dtype.kind == "f"):
                    raise AssertionError(f"{label}: not equal")
            else:
                errs[1] = max(errs[1], max_err(_t(x), _t(y), label,
                                               TOL["scan"], TOL["scan"]))
    return errs


def option_pair(da, thr_kw, det_kw, what, lats=OPTION_LATS):
    """One option: the kernel run over ``da`` (every kernel's launch
    counter must advance) against the plain run over its first ``lats``
    lat rows (union layout: both runs over those rows). Returns (wall of
    the kernel run in s, launches, events in the compared cells, errs)."""
    import torch

    sub = da.isel(lat=slice(0, lats))
    reset_launches()
    t = time.perf_counter()
    kern = api_run(sub if det_kw.get("events_layout") == "union" else da,
                   thr_kw, det_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_launches()
    check_launches(what, launches)
    with plain_route():
        plain = api_run(sub, thr_kw, det_kw)
    errs = outputs_agree(kern, plain, what)
    mhw = plain[1]
    n = int(np.isfinite(np.asarray(mhw["duration"].data)).sum())
    if n == 0:
        raise AssertionError(f"{what}: the compared cells hold no event")
    return wall, launches, n, errs


def phase_options(card, da):
    """Every option of OPTIONS, then each of LONG_RECORDS: kernels against
    the plain versions. Returns kernel 1's rows at the long records."""
    grids = option_grids(da)
    for name, (data, thr_kw, det_kw) in OPTIONS.items():
        wall, launches, n, errs = option_pair(grids[data], thr_kw, det_kw,
                                              f"options {name}")
        log(f"options: {name} ({data} grid): kernels {wall:.3f} s, "
            f"launches {launches}; against plain on {OPTION_LATS} lat rows: "
            f"thresholds bit-equal, seas {errs[0]:.3g}, {n} events agree "
            f"(floats {errs[1]:.3g})  [{card}]")
    return long_records(card)


# Two long records at their real size, whose pools pass kernel 1's shared
# tile (1,816 rows): ERSST v5 (NOAA's monthly 2-degree reconstruction,
# 89 x 180, Jan 1854 - Dec 2024) with tstep=True and every other option
# at its default, and one 4,096-cell block of a daily ERA5-length record
# (1940-2024) at windowHalfWidth=11. LONG_PLAIN_LATS: the lat rows the
# plain versions run on (ERA5's whole block would gather a 11.7 GB pool).
LONG_RECORDS = {
    "ersst_v5_monthly": dict(thr=dict(tstep=True), det=dict(tstep=True),
                             plain_lats=89),
    "era5_daily_w11": dict(thr=dict(windowHalfWidth=11), det={},
                           plain_lats=8),
}


def ersst_grid(seed=8, land=0.3):
    """An ERSST-v5-shaped field: 89 x 180 cells at 2 degrees (88S-88N,
    0-358E), monthly Jan 1854 - Dec 2024 (T = 2,052), float32: a
    latitude-dependent base, a seasonal cycle of either hemisphere's
    phase, a slow trend and AR(1) monthly anomalies; ``land`` of the
    cells all-NaN."""
    from xmhw_tpu_torch.xrlite import Coord, DataArray

    t = doy_edges().monthly_times(1854, 2024)
    lat = np.arange(-88.0, 89.0, 2.0)
    lon = np.arange(0.0, 360.0, 2.0)
    rng = np.random.default_rng(seed)
    T, n = len(t), len(lat) * len(lon)
    la = np.repeat(lat, len(lon))
    m = np.arange(T)[:, None]
    x = np.empty((T, n))
    x[0] = rng.normal(0, 0.5, n)
    eps = rng.normal(0, 0.4, (T, n))
    for i in range(1, T):
        x[i] = 0.6 * x[i - 1] + eps[i]
    ts = (28 - 30 * (la / 90) ** 2 + 0.3 * m / 120
          + 2.5 * np.sin(2 * np.pi * m / 12) * np.sign(la + 0.5) + x)
    ts = ts.astype(np.float32)
    ts[:, rng.permutation(n)[:int(land * n)]] = np.nan
    return DataArray(ts.reshape(T, len(lat), len(lon)), ("time", "lat", "lon"),
                     {"time": Coord(("time",), t),
                      "lat": Coord(("lat",), lat),
                      "lon": Coord(("lon",), lon)},
                     {"units": "degree_C"})


def long_record_grid(name):
    if name == "ersst_v5_monthly":
        return ersst_grid()
    return grid(daily("1940-01-01", "2025-01-01"), 64, 64, seed=9, land=0)


def kernel1_at(card, name, da, thr_kw, cells):
    """Kernel 1 alone at a long record's shape: its route, Z, CUDA-event
    time over the first 4,096 ocean cells beside its bound, and over
    ``cells`` cells beside the plain version's and the yardstick
    torch.nanquantile + torch.nanmean on the gathered pool (bit-equal
    thresholds there, means within one float32 ulp). Returns the row."""
    import torch

    from xmhw_tpu_torch.core.calendar import build_window_ranges, compute_doy
    from xmhw_tpu_torch.ops import doy_quantile as dq
    from xmhw_tpu_torch.xrlite import TimeIndex

    tv = np.asarray(da.coords["time"].values)
    doy, ndoy = compute_doy(TimeIndex(tv), keep_tstep=thr_kw.get("tstep",
                                                                  False))
    w = thr_kw.get("windowHalfWidth", 5)
    starts, lens, ny, rmax = build_window_ranges(doy, w, ndoy)
    ocean = ocean_of(da)
    ts = np.ascontiguousarray(da.data[:, ocean][:, :CELLS])
    cells = min(cells, ts.shape[1])

    def args(c):
        x = torch.full((len(tv) + rmax, c), float("nan"), device=DEV)
        x[:len(tv)] = torch.from_numpy(np.ascontiguousarray(ts[:, :c])).to(
            DEV)
        return (x, torch.from_numpy(starts.reshape(-1)).to(DEV),
                torch.from_numpy(lens.reshape(-1)).to(DEV), ndoy, ny, rmax)

    full = args(ts.shape[1])
    th, se = dq.doy_quantile(*full)
    ms = cuda_ms(lambda: dq.doy_quantile(*full))
    # a compare and an add for each finite pool value: the finite values
    # of every (doy, year) range, from running counts over time
    run = np.concatenate([[0], np.cumsum(np.isfinite(ts).sum(axis=1))])
    pooled = int((run[starts + lens] - run[starts]).sum())
    bms, by = bound(nbytes(*full[:3], th, se), 2 * pooled)
    small = args(cells)
    thk, sek = dq.doy_quantile(*small)
    thp, sep = dq.doy_quantile_plain(*small)
    same_bits(thk, thp, f"{name} kernel 1 thresh")
    err = ulps(sek, sep, f"{name} kernel 1 seas")
    pool = dq.gather_pool(*small)
    sms = cuda_ms(lambda: dq.doy_quantile(*small))
    pms = cuda_ms(lambda: dq.doy_quantile_plain(*small))
    lms = cuda_ms(lambda: (torch.nanquantile(pool, 0.9, dim=1),
                           torch.nanmean(pool, dim=1)))
    sbms, sby = bound(nbytes(*small[:3], thk, sek),
                      2 * int(torch.isfinite(pool).sum()))
    del pool
    row = {"record": name, "Z": ny * rmax, "route": dq.route(ny, rmax),
           "cells": ts.shape[1], "ms": ms, "bound_ms": bms, "bound_by": by,
           "small_cells": cells, "small_ms": sms, "small_plain_ms": pms,
           "small_library_ms": lms, "small_bound_ms": sbms,
           "seas_ulps": err, "pooled_values": pooled}
    log(f"options: {name}: kernel 1 route {row['route']}, Z = "
        f"{ny} years x {rmax} rows = {ny * rmax}; {ts.shape[1]} cells "
        f"x {ndoy} doys: kernel {ms:.3f} ms, bound {bms:.4f} ms ({by}); "
        f"{cells} cells: kernel {sms:.3f} ms, plain {pms:.3f} ms, "
        f"nanquantile + nanmean {lms:.3f} ms, bound {sbms:.4f} ms ({sby}); "
        f"thresholds bit-equal, seas within {err:.2f} ulp  [{card}]")
    return row


def long_records(card):
    """threshold() + detect() of each LONG_RECORDS entry on the card
    (kernels; kernel 1 by its long route) against the plain versions on
    the card, and kernel 1 alone at that shape. Returns kernel 1's rows."""
    from xmhw_tpu_torch.ops import doy_quantile as dq

    rows = []
    for name, rec in LONG_RECORDS.items():
        t = time.perf_counter()
        da = long_record_grid(name)
        made = time.perf_counter() - t
        C = int(ocean_of(da).sum())
        wall, launches, n, errs = option_pair(da, rec["thr"], rec["det"],
                                              name, rec["plain_lats"])
        if dq.doy_quantile.by_route["long"] != launches["doy_quantile"]:
            raise AssertionError(f"{name}: kernel 1 routes "
                                 f"{dq.doy_quantile.by_route}: want long")
        log(f"options: {name}: {C} ocean cells x {da.sizes['time']} "
            f"steps (made in {made:.1f} s): threshold+detect through the "
            f"kernels in {wall:.3f} s, launches {launches}, kernel 1 "
            f"routes {dq.doy_quantile.by_route}; against plain on "
            f"{rec['plain_lats']} lat rows: thresholds bit-equal, seas "
            f"{errs[0]:.3g}, {n} events agree (floats {errs[1]:.3g})  "
            f"[{card}]")
        rows.append(kernel1_at(card, name, da, rec["thr"], 1024))
        rows[-1]["wall_s"] = wall
    return rows


def phase_cli(card):
    """``python -m xmhw_tpu_torch warmup``, in process: build (the cached
    library) and the standard shapes on the card (40 daily years, one
    4,096-cell block, K = 32, 64, 128); every kernel must launch."""
    from xmhw_tpu_torch.__main__ import main as cli

    reset_launches()
    t = time.perf_counter()
    if cli(["warmup"]) != 0:
        raise AssertionError("warmup returned non-zero")
    wall = time.perf_counter() - t
    launches = read_launches()
    check_launches("warmup", launches)
    log(f"cli: warmup in {wall:.3f} s; launches {launches}  [{card}]")


def phase_stream(card):
    """The streamed pipelines file to file (through h5py or its stand-in:
    choose_h5py): the grid through stream_run, the staged chain and the
    CLI, the resume, gap filling on the read-ahead thread with and without
    a mesh, then the production-width band. Returns the band's kernel
    launches."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="xmhw_stream_") as d:
        src, clim = stream_files(card, Path(d), DEV, *STREAM_GRID,
                                 daily(T0, T1))
        stream_resume(card, Path(d), DEV, src, clim)
    with tempfile.TemporaryDirectory(prefix="xmhw_gaps_") as d:
        stream_gaps(card, Path(d), DEV)
    with tempfile.TemporaryDirectory(prefix="xmhw_band_") as d:
        return stream_band(card, Path(d), DEV)


def exact(part, k):
    """The variables of an output file that two runs must write equal:
    thresholds, event positions, counts and categories, ranks."""
    if part == "mhw":
        return (k in ("event", "category") or
                k.startswith(("duration", "index_", "time_")))
    return (part == "rank" or (part, k) == ("clim", "thresh")
            or (part, k) == ("block", "ecount"))


def files_agree(a, b, part):
    """Two output files of the port: the same variables and shapes, the
    same NaN patterns, the ``exact`` variables equal, category-day counts
    within 1 (stream_run computes a day's category in float32, the staged
    block_average in float64: a day on a category edge may fall on either
    side), other floats within rtol = atol = 2e-3. Returns the largest
    float |difference|."""
    import xmhw_tpu_torch as xt

    da, db = xt.open_dataset(a), xt.open_dataset(b)
    what = f"stream {part}"
    if sorted(da.keys()) != sorted(db.keys()):
        raise AssertionError(f"{what}: variables differ")
    worst = 0.0
    for k in db.keys():
        x, y = np.asarray(da[k].data), np.asarray(db[k].data)
        if x.shape != y.shape:
            raise AssertionError(f"{what} {k}: shapes {x.shape} {y.shape}")
        if x.dtype.kind == "M":
            x, y = x.astype("i8"), y.astype("i8")
        if part == "block" and k.endswith("_days"):
            max_err(_t(x), _t(y), f"{what} {k}", 1.0)
            continue
        if exact(part, k) or x.dtype.kind == "i":
            if not np.array_equal(x, y, equal_nan=x.dtype.kind == "f"):
                raise AssertionError(f"{what} {k}: not equal")
            continue
        worst = max(worst, max_err(_t(x), _t(y), f"{what} {k}", TOL["scan"],
                                   TOL["scan"]))
    return worst


def equal_to_fused(clim_path, mhw_path, ts, ocean, t, dev, what):
    """A streamed run's climatology and events against one in-memory
    run_fused over the ocean cells ``ts`` ((T, ocean) float32): thresholds
    and seasonal means equal, every event of the in-memory tables in the
    file (K may be larger there), every table variable but the times
    equal. Returns the number of events."""
    import xmhw_tpu_torch as xt
    from xmhw_tpu_torch.core.calendar import compute_doy
    from xmhw_tpu_torch.core.features_scan import TABLE_VARS
    from xmhw_tpu_torch.core.pipeline import run_fused
    from xmhw_tpu_torch.xrlite import TimeIndex

    clim = xt.open_dataset(clim_path)
    mhw = xt.open_dataset(mhw_path)
    doy, _ = compute_doy(TimeIndex(t))
    th, se, tables, nev, _ = run_fused(ts, doy, (doy - 1).astype(np.int32),
                                       device=dev)
    if tuple(clim["thresh"].shape[1:]) != ocean.shape:
        raise AssertionError(f"{what}: grid {clim['thresh'].shape[1:]} != "
                             f"{ocean.shape}")
    flat = ocean.reshape(-1)
    for k, v in (("thresh", th), ("seas", se)):
        got = np.asarray(clim[k].data).reshape(-1, flat.size)[:, flat]
        if not np.array_equal(got, v, equal_nan=True):
            raise AssertionError(f"{what} {k} != in-memory run_fused")
    K = mhw["event"].sizes["ev"]

    def cells(k):
        return np.asarray(mhw[k].data).reshape(K, -1)[:, flat]

    if tables["event"].shape[0] > K or not np.array_equal(
            np.isfinite(cells("duration")).sum(axis=0), nev):
        raise AssertionError(f"{what} event counts != in-memory run_fused")
    for k in TABLE_VARS:
        if k.startswith("time_"):
            continue
        a = np.asarray(cells(k), np.float64)
        b = np.full(a.shape, np.nan)
        b[:tables[k].shape[0]] = tables[k]
        if not np.array_equal(a, b, equal_nan=True):
            raise AssertionError(f"{what} {k} != in-memory run_fused")
    return int(nev.sum())


def stream_files(card, d, dev, nlat, nlon, t):
    """stream_run and the staged chain over one grid file; their files
    must agree, and stream_run's climatology and events must equal one
    in-memory run_fused over the grid. Then the CLI's ``run``. Returns the
    input file and stream_run's climatology file."""
    import xmhw_tpu_torch as xt
    from xmhw_tpu_torch.stream import _auto_stripe
    from xmhw_tpu_torch.xrlite import Dataset

    n = nlat * nlon
    ds = Dataset()
    ds["sst"] = grid(t, nlat, nlon, seed=5, land=n // 5)
    src = str(d / "sst.nc")
    w = time.perf_counter()
    xt.save_dataset(ds, src)
    w = time.perf_counter() - w
    rows = _auto_stripe(len(t), (nlat, nlon))
    log(f"stream: wrote {n} cells x {len(t)} days ({ds['sst'].data.nbytes} "
        f"B) in {w:.3f} s; stripes of {rows} rows: "
        f"{-(-nlat // rows)}  [{card}]")
    runs = {}
    for how in ("stream_run", "staged"):
        p = {k: str(d / f"{how}_{k}.nc") for k in ("clim", "mhw", "block",
                                                   "rank")}
        reset_launches()
        before = counts()
        t0 = time.perf_counter()
        if how == "stream_run":
            out = xt.stream_run(src, "sst", p["clim"], p["mhw"],
                                block_path=p["block"], rank_path=p["rank"],
                                device=dev)
        else:
            xt.stream_threshold(src, "sst", p["clim"], device=dev)
            xt.stream_detect(src, "sst", p["clim"], p["mhw"], device=dev)
            xt.stream_block_average(p["mhw"], p["block"], dstime_path=src,
                                    dstime_var="sst", clim_path=p["clim"],
                                    device=dev)
            out = dict(p, **{"return": xt.stream_rank(
                p["mhw"], p["rank"], device=dev)[1]})
        wall = time.perf_counter() - t0
        launches = read_launches()
        # the staged chain's block statistics are float64: no stats kernel
        check_launches(how, launches, blocks_since(before)
                       if how == "stream_run" else 0)
        runs[how] = out
        log(f"stream: {how} file to file in {wall:.3f} s = "
            f"{n / wall:.1f} cells/s (land included); launches {launches}"
            f"  [{card}]")
    worst = max(files_agree(runs["stream_run"][k], runs["staged"][k], k)
                for k in runs["staged"])
    data = np.asarray(ds["sst"].data).reshape(len(t), -1)
    ocean = ~np.isnan(data).all(axis=0)
    nev = equal_to_fused(runs["stream_run"]["clim"], runs["stream_run"]["mhw"],
                         np.ascontiguousarray(data[:, ocean]),
                         ocean.reshape(nlat, nlon), t, dev, "stream")
    log(f"stream: stream_run and the staged chain agree (max |diff| "
        f"{worst:.3g}); clim and {nev} events equal one in-memory run_fused"
        f"  [{card}]")
    small = Dataset()
    small["sst"] = grid(t, 8, 8, seed=6, land=8)
    xt.save_dataset(small, str(d / "small.nc"))
    c = [str(d / f"cli_{k}.nc") for k in ("c", "m", "b", "r")]
    r = subprocess.run(
        [sys.executable, "-m", "xmhw_tpu_torch", "--device", str(dev), "run",
         str(d / "small.nc"), "sst", c[0], c[1], "--block", c[2], "--rank",
         c[3]], capture_output=True, text=True, timeout=600,
        cwd=Path(__file__).resolve().parent)
    written = [ln.split(": ", 1)[1] for ln in r.stdout.splitlines()
               if ": " in ln]
    if r.returncode != 0 or sorted(written) != sorted(
            c + [str(d / "cli_r_return.nc")]) or not all(
                Path(f).exists() for f in written):
        raise AssertionError(f"python -m xmhw_tpu_torch run failed: "
                             f"{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
    log(f"stream: python -m xmhw_tpu_torch --device {dev} run on 64 cells "
        f"wrote {', '.join(Path(f).name for f in written)}  [{card}]")
    return src, runs["stream_run"]["clim"]


def stop_after_first_stripe(setattr):
    """In-process stop of a streamed run: ``setattr(_WriteBehind,
    "submit", ...)`` makes the second write-behind job raise instead of
    writing, so the run ends with its first stripe and that stripe's
    watermark on disk. ``setattr`` is pytest's ``monkeypatch.setattr``, or
    the builtin where the caller restores ``_WriteBehind.submit``."""
    from xmhw_tpu_torch import stream as tst

    real, jobs = tst._WriteBehind.submit, []

    def submit(wb, fn):
        jobs.append(fn)
        if len(jobs) == 2:
            def fn():
                raise RuntimeError("stopped after the first stripe")
        real(wb, fn)

    setattr(tst._WriteBehind, "submit", submit)


def stream_resume(card, d, dev, src, clim):
    """stream_detect stopped after its first stripe, then resumed with
    resume=True: the file equals a fresh run's bit for bit, and the
    resumed call launches what the fresh run launched for the remaining
    stripes. The K cache is off for the three runs, as for a first run
    (a stopped run writes none)."""
    import h5py

    import xmhw_tpu_torch as xt
    from xmhw_tpu_torch import stream as tst

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    from torch_multiproc_stream import assert_files_equal

    real = tst.run_detect
    per_call = []

    def counted(*a, **k):
        before = read_launches()
        out = real(*a, **k)
        after = read_launches()
        per_call.append({n: after[n] - before[n] for n in after})
        return out

    fresh, got = str(d / "fresh_m.nc"), str(d / "resumed_m.nc")
    cache = os.environ.get("XMHW_COMPILE_CACHE")
    os.environ["XMHW_COMPILE_CACHE"] = "0"
    tst.run_detect = counted
    try:
        xt.stream_detect(src, "sst", clim, fresh, device=dev)
        stripes = list(per_call)
        submit = tst._WriteBehind.submit
        stop_after_first_stripe(setattr)
        try:
            xt.stream_detect(src, "sst", clim, got, device=dev)
        except RuntimeError as e:
            if "first stripe" not in str(e):
                raise
        else:
            raise AssertionError("the stopped run did not stop")
        finally:
            tst._WriteBehind.submit = submit
        gc.collect()  # the stopped run's open files
        with h5py.File(got, "r") as f:
            mark = json.loads(f.attrs["xmhw_resume"])
        del per_call[:]
        reset_launches()
        t0 = time.perf_counter()
        xt.stream_detect(src, "sst", clim, got, device=dev, resume=True)
        wall = time.perf_counter() - t0
        launches = read_launches()
    finally:
        tst.run_detect = real
        if cache is None:
            os.environ.pop("XMHW_COMPILE_CACHE")
        else:
            os.environ["XMHW_COMPILE_CACHE"] = cache
    want = {n: sum(c[n] for c in stripes[1:]) for n in launches}
    if per_call != stripes[1:] or launches != want or not launches["rle"]:
        raise AssertionError(f"resumed launches {per_call} (total "
                             f"{launches}): want the fresh run's for its "
                             f"stripes 2-{len(stripes)}: {stripes[1:]}")
    assert_files_equal(got, fresh)
    with h5py.File(got, "r") as f:
        if "xmhw_resume" in f.attrs:
            raise AssertionError("the resumed run left its watermark")
    log(f"stream: stream_detect stopped after its first stripe (watermark "
        f"at row {mark['hi']} of {STREAM_GRID[0]}), resumed in {wall:.3f} "
        f"s: {len(per_call)} of {len(stripes)} stripes run, launches "
        f"{launches} (the fresh run's for those stripes); the file equals a "
        f"fresh run's byte for byte  [{card}]")


def stream_gaps(card, d, dev, nlat=48, nlon=64, rows=16):
    """stream_run with maxPadLength=2 over a grid with NaN gaps (gappy),
    three stripes: each stripe's gaps are filled on the card by the
    read-ahead thread while the main thread runs the previous stripe's
    step. Once on ``dev`` and once over the mesh [dev, dev]: the files
    must be equal byte for byte, and the climatology and events equal one
    in-memory run_fused over the gaps filled on the main thread."""
    import torch

    import xmhw_tpu_torch as xt
    from xmhw_tpu_torch.api import _interpolate_na
    from xmhw_tpu_torch.parallel import cell_mesh
    from xmhw_tpu_torch.xrlite import Dataset

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    from torch_multiproc_stream import assert_files_equal

    t = daily(T0, T1)
    ds = Dataset()
    ds["sst"] = gappy(grid(t, nlat, nlon, seed=7, land=nlat * nlon // 5))
    src = str(d / "gaps.nc")
    xt.save_dataset(ds, src)
    one = torch.device(dev)
    outs = {}
    for how, kw in (("one device", {"device": one}),
                    ("mesh", {"mesh": cell_mesh([one, one])})):
        p = {k: str(d / f"gaps_{how[:4]}_{k}.nc") for k in ("clim", "mhw")}
        reset_launches()
        t0 = time.perf_counter()
        xt.stream_run(src, "sst", p["clim"], p["mhw"], maxPadLength=2,
                      stripe=rows, **kw)
        wall = time.perf_counter() - t0
        launches = read_launches()
        check_launches(f"the gap run ({how})", launches)
        outs[how] = (p, wall, launches)
    for k in ("clim", "mhw"):
        assert_files_equal(outs["mesh"][0][k], outs["one device"][0][k])
    data = np.asarray(ds["sst"].data).reshape(len(t), -1)
    ocean = ~np.isnan(data).all(axis=0)
    filled = _interpolate_na(np.ascontiguousarray(data[:, ocean]), 2, one)
    nev = equal_to_fused(outs["one device"][0]["clim"],
                         outs["one device"][0]["mhw"], filled,
                         ocean.reshape(nlat, nlon), t, dev, "stream gaps")
    log(f"stream: maxPadLength=2 over {nlat * nlon} cells with NaN gaps, "
        f"{-(-nlat // rows)} stripes: one device {outs['one device'][1]:.3f}"
        f" s, launches {outs['one device'][2]}; mesh [{one}, {one}] "
        f"{outs['mesh'][1]:.3f} s, launches {outs['mesh'][2]}; files "
        f"byte-equal; clim and {nev} events equal one in-memory run_fused "
        f"over the gaps filled on the main thread  [{card}]")


def synth_card(T, n, seed, land):
    """``synth``'s recipe made on the card (the band's 2 GB would take
    numpy tens of seconds): (T, n) float32 on the host."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    cs = torch.zeros((T + 15, n), dtype=torch.float64, device="cuda")
    torch.cumsum(torch.randn((T + 14, n), generator=g, dtype=torch.float64,
                             device="cuda"), dim=0, out=cs[1:])
    day = torch.arange(T, dtype=torch.float64, device="cuda")[:, None]
    ts = (15 + 3 * torch.sin(2 * np.pi * day / 365.25)
          + 2.5 * (cs[15:15 + T] - cs[:T]) / 15.0).float()
    del cs
    ts[:, torch.randperm(n, generator=g, device="cuda")[:land]] = float("nan")
    out = ts.cpu().numpy()
    del ts
    torch.cuda.empty_cache()
    return out


class step_clock:
    """A streamed run's stages on the host clock: the read
    (GridReader.read, on the read-ahead thread), the device step
    (core.pipeline.run_fused, imported by the call; CUDA events around it
    too), the write-behind job (_WriteBehind._run) and, inside it, the host
    ranks (stats_api.rank_variable) and the event and rank table writes
    (_StreamTableWriter.write), then the return-period file written after
    the last stripe (_write_return_file). ``steps``: (host start, host end,
    event start, event end, cells); ``spans[stage]``: (start, end)."""

    STAGES = {"read": ("stream", "GridReader", "read"),
              "write job": ("stream", "_WriteBehind", "_run"),
              "host ranks": ("stats_api", None, "rank_variable"),
              "table writes": ("stream", "_StreamTableWriter",
                                     "write"),
              "return-period file": ("stream", None, "_write_return_file")}

    def __enter__(self):
        import importlib

        import torch

        from xmhw_tpu_torch.core import pipeline

        self.steps, self.spans, self.undo = [], {}, []

        def patch(owner, attr, wrap):
            real = getattr(owner, attr)
            setattr(owner, attr, wrap(real))
            self.undo.append((owner, attr, real))

        def clocked(into):
            def wrap(fn):
                def run(*a, **k):
                    t = time.perf_counter()
                    try:
                        return fn(*a, **k)
                    finally:
                        into.append((t, time.perf_counter()))
                return run
            return wrap

        for stage, (mod, cls, attr) in self.STAGES.items():
            owner = importlib.import_module(f"xmhw_tpu_torch.{mod}")
            patch(getattr(owner, cls) if cls else owner, attr,
                  clocked(self.spans.setdefault(stage, [])))

        def timed(real):
            def run(ts, *a, **k):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                h0 = time.perf_counter()
                e0.record()
                out = real(ts, *a, **k)
                e1.record()
                self.steps.append((h0, time.perf_counter(), e0, e1,
                                   ts.shape[1]))
                return out
            return run

        patch(pipeline, "run_fused", timed)
        return self

    def __exit__(self, *exc):
        for owner, attr, real in reversed(self.undo):
            setattr(owner, attr, real)

    def device_ms(self):
        self.steps[-1][3].synchronize()
        return [e0.elapsed_time(e1) for _, _, e0, e1, _ in self.steps]

    def total(self, stage):
        return sum(b - a for a, b in self.spans[stage])


class rss_peak:
    """This process's resident set while the block runs: ``before`` and
    ``peak`` in bytes (/proc/self/statm every 10 ms), and ``maxrss``, the
    process's lifetime peak (getrusage) after it."""

    def __enter__(self):
        import threading

        self.page = os.sysconf("SC_PAGE_SIZE")
        self.before = self.peak = self.read()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self.run, daemon=True)
        self.thread.start()
        return self

    def read(self):
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self.page

    def run(self):
        while not self.stop.wait(0.01):
            self.peak = max(self.peak, self.read())

    def __exit__(self, *exc):
        import resource

        self.stop.set()
        self.thread.join()
        self.peak = max(self.peak, self.read())
        self.maxrss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def stream_band(card, d, dev, years=None):
    """The production width through stream_run alone: BAND rows of the
    0.25-degree grid (1,440 longitudes), BAND_LAND of them land, 40 daily
    years (``years`` cuts them), float32, with block statistics and ranks
    as the production job writes them; 8 stripes of 3 rows, so that the
    steady state (read N+1, step N, write N-1) runs six times. Its
    climatology and events must equal one in-memory run_fused over its
    ocean cells. Logs each stripe's wall (from its device step's start to
    the next one's, the last to the run's end) and stages (step_clock),
    cells/s (land included), the device-step share (the steps' CUDA-event
    time over the run's wall) and the host RSS. Returns the run's kernel
    launches."""
    import xmhw_tpu_torch as xt
    from xmhw_tpu_torch.stream import _auto_stripe
    from xmhw_tpu_torch.xrlite import Coord, DataArray, Dataset

    t = daily(T0, T1) if years is None else daily(
        T0, f"{1982 + years}-01-01")
    T, (nlat, nlon) = len(t), BAND
    n = nlat * nlon
    w = time.perf_counter()
    ts = synth_card(T, n, seed=9, land=int(BAND_LAND * n))
    ds = Dataset()
    ds["sst"] = DataArray(
        ts.reshape(T, nlat, nlon), ("time", "lat", "lon"),
        {"time": Coord(("time",), t),
         "lat": Coord(("lat",), -45.875 + 0.25 * np.arange(nlat)),
         "lon": Coord(("lon",), 0.125 + 0.25 * np.arange(nlon))},
        {"units": "degree_C"})
    src = str(d / "band.nc")
    xt.save_dataset(ds, src)
    ocean = ~np.isnan(ts).all(axis=0)
    ocean_ts = np.ascontiguousarray(ts[:, ocean])
    ocean = ocean.reshape(nlat, nlon)
    nbytes = ts.nbytes
    del ds, ts
    gc.collect()
    w = time.perf_counter() - w
    rows = _auto_stripe(T, BAND)
    stripes = -(-nlat // rows)
    log(f"stream band: {nlat} x {nlon} (0.25 deg), {int(ocean.sum())} ocean "
        f"cells of {n}, {T} days, float32 ({nbytes} B), made on the card "
        f"and written in {w:.3f} s; stripes of {rows} rows "
        f"({rows * nlon} cells): {stripes}  [{card}]")
    if years is None and stripes != 8:
        raise AssertionError(f"{stripes} stripes: want 8")
    p = {k: str(d / f"band_{k}.nc") for k in ("clim", "mhw", "block", "rank")}
    reset_launches()
    before = counts()
    with step_clock() as clock, rss_peak() as rss:
        t0 = time.perf_counter()
        xt.stream_run(src, "sst", p["clim"], p["mhw"], block_path=p["block"],
                      rank_path=p["rank"], device=dev)
        wall = time.perf_counter() - t0
    launches = read_launches()
    if len(clock.steps) != stripes:
        raise AssertionError(f"band: {len(clock.steps)} device steps, want "
                             f"{stripes}")
    check_launches("band", launches, blocks_since(before))
    dev_ms = clock.device_ms()
    starts = [s[0] for s in clock.steps] + [t0 + wall]
    per = [b - a for a, b in zip(starts, starts[1:])]
    gb = 1 << 30
    def secs(spans):
        return ", ".join(f"{b - a:.3f}" for a, b in spans)

    log(f"stream band: stream_run in {wall:.3f} s = {n / wall:.1f} cells/s "
        f"(land included; {int(ocean.sum()) / wall:.1f} ocean cells/s); "
        f"launches {launches}; before the first step {starts[0] - t0:.3f} "
        f"s; per stripe (s): {', '.join(f'{x:.3f}' for x in per)}; reads "
        f"(s, read-ahead thread): {secs(clock.spans['read'])}; device steps "
        f"(ms): "
        f"{', '.join(f'{x:.1f}' for x in dev_ms)}; write jobs (s, "
        f"write-behind thread): {secs(clock.spans['write job'])}, of which "
        f"host ranks {clock.total('host ranks'):.3f} s and event and rank "
        f"table writes {clock.total('table writes'):.3f} s in all; then the "
        f"return-period file {clock.total('return-period file'):.3f} s; "
        f"device-step share "
        f"{sum(dev_ms) / 1e3 / wall:.3f}; host RSS {rss.before / gb:.2f} GB "
        f"before, peak {rss.peak / gb:.2f} GB during (sampled), process "
        f"lifetime peak {rss.maxrss / gb:.2f} GB  [{card}]")
    nev = equal_to_fused(p["clim"], p["mhw"], ocean_ts, ocean, t, dev,
                         "stream band")
    log(f"stream band: clim and {nev} events equal one in-memory run_fused "
        f"over the {int(ocean.sum())} ocean cells  [{card}]")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible "
              "(torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    import xmhw_tpu_torch  # noqa: F401  (fails outside a checkout)
    import tempfile

    choose_h5py()
    # the streamed runs' K cache (kcache.json) lives and dies with the run
    cache = tempfile.TemporaryDirectory(prefix="xmhw_kcache_")
    os.environ["XMHW_COMPILE_CACHE"] = cache.name
    card = phase_device()
    phase_build()
    rows = phase_kernels(card)
    phase_reference(card)
    da = grid(daily(T0, T1), 64, 80, seed=3, land=64 * 80 - CELLS)
    clim, mhw, launches = phase_slice(card, da)
    stats = phase_stats(card, da, clim, mhw)
    fused = phase_fused(card, da, clim, mhw, stats)
    fused_launches = fused[2]
    mesh_launches = phase_mesh(card, da, clim, mhw, fused)
    procs_launches = phase_procs(card)
    phase_stream_steps(card, da, clim, mhw)
    rows[0]["long_records"] = phase_options(card, da)
    phase_cli(card)
    stream_launches = phase_stream(card)
    for r in rows:
        if r["name"] == "block_stats":
            r.update(launches=stats_part(launches),
                     fused_launches=fused_launches,
                     mesh_launches=mesh_launches["block_stats"],
                     stream_launches=stats_part(stream_launches))
            continue
        if r["name"] in launches:  # run_bound: counted in phase_kernels
            r["launches"] = launches[r["name"]]
        r["mesh_launches"] = mesh_launches[r["name"]]
        r["procs_launches"] = procs_launches.get(r["name"], [0, 0])
        r["stream_launches"] = stream_launches.get(r["name"], 0)
    cache.cleanup()
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
