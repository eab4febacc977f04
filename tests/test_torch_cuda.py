"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc, and skips without them. The
file imports neither JAX nor the JAX package, so that it runs where only
PyTorch is installed; run it on the card with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: the RLE and the running bound exact; clim thresholds equal
bit for bit and means within one float32 ulp (both round a float64 sum
once, summed in different orders); the
event scan's counts and positions exact and its floats within rtol =
atol = 2e-3. block_average/mhw_rank on the card against the host numpy
path: counts and ranks exact, day statistics rtol 1e-9 (both float64),
event statistics rtol = atol = 1e-5 (float32 tables on the card, float64
sums on the host). float64 threshold + detect (the plain versions on the
card): the same bits run after run and over a mesh, and the CPU's bits
but for the four variances (one ulp: ``torch.sqrt``).
"""

import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from xmhw_tpu_torch.core import pipeline  # noqa: E402
from xmhw_tpu_torch.core.calendar import (build_window_ranges,  # noqa: E402
                                          compute_doy)
import xmhw_tpu_torch as xt  # noqa: E402
from xmhw_tpu_torch.ops import _build, detect_scan, doy_quantile, rle  # noqa
from xmhw_tpu_torch.ops import run_bound  # noqa: E402
from xmhw_tpu_torch.ops.block_stats import (day_bins,  # noqa: E402
                                            day_bins_plain, event_bins,
                                            event_bins_plain)
from xmhw_tpu_torch.xrlite import (Coord, DataArray, Dataset,  # noqa: E402
                                   TimeIndex)
import test_torch_doy_edges as doy_edges  # noqa: E402
import test_torch_rle_edges as rle_edges  # noqa: E402
import test_torch_run_bound_edges as rb_edges  # noqa: E402
import test_torch_scan_edges as edges  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
from torch_multiproc_dryrun import (START_YEAR, field,  # noqa: E402
                                    np_same_bits, same_bits)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _build.library()  # builds the kernels once, or raises nvcc's message
    return torch.device("cuda")


def floats_close(a, b, what, tol=2e-3):
    a, b = a.double().cpu(), b.double().cpu()
    assert torch.equal(torch.isfinite(a), torch.isfinite(b)), what
    m = torch.isfinite(b)
    assert torch.allclose(a[m], b[m], rtol=tol, atol=tol), what


TRIALS = [(700, 5, True, 2, False), (700, 5, True, 2, True),
          (513, 3, True, 4, False), (1030, 5, False, 2, False),
          (64, 2, True, 1, False), (700, 2, True, 1, True)]


# the RLE's output modes: kernel wrapper, plain version, keywords
RLE_MODES = {
    "count": (rle.event_counts, rle.event_counts_plain, {}),
    "days": (rle.mhw_filter, rle.mhw_filter_plain,
             {"full": False, "slot": False}),
    "slots": (rle.mhw_filter, rle.mhw_filter_plain, {"full": False}),
    "full": (rle.mhw_filter, rle.mhw_filter_plain, {}),
}


def rle_all_modes(b, kw, what):
    """The RLE kernel equals its plain version bit for bit on mask ``b``
    in every output mode, one launch each."""
    before = rle.mhw_filter.launches
    for mode, (kernel, plain, extra) in RLE_MODES.items():
        k = kernel(b, **kw, **extra)
        p = plain(b, **kw, **extra)
        assert sorted(k) == sorted(p), mode
        for name in p:
            assert torch.equal(k[name], p[name]), (name, mode, what)
    torch.cuda.synchronize()
    assert rle.mhw_filter.launches == before + len(RLE_MODES)


@pytest.mark.parametrize("trial", range(len(TRIALS)))
def test_rle_kernel_bit_equal(dev, trial):
    T, md, jg, mg, qk = TRIALS[trial]
    rng = np.random.default_rng(11 + trial)
    b = torch.from_numpy(rng.random((T, 300)) < 0.45).to(dev)
    b[0] = trial % 2 == 0
    b[-1] = True
    b[:, 7] = True   # one run over the whole record
    b[:, 8] = False  # no event at all
    kw = dict(min_duration=md, join_gaps=jg, max_gap=mg,
              day0_fillna_quirk=qk)
    rle_all_modes(b, kw, trial)


@pytest.mark.parametrize("name", list(rle_edges.CASES))
def test_rle_kernel_segment_edges(dev, name):
    """The segment-edge cases of tests/test_torch_rle_edges.py at their
    card shapes (T = 14,610 but for the short series)."""
    case = rle_edges.CASES[name]
    assert rle.launch_config(case.T_card)["warps"] == rle_edges.WARPS
    b = torch.from_numpy(rle_edges.edge_mask(name, case.T_card,
                                             case.C_card)).to(dev)
    rle_all_modes(b, rle_edges.kwargs(name), name)


def test_rle_kernel_past_shared_memory(dev):
    """A series too long for the bit words in shared memory (over 47,104
    days) keeps them in global scratch."""
    T = 60000
    assert _build.library().xmhw_rle_scratch(T, 40) > 0
    assert _build.library().xmhw_rle_scratch(14610, 40) == 0
    rng = np.random.default_rng(2)
    b = torch.from_numpy(rng.random((T, 40)) < 0.5).to(dev)
    b[T // 3:T // 2, 5] = True
    rle_all_modes(b, dict(min_duration=5, join_gaps=True, max_gap=2,
                          day0_fillna_quirk=True), "long")


def clim_inputs(dev, C=300, years=4, seed=1):
    t = np.arange("2001-01-01", f"{2001 + years}-01-01",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    doy, ndoy = compute_doy(TimeIndex(t))
    starts, lens, ny, rmax = build_window_ranges(doy, 5, ndoy)
    rng = np.random.default_rng(seed)
    T = len(t)
    ts = np.round(15 + rng.normal(0, 2, (T, C)), 2).astype(np.float32)
    ts[30:90, 7] = np.nan
    ts[:, 19] = 3.25
    ts[:, 23] = rng.normal(0.0, 5.0, T)
    ts[:, 29] = np.nan
    ts[:, 31] = rng.normal(0.0, 1e-6, T)
    x = torch.full((T + rmax, C), float("nan"), device=dev)
    x[:T] = torch.from_numpy(ts).to(dev)
    st = torch.from_numpy(starts.reshape(-1)).to(dev)
    ln = torch.from_numpy(lens.reshape(-1)).to(dev)
    return (x, st, ln, ndoy, ny, rmax), doy


def padded_args(dev, ts, starts, lens, ndoy, ny, rmax):
    x = torch.full((ts.shape[0] + rmax, ts.shape[1]), float("nan"),
                   device=dev)
    x[:ts.shape[0]] = torch.from_numpy(ts).to(dev)
    return (x, torch.from_numpy(starts.reshape(-1)).to(dev),
            torch.from_numpy(lens.reshape(-1)).to(dev), ndoy, ny, rmax)


def doy_case(dev, case):
    """Kernel 1's inputs: the lanes of clim_inputs (4 years); SST-like
    cells over 30 and 40 daily years (pools of 330 and 440 rows); the edge
    pools of tests/test_torch_doy_edges.py over 4 years; the largest pool
    the shared tile holds (1,816 rows)."""
    if case == "lanes":
        return clim_inputs(dev)[0]
    if case == "largest":
        starts, lens, ny, rmax = doy_edges.largest_pool()
        ts = doy_edges.edge_series(3000, 300, seed=5)
        return padded_args(dev, ts, starts, lens, len(starts), ny, rmax)
    years = {"years30": 30, "years40": 40, "edges": 4}[case]
    t = np.arange("1982-01-01", f"{1982 + years}-01-01",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    doy, ndoy = compute_doy(TimeIndex(t))
    starts, lens, ny, rmax = build_window_ranges(doy, 5, ndoy)
    kinds = doy_edges.KINDS if case == "edges" else ("sst",)
    ts = doy_edges.edge_series(len(t), 300, seed=years, kinds=kinds)
    return padded_args(dev, ts, starts, lens, ndoy, ny, rmax)


def within_one_ulp(a, b):
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb):
        return False
    big = torch.maximum(a[fa].abs(), b[fb].abs())
    ulp = torch.nextafter(big, torch.full_like(big, float("inf"))) - big
    return bool(((a[fa].double() - b[fb].double()).abs()
                 <= ulp.double()).all())


DOY_CASES = ("lanes", "years30", "years40", "edges", "largest")


@pytest.mark.parametrize("pctile", [90, 87.5, 10])
@pytest.mark.parametrize("case", DOY_CASES)
def test_doy_quantile_kernel_matches_plain(dev, case, pctile):
    args = doy_case(dev, case)
    before = doy_quantile.doy_quantile.launches
    thk, sek = doy_quantile.doy_quantile(*args, pctile=pctile)
    thp, sep = doy_quantile.doy_quantile_plain(*args, pctile=pctile)
    torch.cuda.synchronize()
    assert doy_quantile.doy_quantile.launches == before + 1
    assert same_bits(thk, thp)
    assert within_one_ulp(sek, sep)
    if case == "lanes":
        assert bool(torch.isnan(thk[:, 29]).all())
    if case == "largest":
        assert args[4] * args[5] == doy_edges.LARGEST_Z


@pytest.mark.parametrize("name", sorted(doy_edges.PAST_TILE))
def test_doy_quantile_takes_pools_past_the_tile(dev, name):
    """Pools past the 1,816 rows of the shared tile (1,817 to 6,400 rows:
    ERSST v5's monthly record, ERA5's daily one at w = 11 and 15, random
    tables) take the kernel's long route over 300 cells of every edge
    kind: thresholds bit-equal to the plain version, means within one
    float32 ulp, at pctile 90 and 87.5; one launch each, by that route."""
    T, starts, lens, ndoy, ny, rmax = doy_edges.past_tile(name)
    ts = doy_edges.edge_series(T, 300, seed=7)
    args = padded_args(dev, ts, starts, lens, ndoy, ny, rmax)
    for pctile in (90, 87.5):
        before = doy_quantile.doy_quantile.launches
        long = doy_quantile.doy_quantile.by_route["long"]
        thk, sek = doy_quantile.doy_quantile(*args, pctile=pctile)
        thp, sep = doy_quantile.doy_quantile_plain(*args, pctile=pctile)
        torch.cuda.synchronize()
        assert doy_quantile.doy_quantile.launches == before + 1
        assert doy_quantile.doy_quantile.by_route["long"] == long + 1
        assert same_bits(thk, thp), pctile
        assert within_one_ulp(sek, sep), pctile


def scan_case(dev, name):
    rng = np.random.default_rng(3)
    T, C, D = 700, 300, 40
    doy_pos = (np.arange(T) % D).astype(np.int32)
    if name == "walk":
        ts = (15 + 3 * np.sin(2 * np.pi * np.arange(T) / 365)[:, None]
              + np.cumsum(rng.normal(0, .6, (T, C)), 0) * 0.3)
        ts[50:60, 3] = np.nan
        th = 16.5 + rng.normal(0, .2, (D, C))
        se = 15 + rng.normal(0, .1, (D, C))
        se[5, 4] = np.nan  # seas NaN, thresh finite on some event days
    else:  # dense: events at the minimal separation, every phase
        th = np.full((D, C), 0.5)
        se = np.zeros((D, C))
        ts = np.zeros((T, C))
        for c in range(C):
            for s in range(c % 16, T - 5, 8):
                ts[s:s + 5, c] = 1.0 + 0.1 * rng.random(5)
        ts[256:260, 5] = np.nan
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
            for a in (ts, th, se)] + [torch.from_numpy(doy_pos).to(dev)]


SCAN_CASES = ([(K, c) for c in ("walk", "dense") for K in (128, 3)]
              + [(edges.CASES[n].K, n) for n in edges.CASES])


@pytest.mark.parametrize("K,case", SCAN_CASES,
                         ids=[f"{K}-{c}" for K, c in SCAN_CASES])
def test_event_scan_kernel_matches_plain(dev, case, K):
    """The random walk and the dense pattern, then the segment-edge cases
    of tests/test_torch_scan_edges.py at their card shapes."""
    kw = {}
    if case in edges.CASES:
        assert detect_scan.launch_config()["warps"] == edges.WARPS
        cs = edges.CASES[case]
        ts, th, se, pos = (torch.from_numpy(a).to(dev) for a in
                           edges.edge_inputs(case, cs.T_card, cs.C_card))
        kw = cs.rle
    else:
        ts, th, se, pos = scan_case(dev, case)
    f = rle.mhw_filter_plain(ts > th[pos.long()], **kw)
    if case not in edges.CASES:
        assert int(f["n_events"].max()) > (K if K < 10 else 10)
    args = (ts, th, se, pos, f["event_day"], f["is_start"], K)
    before = detect_scan.event_stats.launches
    Fk, Ik = detect_scan.event_stats(*args)
    Fp, Ip = detect_scan.event_stats_plain(*args)
    torch.cuda.synchronize()
    assert detect_scan.event_stats.launches == before + 1
    assert torch.equal(Ik, Ip)
    for i, ch in enumerate(detect_scan.F_CHANNELS):
        floats_close(Fk[i], Fp[i], ch)


def test_pipeline_on_card_matches_cpu(dev):
    """run_clim + run_detect through the kernels (several cell blocks)
    against the same pipeline on the CPU (plain versions)."""
    args, doy = clim_inputs(dev, C=200, years=3, seed=4)
    ts = args[0][:len(doy)].cpu().numpy()
    out = {}
    for d in ("cuda", "cpu"):
        th, se = pipeline.run_clim(ts, doy, 5, 366, 90, True, 31, True,
                                   block=64, device=d)
        tables, nev, _ = pipeline.run_detect(
            ts, th, se, (doy - 1).astype(np.int32), 5, True, 2, block=64,
            device=d)
        out[d] = th, se, tables, nev
    (a, b, c, n), (a2, b2, c2, n2) = out["cuda"], out["cpu"]
    np.testing.assert_array_equal(a, a2)
    np.testing.assert_allclose(b, b2, atol=1e-5, equal_nan=True)
    np.testing.assert_array_equal(n, n2)
    for k in c2:
        np.testing.assert_allclose(c[k], c2[k], rtol=2e-3, atol=2e-3,
                                   equal_nan=True, err_msg=k)


@pytest.mark.parametrize("T,C", [(3001, 300), (1, 33), (1024, 4096)])
def test_run_bound_kernel_bit_equal(dev, T, C):
    rng = np.random.default_rng(T)
    m = torch.from_numpy(rng.random((T, C)) > 0.6).to(dev)
    m[:, 0] = False
    m[:, -1] = True
    before = run_bound.run_bound.launches
    for mask in (m, ~m):
        for forward in (True, False):
            k = run_bound.run_bound(mask, forward)
            p = run_bound.run_bound_plain(mask, forward)
            assert k.dtype == torch.int32
            assert torch.equal(k, p), (forward, T, C)
    torch.cuda.synchronize()
    assert run_bound.run_bound.launches == before + 4


@pytest.mark.parametrize("name", list(rb_edges.CASES))
def test_run_bound_kernel_segment_edges(dev, name):
    """The segment-edge cases of tests/test_torch_run_bound_edges.py at
    their card shapes (60,000 days among them): both directions, on the
    mask and its negation."""
    case = rb_edges.CASES[name]
    assert run_bound.launch_config(case.T_card)["warps"] == rb_edges.WARPS
    m = torch.from_numpy(rb_edges.edge_mask(name, case.T_card,
                                            case.C_card)).to(dev)
    before = run_bound.run_bound.launches
    for mask in (m, ~m):
        for forward in (True, False):
            assert torch.equal(run_bound.run_bound(mask, forward),
                               run_bound.run_bound_plain(mask, forward)), (
                name, forward)
    torch.cuda.synchronize()
    assert run_bound.run_bound.launches == before + 4


def mesh_inputs(C=300, years=3):
    """A float32 series and the pipeline's calendar arguments."""
    (x, *_), doy = clim_inputs(torch.device("cpu"), C=C, years=years,
                               seed=7)
    ts = x[:len(doy)].numpy()
    years_of = (np.arange("2001-01-01", f"{2001 + years}-01-01",
                          dtype="datetime64[D]").astype("datetime64[Y]")
                .astype(int) + 1970)
    return ts, doy, years_of


def launch_counts():
    return (doy_quantile.doy_quantile.launches, rle.mhw_filter.launches,
            detect_scan.event_stats.launches)


def test_mesh_on_one_card_matches_single(dev):
    """run_clim, run_detect and run_fused (with its stats stage and
    ranks) on a mesh of [cuda:0, cuda:0] equal the single-device run bit
    for bit, and each kernel launches once per shard."""
    from xmhw_tpu_torch.core.stats import day_block_edges
    from xmhw_tpu_torch.parallel import cell_mesh

    ts, doy, years = mesh_inputs()
    pos = (doy - 1).astype(np.int32)
    mesh = cell_mesh(["cuda:0", "cuda:0"])
    out = {}
    for label, kw in (("single", {}), ("mesh", {"mesh": mesh})):
        before = launch_counts()
        th, se = pipeline.run_clim(ts, doy, 5, 366, 90, True, 31, True,
                                   device="cuda", **kw)
        tables, nev, _ = pipeline.run_detect(ts, th, se, pos, 5, True, 2,
                                             device="cuda", **kw)
        torch.cuda.synchronize()
        launches = [b - a for a, b in zip(before, launch_counts())]
        bins = np.arange(years[0], years[-1] + 2)
        fused = pipeline.run_fused(
            ts, doy, pos, ybod_np=(years - bins[0]).astype(np.int32),
            nbins=len(bins) - 1, day_edges=day_block_edges(years, bins),
            count_nans=True, rank_names=("intensity_max", "duration"),
            device="cuda", **kw)
        out[label] = (th, se, tables, nev, fused, launches)
    a, b = out["single"], out["mesh"]
    # clim: 1 launch a shard; detect: a counting and a detect RLE launch
    assert a[5] == [1, 2, 1] and b[5] == [2, 4, 2]
    for x, y in zip(a[:2], b[:2]):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a[3], b[3])
    for k in a[2]:
        np.testing.assert_array_equal(a[2][k], b[2][k], err_msg=k)
    fa, fb = a[4], b[4]
    for i in (0, 1, 3):
        np.testing.assert_array_equal(fa[i], fb[i])
    for k in fa[2]:
        np.testing.assert_array_equal(fa[2][k], fb[2][k], err_msg=k)
    for part in fa[4]:
        for k in fa[4][part]:
            np.testing.assert_array_equal(fa[4][part][k], fb[4][part][k],
                                          err_msg=f"{part} {k}")


# year-bin event statistics: (K, C, nbins, days of the key table or 0 for
# bins as keys, what else the case holds)
EVENT_BIN_CASES = {
    "shuffled": (40, 300, 7, 500, ""),
    "bins_as_keys": (40, 300, 7, 0, ""),
    "empty_bins": (40, 300, 12, 500, "empty"),
    "nan_cells": (40, 300, 7, 500, "nan"),
    "no_slots": (0, 300, 7, 500, ""),
    "past_128": (200, 133, 5, 0, "nan"),
}


def event_bin_case(dev, name):
    """Seeded event tables for :func:`event_bins`: slots in no order of
    bin, keys below 0 and past the table's end, days outside every bin,
    empty slots (NaN), +-inf; "empty": only bins 0-3 of 12 hold slots;
    "nan": cells 5-9 all NaN."""
    K, C, nbins, T, extra = EVENT_BIN_CASES[name]
    rng = np.random.default_rng(11)
    vals = rng.normal(1.0, 2.0, (13, K, C))
    vals[:, rng.random((K, C)) < 0.25] = np.nan
    vals[4][rng.random((K, C)) < 0.02] = np.inf
    vals[2][rng.random((K, C)) < 0.02] = -np.inf
    hi = 4 if extra == "empty" else nbins
    if T:
        lut = np.where(rng.random(T) < 0.1, -1, rng.integers(0, hi, T))
        key = rng.integers(-5, T + 5, (K, C))
        lut_t = torch.from_numpy(lut.astype(np.int32)).to(dev)
    else:
        key = np.where(rng.random((K, C)) < 0.1, -1,
                       rng.integers(0, hi, (K, C)))
        lut_t = None
    if extra == "nan":
        vals[:, :, 5:10] = np.nan
    vals_t = torch.from_numpy(vals.astype(np.float32)).to(dev)
    return ([v for v in vals_t], torch.from_numpy(key.astype(np.int32)).to(
        dev), nbins, lut_t)


@pytest.mark.parametrize("cold", [False, True])
@pytest.mark.parametrize("name", list(EVENT_BIN_CASES))
def test_block_event_kernel_bit_equal(dev, name, cold):
    """The event-bin kernel equals its plain version (a running sum per bin
    on the card) bit for bit, NaN where the plain version has NaN; one
    launch."""
    vals, key, nbins, lut = event_bin_case(dev, name)
    neg = [2, 3, 4, 5, 6, 9, 10] if cold else []
    before = event_bins.launches
    got = event_bins(vals, key, nbins, lut=lut, negate=neg)
    want = event_bins_plain(vals, key, nbins, lut=lut, negate=neg)
    torch.cuda.synchronize()
    assert event_bins.launches == before + 1
    assert list(got) == list(want)
    for k in want:
        assert same_bits(got[k], want[k]), (name, k)
    if vals[0].shape[0]:
        assert float(got["ecount"].sum()) > 0


# (T, C, edges, cells whose series is all NaN)
DAY_BIN_CASES = {
    "years": (1461, 300, (0, 365, 730, 1096, 1461), ()),
    "no_days": (1461, 300, (0, 0, 365, 365, 1000, 1461, 1461), ()),
    "nan_cells": (800, 130, (3, 200, 500, 799), (4, 5, 6, 129)),
}


@pytest.mark.parametrize("count_nans", [False, True])
@pytest.mark.parametrize("with_cats", [False, True])
@pytest.mark.parametrize("name", list(DAY_BIN_CASES))
def test_block_day_kernel_bit_equal(dev, name, with_cats, count_nans):
    """The day-bin kernel equals its plain version bit for bit: bins
    without days (equal edges), all-NaN cells, a cell with th == se
    (infinite or NaN categories), days past the last edge; one launch."""
    T, C, edges, nan_cells = DAY_BIN_CASES[name]
    rng = np.random.default_rng(12)
    ts = rng.normal(16.0, 1.5, (T, C))
    ts[rng.random((T, C)) < 0.03] = np.nan
    ts[:, list(nan_cells)] = np.nan
    th = rng.normal(17.0, 0.3, (366, C))
    se = rng.normal(15.5, 0.3, (366, C))
    th[:, 7] = se[:, 7]
    pos = (np.arange(T) % 365).astype(np.int32)
    ts_t, th_t, se_t = (torch.from_numpy(a.astype(np.float32)).to(dev)
                        for a in (ts, th, se))
    clim = ((th_t, se_t, torch.from_numpy(pos).to(dev)) if with_cats
            else (None, None, None))
    before = day_bins.launches
    got = day_bins(ts_t, edges, *clim, count_nans=count_nans)
    want = day_bins_plain(ts_t, edges, *clim, count_nans=count_nans)
    torch.cuda.synchronize()
    assert day_bins.launches == before + 1
    assert list(got) == list(want)
    for k in want:
        assert same_bits(got[k], want[k]), (name, k)
    if with_cats:
        assert float(got["moderate_days"].sum()) > 0


def test_stats_kernels_refuse_what_they_cannot_launch(dev, monkeypatch):
    """On the card the stats kernels launch or raise TypeError: float64
    values, a float64 climatology beside a float32 series, a key left on
    the CPU. Nothing launches and nothing is counted."""
    from xmhw_tpu_torch import utils

    monkeypatch.setattr(utils, "_counts", {})
    vals, key, nbins, lut = event_bin_case(dev, "shuffled")
    ts = torch.randn((400, 50), device=dev)
    th = torch.randn((366, 50), dtype=torch.float64, device=dev)
    pos = torch.arange(400, dtype=torch.int32, device=dev) % 366
    before = (event_bins.launches, day_bins.launches)
    calls = [
        lambda: event_bins([v.double() for v in vals], key, nbins, lut=lut),
        lambda: event_bins(vals, key.cpu(), nbins, lut=lut),
        lambda: day_bins(ts.double(), (0, 100, 400)),
        lambda: day_bins(ts, (0, 100, 400), th, th, pos),
    ]
    for call in calls:
        with pytest.raises(TypeError, match="block_stats kernel"):
            call()
    assert (event_bins.launches, day_bins.launches) == before
    assert utils.counts().get("stats_calls", 0) == 0


@pytest.mark.parametrize("dtype,use_kernels", [
    (np.float32, None), (np.float32, False), (np.float64, None)])
def test_run_fused_stats_route_follows_use_kernels(dev, monkeypatch, dtype,
                                                   use_kernels):
    """run_fused's stats stage takes the kernels by ``use_kernels_for``:
    float32 on the card launches each once a block; ``use_kernels=False``
    and float64 launch none and count no kernel call."""
    from xmhw_tpu_torch import utils
    from xmhw_tpu_torch.core.stats import day_block_edges

    t = np.arange("2001-01-01", "2004-01-01", dtype="datetime64[D]")
    doy, _ = compute_doy(TimeIndex(t))
    years = t.astype("datetime64[Y]").astype(int) + 1970
    bins = np.arange(years[0], years[-1] + 2)
    ts = field(len(t), 200, seed=14).astype(dtype)
    kw = dict(ybod_np=(years - bins[0]).astype(np.int32),
              nbins=len(bins) - 1, day_edges=day_block_edges(years, bins),
              count_nans=True, block=100, device="cuda")
    pos = (doy - 1).astype(np.int32)
    monkeypatch.setattr(utils, "_counts", {})
    before = (event_bins.launches, day_bins.launches)
    got = pipeline.run_fused(ts, doy, pos, use_kernels=use_kernels, **kw)[4]
    torch.cuda.synchronize()
    n = 2 if use_kernels is None and dtype == np.float32 else 0
    assert (event_bins.launches - before[0],
            day_bins.launches - before[1]) == (n, n)
    assert utils.counts().get("stats_calls") == 4
    assert utils.counts().get("stats_kernel_calls", 0) == 2 * n
    assert np.nansum(got["block"]["ecount"]) > 20


def test_fused_stats_mesh_block_20_matches_single(dev):
    """run_fused's stats on a mesh of [cuda:0, cuda:0] at block=20 equal
    the single-device run bit for bit (the kernels' sums do not depend on
    the shard's width), cold spells too; each stats kernel launches once
    per shard."""
    from xmhw_tpu_torch.core.stats import day_block_edges
    from xmhw_tpu_torch.parallel import cell_mesh

    t = np.arange("2001-01-01", "2005-01-01", dtype="datetime64[D]")
    doy, _ = compute_doy(TimeIndex(t))
    years = t.astype("datetime64[Y]").astype(int) + 1970
    ts = field(len(t), 300, seed=13)
    ts[:, 3] = np.nan
    pos = (doy - 1).astype(np.int32)
    bins = np.arange(years[0], years[-1] + 2)
    kw = dict(ybod_np=(years - bins[0]).astype(np.int32),
              nbins=len(bins) - 1, day_edges=day_block_edges(years, bins),
              count_nans=True, device="cuda")
    for cold in (False, True):
        out = {}
        for label, mkw in (("single", {}),
                           ("mesh", {"mesh": cell_mesh(["cuda:0", "cuda:0"]),
                                     "block": 20})):
            before = (event_bins.launches, day_bins.launches)
            fused = pipeline.run_fused(ts, doy, pos, cold_spells=cold,
                                       **kw, **mkw)
            torch.cuda.synchronize()
            out[label] = (fused[4], (event_bins.launches - before[0],
                                     day_bins.launches - before[1]))
        (a, la), (b, lb) = out["single"], out["mesh"]
        assert la == (1, 1) and lb == (30, 30)
        assert np.nansum(a["block"]["ecount"]) > 50
        for part in ("block", "day"):
            assert sorted(a[part]) == sorted(b[part])
            for k in a[part]:
                assert np_same_bits(a[part][k], b[part][k]), (cold, part, k)


def test_kernels_on_a_second_card(dev):
    """Each kernel launches on its tensor's device, not the current one:
    inputs on cuda:1 while cuda:0 is current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two visible GPUs")
    d1 = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    m = torch.from_numpy(np.random.default_rng(5).random((3001, 300))
                         > 0.6).to(d1)
    for forward in (True, False):
        assert torch.equal(run_bound.run_bound(m, forward),
                           run_bound.run_bound_plain(m, forward))
    k = rle.mhw_filter(m)
    p = rle.mhw_filter_plain(m)
    for name in p:
        assert torch.equal(k[name], p[name]), name
    args = tuple(a.to(d1) if torch.is_tensor(a) else a
                 for a in doy_case(dev, "lanes"))
    thk, sek = doy_quantile.doy_quantile(*args)
    thp, sep = doy_quantile.doy_quantile_plain(*args)
    assert thk.device == d1 and same_bits(thk, thp)
    ts, th, se, pos = (a.to(d1) for a in scan_case(dev, "walk"))
    f = rle.mhw_filter_plain(ts > th[pos.long()])
    sargs = (ts, th, se, pos, f["event_day"], f["is_start"], 64)
    Fk, Ik = detect_scan.event_stats(*sargs)
    Fp, Ip = detect_scan.event_stats_plain(*sargs)
    torch.cuda.synchronize(d1)
    assert torch.equal(Ik, Ip)
    floats_close(Fk, Fp, "scan on cuda:1")


def stats_events(dev):
    """threshold() + detect() (float32 kernels) of a 5-year 6 x 7 grid on
    the card, compact and union layouts, and the ts/thresh/seas dstime."""
    t = np.arange("2001-01-01", "2006-01-01",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    T = len(t)
    rng = np.random.default_rng(6)
    day = np.arange(T)[:, None, None]
    ts = (15 + 3 * np.sin(2 * np.pi * day / 365.25)
          + np.cumsum(rng.normal(0, 0.3, (T, 6, 7)), 0) * 0.2)
    ts[:, 0, 0] = np.nan
    ts[50:52, 2, 3] = np.nan
    da = DataArray(ts.astype(np.float32), ("time", "lat", "lon"),
                   {"time": Coord(("time",), t),
                    "lat": Coord(("lat",), np.arange(6.0)),
                    "lon": Coord(("lon",), np.arange(7.0))})
    clim = xt.threshold(da, device=dev)
    mhw, inter = xt.detect(da, clim["thresh"], clim["seas"], device=dev,
                           intermediate=True, events_layout="compact")
    union = xt.detect(da, clim["thresh"], clim["seas"], device=dev)
    return da, mhw, union, inter


def stats_close(got, want):
    assert sorted(got.keys()) == sorted(want.keys())
    for k in want.keys():
        a = np.asarray(got[k].data, np.float64)
        b = np.asarray(want[k].data, np.float64)
        assert np.array_equal(np.isnan(a), np.isnan(b)), k
        if k == "ecount" or k.endswith("_days"):
            np.testing.assert_array_equal(a, b, err_msg=k)
        elif k.startswith("ts_"):
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=0,
                                       equal_nan=True, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                       equal_nan=True, err_msg=k)


def test_stats_on_card_match_host(dev):
    da, mhw, union, inter = stats_events(dev)
    for ev in (mhw, union):
        assert np.isfinite(np.asarray(ev["duration"].data)).sum() > 20
        for kw in (dict(period=[2001, 2005]), dict(dstime=da),
                   dict(dstime=inter, removeMissing=True),
                   dict(dstime=inter, blockLength=2)):
            stats_close(xt.block_average(ev, device="cuda", **kw),
                        xt.block_average(ev, device=False, **kw))
        stats_close(xt.block_average(ev, period=[2001, 2005], device=True),
                    xt.block_average(ev, period=[2001, 2005], device=False))
        rk, rp = xt.mhw_rank(ev, device="cuda")
        hk, hp = xt.mhw_rank(ev, device=False)
        for k in hk.keys():
            np.testing.assert_array_equal(rk[k].data, hk[k].data, err_msg=k)
            np.testing.assert_array_equal(rp[k].data, hp[k].data, err_msg=k)


@pytest.mark.parametrize("cell_block", [65536, 7], ids=["one", "blocks"])
def test_ranks_on_card_in_cell_blocks_match_host(dev, cell_block):
    """mhw_rank on the card, in one cell block or several: ranks and
    return periods equal the host path's bit for bit."""
    _, mhw, union, _ = stats_events(dev)
    for ev in (mhw, union):
        hk, hp = xt.mhw_rank(ev, device=False)
        rk, rp = xt.mhw_rank(ev, device="cuda", cell_block=cell_block)
        assert sorted(rk.keys()) == sorted(hk.keys())
        for k in hk.keys():
            np.testing.assert_array_equal(rk[k].data, hk[k].data, err_msg=k)
            np.testing.assert_array_equal(rp[k].data, hp[k].data, err_msg=k)


def _tables_as(ds, dtype):
    """``ds`` with every float table cast to ``dtype``."""
    out = Dataset()
    for k in ds.keys():
        a = np.asarray(ds[k].data)
        out[k] = ds[k].copy(data=a.astype(dtype) if a.dtype.kind == "f"
                            else a)
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ranks_land_in_pinned_memory_with_the_host_bits(dev, dtype):
    """mhw_rank on the card, union and compact layouts, float32 and float64
    tables: float64 ranks and return periods equal to the host path's bit
    for bit, each call's results in page-locked memory (one
    ``rank_pinned_calls`` a call), and a second call, after the first's
    results are let go and its buffers return to the caching host
    allocator, gives the same bits."""
    from xmhw_tpu_torch import utils

    _, mhw, union, _ = stats_events(dev)
    for ev in (mhw, union):
        ev = _tables_as(ev, dtype)
        assert np.asarray(ev["intensity_max"].data).dtype == dtype
        hk, hp = xt.mhw_rank(ev, device=False)
        before = utils.counts()
        first = xt.mhw_rank(ev, device="cuda")
        for got, want in zip(first, (hk, hp)):
            assert sorted(got.keys()) == sorted(want.keys())
            for k in want.keys():
                assert got[k].data.dtype == np.float64, k
                np.testing.assert_array_equal(got[k].data, want[k].data,
                                              err_msg=k)
        bits = {k: first[0][k].data.tobytes() + first[1][k].data.tobytes()
                for k in hk.keys()}
        del first, got
        rk, rp = xt.mhw_rank(ev, device="cuda")
        for k in hk.keys():
            assert rk[k].data.tobytes() + rp[k].data.tobytes() == bits[k], k
        after = utils.counts()
        for name in ("rank_calls", "rank_pinned_calls"):
            assert after.get(name, 0) - before.get(name, 0) == 2, name


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros((10, 4), dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        doy_quantile.doy_quantile(x, x, x, 1, 1, 1)
    with pytest.raises(TypeError):
        rle.mhw_filter(x)
    with pytest.raises(TypeError):
        detect_scan.event_stats(x, x, x, x, x, x, 4)
    with pytest.raises(TypeError):
        run_bound.run_bound(x)
    with pytest.raises(TypeError):  # not contiguous
        run_bound.run_bound(torch.zeros((4, 10), dtype=torch.bool,
                                        device=dev).t())


def test_broken_source_build_raises(dev, tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    src = csrc / "runtime.cu"
    text = src.read_text()
    broken = text.replace("#include <cuda_runtime.h>",
                          "#include <cuda_runtime.h>\nint broken = ;")
    assert broken != text
    src.write_text(broken)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="error"):
        _build.build()


def test_timed_synchronises_the_card(dev, monkeypatch):
    from xmhw_tpu_torch import utils

    real = torch.cuda.synchronize
    calls = []

    def spy(d=None):
        calls.append(d)
        real(d)

    monkeypatch.setattr(torch.cuda, "synchronize", spy)
    with utils.timed("matmul", log=False) as t:
        x = torch.ones((512, 512), device=dev)
        t["sync"] = [x @ x, torch.ones(2)]
    assert calls == [x.device]
    assert t["seconds"] > 0.0


def test_trace_holds_the_program_spans_over_the_card_work(dev, tmp_path):
    """utils.trace around threshold() + detect() on the card: the chrome
    trace holds the program's spans, the kernels they launched and the
    copies, on one clock; the byte counters equal the traced copies."""
    import glob
    import json

    from xmhw_tpu_torch import utils

    da = f64_grid()
    da = DataArray(da.data.astype(np.float32), da.dims, da.coords)
    clim = xt.threshold(da, device=str(dev))  # builds, warms
    xt.detect(da, clim["thresh"], clim["seas"], device=str(dev))
    before = utils.counts()
    with utils.trace(str(tmp_path)):
        clim = xt.threshold(da, device=str(dev))
        mhw = xt.detect(da, clim["thresh"], clim["seas"], device=str(dev))
    after = utils.counts()
    # detect()'s union grids, built on the card: each valid entry's flat
    # index (int64) and every variable's value up, the grids down
    n = int(np.isfinite(np.asarray(mhw["event"].data)).sum())
    union_up = n * (8 + sum(np.asarray(mhw[k].data).itemsize
                            for k in mhw.keys()))
    union_down = after["union_card_bytes"] - before["union_card_bytes"]
    assert union_down == sum(np.asarray(mhw[k].data).nbytes
                             for k in mhw.keys())
    (path,) = glob.glob(str(tmp_path / "*.json"))
    with open(path) as f:
        ev = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = [e for e in ev if e.get("cat") == "user_annotation"
             and str(e["name"]).startswith("xmhw/")]
    names = [e["name"] for e in spans]
    for n, k in (("xmhw/threshold", 1), ("xmhw/detect", 1),
                 ("xmhw/land_check", 4), ("xmhw/assemble", 2),
                 ("xmhw/run_clim", 1), ("xmhw/run_detect", 1)):
        assert names.count(n) == k, n
    kernels = [e for e in ev if e.get("cat") == "kernel"]
    assert any("doy_quantile" in e["name"] for e in kernels)
    assert any("rle_kernel" in e["name"] for e in kernels)
    (t0, t1), (d0, d1) = [(e["ts"], e["ts"] + e["dur"]) for e in spans
                          if e["name"] in ("xmhw/threshold", "xmhw/detect")]
    assert t0 < t1 <= d0 < d1  # host spans on the device's clock
    copied = {k: sum(int((e.get("args") or {}).get("bytes", 0)) for e in ev
                     if e.get("cat") == "gpu_memcpy" and k in e["name"])
              for k in ("HtoD", "DtoH")}
    # the counters hold the pipeline's copies; the trace has besides
    # a few bytes of scalars up and of K and the overflow check down
    for k, name, union in (("HtoD", "h2d_bytes", union_up),
                           ("DtoH", "d2h_bytes", union_down)):
        assert 0 <= copied[k] - (after[name] - before[name]) - union <= 256, k


def test_stats_default_device_is_the_card(dev):
    """block_average()/mhw_rank() without ``device`` equal device="cuda"
    bit for bit."""
    _, mhw, _, inter = stats_events(dev)
    a = xt.block_average(mhw, dstime=inter)
    b = xt.block_average(mhw, dstime=inter, device="cuda")
    for k in b.keys():
        assert np_same_bits(a[k].data, b[k].data), k
    for x, y in zip(xt.mhw_rank(mhw), xt.mhw_rank(mhw, device="cuda")):
        for k in y.keys():
            assert np_same_bits(x[k].data, y[k].data), k


def union_grid():
    """10 daily years on a 64 x 64 grid, row 0 and column 9 land."""
    T = 3650
    t = (np.datetime64("2001-01-01", "ns")
         + np.arange(T) * np.timedelta64(1, "D"))
    ts = field(T, 64 * 64, 12).reshape(T, 64, 64)
    ts[:, 0, :] = np.nan
    ts[:, :, 9] = np.nan
    return DataArray(ts, ("time", "lat", "lon"),
                     {"time": Coord(("time",), t),
                      "lat": Coord(("lat",), np.arange(64.0)),
                      "lon": Coord(("lon",), np.arange(64.0))})


def test_union_grids_built_on_the_card(dev, monkeypatch):
    """detect()'s union grids on the card: bit-equal to the host route,
    which a card run takes where the pinned buffers would not fit, in
    every variable; the counters rise by one call, the grids' bytes,
    their pinned request and their rows;
    the arrays are writable views of pinned memory, and they keep their
    values while a second detect() runs."""
    from xmhw_tpu_torch import api, utils

    da = union_grid()
    clim = xt.threshold(da, device=dev)
    args = (da, clim["thresh"], clim["seas"])
    before = utils.counts()
    card = xt.detect(*args, device=dev)
    after = utils.counts()
    grids = {k: np.asarray(card[k].data) for k in card.keys()}
    assert all(card[k].dims[0] == "events" for k in grids)
    assert after["union_card_calls"] - before.get("union_card_calls",
                                                  0) == 1
    assert after["union_card_bytes"] - before.get(
        "union_card_bytes", 0) == sum(a.nbytes for a in grids.values())
    assert after["union_pinned_bytes"] - before.get(
        "union_pinned_bytes", 0) == api._pinned_bytes(
        [a.nbytes for a in grids.values()])
    assert after["union_rows"] - before.get("union_rows", 0) == len(
        card.coords["events"].values)
    assert torch.from_numpy(grids["duration"]).is_pinned()

    # no host memory to pin: the host route
    monkeypatch.setattr(api, "_host_available", lambda: 0)
    host = xt.detect(*args, device=dev)
    monkeypatch.undo()
    assert utils.counts()["union_card_calls"] == after["union_card_calls"]
    assert utils.counts()["union_pinned_bytes"] == after[
        "union_pinned_bytes"]
    assert sorted(host.keys()) == sorted(card.keys())
    for k in host.keys():
        assert card[k].dims == host[k].dims, k
        for c in host[k].coords:
            assert np_same_bits(card[k].coords[c].values,
                                host[k].coords[c].values), (k, c)
        assert np_same_bits(grids[k], host[k].data), k
    assert np.isfinite(grids["event"]).sum() > 1000

    kept = {k: a.copy() for k, a in grids.items()}
    again = xt.detect(*args, device=dev)
    assert utils.counts()["union_card_calls"] == after[
        "union_card_calls"] + 1
    for k, a in grids.items():
        assert np_same_bits(a, kept[k]), k
        assert np_same_bits(np.asarray(again[k].data), kept[k]), k
        assert a.flags.writeable, k
    grids["duration"][0, 1, 1] = 7.0
    assert grids["duration"][0, 1, 1] == 7.0


def inter_box():
    """10 daily years on a 16 x 16 grid, row 0 and column 3 land."""
    T = 3650
    t = (np.datetime64("2001-01-01", "ns")
         + np.arange(T) * np.timedelta64(1, "D"))
    ts = field(T, 16 * 16, 14).reshape(T, 16, 16)
    ts[:, 0, :] = np.nan
    ts[:, :, 3] = np.nan
    return DataArray(ts, ("time", "lat", "lon"),
                     {"time": Coord(("time",), t),
                      "lat": Coord(("lat",), np.arange(16.0)),
                      "lon": Coord(("lon",), np.arange(16.0))})


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_intermediate_grids_built_on_the_card(dev, dtype, monkeypatch):
    """detect(intermediate=True) on the card builds the intermediate
    grids there: bit-equal to ``device="cpu"`` (the same climatology) in
    every variable, dims and coordinates; each grid a view of page-locked
    memory; the call counts one ``inter_card_calls`` and the grids'
    bytes in ``inter_bytes``. With no host memory to pin, the card run
    takes the host route, counts no card call and gives the same bits."""
    from xmhw_tpu_torch import api, utils

    da = inter_box()
    clim = xt.threshold(da, dtype=dtype, device="cpu")
    args = (da, clim["thresh"], clim["seas"])
    kw = dict(intermediate=True, dtype=dtype)
    _, want = xt.detect(*args, device="cpu", **kw)
    before = utils.counts()
    _, card = xt.detect(*args, device=dev, **kw)
    after = utils.counts()
    assert after["inter_card_calls"] - before.get("inter_card_calls",
                                                  0) == 1
    assert after["inter_bytes"] - before.get("inter_bytes", 0) == sum(
        card[k].data.nbytes for k in card.keys())
    assert list(card.keys()) == list(want.keys())
    for k in want.keys():
        assert card[k].dims == want[k].dims, k
        for c in want[k].coords:
            assert np_same_bits(card[k].coords[c].values,
                                want[k].coords[c].values), (k, c)
        assert np_same_bits(card[k].data, want[k].data), k
        assert torch.from_numpy(card[k].data).is_pinned(), k
    assert np.nansum(card["events"].data) > 0

    monkeypatch.setattr(api, "_host_available", lambda: 0)
    _, host = xt.detect(*args, device=dev, **kw)
    assert utils.counts()["inter_card_calls"] == after["inter_card_calls"]
    for k in want.keys():
        assert np_same_bits(host[k].data, card[k].data), k
        assert not torch.from_numpy(host[k].data).is_pinned(), k


def test_land_check_compacts_into_pinned_memory(dev, monkeypatch):
    """threshold() + detect() on the card: every land check of the pair
    writes page-locked memory, and the series run_clim and run_detect get
    is that buffer; the outputs equal the plain-memory route's; a second
    pair reuses the cached buffer and leaves the first pair's results as
    they were."""
    from xmhw_tpu_torch import api, utils

    da = union_grid()
    seen = []  # (stage, pinned, address): holding the arrays would
    # keep their buffers from the cache

    def spy(name, fn):
        def inner(ts_np, *a, **kw):
            seen.append((name, torch.from_numpy(ts_np).is_pinned(),
                         ts_np.ctypes.data))
            return fn(ts_np, *a, **kw)
        return inner

    monkeypatch.setattr(api, "run_clim", spy("clim", api.run_clim))
    monkeypatch.setattr(api, "run_detect", spy("detect", api.run_detect))

    def pair():
        clim = xt.threshold(da, device=dev)
        return clim, xt.detect(da, clim["thresh"], clim["seas"],
                               device=dev)

    before = utils.counts()
    first = pair()
    after = utils.counts()
    calls = after["land_calls"] - before.get("land_calls", 0)
    assert calls == 4
    assert after["land_pinned_calls"] - before.get(
        "land_pinned_calls", 0) == calls
    assert [(n, p) for n, p, _ in seen] == [("clim", True),
                                            ("detect", True)]
    kept = [{k: np.asarray(ds[k].data).copy() for k in ds.keys()}
            for ds in first]

    second = pair()
    assert len({a for _, _, a in seen}) == 1  # one cached buffer
    assert all(p for _, p, _ in seen)
    for ds, want in zip(first, kept):
        for k in ds.keys():
            assert np_same_bits(ds[k].data, want[k]), k

    monkeypatch.setattr(api, "_land_pinned", lambda dev, nbytes: False)
    n = utils.counts()["land_pinned_calls"]
    plain = pair()
    assert utils.counts()["land_pinned_calls"] == n
    assert not any(p for _, p, _ in seen[-2:])
    for a, b, c in zip(first, second, plain):
        for k in a.keys():
            assert np_same_bits(b[k].data, a[k].data), k
            assert np_same_bits(c[k].data, a[k].data), k


def f64_grid():
    """10 daily years on a 6 x 7 grid, float64, one land cell."""
    t = np.arange("2001-01-01", "2011-01-01",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    rng = np.random.default_rng(8)
    day = np.arange(len(t))[:, None, None]
    ts = (15 + 3 * np.sin(2 * np.pi * day / 365.25)
          + np.cumsum(rng.normal(0, 0.3, (len(t), 6, 7)), 0) * 0.2)
    ts[:, 0, 0] = np.nan
    return DataArray(ts, ("time", "lat", "lon"),
                     {"time": Coord(("time",), t),
                      "lat": Coord(("lat",), np.arange(6.0)),
                      "lon": Coord(("lon",), np.arange(7.0))})


def f64_run(da, **kw):
    clim = xt.threshold(da, dtype=np.float64, **kw)
    mhw = xt.detect(da, clim["thresh"], clim["seas"], dtype=np.float64,
                    events_layout="compact", **kw)
    return clim, mhw


def assert_ds_bits(a, b):
    assert sorted(a.keys()) == sorted(b.keys())
    for k in a.keys():
        assert np_same_bits(a[k].data, b[k].data), k


def test_float64_detect_repeats_its_bits(dev):
    """float64 runs the plain event scan on the card: run after run, the
    same bits (its sums add each event's days in order, no atomics)."""
    da = f64_grid()
    first = f64_run(da, device="cuda")
    assert np.isfinite(np.asarray(first[1]["duration"].data)).sum() > 20
    for _ in range(2):
        for a, b in zip(first, f64_run(da, device="cuda")):
            assert_ds_bits(a, b)
    ts, th, se, pos = (a.double() if a.is_floating_point() else a
                       for a in scan_case(dev, "walk"))
    f = rle.mhw_filter_plain(ts > th[pos.long()])
    args = (ts, th, se, pos, f["event_day"], f["is_start"], 128)
    F0, I0 = detect_scan.event_stats_plain(*args)
    for _ in range(3):
        F, I = detect_scan.event_stats_plain(*args)
        assert same_bits(F, F0) and torch.equal(I, I0)


def test_float64_mesh_on_one_card_matches_single(dev):
    """float64 threshold() + detect() over [cuda:0, cuda:0] equal the
    single-device run bit for bit."""
    from xmhw_tpu_torch.parallel import cell_mesh

    da = f64_grid()
    one = f64_run(da, device="cuda")
    two = f64_run(da, mesh=cell_mesh(["cuda:0", "cuda:0"]))
    for a, b in zip(one, two):
        assert_ds_bits(a, b)


def test_float64_card_bits_against_the_cpu(dev):
    """float64 on the card and on the CPU: the climatology and every
    event-table variable equal bit for bit, but the four variances
    (intensity_var*, severity_var), whose ``torch.sqrt`` rounds
    correctly on the card and not always on the CPU (~0.9 % of float64
    inputs one ulp apart): those within one ulp."""
    da = f64_grid()
    for a, b in zip(f64_run(da, device="cuda"), f64_run(da, device="cpu")):
        assert sorted(a.keys()) == sorted(b.keys())
        for k in a.keys():
            if "_var" not in k:
                assert np_same_bits(a[k].data, b[k].data), k
                continue
            x, y = np.asarray(a[k].data), np.asarray(b[k].data)
            np.testing.assert_allclose(x, y, rtol=2.0 ** -52, atol=0,
                                       equal_nan=True, err_msg=k)


def test_fused_threshold_detect_kernels_match_plain(dev):
    """fused_threshold_detect at the main path's shape (T = 14,610 x
    4,096 cells, K = 128, float32): kernels 1-3 once each against the
    plain versions, at PERF.md's bars (thresh 1e-6, seas 1e-5, counts and
    positions exact, event floats rtol = atol = 2e-3)."""
    t = np.arange(f"{START_YEAR}-01-01", f"{START_YEAR + 40}-01-01",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    doy, ndoy = compute_doy(TimeIndex(t))
    assert len(t) == 14610
    pos = (doy - 1).astype(np.int32)
    x = torch.from_numpy(field(len(t), 4096, seed=2)).to(dev)
    rle.reset_launches()
    before = launch_counts()
    th, se, tab, n = pipeline.fused_threshold_detect(x, doy, pos, K=128,
                                                     ndoy=ndoy)
    torch.cuda.synchronize()
    assert [b - a for a, b in zip(before, launch_counts())] == [1, 1, 1]
    assert rle.mhw_filter.by_mode["days"] == 1
    thp, sep, tabp, n_p = pipeline.fused_threshold_detect(
        x, doy, pos, K=128, ndoy=ndoy, use_kernels=False)
    assert int(n.sum()) > 0
    assert torch.equal(n, n_p)
    floats_close(th, thp, "thresh", tol=1e-6)
    floats_close(se, sep, "seas", tol=1e-5)
    exact = ("event", "index_", "time_", "duration", "category")
    for k, v in tabp.items():
        if k.startswith(exact):
            assert torch.equal(torch.nan_to_num(tab[k].double(), nan=-9.0),
                               torch.nan_to_num(v.double(), nan=-9.0)), k
        else:
            floats_close(tab[k], v, k)


def test_dryrun_two_ranks_on_one_card(dev):
    """tools/torch_multiproc_dryrun.py: two ranks of a gloo group on
    cuda:0 (nccl with one GPU a rank where two are visible), each feeding
    its own shard, bit-equal to the unsharded step."""
    import subprocess

    root = Path(__file__).resolve().parent.parent
    r = subprocess.run(
        [sys.executable, str(root / "tools" / "torch_multiproc_dryrun.py"),
         "--device", "cuda", "--timeout", "200"], capture_output=True,
        text=True, timeout=260, cwd=root)
    assert r.returncode == 0, r.stdout + r.stderr[-4000:]
    assert "rank 0: OK" in r.stdout and "rank 1: OK" in r.stdout
    assert "torch multiproc dryrun: PASS" in r.stdout


@pytest.fixture
def h5py_lib(monkeypatch):
    """The library the streamed files go through, for this test alone:
    h5py, or on a machine without it (the card's) the numpy stand-in, put
    first on sys.path as chip_smoke.py puts it. The path and the module
    are taken back after the test."""
    import importlib.util

    if importlib.util.find_spec("h5py") is not None:
        yield
        return
    monkeypatch.syspath_prepend(
        str(Path(__file__).resolve().parent.parent / "tools" /
            "h5py_standin"))
    yield
    sys.modules.pop("h5py", None)


def test_stream_run_fills_gaps_on_the_read_ahead_thread(dev, tmp_path,
                                                        h5py_lib):
    """stream_run(maxPadLength=2) on the card, four stripes: each stripe's
    gaps are filled on the card by the read-ahead thread while the main
    thread steps the previous stripe. The climatology and the event tables
    equal one in-memory run_fused over the gaps filled on the main thread,
    bit for bit, and the K of later stripes (k_min) loses no event."""
    from xmhw_tpu_torch.api import _interpolate_na
    from xmhw_tpu_torch.core.features_scan import TABLE_VARS
    from xmhw_tpu_torch.xrlite import Dataset

    t = np.arange(f"{START_YEAR}-01-01", f"{START_YEAR + 6}-01-01",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    T, ny, nx = len(t), 16, 24
    ts = field(T, ny * nx, 21).astype(np.float32)
    rng = np.random.default_rng(4)
    ts[:, rng.permutation(ny * nx)[:40]] = np.nan  # land
    for c in rng.permutation(ny * nx)[:96]:  # 1-, 2- and 5-day gaps
        for n in (1, 2, 5):
            s = int(rng.integers(1, T - 6))
            ts[s:s + n, c] = np.nan
    ds = Dataset()
    ds["sst"] = DataArray(
        ts.reshape(T, ny, nx), ("time", "lat", "lon"),
        {"time": Coord(("time",), t),
         "lat": Coord(("lat",), np.arange(ny, dtype=float)),
         "lon": Coord(("lon",), np.arange(nx, dtype=float))})
    src = str(tmp_path / "sst.nc")
    xt.save_dataset(ds, src)
    c, m = str(tmp_path / "c.nc"), str(tmp_path / "m.nc")
    xt.stream_run(src, "sst", c, m, maxPadLength=2, stripe=4, device=dev)
    ocean = ~np.isnan(ts).all(axis=0)
    filled = _interpolate_na(np.ascontiguousarray(ts[:, ocean]), 2, dev)
    doy, ndoy = compute_doy(TimeIndex(t))
    th, se, tables, nev, _ = pipeline.run_fused(
        filled, doy, (doy - 1).astype(np.int32), ndoy=ndoy, device=dev)
    clim, mhw = xt.open_dataset(c), xt.open_dataset(m)
    for k, v in (("thresh", th), ("seas", se)):
        assert np_same_bits(
            np.asarray(clim[k].data).reshape(ndoy, -1)[:, ocean], v), k
    K = mhw["event"].sizes["ev"]
    assert K >= tables["event"].shape[0] and int(nev.sum()) > 0
    for k in TABLE_VARS:
        if k.startswith("time_"):
            continue
        got = np.asarray(mhw[k].data, np.float64).reshape(K, -1)[:, ocean]
        want = np.full(got.shape, np.nan)
        want[:tables[k].shape[0]] = tables[k]
        np.testing.assert_array_equal(got, want, err_msg=k)
