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
from xmhw_tpu_torch.xrlite import Coord, DataArray, TimeIndex  # noqa
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
    the wrapper takes (1,816 rows)."""
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


def test_doy_quantile_refuses_pools_past_the_tile(dev):
    args = list(doy_case(dev, "largest"))
    args[4] += 1  # ny * rmax = 1,824 rows: past the 227 KB shared tile
    args[1] = torch.zeros(args[3] * args[4], dtype=torch.int32, device=dev)
    args[2] = torch.zeros_like(args[1])
    with pytest.raises(ValueError):
        doy_quantile.doy_quantile(*args)


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
