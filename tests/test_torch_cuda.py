"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc, and skips without them. The
file imports neither JAX nor the JAX package, so that it runs where only
PyTorch is installed; run it on the card with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: the RLE and the running bound exact; clim thresholds exact
and means within 1e-5 (both sum in float64, in different orders); the
event scan's counts and positions exact and its floats within rtol =
atol = 2e-3. block_average/mhw_rank on the card against the host numpy
path: counts and ranks exact, day statistics rtol 1e-9 (both float64),
event statistics rtol = atol = 1e-5 (float32 tables on the card, float64
sums on the host).
"""

import shutil

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
import test_torch_scan_edges as edges  # noqa: E402

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
    before = rle.mhw_filter.launches
    for full in (True, False):
        k = rle.mhw_filter(b, full=full, **kw)
        p = rle.mhw_filter_plain(b, full=full, **kw)
        assert sorted(k) == sorted(p)
        for name in p:
            assert torch.equal(k[name], p[name]), (name, full)
    torch.cuda.synchronize()
    assert rle.mhw_filter.launches == before + 2


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


@pytest.mark.parametrize("pctile", [90, 87.5, 10])
def test_doy_quantile_kernel_matches_plain(dev, pctile):
    args, _ = clim_inputs(dev)
    before = doy_quantile.doy_quantile.launches
    thk, sek = doy_quantile.doy_quantile(*args, pctile=pctile)
    thp, sep = doy_quantile.doy_quantile_plain(*args, pctile=pctile)
    assert doy_quantile.doy_quantile.launches == before + 1
    assert torch.equal(torch.isnan(thk), torch.isnan(thp))
    assert torch.equal(torch.nan_to_num(thk), torch.nan_to_num(thp))
    floats_close(sek, sep, "seas", tol=1e-5)
    assert bool(torch.isnan(thk[:, 29]).all())


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
                    xt.block_average(ev, period=[2001, 2005]))
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
    src = csrc / "rle.cu"
    src.write_text(src.read_text().replace("int cnt = 0;", "int cnt = 0"))
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
