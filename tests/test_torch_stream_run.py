"""The port's one-pass streamed pipeline (xmhw_tpu_torch.stream_run), its
resume watermark and its grid bands, on the CPU.

stream_run (climatology + detection + year-block statistics + ranks, one
read and one upload per stripe) must write the files of the port's staged
chain (stream_threshold -> stream_detect -> stream_block_average ->
stream_rank) and of xmhw_tpu.stream_run on the same input. A run stopped
after its first stripe and resumed, and a grid cut into two row bands
merged with merge_grid_band_files, must write the files of one
uninterrupted run. Bars as in tests/test_torch_stream.py: float64 within
1e-9; float32 thresholds bit-equal, seasonal means within 1e-5, event
positions, counts and ranks exact, event floats within 2e-3.
"""

import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import h5py  # noqa: E402

import xmhw_tpu as xm  # noqa: E402
import xmhw_tpu_torch as xt  # noqa: E402
from test_torch_stream import assert_files_match, write_grid  # noqa: E402
from xmhw_tpu_torch import stream as tst  # noqa: E402

PARTS = ("clim", "mhw", "block", "rank", "return")
CPU = {"device": "cpu"}


@pytest.fixture(scope="module")
def grid_file(tmp_path_factory):
    return write_grid(tmp_path_factory.mktemp("trun") / "sst.nc")


def run(pkg, src, d, dtype=np.float64, stripe=5, **kw):
    d.mkdir(exist_ok=True)
    return pkg.stream_run(
        src, "sst", str(d / "c.nc"), str(d / "m.nc"),
        block_path=str(d / "b.nc"), rank_path=str(d / "r.nc"),
        dtype=dtype, stripe=stripe, **kw)


def staged(src, d, dtype=np.float64, stripe=5):
    d.mkdir(exist_ok=True)
    c, m = str(d / "c.nc"), str(d / "m.nc")
    xt.stream_threshold(src, "sst", c, dtype=dtype, stripe=stripe, **CPU)
    xt.stream_detect(src, "sst", c, m, dtype=dtype, stripe=stripe, **CPU)
    b = xt.stream_block_average(m, str(d / "b.nc"), dstime_path=src,
                                dstime_var="sst", clim_path=c,
                                stripe=stripe, **CPU)
    r, p = xt.stream_rank(m, str(d / "r.nc"), stripe=stripe, **CPU)
    return dict(zip(PARTS, (c, m, b, r, p)))


@pytest.mark.parametrize("ref,dtype", [
    ("port_staged", np.float64), ("xmhw_tpu", np.float64),
    ("xmhw_tpu", np.float32)], ids=["port_staged", "jax_f64", "jax_f32"])
def test_stream_run_matches(grid_file, tmp_path, ref, dtype):
    got = run(xt, grid_file, tmp_path / "got", dtype, **CPU)
    exp = (staged(grid_file, tmp_path / "exp", dtype) if ref == "port_staged"
           else run(xm, grid_file, tmp_path / "exp", dtype))
    assert sorted(got) == sorted(PARTS)
    for part in PARTS:
        assert_files_match(got[part], exp[part],
                           f32=dtype == np.float32)


def test_stream_run_resume_without_watermark(grid_file, tmp_path):
    """resume=True with no interrupted run is a fresh run."""
    got = run(xt, grid_file, tmp_path / "got", resume=True, **CPU)
    exp = run(xt, grid_file, tmp_path / "exp", **CPU)
    for part in PARTS:
        assert_files_match(got[part], exp[part], f64_tol=0)
    with h5py.File(got["clim"], "r") as f:
        assert "xmhw_resume" not in f.attrs


def _stop_after_first_stripe(monkeypatch):
    """The second write-behind job raises instead of writing: the run
    stops with its first stripe (and that stripe's watermark) on disk."""
    real = tst._WriteBehind.submit
    jobs = []

    def submit(self, fn):
        jobs.append(fn)
        if len(jobs) == 2:
            def fn():
                raise RuntimeError("stopped after the first stripe")
        real(self, fn)

    monkeypatch.setattr(tst._WriteBehind, "submit", submit)


def _run_all(src, d, resume=False):
    """Every streamed function, on files of its own, 3-row stripes (four
    stripes of the 12-row grid); returns (paths, watermarked path)."""
    d.mkdir(exist_ok=True)
    kw = dict(stripe=3, resume=resume, **CPU)
    return {
        "stream_threshold": lambda: (
            [xt.stream_threshold(src, "sst", str(d / "c.nc"),
                                 dtype=np.float64, **kw)], "c.nc"),
        "stream_detect": lambda: (
            [xt.stream_detect(src, "sst", str(d.parent / "c0.nc"),
                              str(d / "m.nc"), dtype=np.float64, **kw)],
            "m.nc"),
        "stream_block_average": lambda: (
            [xt.stream_block_average(
                str(d.parent / "m0.nc"), str(d / "b.nc"), dstime_path=src,
                dstime_var="sst", clim_path=str(d.parent / "c0.nc"),
                **kw)], "b.nc"),
        "stream_rank": lambda: (
            list(xt.stream_rank(str(d.parent / "m0.nc"), str(d / "r.nc"),
                                **kw)), "r.nc"),
        "stream_run": lambda: (
            list(run(xt, src, d, **kw).values()), "c.nc"),
    }


@pytest.mark.parametrize("fn", ["stream_threshold", "stream_detect",
                                "stream_block_average", "stream_rank",
                                "stream_run"])
def test_resume_after_stop(grid_file, tmp_path, monkeypatch, fn):
    """A run that stops after its first stripe leaves the watermark of
    that stripe; resume=True skips it, writes the other three, clears the
    watermark, and the files equal those of an uninterrupted run."""
    c0, m0 = str(tmp_path / "c0.nc"), str(tmp_path / "m0.nc")
    xt.stream_threshold(grid_file, "sst", c0, dtype=np.float64, **CPU)
    xt.stream_detect(grid_file, "sst", c0, m0, dtype=np.float64, **CPU)
    exp, name = _run_all(grid_file, tmp_path / "exp")[fn]()

    with monkeypatch.context() as mp:
        _stop_after_first_stripe(mp)
        with pytest.raises(RuntimeError, match="first stripe"):
            _run_all(grid_file, tmp_path / "got")[fn]()
    gc.collect()  # close the stopped run's files
    marked = tmp_path / "got" / name
    with h5py.File(marked, "r") as f:
        assert '"hi": 3' in f.attrs["xmhw_resume"]

    reads = []
    real = tst._prefetched

    def counting(pairs, fetch):
        pairs = list(pairs)
        reads.extend(pairs)
        return real(pairs, fetch)

    monkeypatch.setattr(tst, "_prefetched", counting)
    got, _ = _run_all(grid_file, tmp_path / "got", resume=True)[fn]()
    assert reads == [(3, 6), (6, 9), (9, 12)]  # the first stripe skipped
    with h5py.File(marked, "r") as f:
        assert "xmhw_resume" not in f.attrs
    for g, e in zip(got, exp):
        assert_files_match(g, e, f64_tol=0)


def test_grid_bands_merge_to_the_single_run(grid_file, tmp_path):
    """stream_run over two row bands (grid_rows), merged per output by
    merge_grid_band_files, equals one run over the whole grid."""
    kw = dict(dtype=np.float64, stripe=3, **CPU)
    one = xt.stream_run(grid_file, "sst", str(tmp_path / "c.nc"),
                        str(tmp_path / "m.nc"),
                        block_path=str(tmp_path / "b.nc"), **kw)
    bands = []
    for lo, hi in ((0, 6), (6, 12)):
        d = tmp_path / f"band{lo}"
        d.mkdir()
        bands.append((lo, hi, xt.stream_run(
            grid_file, "sst", str(d / "c.nc"), str(d / "m.nc"),
            block_path=str(d / "b.nc"), grid_rows=(lo, hi), **kw)))
    for part in ("clim", "mhw", "block"):
        merged = str(tmp_path / f"merged_{part}.nc")
        xt.merge_grid_band_files(
            [(out[part], lo, hi) for lo, hi, out in bands], merged, "lat")
        assert_files_match(merged, one[part], f64_tol=0)
