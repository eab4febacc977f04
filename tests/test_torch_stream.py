"""Streamed file-to-file stages of the PyTorch port against the JAX package.

The same synthetic NetCDF (a 12 x 8 grid, 3 daily years, land cells and a
short interior gap, written with xmhw_tpu_torch.save_dataset) goes through
xmhw_tpu.stream_* and xmhw_tpu_torch.stream_*(device="cpu"); the written
files must agree variable by variable, coordinate by coordinate and
attribute by attribute, the global ``source`` attribute aside (it names
the package).

Bars: float64 within 1e-9 (the JAX suite's bar between its own stream
files). float32: thresholds bit-equal; seasonal means within atol 1e-5
(the port sums the mean in float64, XLA in float32: tests/test_torch_clim.py);
event positions, counts, categories and ranks exact; other event floats
within rtol = atol = 2e-3.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import h5py  # noqa: E402

import xmhw_tpu as xm  # noqa: E402
import xmhw_tpu_torch as xt  # noqa: E402
from xmhw_tpu_torch import stream as tst  # noqa: E402
from xmhw_tpu_torch.xrlite import Coord, DataArray, Dataset  # noqa: E402

NY, NX = 12, 8
# attributes holding HDF5 object references: a variable's dimensions are
# compared as the names of the scales its DIMENSION_LIST points to; a
# scale's REFERENCE_LIST (its back-references) is left out
_REF_ATTRS = ("DIMENSION_LIST", "REFERENCE_LIST")


def write_grid(path, seed=42):
    """The synthetic SST file of tests/test_stream_run.py, written by the
    port: seasonal cycle + noise, two land cells, a 4-day gap."""
    rng = np.random.default_rng(seed)
    t = np.arange("2000-01-01", "2003-01-01",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    T = len(t)
    day = np.arange(T)[:, None, None]
    sst = (15 + 3 * np.sin(2 * np.pi * day / 365.25)
           + rng.normal(0, 2.2, (T, NY, NX))).astype(np.float64)
    sst[:, 0, 0] = np.nan  # land
    sst[:, 5, 3] = np.nan
    sst[100:104, 2, 2] = np.nan  # short interior gap
    ds = Dataset()
    ds["sst"] = DataArray(
        sst, ("time", "lat", "lon"),
        {"time": Coord(("time",), t),
         "lat": Coord(("lat",), np.linspace(-40, -30, NY)),
         "lon": Coord(("lon",), np.linspace(140, 147, NX))},
        {"units": "degC"})
    xt.save_dataset(ds, str(path))
    return str(path)


def _exact(name):
    """Variables that must agree exactly in float32 runs too: coordinates,
    event positions and counts, categories and ranks."""
    return (name.startswith(("time", "index_", "duration")) or name in (
        "event", "ecount", "category", "ev", "events", "doy", "lat",
        "lon", "years") or name.endswith("_days"))


def _attrs(node):
    return {k: v for k, v in node.attrs.items() if k not in _REF_ATTRS}


def _attr_equal(a, b):
    if isinstance(a, (bytes, str)) or isinstance(b, (bytes, str)):
        return a == b
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        return a.shape == b.shape and np.array_equal(a, b, equal_nan=True)
    return np.array_equal(a, b)


def assert_files_match(got, exp, f32=False, f64_tol=1e-9):
    """Every dataset (variables and coordinates), its dtype, shape,
    fill value, dimension scales and attributes, and every global
    attribute but ``source``, of two NetCDF4 files."""
    with h5py.File(got, "r") as a, h5py.File(exp, "r") as b:
        ga, gb = _attrs(a), _attrs(b)
        ga.pop("source"), gb.pop("source")
        assert sorted(ga) == sorted(gb), (sorted(ga), sorted(gb))
        for k in gb:
            assert _attr_equal(ga[k], gb[k]), (k, ga[k], gb[k])
        assert sorted(a.keys()) == sorted(b.keys())
        for name in b:
            x, y = a[name], b[name]
            what = f"{os.path.basename(exp)}:{name}"
            assert (x.shape, x.dtype) == (y.shape, y.dtype), what
            assert _attr_equal(x.fillvalue, y.fillvalue), what
            xa, ya = _attrs(x), _attrs(y)
            assert sorted(xa) == sorted(ya), what
            for k in ya:
                assert _attr_equal(xa[k], ya[k]), (what, k)
            assert tst.GridReader._dims_of(x) == tst.GridReader._dims_of(y)
            xv, yv = x[()], y[()]
            if xv.dtype.kind not in "fc":
                np.testing.assert_array_equal(xv, yv, err_msg=what)
            elif not f32:
                np.testing.assert_allclose(xv, yv, rtol=f64_tol,
                                           atol=f64_tol, equal_nan=True,
                                           err_msg=what)
            elif _exact(name) or name == "thresh":
                np.testing.assert_array_equal(xv, yv, err_msg=what)
            elif name == "seas":
                np.testing.assert_allclose(xv, yv, rtol=0, atol=1e-5,
                                           equal_nan=True, err_msg=what)
            else:
                np.testing.assert_allclose(xv, yv, rtol=2e-3, atol=2e-3,
                                           equal_nan=True, err_msg=what)


@pytest.fixture(scope="module")
def grid_file(tmp_path_factory):
    return write_grid(tmp_path_factory.mktemp("tstream") / "sst.nc")


@pytest.fixture(scope="module")
def packed_file(tmp_path_factory):
    """CF-packed int16 file (scale_factor/add_offset, an integer
    _FillValue and missing_value), as OISST products ship SST; the recipe
    of tests/test_stream.py:435-491 on the grid and land of write_grid
    (the JAX package then reuses its compiled programs)."""
    rng = np.random.default_rng(7)
    t = np.arange("2000-01-01", "2003-01-01",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    T, ny, nx = len(t), NY, NX
    day = np.arange(T)[:, None, None]
    sst = (15 + 3 * np.sin(2 * np.pi * day / 365.25)
           + rng.normal(0, 2.2, (T, ny, nx)))
    sst[:, 0, 0] = np.nan
    sst[:, 5, 3] = np.nan
    sst[50:53, 2, 2] = np.nan
    sf, ao, fill, miss = 0.01, 10.0, np.int16(-999), np.int16(-32768)
    packed = np.where(np.isnan(sst), fill.astype(np.float64),
                      np.round((sst - ao) / sf)).astype(np.int16)
    packed[50:53, 2, 2] = miss
    path = str(tmp_path_factory.mktemp("tpacked") / "sst_packed.nc")
    tdays = ((t - np.datetime64("2000-01-01", "ns"))
             / np.timedelta64(1, "D")).astype(np.float64)
    with h5py.File(path, "w") as f:
        tn = f.create_dataset("time", data=tdays)
        tn.attrs["units"] = "days since 2000-01-01 00:00:00"
        tn.attrs["calendar"] = "standard"
        tn.make_scale("time")
        yn = f.create_dataset("lat", data=np.linspace(-40, -31, ny))
        yn.make_scale("lat")
        xn = f.create_dataset("lon", data=np.linspace(140, 145, nx))
        xn.make_scale("lon")
        v = f.create_dataset("sst", data=packed, dtype="i2")
        v.attrs["scale_factor"] = np.float64(sf)
        v.attrs["add_offset"] = np.float64(ao)
        v.attrs["_FillValue"] = fill
        v.attrs["missing_value"] = miss
        v.attrs["units"] = "degree_C"
        for d, s in zip(v.dims, (tn, yn, xn)):
            d.attach_scale(s)
    return path


F64 = np.float64


def _clim_mhw(pkg, d, src, thr, det, stripe=5, layout="compact", dtype=F64,
              **dev):
    c, m = str(d / "clim.nc"), str(d / "mhw.nc")
    pkg.stream_threshold(src, "sst", c, dtype=dtype, stripe=stripe, **thr,
                         **dev)
    out = pkg.stream_detect(src, "sst", c, m, dtype=dtype, stripe=stripe,
                            events_layout=layout, **det, **dev)
    return [c, *out] if isinstance(out, tuple) else [c, out]


def _threshold(stripe, **kw):
    def run(pkg, d, src, **dev):
        c = str(d / "clim.nc")
        pkg.stream_threshold(src, "sst", c, dtype=F64, stripe=stripe, **kw,
                             **dev)
        return [c]
    return run


def _detect(layout="compact", dtype=F64, det=None, **kw):
    def run(pkg, d, src, **dev):
        return _clim_mhw(pkg, d, src, kw, dict(kw, **(det or {})),
                         layout=layout, dtype=dtype, **dev)
    return run


def _block(with_ts, with_clim, **kw):
    def run(pkg, d, src, **dev):
        c, m = _clim_mhw(pkg, d, src, {}, {}, **dev)
        b = str(d / "blk.nc")
        pkg.stream_block_average(
            m, b, dstime_path=src if with_ts else None,
            dstime_var="sst" if with_ts else None,
            clim_path=c if with_clim else None,
            period=None if with_ts else [2000, 2002], stripe=5, **kw, **dev)
        return [b]
    return run


def _rank(pkg, d, src, **dev):
    _, m = _clim_mhw(pkg, d, src, {}, {}, **dev)
    return list(pkg.stream_rank(m, str(d / "rank.nc"), stripe=5, **dev))


CASES = {
    "threshold_stripe12": (_threshold(12), False),
    "threshold_stripe5": (_threshold(5), False),
    "threshold_climatologyPeriod": (
        _threshold(5, climatologyPeriod=[2000, 2001]), False),
    "detect_compact": (_detect(), False),
    "detect_union": (_detect("union"), False),
    "detect_float32": (_detect(dtype=np.float32), True),
    "anynans": (_detect("union", anynans=True), False),
    "maxPadLength": (_detect("union", maxPadLength=5), False),
    "coldSpells": (_detect("union", coldSpells=True), False),
    "compress": (_detect(compress=1), False),
    "intermediate": (_detect(det={"intermediate": True}), False),
    "block_average_events_only": (_block(False, False), False),
    "block_average_ts": (_block(True, False, removeMissing=True), False),
    "block_average_ts_clim": (_block(True, True), False),
    "rank": (_rank, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_stream_matches_jax(grid_file, tmp_path, case):
    fn, f32 = CASES[case]
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    exp = fn(xm, tmp_path / "jax", grid_file)
    got = fn(xt, tmp_path / "torch", grid_file, device="cpu")
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in exp]
    for g, e in zip(got, exp):
        assert_files_match(g, e, f32=f32)
    with h5py.File(got[-1], "r") as f:
        assert str(f.attrs["source"]).startswith("xmhw_tpu_torch stream_")


def test_packed_reader_matches_jax(packed_file, tmp_path):
    """The CF-packed int16 input decodes as in the JAX package, through
    threshold and detect."""
    out = {}
    for pkg, dev in ((xm, {}), (xt, {"device": "cpu"})):
        d = tmp_path / pkg.__name__
        d.mkdir()
        out[pkg] = _clim_mhw(pkg, d, packed_file, {}, {}, **dev)
    for g, e in zip(out[xt], out[xm]):
        assert_files_match(g, e)
    with tst.GridReader(packed_file, "sst") as g:
        assert "scale_factor" not in g.attrs
        assert np.isnan(g.read(0, 1)[:, 0]).all()  # integer fill -> NaN


STREAM_CALLS = {
    "stream_threshold": lambda src, d: xt.stream_threshold(
        src, "sst", str(d / "c.nc")),
    "stream_detect": lambda src, d: xt.stream_detect(
        src, "sst", src, str(d / "m.nc")),
    "stream_block_average": lambda src, d: xt.stream_block_average(
        src, str(d / "b.nc"), period=[2000, 2002]),
    "stream_rank": lambda src, d: xt.stream_rank(src, str(d / "r.nc")),
    "stream_run": lambda src, d: xt.stream_run(
        src, "sst", str(d / "c.nc"), str(d / "m.nc")),
}


@pytest.mark.parametrize("fn", list(STREAM_CALLS))
def test_cuda_without_gpu_raises(grid_file, tmp_path, fn):
    """The default device is "cuda": without a GPU every streamed
    function raises before it writes anything; nothing falls back to the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        STREAM_CALLS[fn](grid_file, tmp_path)
    assert not list(tmp_path.iterdir())


def test_mesh_is_refused(grid_file, tmp_path):
    with pytest.raises(NotImplementedError, match="one device"):
        xt.stream_threshold(grid_file, "sst", str(tmp_path / "c.nc"),
                            mesh=object(), device="cpu")


def test_kcache_round_trip(grid_file, tmp_path, monkeypatch):
    """A re-run of the same dataset starts at the event capacity K the
    first run found (kcache.json under XMHW_COMPILE_CACHE) and writes the
    same file; XMHW_COMPILE_CACHE=0 disables the table, and its default
    directory is the port's own."""
    monkeypatch.setenv("XMHW_COMPILE_CACHE", str(tmp_path / "cache"))
    clim = str(tmp_path / "clim.nc")
    xt.stream_threshold(grid_file, "sst", clim, dtype=F64, stripe=5,
                        device="cpu")
    seen = []
    real = tst.run_detect

    def spy(*a, **k):
        seen.append(k["k_min"])
        return real(*a, **k)

    monkeypatch.setattr(tst, "run_detect", spy)
    outs = [str(tmp_path / f"m{i}.nc") for i in range(2)]
    for i, out in enumerate(outs):
        seen.clear()
        xt.stream_detect(grid_file, "sst", clim, out, dtype=F64, stripe=5,
                         device="cpu")
        if i == 0:
            assert seen[0] == 1  # no table yet
            assert (tmp_path / "cache" / "kcache.json").exists()
            with h5py.File(out, "r") as f:
                K = f["ev"].shape[0]
    assert seen == [K] * len(seen)  # every stripe starts at the final K
    assert_files_match(outs[1], outs[0], f64_tol=0)

    monkeypatch.setenv("XMHW_COMPILE_CACHE", "0")
    assert tst._kcache_file() is None
    monkeypatch.delenv("XMHW_COMPILE_CACHE")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert tst._kcache_file() == str(
        tmp_path / "home" / ".cache" / "xmhw_tpu_torch" / "kcache.json")
