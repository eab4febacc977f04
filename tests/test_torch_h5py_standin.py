"""The numpy stand-in for h5py (tools/h5py_standin) against real h5py.

The card's machine has numpy but no h5py, so ``chip_smoke.py`` runs the
port's streamed pipelines there through a stand-in that keeps raw numpy
arrays behind an HDF5 signature. Here, on the CPU, each streamed call runs
twice on the same input: once through real h5py and once through the
stand-in, swapped in as ``h5py`` for the call. Each output file is read
back by the library that wrote it, and the two must hold the same
datasets in the same order: names, shapes, dtypes, max shapes, fill
values, bytes, dimension scales, and attributes with their
types and bytes. The calls: stream_run, the staged chain,
stream_detect(intermediate=True), a resume after the first stripe,
merge_grid_band_files over two bands, and ``python -m xmhw_tpu_torch
--device cpu run`` with the stand-in first on PYTHONPATH; and
tools/torch_multiproc_stream.py through the stand-in, as on the card.

Then the refusals: each call the stand-in lacks raises NotImplementedError
naming it, the stand-in refuses HDF5 files, and h5py refuses the
stand-in's files.
"""

import ast
import gc
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import h5py  # noqa: E402

import xmhw_tpu_torch as xt  # noqa: E402
from test_torch_stream import write_grid  # noqa: E402
from test_torch_stream_run import _stop_after_first_stripe  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
STANDIN_DIR = ROOT / "tools" / "h5py_standin"
_spec = importlib.util.spec_from_file_location(
    "h5py", STANDIN_DIR / "h5py" / "__init__.py")
STANDIN = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(STANDIN)
CPU = {"device": "cpu"}
PARTS = ("clim", "mhw", "block", "rank", "return")


def through(mod, monkeypatch, fn):
    """``fn()`` with ``import h5py`` resolving to ``mod``."""
    with monkeypatch.context() as mp:
        mp.setitem(sys.modules, "h5py", mod)
        return fn()


def value(v):
    """An attribute or dataset value as a comparable tuple: its type,
    dtype, shape and bytes (object arrays element by element)."""
    if isinstance(v, np.ndarray):
        if v.dtype.kind == "O":
            return ("ndarray", "O", v.shape,
                    [value(x) for x in v.reshape(-1)])
        return ("ndarray", v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, np.generic):
        return (type(v).__name__, v.dtype.str, v.tobytes())
    return (type(v).__name__, v)


def attrs_of(f, node):
    """Attributes in the order the library gives them; object references
    as the names of the datasets they point to."""
    out = []
    for k, v in node.attrs.items():
        if k == "DIMENSION_LIST":
            v = [[f[r].name for r in refs] for refs in v]
        elif k == "REFERENCE_LIST":
            v = [(f[rec["dataset"]].name, int(rec["dimension"]))
                 for rec in v]
        else:
            v = value(v)
        out.append((k, v))
    return out


def dump(path, mod):
    """Everything of a file that the port writes or reads, through the
    library ``mod`` that wrote it."""
    with mod.File(path, "r") as f:
        nodes = []
        for name in f.keys():
            x = f[name]
            nodes.append((name, {
                "shape": x.shape, "dtype": x.dtype.str,
                "vlen": (x.dtype.metadata or {}).get("vlen"),
                "maxshape": x.maxshape, "fillvalue": value(x.fillvalue),
                "is_scale": x.is_scale,
                "scales": [[s.name for s in d.values()] for d in x.dims],
                "attrs": attrs_of(f, x), "data": value(x[()])}))
        return {"attrs": attrs_of(f, f), "datasets": nodes}


def is_standin_file(path):
    with open(path, "rb") as fh:
        return fh.read(16) == STANDIN.SIGNATURE + STANDIN.MAGIC


def assert_same_files(real, stand):
    """Each pair (h5py's file, the stand-in's) holds the same content."""
    assert len(real) == len(stand) > 0
    for a, b in zip(real, stand):
        assert not is_standin_file(a) and is_standin_file(b), (a, b)
        da, db = dump(a, h5py), dump(b, STANDIN)
        assert da["attrs"] == db["attrs"], (a, b)
        assert [n for n, _ in da["datasets"]] == [n for n, _ in
                                                  db["datasets"]], (a, b)
        for (name, x), (_, y) in zip(da["datasets"], db["datasets"]):
            for k in x:
                assert x[k] == y[k], (os.path.basename(a), name, k)


# ---- the streamed calls, once through each library -------------------------
def call_stream_run(src, d, stripe=5, **kw):
    out = xt.stream_run(src, "sst", str(d / "c.nc"), str(d / "m.nc"),
                        block_path=str(d / "b.nc"),
                        rank_path=str(d / "r.nc"), stripe=stripe, **kw,
                        **CPU)
    return [out[p] for p in PARTS]


def call_staged(src, d):
    c, m = str(d / "c.nc"), str(d / "m.nc")
    xt.stream_threshold(src, "sst", c, stripe=5, **CPU)
    xt.stream_detect(src, "sst", c, m, stripe=5, **CPU)
    b = xt.stream_block_average(m, str(d / "b.nc"), dstime_path=src,
                                dstime_var="sst", clim_path=c, stripe=5,
                                **CPU)
    r, p = xt.stream_rank(m, str(d / "r.nc"), stripe=5, **CPU)
    return [c, m, b, r, p]


def call_intermediate(src, d):
    c = str(d / "c.nc")
    xt.stream_threshold(src, "sst", c, stripe=4, **CPU)
    m, inter = xt.stream_detect(src, "sst", c, str(d / "m.nc"),
                                intermediate=True, stripe=4, **CPU)
    return [c, m, inter]


def call_resume(src, d, monkeypatch):
    """stream_run stopped after its first 3-row stripe, then resumed."""
    def go(resume):
        return call_stream_run(src, d, stripe=3, resume=resume)

    with monkeypatch.context() as mp:
        _stop_after_first_stripe(mp)
        with pytest.raises(RuntimeError, match="first stripe"):
            go(False)
    gc.collect()  # the stopped run's open files
    return go(True)


def call_merge(src, d):
    bands = []
    for lo, hi in ((0, 6), (6, 12)):
        b = d / f"band{lo}"
        b.mkdir()
        bands.append((lo, hi, xt.stream_run(
            src, "sst", str(b / "c.nc"), str(b / "m.nc"),
            block_path=str(b / "b.nc"), stripe=3, grid_rows=(lo, hi),
            **CPU)))
    merged = []
    for part in ("clim", "mhw", "block"):
        merged.append(xt.merge_grid_band_files(
            [(out[part], lo, hi) for lo, hi, out in bands],
            str(d / f"merged_{part}.nc"), "lat"))
    return merged


CALLS = {"stream_run": call_stream_run, "staged": call_staged,
         "intermediate": call_intermediate, "resume": call_resume,
         "merge": call_merge}


@pytest.mark.parametrize("call", sorted(CALLS))
def test_standin_writes_what_h5py_writes(tmp_path, monkeypatch, call):
    fn = CALLS[call]
    files = {}
    for lib, mod in (("h5py", h5py), ("standin", STANDIN)):
        d = tmp_path / lib
        d.mkdir()

        def run(d=d):
            src = write_grid(d / "sst.nc")
            args = (src, d, monkeypatch) if call == "resume" else (src, d)
            return [src] + list(fn(*args))

        files[lib] = through(mod, monkeypatch, run)
    assert_same_files(files["h5py"], files["standin"])


def test_cli_run_through_the_standin_on_pythonpath(tmp_path, monkeypatch):
    """``python -m xmhw_tpu_torch --device cpu run`` in a process whose
    PYTHONPATH starts with the stand-in writes the files that the same
    command writes through h5py."""
    from xmhw_tpu_torch.__main__ import main

    names = ("c.nc", "m.nc", "b.nc", "r.nc", "r_return.nc")
    real, stand = tmp_path / "h5py", tmp_path / "standin"
    real.mkdir()
    stand.mkdir()
    src = write_grid(real / "sst.nc")
    assert main(["--device", "cpu", "run", src, "sst", str(real / "c.nc"),
                 str(real / "m.nc"), "--block", str(real / "b.nc"),
                 "--rank", str(real / "r.nc"), "--stripe", "5"]) == 0
    s_src = through(STANDIN, monkeypatch,
                    lambda: write_grid(stand / "sst.nc"))
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(STANDIN_DIR), str(ROOT)]))
    r = subprocess.run(
        [sys.executable, "-m", "xmhw_tpu_torch", "--device", "cpu", "run",
         s_src, "sst", str(stand / "c.nc"), str(stand / "m.nc"), "--block",
         str(stand / "b.nc"), "--rank", str(stand / "r.nc"), "--stripe",
         "5"], capture_output=True, text=True, env=env, cwd=tmp_path,
        timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert len(r.stdout.splitlines()) == len(names)
    assert_same_files([src] + [str(real / n) for n in names],
                      [s_src] + [str(stand / n) for n in names])


def test_multiproc_stream_tool_through_the_standin_on_pythonpath():
    """tools/torch_multiproc_stream.py with the stand-in first on
    PYTHONPATH, as chip_smoke.py runs it on the card: two ranks write
    their bands, merge them and hold the merged files to one process's
    (its assert_files_equal reads the scales of every dataset)."""
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(STANDIN_DIR), str(ROOT)]))
    r = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "torch_multiproc_stream.py"),
         "--device", "cpu", "--timeout", "200"], capture_output=True,
        text=True, env=env, cwd=ROOT, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr[-4000:]
    assert "rank 0: OK" in r.stdout and "rank 1: band (5, 12)" in r.stdout
    assert "torch multiproc stream: PASS" in r.stdout


def test_low_level_calls_match_h5py(tmp_path):
    """The calls the port makes, one by one: creation with data, shape,
    fill value, chunks, max shape and compression, scales,
    growth along an axis and to a shape, region writes, reads."""
    def build(mod, path):
        with mod.File(path, "w") as f:
            f.attrs["title"] = "t"
            ev = f.create_dataset("ev", data=np.arange(3), maxshape=(None,),
                                  chunks=(3,))
            ev.make_scale("ev")
            lat = f.create_dataset("lat", data=np.linspace(-1, 1, 4))
            lat.make_scale("lat")
            lab = f.create_dataset("lab", data=np.asarray(
                ["a", "bc", "d", "e"], dtype=mod.string_dtype()))
            lab.make_scale("lab")
            x = f.create_dataset("x", shape=(3, 4), dtype="<f4",
                                 fillvalue=np.nan, chunks=(3, 1),
                                 maxshape=(None, 4), compression="gzip",
                                 compression_opts=4, shuffle=True)
            x.dims[0].attach_scale(ev)
            x.dims[1].attach_scale(lat)
            x.dims[1].attach_scale(lab)
            x[:, 1:3] = np.arange(6, dtype=np.float64).reshape(3, 2)
            x.attrs["_FillValue"] = np.array([np.nan], np.float32)
            x.resize(5, axis=0)
            x[4] = 7
            ev.resize((5,))
            ev[...] = np.arange(5)
            y = f.create_dataset("y", shape=(2,), dtype="i1", fillvalue=3)
            y[1] = -1
            f.create_dataset("z", data=np.ones((0, 2), np.float32))
        with mod.File(path, "r+") as f:
            f.attrs.pop("title")
            f["x"].attrs["units"] = "degC"
            f["x"].resize((6, 4))
            dest = np.zeros((6, 2), np.float32)
            f["x"].read_direct(dest, np.s_[:, 1:3])
            return (dest.tobytes(), value(f["x"][2:5, ::2]),
                    value(f["x"][1, 2]), value(f["lab"][1]),
                    mod.h5ds.is_scale(f["lat"].id),
                    mod.h5ds.is_scale(f["x"].id), len(f["x"].dims[1]),
                    f["x"].dims[1][1].name,
                    "x" in f, "/x" in f, "q" in f)

    real = build(h5py, tmp_path / "real.h5")
    stand = build(STANDIN, tmp_path / "stand.h5")
    assert real == stand
    assert_same_files([str(tmp_path / "real.h5")],
                      [str(tmp_path / "stand.h5")])


ATTR_VALUES = {"str": "abc", "empty": "", "utf8": "é", "bytes": b"xy",
               "int": 3, "float": 2.5, "bool": True, "f4": np.float32(1.5),
               "i1": np.int8(-3), "list": [1, 2], "tuple": (1.0, 2),
               "nan": np.array([np.nan], np.float32), "strs": ["a", "bb"],
               "np_bytes": np.bytes_(b"z"), "u8": np.arange(3, dtype="u8")}
REFUSED = {"none": None, "dict": {"a": 1}, "object": object(),
           "np_str": np.str_("q"), "unicode_array": np.array(["a"]),
           "datetime": np.datetime64("2000-01-01")}


def test_attribute_types_match_h5py(tmp_path):
    """Values read back with h5py's types and bytes; the values h5py
    refuses raise TypeError in both (the port then stores ``str(v)``)."""
    got = {}
    for mod in (h5py, STANDIN):
        with mod.File(tmp_path / f"{mod.__name__}{id(mod)}.h5", "w") as f:
            for k, v in ATTR_VALUES.items():
                f.attrs[k] = v
            for k, v in REFUSED.items():
                with pytest.raises(TypeError):
                    f.attrs[k] = v
            got[mod] = [(k, value(v)) for k, v in f.attrs.items()]
    assert got[h5py] == got[STANDIN]


@pytest.mark.parametrize("what", [
    "mode a", "Group", "h5ds attach_scale", "create_group",
    "create_dataset track_order", "fancy index", "astype",
    "detach_scale", "dims label"])
def test_standin_refuses_what_it_lacks(tmp_path, what):
    """A call outside the implemented surface raises NotImplementedError
    that names it; nothing returns quietly."""
    p = tmp_path / "s.h5"
    with STANDIN.File(p, "w") as f:
        x = f.create_dataset("x", data=np.arange(4.0))
        calls = {
            "mode a": (lambda: STANDIN.File(p, "a"), "mode='a'"),
            "Group": (lambda: STANDIN.Group, "h5py.Group"),
            "h5ds attach_scale": (lambda: STANDIN.h5ds.attach_scale,
                                  "h5ds.attach_scale"),
            "create_group": (lambda: f.create_group("g"),
                             "File.create_group"),
            "create_dataset track_order": (
                lambda: f.create_dataset("y", data=[1], track_order=True),
                "track_order"),
            "fancy index": (lambda: x[[0, 2]], "basic indexing"),
            "astype": (lambda: x.astype("f4"), "Dataset.astype"),
            "detach_scale": (lambda: x.dims[0].detach_scale(x),
                             "DimensionProxy.detach_scale"),
            "dims label": (lambda: x.dims[0].label, "DimensionProxy.label"),
        }
        fn, name = calls[what]
        with pytest.raises(NotImplementedError, match=name) as e:
            fn()
        assert "stand-in" in str(e.value)


def test_standin_refuses_hdf5_files(tmp_path):
    p = tmp_path / "real.h5"
    with h5py.File(p, "w") as f:
        f.create_dataset("x", data=np.arange(3))
    with pytest.raises(OSError, match="HDF5 file, not one of the numpy "
                       "stand-in"):
        STANDIN.File(p, "r")


def test_h5py_refuses_standin_files(tmp_path):
    p = tmp_path / "stand.h5"
    with STANDIN.File(p, "w") as f:
        f.create_dataset("x", data=np.arange(3))
    with open(p, "rb") as fh:
        assert fh.read(8) == b"\x89HDF\r\n\x1a\n"  # passes stream.py's guard
    with pytest.raises(OSError):
        h5py.File(p, "r")


def test_standin_imports_numpy_json_and_stdlib_only():
    tree = ast.parse((STANDIN_DIR / "h5py" / "__init__.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top == "numpy" or top in sys.stdlib_module_names, n
