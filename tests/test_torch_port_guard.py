"""Guards on the PyTorch port's boundaries.

* The pure-numpy host modules are copies of the JAX package's: they must
  not drift apart (import lines aside). Where a module is only partly
  numpy (stats_api.py, identify.py, stream.py, __main__.py), or repairs
  a function of the original (core/point.py), each copied function,
  class and module constant must have the original's syntax tree.
* Importing the port loads neither JAX nor the JAX package, and the port
  exports every name the JAX package does.
* device="cuda" without a GPU raises; it never runs on the CPU quietly.
* A failing nvcc build raises with the compiler's own message.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import xmhw_tpu_torch as xt  # noqa: E402
from xmhw_tpu_torch.ops import _build  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
COPIES = ["annotate.py", "exception.py", "core/calendar.py",
          "features.py", "stats.py", "xmhw.py", "xrlite/__init__.py",
          "xrlite/adapt.py", "xrlite/alloc.py", "xrlite/dataarray.py",
          "xrlite/export.py", "xrlite/netcdf.py", "xrlite/timeutils.py"]
# the non-import lines a copy changes: its array handoff to torch, the
# package name in a shim's docstring, calc_clim's device argument
SUBS = {
    "xrlite/dataarray.py": [("jnp.asarray(flat)", "torch.as_tensor(flat)")],
    "features.py": [("from xmhw_tpu.", "from xmhw_tpu_torch.")],
    "stats.py": [("from xmhw_tpu.", "from xmhw_tpu_torch.")],
    "xmhw.py": [
        ("from xmhw_tpu.", "from xmhw_tpu_torch."),
        ("skipna=False, dtype=None):",
         'skipna=False, dtype=None, device="cuda"):'),
        ("DataArrays on the 'doy' dimension.\n",
         "DataArrays on the 'doy' dimension. ``device``: where it runs\n"
         '    (default ``"cuda"``), as in threshold().\n'),
        ("patch_feb29=not tstep)", "patch_feb29=not tstep, device=device)"),
    ],
}
# partly-numpy modules: the top-level functions that are ported to torch
# (everything else must be a copy); _block_ts_stats is a copy that hands
# the device on to _block_ts_stats_device
PORTED = {
    "stats_api.py": {"block_average", "mhw_rank", "_block_ts_stats_device",
                     "_rank_device", "_stats_device"},
    "identify.py": {"runavg", "mhw_filter"},
    "stream.py": {"stream_threshold", "stream_detect", "stream_block_average",
                  "stream_rank", "stream_run", "_kcache_file"},
    "__main__.py": {"main", "_warmup", "build_parser"},
    # runavg_circular_np wraps a window wider than the axis (12 monthly
    # rows), which the JAX package's copy cuts short
    "core/point.py": {"runavg_circular_np"},
    # the torch mesh: CELL_AXIS and pad_cells stay copies
    "parallel/mesh.py": {"cell_mesh", "cell_sharding", "replicated",
                         "make_cell_array"},
}
# copies whose own docstring the port rewrites (what overlaps what on the
# card); the rest of each, its methods' docstrings too, is held to the
# original's syntax tree
NEW_DOCSTRING = {"stream.py": {"_prefetched", "_WriteBehind"}}
# top-level names of the original that the port leaves out: _cats_kernel
# and its jit cache (the port's day statistics compute the categories
# inline, ops/block_stats.day_bins), and the JAX compile-cache switch
# (torch has none)
DROPPED = {"stream.py": {"_cats_kernel", "_cats_jit"},
           "__main__.py": {"_enable_compile_cache"}}
FN_SUBS = {"stats_api.py": [("years_coord, removeMissing)\n        dy_idx",
                             "years_coord, removeMissing,\n"
                             "                device)\n        dy_idx")],
           # the files' global "source" attribute names the port
           "stream.py": [('"source": "xmhw_tpu stream',
                          '"source": "xmhw_tpu_torch stream')]}


def code_lines(path, subs=()):
    """Source lines with every import statement removed."""
    src = path.read_text()
    for a, b in subs:
        src = src.replace(a, b)
    drop = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            drop.update(range(node.lineno, node.end_lineno + 1))
    return [ln for i, ln in enumerate(src.splitlines(), 1) if i not in drop]


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_matches_original(rel):
    orig = code_lines(ROOT / "xmhw_tpu" / rel, SUBS.get(rel, ()))
    port = code_lines(ROOT / "xmhw_tpu_torch" / rel)
    assert port == orig, f"xmhw_tpu_torch/{rel} drifted from xmhw_tpu/{rel}"


def top_level(path, subs=(), new_docstring=()):
    """Module-level functions, classes and assignments -> their dumped
    syntax trees (comments aside; for the names in ``new_docstring``,
    their own docstring aside)."""
    src = path.read_text()
    for a, b in subs:
        assert a in src, a
        src = src.replace(a, b)
    out = {}
    for node in ast.parse(src).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            if node.name in new_docstring:
                assert ast.get_docstring(node), node.name
                node.body = node.body[1:]
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.Assign):
            out[ast.unparse(node.targets)] = ast.dump(node)
    return out


@pytest.mark.parametrize("rel", sorted(PORTED))
def test_copied_functions_match_original(rel):
    new_doc = NEW_DOCSTRING.get(rel, set())
    orig = top_level(ROOT / "xmhw_tpu" / rel, FN_SUBS.get(rel, ()), new_doc)
    port = top_level(ROOT / "xmhw_tpu_torch" / rel, (), new_doc)
    assert PORTED[rel] <= set(port), sorted(PORTED[rel] - set(port))
    dropped = DROPPED.get(rel, set())
    assert dropped <= set(orig) and not dropped & set(port), dropped
    copied = sorted(set(orig) - PORTED[rel] - dropped)
    assert copied and set(copied) <= set(port), sorted(set(copied)
                                                      - set(port))
    drifted = [n for n in copied if port[n] != orig[n]]
    assert not drifted, f"xmhw_tpu_torch/{rel}: {drifted} drifted"


def test_port_imports_no_jax():
    for path in (ROOT / "xmhw_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "xmhw_tpu"), f"{path}: {n}"
    code = ("import sys, xmhw_tpu_torch, xmhw_tpu_torch.core.pipeline, "
            "xmhw_tpu_torch.identify, xmhw_tpu_torch.stats, "
            "xmhw_tpu_torch.features, xmhw_tpu_torch.xmhw, "
            "xmhw_tpu_torch.ops.run_bound, xmhw_tpu_torch.stream, "
            "xmhw_tpu_torch.parallel.mesh, "
            "xmhw_tpu_torch.__main__; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'xmhw_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("rel", [
    "chip_smoke.py", "tools/h5py_standin/h5py/__init__.py"]
    + sorted(str(p.relative_to(ROOT))
             for p in (ROOT / "tools").glob("torch_*.py")))
def test_port_scripts_import_no_jax(rel):
    """chip_smoke.py, the port's tools (the multi-process dryruns among
    them) and the numpy stand-in for h5py run where JAX is not
    installed."""
    for node in ast.walk(ast.parse((ROOT / rel).read_text())):
        names = ([a.name for a in node.names]
                 if isinstance(node, ast.Import) else
                 [node.module or ""] if isinstance(node, ast.ImportFrom)
                 and node.level == 0 else [])
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "xmhw_tpu"), n


def test_port_does_not_name_the_h5py_standin():
    """The stand-in (tools/h5py_standin) is chosen only by what is first
    on sys.path, for the card check: no module of the port knows of it."""
    for path in (ROOT / "xmhw_tpu_torch").rglob("*.py"):
        text = path.read_text()
        for name in ("h5py_standin", "NPSTAND1"):
            assert name not in text, f"{path} names the stand-in"


def test_port_exports_the_jax_package_names():
    import xmhw_tpu

    assert set(xt.__all__) == set(xmhw_tpu.__all__)
    for name in xt.__all__:
        assert hasattr(xt, name), name


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: nothing to refuse")
    da_t = np.arange("2001-01-01", "2002-01-01",
                     dtype="datetime64[D]").astype("datetime64[ns]")
    from xmhw_tpu_torch.xrlite import Coord, DataArray

    da = DataArray(np.zeros((len(da_t), 2, 2), np.float32),
                   ("time", "lat", "lon"),
                   {"time": Coord(("time",), da_t),
                    "lat": Coord(("lat",), [0.0, 1.0]),
                    "lon": Coord(("lon",), [0.0, 1.0])})
    with pytest.raises(RuntimeError, match="cuda"):
        xt.threshold(da)  # the default device is "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        xt.detect(da, da, da, device="cuda")
    for dev in ("cuda", True):
        with pytest.raises(RuntimeError, match="cuda"):
            xt.block_average(da, period=[2001, 2001], device=dev)
        with pytest.raises(RuntimeError, match="cuda"):
            xt.mhw_rank(da, device=dev)


def test_build_failure_raises_nvcc_message(tmp_path, monkeypatch):
    """The build runs nvcc over csrc/*.cu and raises with its output when
    it fails; nothing falls back to the plain code."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho \"broken.cu(3): error: expected a ';'\""
                    " >&2\nexit 2\n")
    fake.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "broken.cu").write_text("int x\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    with pytest.raises(RuntimeError, match="expected a ';'") as e:
        _build.build()
    assert "exit code 2" in str(e.value)
    assert not list((tmp_path / "_build").glob("*.so"))
