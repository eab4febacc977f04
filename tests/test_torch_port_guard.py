"""Guards on the PyTorch port's boundaries.

* The pure-numpy host modules are copies of the JAX package's: they must
  not drift apart (import lines aside).
* Importing the port loads neither JAX nor the JAX package.
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
COPIES = ["annotate.py", "exception.py", "core/calendar.py", "core/point.py",
          "xrlite/__init__.py", "xrlite/adapt.py", "xrlite/alloc.py",
          "xrlite/dataarray.py", "xrlite/export.py", "xrlite/netcdf.py",
          "xrlite/timeutils.py"]
# the one non-import line a copy changes: its array handoff to torch
SUBS = {"xrlite/dataarray.py": [("jnp.asarray(flat)",
                                 "torch.as_tensor(flat)")]}


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
    code = ("import sys, xmhw_tpu_torch, xmhw_tpu_torch.core.pipeline; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'xmhw_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


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
