"""The port's CLI (python -m xmhw_tpu_torch): the streamed pipelines
without writing Python, on the CPU with ``--device cpu``.

Its staged chain (threshold, detect, block-average, rank) and its one-pass
``run`` must write the files of xmhw_tpu.stream_run on the same input
(float64 within 1e-9, global ``source`` aside; the JAX suite holds its
staged and one-pass files equal). Without a GPU the default device
("cuda") raises, for every subcommand.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import xmhw_tpu as xm  # noqa: E402
from test_torch_stream import assert_files_match, write_grid  # noqa: E402
from xmhw_tpu_torch.__main__ import main  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PARTS = ("clim", "mhw", "block", "rank", "return")
FILES = ("c.nc", "m.nc", "b.nc", "r.nc", "r_return.nc")


@pytest.fixture(scope="module")
def grid_file(tmp_path_factory):
    return write_grid(tmp_path_factory.mktemp("tcli") / "sst.nc")


@pytest.fixture(scope="module")
def jax_run(grid_file, tmp_path_factory):
    d = tmp_path_factory.mktemp("tcli_jax")
    return xm.stream_run(grid_file, "sst", str(d / "c.nc"), str(d / "m.nc"),
                         block_path=str(d / "b.nc"),
                         rank_path=str(d / "r.nc"), dtype=np.float64,
                         stripe=5)


def test_cli_help(capsys):
    with pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "--device" in out
    for cmd in ("run", "threshold", "detect", "block-average", "rank",
                "warmup"):
        assert cmd in out


def test_cli_module_entrypoint():
    r = subprocess.run([sys.executable, "-m", "xmhw_tpu_torch", "--help"],
                       capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "fused single pass" in r.stdout


def test_cli_staged_chain_matches_jax(grid_file, jax_run, tmp_path):
    c, m, b, r = (str(tmp_path / f) for f in FILES[:4])
    cpu = ["--device", "cpu"]
    assert main(cpu + ["--f64", "threshold", grid_file, "sst", c,
                       "--stripe", "5"]) == 0
    assert main(cpu + ["--f64", "detect", grid_file, "sst", c, m,
                       "--stripe", "5"]) == 0
    assert main(cpu + ["block-average", m, b, "--dstime", grid_file,
                       "--dstime-var", "sst", "--clim", c,
                       "--stripe", "5"]) == 0
    assert main(cpu + ["rank", m, r, "--stripe", "2"]) == 0
    for part, f in zip(PARTS, FILES):
        assert_files_match(str(tmp_path / f), jax_run[part])


def test_cli_run_matches_jax(grid_file, jax_run, tmp_path, capsys):
    d = tmp_path
    assert main(["--device", "cpu", "--f64", "run", grid_file, "sst",
                 str(d / "c.nc"), str(d / "m.nc"), "--block",
                 str(d / "b.nc"), "--rank", str(d / "r.nc"),
                 "--stripe", "3", "--resume"]) == 0
    assert f"return: {d / 'r_return.nc'}" in capsys.readouterr().out
    for part, f in zip(PARTS, FILES):
        assert_files_match(str(d / f), jax_run[part])


@pytest.mark.parametrize("cmd", ["run", "threshold", "detect",
                                 "block-average", "rank", "warmup"])
def test_cli_cuda_without_gpu_raises(grid_file, tmp_path, cmd):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: nothing to refuse")
    out = str(tmp_path / "o.nc")
    argv = {"run": [grid_file, "sst", out, str(tmp_path / "m.nc")],
            "threshold": [grid_file, "sst", out],
            "detect": [grid_file, "sst", grid_file, out],
            "block-average": [grid_file, out, "--period", "2000", "2002"],
            "rank": [grid_file, out],
            "warmup": ["--point"]}[cmd]
    with pytest.raises(RuntimeError, match="cuda"):
        main([cmd] + argv)
    assert not list(tmp_path.iterdir())


def test_cli_warmup_on_cpu_says_so(capsys):
    """An explicit --device cpu runs the standard shapes with the plain
    torch code, builds nothing, and says so."""
    assert main(["--device", "cpu", "warmup", "--days", "800", "--cells",
                 "64", "--k", "32"]) == 0
    out = capsys.readouterr().out
    assert "no kernels to build" in out
    assert "grid climatology (64 cells)" in out
    assert "grid detect K=32" in out
