"""Build the port's CUDA kernels with nvcc and load them with ctypes.

At first use, every ``xmhw_tpu_torch/csrc/*.cu`` is compiled by ONE nvcc
call into one shared library with a plain C interface
(``xmhw_tpu_torch/_build/libxmhw_kernels_<hash>.so``). The file name
carries a hash of the sources and flags, so an edited source rebuilds
and an unchanged one loads the cached library. No PyTorch headers are
included, which keeps a cold build to seconds.

Every ``extern "C"`` launcher returns ``cudaGetLastError()`` after its
launch; :func:`check` raises on a non-zero code, so a launch the card
refuses is reported where it happened.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# launcher name -> argument types (pointers and the stream as c_void_p)
SIGNATURES = {
    "xmhw_doy_quantile": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    "xmhw_rle": (_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                 _P),
    "xmhw_event_scan": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P,
                        _P),
    "xmhw_run_bound": (_P, _I, _I, _I, _P, _P),
}


def nvcc_path() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc "
                           "on PATH to build the CUDA kernels")
    return found


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (if the sources changed) and return the
    library path. Raises with nvcc's own message when it fails."""
    so = BUILD_DIR / f"libxmhw_kernels_{_digest()}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *map(str, sources())]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {r.returncode}:\n"
            f"{' '.join(cmd)}\n{r.stdout}{r.stderr}")
    os.replace(tmp, so)
    return so


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.xmhw_error_string.argtypes = [ctypes.c_int]
    lib.xmhw_error_string.restype = ctypes.c_char_p
    lib.xmhw_event_scan_config.argtypes = [ctypes.POINTER(_I)] * 3
    lib.xmhw_event_scan_config.restype = None
    lib.xmhw_event_scan_scratch.argtypes = [_I, _I]
    lib.xmhw_event_scan_scratch.restype = ctypes.c_longlong
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        msg = library().xmhw_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_of(t) -> int:
    """The current CUDA stream of ``t``'s device, as an int for ctypes."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
