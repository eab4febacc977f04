"""xmhw_tpu_torch — marine heatwave detection in PyTorch and CUDA.

The port of :mod:`xmhw_tpu` (JAX on a TPU) to PyTorch on an NVIDIA GPU.
Plain tensor code is torch; the three hot-path kernels (the pooled
day-of-year percentile, the event run-length encoding and the event scan)
and the running-bound primitive are CUDA C++ under ``csrc/``, built with
nvcc at first use.

Public API (reference parity: README.rst:16-21):
    threshold()      day-of-year percentile/mean climatology
    detect()         MHW event identification + ~30 per-event properties
    block_average()  year-block statistics
    mhw_rank()       per-property ranks and return periods

``device`` of threshold()/detect() names a torch device (default
``"cuda"``); that of block_average()/mhw_rank() keeps the JAX package's
bool (False: the numpy host path, True: ``"cuda"``) or names a device.

Importing the package touches no device and sets no environment.
"""

from .api import detect, flip_cold, land_check, threshold
from .exception import XmhwException
from .stats_api import block_average, mhw_rank
from .xrlite import DataArray, Dataset, TimeIndex

__version__ = "0.1.0"

__all__ = [
    "DataArray",
    "Dataset",
    "TimeIndex",
    "XmhwException",
    "block_average",
    "detect",
    "flip_cold",
    "land_check",
    "mhw_rank",
    "threshold",
    "__version__",
]
