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

The streamed file-to-file pipelines (:mod:`xmhw_tpu_torch.stream`:
stream_threshold/detect/block_average/rank, the one-pass stream_run, and
merge_grid_band_files) and the CLI (``python -m xmhw_tpu_torch``) run
grids larger than host memory; open_dataset/save_dataset read and write
NetCDF4.

``device`` of threshold()/detect() and of the stream functions names a
torch device (default ``"cuda"``); that of block_average()/mhw_rank()
also takes the JAX package's bool (True, the default: ``"cuda"``;
False: the numpy host path, the JAX package's default).

Importing the package touches no device and sets no environment.
"""

from .api import detect, flip_cold, land_check, threshold
from .exception import XmhwException
from .stats_api import block_average, mhw_rank
from .stream import (merge_grid_band_files, stream_block_average,
                     stream_detect, stream_rank, stream_run,
                     stream_threshold)
from .xrlite import (DataArray, Dataset, TimeIndex, open_dataset,
                     save_dataset, to_dataframe, to_xarray)

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
    "merge_grid_band_files",
    "mhw_rank",
    "open_dataset",
    "save_dataset",
    "stream_block_average",
    "stream_detect",
    "stream_rank",
    "stream_run",
    "stream_threshold",
    "threshold",
    "to_dataframe",
    "to_xarray",
    "__version__",
]
