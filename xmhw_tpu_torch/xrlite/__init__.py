"""Lightweight labeled-array + NetCDF shell (xarray/cftime replacement)."""

from .adapt import as_dataarray, as_dataset
from .dataarray import Coord, DataArray, Dataset, unstack_cell
from .export import to_dataframe, to_xarray
from .netcdf import open_dataset, save_dataset
from .timeutils import (
    TimeIndex,
    calendar_ndays,
    decode_cf_time,
    encode_cf_time,
    normalize_calendar,
)

__all__ = [
    "Coord",
    "as_dataarray",
    "as_dataset",
    "DataArray",
    "Dataset",
    "TimeIndex",
    "calendar_ndays",
    "decode_cf_time",
    "encode_cf_time",
    "normalize_calendar",
    "open_dataset",
    "save_dataset",
    "to_dataframe",
    "to_xarray",
    "unstack_cell",
]
