"""Exporters: xrlite objects -> xarray / pandas.

The reference returns xarray Datasets that users pipe straight into the
xarray ecosystem (reference: xmhw/xmhw.py:210-214, 465-478) and converts
per-cell tables through pandas (reference: identify.py:377, 402). xarray
and pandas are deliberately not dependencies of this package, but a
migrating user usually has them — ``to_xarray``/``to_dataframe`` convert
xrlite outputs into the native objects when the libraries are importable
(and raise a clear ImportError when not).

Time handling: TimeIndex coords backed by datetime64 export as plain
datetime64[ns] (what xarray's CF decoding produces for real-world
calendars). Synthetic calendars (noleap/360_day/...) hold raw CF offsets
— they export with their ``units``/``calendar`` attrs intact, and
``to_xarray`` re-decodes them through cftime via
``xarray.decode_cf``-compatible metadata when cftime is available
(decode=True), or leaves the raw numbers + attrs otherwise.
"""

from __future__ import annotations

import numpy as np

from .dataarray import Coord, DataArray, Dataset, _coord_values
from .timeutils import TimeIndex

__all__ = ["to_xarray", "to_dataframe"]


def _import_xarray():
    try:
        import xarray as xr
    except ImportError as e:  # pragma: no cover - environment-dependent
        raise ImportError(
            "to_xarray() requires the optional dependency 'xarray' "
            "(pip install xarray)") from e
    return xr


def _export_coord_values(c: Coord):
    """(values, attrs) with TimeIndex handled: datetime64 passes through,
    synthetic calendars keep raw offsets + CF units/calendar attrs."""
    attrs = dict(c.attrs)
    v = c.values
    if isinstance(v, TimeIndex):
        raw = np.asarray(v.values)
        if np.issubdtype(raw.dtype, np.datetime64):
            return raw, attrs
        # synthetic calendar: raw CF offsets + decoding metadata
        if v.units is not None:
            attrs.setdefault("units", v.units)
        attrs.setdefault("calendar", v.calendar)
        return raw, attrs
    return v, attrs


def _decode_synthetic_inplace(xr, obj):
    """Re-decode raw synthetic-calendar time coords through cftime, when
    available — matching what xarray.open_dataset(decode_times=True)
    would have produced. Quietly keeps raw values if cftime is absent."""
    try:
        import cftime  # noqa: F401
        from xarray.coding.times import decode_cf_datetime
    except ImportError:
        return obj
    for name in list(obj.coords):
        c = obj.coords[name]
        a = dict(c.attrs)
        if "units" not in a or "since" not in str(a.get("units", "")):
            continue
        if np.issubdtype(np.asarray(c.values).dtype, np.datetime64):
            continue
        try:
            decoded = decode_cf_datetime(
                np.asarray(c.values), a["units"],
                a.get("calendar", "standard"))
        except Exception:
            continue
        attrs = {k: v for k, v in a.items()
                 if k not in ("units", "calendar")}
        obj = obj.assign_coords(
            {name: xr.DataArray(decoded, dims=c.dims, attrs=attrs)})
        obj[name].encoding.update(units=a["units"],
                                  calendar=a.get("calendar", "standard"))
    return obj


def to_xarray(obj, decode_times=True):
    """Convert an xrlite DataArray/Dataset to the xarray equivalent.

    Dims, coords (including scalar and non-dim coords), variable attrs
    and global attrs all carry over, so the result matches the Dataset
    the reference returns (reference: xmhw.py:210-214, 465-478)
    structurally. Requires xarray; synthetic-calendar time coords are
    re-decoded through cftime when ``decode_times`` and cftime is
    installed.
    """
    xr = _import_xarray()
    if isinstance(obj, DataArray):
        coords = {}
        for k, c in obj.coords.items():
            vals, attrs = _export_coord_values(c)
            if c.dims:
                coords[k] = xr.DataArray(vals, dims=c.dims, attrs=attrs)
            else:
                coords[k] = xr.DataArray(np.asarray(vals)[()], attrs=attrs)
        out = xr.DataArray(np.asarray(obj.data), dims=obj.dims,
                           coords=coords, attrs=dict(obj.attrs),
                           name=obj.name)
    elif isinstance(obj, Dataset):
        data_vars = {}
        coords = {}
        for k, c in obj.coords.items():
            vals, attrs = _export_coord_values(c)
            if c.dims:
                coords[k] = xr.DataArray(vals, dims=c.dims, attrs=attrs)
            else:
                coords[k] = xr.DataArray(np.asarray(vals)[()], attrs=attrs)
        for name, da in obj.items():
            data_vars[name] = xr.DataArray(
                np.asarray(da.data), dims=da.dims, attrs=dict(da.attrs))
        out = xr.Dataset(data_vars, coords=coords, attrs=dict(obj.attrs))
    else:
        raise TypeError(
            f"to_xarray expects an xrlite DataArray or Dataset, got "
            f"{type(obj).__name__!r}")
    if decode_times:
        out = _decode_synthetic_inplace(xr, out)
    return out


def _import_pandas():
    try:
        import pandas as pd
    except ImportError as e:  # pragma: no cover - environment-dependent
        raise ImportError(
            "to_dataframe() requires the optional dependency 'pandas' "
            "(pip install pandas)") from e
    return pd


def _dim_labels(obj, dims):
    """Per-dim index labels: the dim's own coord values, else positions."""
    sizes = obj.sizes if isinstance(obj, DataArray) else obj.dims
    labels = {}
    for d in dims:
        c = obj.coords.get(d)
        if c is not None and c.dims == (d,):
            labels[d] = np.asarray(_coord_values(c))
        else:
            labels[d] = np.arange(sizes[d])
    return labels


def to_dataframe(obj):
    """Convert to a pandas DataFrame, matching xarray's ``to_dataframe``
    semantics: the index is the (Multi)Index over all dims, columns are
    data variables broadcast over the full dim product (the reference's
    per-cell engine lives in pandas — identify.py:377 — so its users
    expect frame-shaped output for further analysis).
    """
    pd = _import_pandas()
    if isinstance(obj, DataArray):
        ds = Dataset()
        ds[obj.name or "value"] = obj
        obj = ds
    if not isinstance(obj, Dataset):
        raise TypeError(
            f"to_dataframe expects an xrlite DataArray or Dataset, got "
            f"{type(obj).__name__!r}")
    dims = list(obj.dims)  # ordered by first appearance across variables
    sizes = obj.dims
    labels = _dim_labels(obj, dims)
    if dims:
        index = pd.MultiIndex.from_product(
            [labels[d] for d in dims], names=dims)
    else:
        index = pd.RangeIndex(1)
    cols = {}
    for name, da in obj.items():
        data = np.asarray(da.data)
        # broadcast to the full dim product in `dims` order
        expand = tuple(slice(None) if d in da.dims else None for d in dims)
        perm = [da.dims.index(d) for d in dims if d in da.dims]
        data = np.transpose(data, perm)[
            tuple(expand)] if dims else data.reshape(())
        full = np.broadcast_to(
            data, tuple(sizes[d] for d in dims) if dims else ())
        cols[name] = np.asarray(full).reshape(-1)
    # non-dim coords (e.g. per-cell lat/lon after stacking) ride along
    # as columns, like xarray's to_dataframe
    for k, c in obj.coords.items():
        if k in dims or not c.dims or k in cols:
            continue
        if all(d in dims for d in c.dims):
            vals = np.asarray(_coord_values(c))
            expand = tuple(slice(None) if d in c.dims else None
                           for d in dims)
            perm = [c.dims.index(d) for d in dims if d in c.dims]
            vals = np.transpose(vals, perm)[tuple(expand)]
            cols[k] = np.asarray(np.broadcast_to(
                vals, tuple(sizes[d] for d in dims))).reshape(-1)
    return pd.DataFrame(cols, index=index)
