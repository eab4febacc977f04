"""Duck-typed input adapters: accept xarray objects at the public API.

The reference's public contract is "temp: xarray DataArray"
(reference: xmhw/xmhw.py:53-57, 325-334). xarray is deliberately not a
dependency of this package, but a migrating user holds xarray objects —
``as_dataarray``/``as_dataset`` convert ANY object with the xarray shape
(``dims`` / ``coords`` / ``values`` / ``attrs``) into the xrlite
equivalents, so xarray inputs work at every entry point without the
import. Conversion is structural only (no xarray API calls), so it works
with real xarray, with test stubs, and with anything else duck-typed.

cftime-backed time axes (object-dtype arrays of objects carrying
``year/month/day[/calendar]``) are re-encoded onto xrlite's
:class:`TimeIndex` with the matching CF calendar, reproducing the
reference's cftime handling (reference: xmhw/identify.py:114-119).
"""

from __future__ import annotations

import numpy as np

from .dataarray import Coord, DataArray, Dataset
from .timeutils import TimeIndex, normalize_calendar

__all__ = ["as_dataarray", "as_dataset"]


def _looks_like_dataarray(obj) -> bool:
    return (hasattr(obj, "dims") and hasattr(obj, "coords")
            and (hasattr(obj, "values") or hasattr(obj, "data")))


def _raw_values(obj):
    v = getattr(obj, "values", None)
    if v is None:
        v = obj.data
    return v


_CUM_365 = np.concatenate(
    [[0], np.cumsum([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30])])
_CUM_366 = np.concatenate(
    [[0], np.cumsum([31, 29, 31, 30, 31, 30, 31, 31, 30, 31, 30])])


def _encode_date_components(y, m, d, frac, calendar, y0):
    """Days since ``y0``-01-01 on a synthetic CF calendar."""
    cal = normalize_calendar(calendar)
    if cal == "360_day":
        days = (y - y0) * 360 + (m - 1) * 30 + (d - 1)
    elif cal in ("all_leap", "366_day"):
        days = (y - y0) * 366 + _CUM_366[m - 1] + (d - 1)
    elif cal == "julian":
        # julian leap rule: every 4th year, no century exception
        nleap = (y - 1) // 4 - (y0 - 1) // 4
        leap_extra = ((y % 4 == 0) & (m > 2)).astype(np.int64)
        days = (y - y0) * 365 + nleap + _CUM_365[m - 1] + (d - 1) + leap_extra
    else:  # noleap / 365_day
        days = (y - y0) * 365 + _CUM_365[m - 1] + (d - 1)
    return days.astype(np.float64) + frac


def _object_dates_to_timeindex(vals: np.ndarray) -> TimeIndex | None:
    """Convert an object array of date-like objects (cftime / datetime)
    to a TimeIndex, or None if the elements are not date-like."""
    flat = vals.ravel()
    if flat.size == 0:
        return None
    first = flat[0]
    if not all(hasattr(first, a) for a in ("year", "month", "day")):
        return None
    y = np.array([t.year for t in flat], np.int64)
    m = np.array([t.month for t in flat], np.int64)
    d = np.array([t.day for t in flat], np.int64)
    hh = np.array([getattr(t, "hour", 0) for t in flat], np.int64)
    mi = np.array([getattr(t, "minute", 0) for t in flat], np.int64)
    ss = np.array([getattr(t, "second", 0) for t in flat], np.float64)
    cal = normalize_calendar(
        getattr(first, "calendar", "") or "standard")
    if cal in ("standard", "gregorian", "proleptic_gregorian", ""):
        iso = np.array(
            ["%04d-%02d-%02dT%02d:%02d:%02d" % t
             for t in zip(y, m, d, hh, mi, ss.astype(np.int64))],
            dtype="datetime64[ns]")
        return TimeIndex(iso)
    frac = (hh * 3600 + mi * 60 + ss) / 86400.0
    y0 = int(y.min())
    raw = _encode_date_components(y, m, d, frac, cal, y0)
    units = f"days since {y0:04d}-01-01 00:00:00"
    return TimeIndex(raw, calendar=cal, units=units)


def _convert_coord(c) -> Coord:
    cdims = tuple(getattr(c, "dims", ()) or ())
    vals = _raw_values(c)
    attrs = dict(getattr(c, "attrs", {}) or {})
    # xarray keeps calendar/units in .encoding after CF decoding; carry
    # them into attrs so get_calendar() sees them (reference:
    # identify.py:114-119 reads encoding first, then attrs)
    enc = dict(getattr(c, "encoding", {}) or {})
    for k in ("calendar", "units"):
        if k in enc and k not in attrs:
            attrs[k] = enc[k]
    if not isinstance(vals, TimeIndex):
        vals = np.asarray(vals)
        if vals.dtype == object:
            ti = _object_dates_to_timeindex(vals)
            if ti is not None:
                ti.attrs = attrs
                vals = ti
        elif np.issubdtype(vals.dtype, np.datetime64):
            vals = vals.astype("datetime64[ns]")
    if not isinstance(vals, TimeIndex) and np.ndim(vals) == 0:
        vals = np.asarray(vals)[()]
        cdims = ()
    return Coord(cdims, vals, attrs)


def as_dataarray(obj, name=None) -> DataArray:
    """Convert any xarray-shaped object to an xrlite DataArray.

    xrlite DataArrays pass through unchanged; anything else must expose
    ``dims`` (names), ``coords`` (mapping of objects with
    ``dims``/``values``), ``values`` or ``data``, and optionally
    ``attrs``/``name``/``encoding``. Multi-dimensional coordinates are
    skipped (the pipeline only consumes dim-aligned 1-D/scalar coords).
    """
    if isinstance(obj, DataArray):
        return obj
    if not _looks_like_dataarray(obj):
        raise TypeError(
            f"cannot adapt {type(obj).__name__!r} to a DataArray: "
            "expected xrlite.DataArray or an xarray-like object with "
            "dims/coords/values")
    dims = tuple(obj.dims)
    data = np.asarray(_raw_values(obj))
    coords = {}
    for cname in obj.coords:
        c = obj.coords[cname]
        conv = _convert_coord(c)
        if len(conv.dims) > 1:
            continue
        coords[cname] = conv
    attrs = dict(getattr(obj, "attrs", {}) or {})
    return DataArray(data, dims, coords, attrs,
                     name or getattr(obj, "name", None))


def as_dataset(obj) -> Dataset:
    """Convert any xarray-shaped Dataset (``data_vars`` mapping) or a
    single DataArray-like to an xrlite Dataset."""
    if isinstance(obj, Dataset):
        return obj
    if isinstance(obj, DataArray) or (
            not hasattr(obj, "data_vars") and _looks_like_dataarray(obj)):
        da = as_dataarray(obj)
        ds = Dataset()
        ds[da.name or "ts"] = da
        return ds
    if not hasattr(obj, "data_vars"):
        raise TypeError(
            f"cannot adapt {type(obj).__name__!r} to a Dataset: expected "
            "xrlite.Dataset or an xarray-like object with data_vars")
    ds = Dataset(attrs=dict(getattr(obj, "attrs", {}) or {}))
    for vname in obj.data_vars:
        ds[vname] = as_dataarray(obj.data_vars[vname], name=vname)
    return ds
