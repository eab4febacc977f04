"""NetCDF4 (HDF5) reading/writing via h5py.

The reference round-trips every pipeline stage through NetCDF
(reference: docs/gettingstarted.rst:64,158-188 — save clim/mhw with
``to_netcdf``). netCDF4/xarray are not available in this image, but all
modern NetCDF4 files are HDF5 under the hood, so we implement the (small)
dimension-scales convention directly with h5py:

* a *dimension* is an HDF5 dataset with attr ``CLASS=DIMENSION_SCALE``
* a *variable* references its dims through ``DIMENSION_LIST``
* ``_FillValue`` marks missing data; CF ``units``/``calendar`` mark time

Classic (netCDF3) files fall back to ``scipy.io.netcdf_file``.
"""

from __future__ import annotations

import numpy as np

from .dataarray import Coord, DataArray, Dataset
from .timeutils import TimeIndex, decode_cf_time, encode_cf_time


def _h5attrs(obj):
    out = {}
    for k, v in obj.attrs.items():
        if k in ("CLASS", "NAME", "DIMENSION_LIST", "REFERENCE_LIST",
                 "_Netcdf4Dimid", "_Netcdf4Coordinates", "_NCProperties"):
            continue
        if isinstance(v, bytes):
            v = v.decode("utf-8", "replace")
        elif isinstance(v, np.ndarray) and v.size == 1:
            v = v.item()
            if isinstance(v, bytes):
                v = v.decode("utf-8", "replace")
        out[k] = v
    return out


def _is_time(name, attrs):
    units = str(attrs.get("units", ""))
    return " since " in units


def open_dataset(path):
    """Open a NetCDF file as an xmhw_tpu Dataset."""
    with open(path, "rb") as fh:
        magic = fh.read(4)
    if magic == b"\x89HDF":
        return _open_h5(path)
    return _open_classic(path)


def _cf_unpack(vals, attrs):
    """CF packing/fill decode: scale_factor, add_offset, _FillValue and
    missing_value (xarray-equivalent; real-world products like packed
    int16 OISST need this). Consumes the packing attrs."""
    fv = attrs.pop("_FillValue", None)
    mv = attrs.pop("missing_value", None)
    sf = attrs.pop("scale_factor", None)
    ao = attrs.pop("add_offset", None)
    packed = sf is not None or ao is not None
    if not packed and fv is None and mv is None:
        return vals
    mask = np.zeros(np.shape(vals), bool)
    for f in (fv, mv):
        if f is None:
            continue
        f = np.asarray(f).reshape(-1)[0]
        if np.issubdtype(vals.dtype, np.floating) and np.isnan(
                np.float64(f)):
            mask |= np.isnan(vals)
        else:
            mask |= vals == vals.dtype.type(f)
    if packed or (mask.any() and not np.issubdtype(vals.dtype,
                                                   np.floating)):
        out_dt = np.result_type(
            np.float32 if vals.dtype.itemsize <= 2 else np.float64,
            *(np.asarray(x).dtype for x in (sf, ao) if x is not None))
        vals = vals.astype(out_dt)
        if sf is not None:
            vals = vals * np.asarray(sf).reshape(-1)[0]
        if ao is not None:
            vals = vals + np.asarray(ao).reshape(-1)[0]
    if mask.any():
        vals = np.where(mask, np.nan, vals)
    return vals


def _open_h5(path):
    import h5py

    ds = Dataset()
    with h5py.File(path, "r") as h:
        ds.attrs.update(_h5attrs(h))
        dim_names = []
        var_names = []
        for name, node in h.items():
            if not isinstance(node, h5py.Dataset):
                continue
            is_scale = node.attrs.get("CLASS", b"") == b"DIMENSION_SCALE"
            (dim_names if is_scale else var_names).append(name)

        coords = {}
        for name in dim_names:
            node = h[name]
            attrs = _h5attrs(node)
            vals = node[()]
            if _is_time(name, attrs):
                cal = str(attrs.pop("calendar", "standard"))
                units = str(attrs.pop("units"))
                tindex = decode_cf_time(vals, units, cal)
                tindex.attrs.update(attrs)
                tindex.encoding = {"units": units, "calendar": cal}
                coords[name] = Coord((name,), tindex, attrs)
            else:
                vals = _cf_unpack(vals, attrs)
                coords[name] = Coord((name,), vals, attrs)

        for name in var_names:
            node = h[name]
            attrs = _h5attrs(node)
            vals = _cf_unpack(node[()], attrs)
            # resolve dims through DIMENSION_LIST references
            dims = []
            if "DIMENSION_LIST" in node.attrs:
                for i, refs in enumerate(node.attrs["DIMENSION_LIST"]):
                    if len(refs):
                        dims.append(h[refs[0]].name.lstrip("/"))
                    else:
                        # axis with no attached scale (hand-written or
                        # partially-annotated files): synthetic name
                        dims.append(f"dim_{i}")
            else:
                dims = [f"dim_{i}" for i in range(vals.ndim)]
            if _is_time(name, attrs):
                cal = str(attrs.pop("calendar", "standard"))
                units = str(attrs.pop("units"))
                tindex = decode_cf_time(vals, units, cal)
                vals = tindex.values
                if not np.issubdtype(np.asarray(vals).dtype,
                                     np.datetime64):
                    # synthetic calendars keep raw offsets: preserve the
                    # CF metadata so year derivation survives round trips
                    attrs.update(units=units, calendar=cal)
            if attrs.pop("dtype", None) == "bool":
                vals = vals.astype(bool)
            # 1-D variable over an unnamed dim is an aux coordinate
            da = DataArray(
                vals, dims,
                {d: coords[d] for d in dims if d in coords},
                attrs, name,
            )
            ds[name] = da
        for cname, c in coords.items():
            ds.coords.setdefault(cname, c)
    return ds


def _open_classic(path):
    from scipy.io import netcdf_file

    ds = Dataset()
    with netcdf_file(path, "r", mmap=False) as f:
        ds.attrs.update({
            k: (v.decode() if isinstance(v, bytes) else v)
            for k, v in f._attributes.items()
        })
        coords = {}
        for name, var in f.variables.items():
            attrs = {
                k: (v.decode() if isinstance(v, bytes) else v)
                for k, v in var._attributes.items()
            }
            vals = _cf_unpack(np.array(var[:]), attrs)
            if name in f.dimensions:
                if _is_time(name, attrs):
                    cal = str(attrs.pop("calendar", "standard"))
                    units = str(attrs.pop("units"))
                    tindex = decode_cf_time(vals, units, cal)
                    tindex.encoding = {"units": units, "calendar": cal}
                    coords[name] = Coord((name,), tindex, attrs)
                else:
                    coords[name] = Coord((name,), vals, attrs)
        for name, var in f.variables.items():
            if name in f.dimensions:
                continue
            attrs = {
                k: (v.decode() if isinstance(v, bytes) else v)
                for k, v in var._attributes.items()
            }
            vals = _cf_unpack(np.array(var[:]), attrs)
            dims = list(var.dimensions)
            ds[name] = DataArray(
                vals, dims, {d: coords[d] for d in dims if d in coords},
                attrs, name,
            )
        for cname, c in coords.items():
            ds.coords.setdefault(cname, c)
    return ds


def save_dataset(ds, path, encoding=None):
    """Write a Dataset as a NetCDF4/HDF5 file (dimension-scales convention).

    ``encoding`` may map var name -> dict(dtype=..., zlib=bool,
    complevel=int) matching the reference's documented compression advice
    for sparse event output (reference: docs/gettingstarted.rst:158-188).
    """
    import h5py

    encoding = encoding or {}
    # collect dims and their sizes/coord values
    dim_sizes = {}
    for da in ds.data_vars.values():
        for d, s in da.sizes.items():
            dim_sizes[d] = s
    with h5py.File(path, "w") as h:
        for k, v in ds.attrs.items():
            try:
                h.attrs[k] = v
            except TypeError:
                h.attrs[k] = str(v)
        scales = {}
        for d, size in dim_sizes.items():
            coord = ds.coords.get(d)
            if coord is None:
                # a data variable named after its own dim is a
                # coordinate variable (xarray semantics): its VALUES
                # become the scale (it is skipped in the var loop below
                # — dropping it here would silently replace the values
                # with positional labels)
                dv = ds.data_vars.get(d) if hasattr(
                    ds, "data_vars") else None
                if dv is not None and tuple(dv.dims) == (d,):
                    coord = dv
            attrs = {}
            if coord is not None and coord.dims == (d,):
                vals = coord.values
                attrs = dict(coord.attrs)
                if isinstance(vals, TimeIndex):
                    raw, units, cal = encode_cf_time(
                        vals, vals.encoding.get("units"))
                    attrs.update(units=units, calendar=cal)
                    vals = raw
                elif np.issubdtype(np.asarray(vals).dtype, np.datetime64):
                    tindex = TimeIndex(vals)
                    raw, units, cal = encode_cf_time(tindex, None)
                    attrs.update(units=units, calendar=cal)
                    vals = raw
                elif vals.dtype.kind in "OU":
                    vals = np.asarray(
                        [str(x) for x in vals],
                        dtype=h5py.string_dtype(),
                    )
            else:
                vals = np.arange(size)
            node = h.create_dataset(d, data=vals)
            node.make_scale(d)
            for k, v in attrs.items():
                try:
                    node.attrs[k] = v
                except TypeError:
                    node.attrs[k] = str(v)
            scales[d] = node
        for name, da in ds.data_vars.items():
            if name in scales:
                continue
            enc = encoding.get(name, {})
            data = da.data
            var_attrs = dict(da.attrs)  # never mutate the caller's array
            if np.issubdtype(data.dtype, np.datetime64):
                tindex = TimeIndex(data.reshape(-1))
                raw, units, cal = encode_cf_time(tindex, None)
                data = np.asarray(raw).reshape(da.shape)
                var_attrs.update(units=units, calendar=cal)
            if data.dtype == bool:
                data = data.astype(np.int8)
                var_attrs["dtype"] = "bool"
            if "dtype" in enc:
                data = data.astype(enc["dtype"])
            kwargs = {}
            if enc.get("zlib"):
                kwargs.update(compression="gzip",
                              compression_opts=enc.get("complevel", 4))
            node = h.create_dataset(name, data=data, **kwargs)
            for i, d in enumerate(da.dims):
                node.dims[i].attach_scale(scales[d])
            if np.issubdtype(np.asarray(data).dtype, np.floating):
                node.attrs["_FillValue"] = np.array(
                    [np.nan], dtype=data.dtype)
            for k, v in var_attrs.items():
                try:
                    node.attrs[k] = v
                except TypeError:
                    node.attrs[k] = str(v)
