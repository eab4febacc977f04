"""A numpy stand-in for the part of h5py that xmhw_tpu_torch calls.

It exists for one purpose: to run the port's streamed file-to-file
pipelines on a machine that has numpy but no h5py. Put
``tools/h5py_standin`` first on ``sys.path`` (or ``PYTHONPATH``) and
``import h5py`` resolves to this module; ``chip_smoke.py`` does so where
h5py is not installed. It is never installed with the package, and no
module of ``xmhw_tpu_torch`` names it.

What it implements, and nothing more (the calls of ``xmhw_tpu_torch``'s
stream and NetCDF modules and of ``tools/torch_multiproc_stream.py``):

* ``File(path, "r" | "r+" | "w")``, a context manager with ``keys``,
  ``items``, ``in``, iteration, ``attrs``, ``create_dataset``, ``flush``
  and ``close``; ``f[name]`` and ``f[reference]``;
* ``Dataset``: ``shape``, ``dtype``, ``ndim``, ``maxshape``, ``chunks``,
  ``fillvalue``, ``name``, ``file``, ``id``, ``attrs``, ``is_scale``,
  ``make_scale``, ``resize``, ``read_direct`` and basic-index ``[]``
  reads and writes;
* ``dims``, iterated or indexed, and ``dims[i]`` with ``attach_scale``,
  ``len``, ``[k]`` and ``values``; the ``DIMENSION_LIST`` and
  ``REFERENCE_LIST`` attributes as h5py shows them (object references);
* ``h5ds.is_scale(node.id)`` and ``string_dtype()``.

Attribute values come back with h5py's types (``str`` for ``str`` and
``bytes``, numpy scalars for numbers, arrays for sequences), and the
values h5py refuses raise the ``TypeError`` h5py raises. Anything else
raises ``NotImplementedError`` naming the call.

The file format is not HDF5. A file starts with the 8-byte HDF5
signature (so that code which checks it passes), then this module's own
8-byte magic, then the offset and length of a JSON header. Each numeric
dataset is one C-ordered raw array at an offset the header records;
hyperslab reads and region writes go through ``mmap`` of that region
alone, so a stripe read touches only that stripe. Vlen string datasets
(small coordinate labels) live in the header. ``resize`` moves a dataset
to the end of the file; compression keywords are recorded and the data
is stored raw. The header is written by ``flush`` and ``close`` (a file
object that is garbage-collected unclosed writes nothing more, as after
a crash). h5py refuses these files (bad superblock version), and this
module refuses HDF5 files, so a mix-up fails loudly either way.
"""

from __future__ import annotations

import base64
import json
import mmap
import os
import struct
import threading
import types
from collections.abc import MutableMapping

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
MAGIC = b"NPSTAND1"
_PREFIX = 32  # signature, magic, header offset (u8), header length (u8)
_ALIGN = 64
_FILL_CHUNK = 1 << 24
_SCALE_CLASS = b"DIMENSION_SCALE"
_REF_DTYPE = np.dtype({"names": ["dataset", "dimension"],
                       "formats": ["O", "<u4"], "offsets": [0, 8],
                       "itemsize": 16})
_COMPUTED = ("DIMENSION_LIST", "REFERENCE_LIST")


def _missing(owner, name):
    return NotImplementedError(
        f"{owner}.{name} is not in the numpy stand-in for h5py "
        "(tools/h5py_standin), which implements only the calls "
        "xmhw_tpu_torch makes")


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise _missing("h5py", name)


def string_dtype(encoding="utf-8", length=None):
    """h5py's variable-length UTF-8 string dtype."""
    if encoding != "utf-8" or length is not None:
        raise _missing("h5py", f"string_dtype({encoding!r}, {length!r})")
    return np.dtype("O", metadata={"vlen": str})


def _is_vlen_str(dt):
    return dt.kind == "O" and (dt.metadata or {}).get("vlen") is str


def _no_conversion(dt):
    return TypeError(f"No conversion path for dtype: {dt!r}")


class Reference:
    """An object reference, as held by DIMENSION_LIST/REFERENCE_LIST."""

    __slots__ = ("_name",)

    def __init__(self, name):
        self._name = name

    def __repr__(self):
        return "<HDF5 object reference (numpy stand-in)>"


def _b64(b):
    return base64.b64encode(bytes(b)).decode("ascii")


def _encode(v):
    """An attribute value as JSON, converted as h5py converts it."""
    if isinstance(v, np.str_):
        raise _no_conversion(np.asarray(v).dtype)
    if isinstance(v, str):
        return {"str": v}
    if isinstance(v, np.bytes_):
        return {"S": _b64(v)}
    if isinstance(v, bytes):
        try:
            return {"str": v.decode("utf-8")}
        except UnicodeDecodeError:
            raise _missing("AttributeManager", "__setitem__ of non-UTF-8 "
                           "bytes") from None
    if (isinstance(v, (list, tuple)) and v
            and all(type(x) is str for x in v)):
        return {"strs": list(v)}
    a = np.asarray(v)
    if a.dtype.kind in "biufc":
        return {"num": a.dtype.str, "shape": list(a.shape) if a.ndim else None,
                "b64": _b64(np.ascontiguousarray(a).tobytes())}
    if a.dtype.kind == "O":
        raise TypeError(f"Object dtype {a.dtype!r} has no native HDF5 "
                        "equivalent")
    if a.dtype.kind in "UMm":
        raise _no_conversion(a.dtype)
    raise _missing("AttributeManager", f"__setitem__ of {a.dtype!r} values")


def _decode(j):
    if "str" in j:
        return j["str"]
    if "S" in j:
        return np.bytes_(base64.b64decode(j["S"]))
    if "strs" in j:
        return np.array(j["strs"], dtype=object)
    a = np.frombuffer(base64.b64decode(j["b64"]), np.dtype(j["num"])).copy()
    return a[0] if j["shape"] is None else a.reshape(j["shape"])


def _check_key(key, what):
    """Basic indexing only: (), Ellipsis, ints, slices, tuples of them."""
    parts = key if isinstance(key, tuple) else (key,)
    for p in parts:
        if not (p is Ellipsis or isinstance(p, (slice, int, np.integer))):
            raise _missing("Dataset", f"{what}[{key!r}] (only basic "
                           "indexing: ints, slices, Ellipsis)")
    return key


class AttributeManager(MutableMapping):
    """``node.attrs``: h5py's attribute mapping, in name order."""

    def __init__(self, file, store, computed=None):
        self._file = file
        self._store = store
        self._computed = computed or (lambda: {})

    def __getitem__(self, key):
        comp = self._computed()
        if key in comp:
            return comp[key]
        return _decode(self._store[key])

    def __setitem__(self, key, value):
        self._file._writable("create attribute")
        if key in _COMPUTED:
            raise _missing("AttributeManager", f"__setitem__({key!r})")
        enc = _encode(value)
        with self._file._lock:
            self._store[key] = enc

    def __delitem__(self, key):
        self._file._writable("delete attribute")
        with self._file._lock:
            del self._store[key]

    def __contains__(self, key):
        return key in self._store or key in self._computed()

    def __iter__(self):
        return iter(sorted(set(self._store) | set(self._computed())))

    def __len__(self):
        return len(set(self._store) | set(self._computed()))

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        raise _missing("AttributeManager", name)


class _ObjectID:
    """``node.id``: only what ``h5ds.is_scale`` reads."""

    def __init__(self, node):
        self._node = node

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        raise _missing("ObjectID", name)


def _h5ds_is_scale(oid):
    return oid._node.is_scale


def _h5ds_getattr(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise _missing("h5py.h5ds", name)


h5ds = types.ModuleType("h5py.h5ds", "h5py's dimension-scale calls: "
                        "only is_scale")
h5ds.is_scale = _h5ds_is_scale
h5ds.__getattr__ = _h5ds_getattr


class DimensionProxy:
    """``node.dims[i]``: the scales attached to axis ``i``."""

    def __init__(self, node, axis):
        self._node = node
        self._axis = axis

    def _names(self):
        dl = self._node._ent["dimlist"]
        return list(dl[self._axis]) if dl is not None else []

    def attach_scale(self, scale):
        node = self._node
        node.file._writable("attach a scale")
        if not isinstance(scale, Dataset) or scale.file is not node.file:
            raise _missing("DimensionProxy", "attach_scale of a scale in "
                           "another file")
        with node.file._lock:
            ent = node._ent
            if ent["dimlist"] is None:
                ent["dimlist"] = [[] for _ in range(node.ndim)]
            if scale._name not in ent["dimlist"][self._axis]:
                ent["dimlist"][self._axis].append(scale._name)
                scale._ent["reflist"].append([node._name, self._axis])

    def __len__(self):
        return len(self._names())

    def __getitem__(self, k):
        if not isinstance(k, (int, np.integer)):
            raise _missing("DimensionProxy", f"__getitem__({k!r})")
        return Dataset(self._node.file, self._names()[k])

    def values(self):
        return [Dataset(self._node.file, n) for n in self._names()]

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        raise _missing("DimensionProxy", name)


class DimensionManager:
    """``node.dims``."""

    def __init__(self, node):
        self._node = node

    def __getitem__(self, i):
        if not -self._node.ndim <= i < self._node.ndim:
            raise IndexError(i)
        return DimensionProxy(self._node, i % self._node.ndim)

    def __len__(self):
        return self._node.ndim

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        raise _missing("DimensionManager", name)


class Dataset:
    """One array of a stand-in file; a handle, like h5py's."""

    def __init__(self, file, name):
        self._file = file
        self._name = name

    @property
    def _ent(self):
        return self._file._header["datasets"][self._name]

    @property
    def file(self):
        return self._file

    @property
    def name(self):
        return "/" + self._name

    @property
    def id(self):
        return _ObjectID(self)

    @property
    def shape(self):
        return tuple(self._ent["shape"])

    @property
    def ndim(self):
        return len(self._ent["shape"])

    @property
    def dtype(self):
        dt = self._ent["dtype"]
        return string_dtype() if dt == "vlen-str" else np.dtype(dt)

    @property
    def maxshape(self):
        return tuple(self._ent["maxshape"])

    @property
    def chunks(self):
        c = self._ent["chunks"]
        return None if c is None else tuple(c)

    @property
    def fillvalue(self):
        if self._ent["dtype"] == "vlen-str":
            return b""
        return _decode(self._ent["fillvalue"])

    @property
    def attrs(self):
        return AttributeManager(self._file, self._ent["attrs"],
                                self._computed_attrs)

    @property
    def dims(self):
        return DimensionManager(self)

    @property
    def is_scale(self):
        return self._ent["attrs"].get("CLASS") == {"S": _b64(_SCALE_CLASS)}

    def _computed_attrs(self):
        ent, out = self._ent, {}
        if ent["dimlist"] is not None:
            dl = np.empty(len(ent["dimlist"]), dtype=object)
            for i, names in enumerate(ent["dimlist"]):
                refs = np.empty(len(names), dtype=object)
                refs[:] = [Reference(n) for n in names]
                dl[i] = refs
            out["DIMENSION_LIST"] = dl
        if ent["reflist"]:
            rl = np.empty(len(ent["reflist"]), _REF_DTYPE)
            for i, (n, ax) in enumerate(ent["reflist"]):
                rl[i] = (Reference(n), ax)
            out["REFERENCE_LIST"] = rl
        return out

    def __repr__(self):
        return (f'<HDF5 dataset "{self._name}": shape {self.shape}, type '
                f'"{self.dtype.str}" (numpy stand-in)>')

    def make_scale(self, name=""):
        self._file._writable("make a scale")
        self.attrs["CLASS"] = np.bytes_(_SCALE_CLASS)
        self.attrs["NAME"] = np.bytes_(str(name).encode())

    def resize(self, size, axis=None):
        """Grow or shrink along the axes whose maxshape allows it: the
        array moves to a new region at the end of the file (the old region
        is left unused), the new part at the fill value."""
        f = self._file
        f._writable("resize")
        if self.chunks is None:
            raise TypeError("Only chunked datasets can be resized")
        if self._ent["dtype"] == "vlen-str":
            raise _missing("Dataset", "resize of a string dataset")
        if axis is not None:
            new = list(self.shape)
            new[axis] = int(size)
        else:
            new = [int(size)] if np.ndim(size) == 0 else [int(s) for s in size]
        if len(new) != self.ndim:
            raise TypeError(f"new shape {new} has another rank than "
                            f"{self.shape}")
        for s, m in zip(new, self.maxshape):
            if s < 0 or (m is not None and s > m):
                raise ValueError(f"dimension cannot exceed the existing "
                                 f"maximal size (new: {s} max: {m})")
        with f._lock:
            ent = self._ent
            old_shape, old_off = self.shape, ent["offset"]
            if tuple(new) == old_shape:
                return
            off = f._alloc(int(np.prod(new)) * self.dtype.itemsize,
                           self.fillvalue)
            keep = tuple(slice(0, min(a, b)) for a, b in zip(old_shape, new))
            if all(k.stop for k in keep):
                part = f._read(old_off, old_shape, self.dtype, keep)
                f._write(off, tuple(new), self.dtype, keep, part)
            ent["shape"], ent["offset"] = new, off

    def __getitem__(self, key):
        key = _check_key(key, "Dataset")
        ent = self._ent
        if ent["dtype"] == "vlen-str":
            vals = np.empty(len(ent["strings"]), dtype=object)
            vals[:] = [s.encode() for s in ent["strings"]]
            return vals.reshape(self.shape)[key]
        out = self._file._read(ent["offset"], self.shape, self.dtype, key)
        return out[()] if out.ndim == 0 else out

    def __setitem__(self, key, value):
        self._file._writable("write data")
        key = _check_key(key, "Dataset")
        ent = self._ent
        if ent["dtype"] == "vlen-str":
            raise _missing("Dataset", "__setitem__ of a string dataset")
        self._file._write(ent["offset"], self.shape, self.dtype, key, value)

    def read_direct(self, dest, source_sel=None, dest_sel=None):
        ent = self._ent
        if ent["dtype"] == "vlen-str" or dest_sel is not None:
            raise _missing("Dataset", "read_direct of a string dataset or "
                           "into a dest_sel")
        src = _check_key(() if source_sel is None else source_sel,
                         "read_direct source ")
        self._file._read(ent["offset"], self.shape, self.dtype, src,
                         into=dest)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        raise _missing("Dataset", name)


class File:
    """A stand-in file: ``"r"`` reads, ``"r+"`` reads and writes, ``"w"``
    creates (truncating)."""

    def __init__(self, name, mode="r", **kwds):
        self._fd = None
        if kwds:
            raise _missing("File", f"__init__({', '.join(sorted(kwds))}=...)")
        if mode not in ("r", "r+", "w"):
            raise _missing("File", f"__init__(mode={mode!r})")
        self.filename = os.fspath(name)
        self.mode = "r" if mode == "r" else "r+"
        self._lock = threading.RLock()
        flags = {"r": os.O_RDONLY, "r+": os.O_RDWR,
                 "w": os.O_RDWR | os.O_CREAT | os.O_TRUNC}[mode]
        self._fd = os.open(self.filename, flags, 0o666)
        try:
            if mode == "w":
                os.pwrite(self._fd, SIGNATURE + MAGIC + bytes(16), 0)
                self._header = {"attrs": {}, "datasets": {}}
                self._hdr_at = (0, 0)
                self._size = _PREFIX
                self._data_end = _PREFIX
                self.flush()
            else:
                self._load()
        except BaseException:
            os.close(self._fd)
            self._fd = None
            raise

    def _load(self):
        head = os.pread(self._fd, _PREFIX, 0)
        if head[:8] != SIGNATURE:
            raise OSError(f"Unable to open file {self.filename!r} (file "
                          "signature not found)")
        if head[8:16] != MAGIC:
            raise OSError(
                f"{self.filename!r} is an HDF5 file, not one of the numpy "
                "stand-in for h5py (tools/h5py_standin), which reads only "
                "its own files: open it with h5py")
        off, n = struct.unpack("<QQ", head[16:32])
        self._header = json.loads(os.pread(self._fd, n, off))
        self._hdr_at = (off, n)
        self._size = os.fstat(self._fd).st_size
        ends = [e["offset"] + self._nbytes(e)
                for e in self._header["datasets"].values()
                if e["offset"] is not None]
        self._data_end = max([_PREFIX] + ends)

    @staticmethod
    def _nbytes(ent):
        return int(np.prod(ent["shape"])) * np.dtype(ent["dtype"]).itemsize

    # ---- the file as a mapping of datasets ---------------------------------
    def _open(self):
        if self._fd is None:
            raise ValueError("Invalid location identifier (the file is "
                             "closed)")

    def _writable(self, what):
        self._open()
        if self.mode == "r":
            raise OSError(f"Unable to {what} (no write intent on file)")

    @property
    def attrs(self):
        self._open()
        return AttributeManager(self, self._header["attrs"])

    def __getitem__(self, key):
        self._open()
        if isinstance(key, Reference):
            key = key._name
        if not isinstance(key, str):
            raise _missing("File", f"__getitem__({key!r})")
        key = key[1:] if key.startswith("/") else key
        if "/" in key or not key:
            raise _missing("File", f"__getitem__({key!r}) (groups)")
        if key not in self._header["datasets"]:
            raise KeyError(f"Unable to open object (object {key!r} "
                           "doesn't exist)")
        return Dataset(self, key)

    def __contains__(self, key):
        key = key[1:] if isinstance(key, str) and key.startswith("/") else key
        return key in self._header["datasets"]

    def __iter__(self):
        return iter(sorted(self._header["datasets"]))

    def keys(self):
        return list(self)

    def items(self):
        return [(k, Dataset(self, k)) for k in self]

    def create_dataset(self, name, shape=None, dtype=None, data=None,
                       chunks=None, maxshape=None, fillvalue=None,
                       compression=None, compression_opts=None,
                       shuffle=None, **kwds):
        self._writable("create dataset")
        if kwds:
            raise _missing("File", "create_dataset("
                           f"{', '.join(sorted(kwds))}=...)")
        if "/" in name.strip("/"):
            raise _missing("File", "create_dataset in a group")
        name = name.strip("/")
        if data is not None:
            data = np.asarray(data, dtype=dtype)
            dt = data.dtype
            if shape is not None and tuple(shape) != data.shape:
                raise ValueError(f"shape {tuple(shape)} does not match the "
                                 f"data's {data.shape}")
            shape = data.shape
        else:
            if shape is None or dtype is None:
                raise TypeError("One of data, shape or dtype must be "
                                "specified")
            dt = np.dtype(dtype)
            shape = (shape,) if np.ndim(shape) == 0 else tuple(shape)
        shape = tuple(int(s) for s in shape)
        strings = _is_vlen_str(dt)
        if not strings:
            if dt.kind in "OUMm":
                raise _no_conversion(dt)
            if dt.kind not in "biufc":
                raise _missing("File", f"create_dataset of {dt!r} data")
        maxshape = shape if maxshape is None else tuple(
            None if m is None else int(m) for m in maxshape)
        if len(maxshape) != len(shape) or any(
                m is not None and m < s for s, m in zip(shape, maxshape)):
            raise ValueError(f"maxshape {maxshape} does not fit shape "
                             f"{shape}")
        if chunks is not None:
            chunks = tuple(int(c) for c in chunks)
            if any(c <= 0 for c in chunks):
                raise ValueError("All chunk dimensions must be positive")
            if any(m is not None and c > m for c, m in zip(chunks, maxshape)):
                raise ValueError("Chunk shape must not be greater than data "
                                 "shape in any dimension. "
                                 f"{chunks} is not compatible with {shape}")
        elif maxshape != shape or compression is not None:
            chunks = tuple(max(1, s) for s in shape)  # h5py guesses some
        if strings:
            if chunks is not None:
                raise _missing("File", "create_dataset of a chunked "
                               "string dataset")
            if data is None:
                raise _missing("File", "create_dataset of an empty string "
                               "dataset")
            fill = None
            vals = [x.decode() if isinstance(x, bytes) else str(x)
                    for x in data.reshape(-1)]
        else:
            fill = _encode(np.zeros((), dt)[()] if fillvalue is None
                           else dt.type(fillvalue))
        ent = {"dtype": "vlen-str" if strings else dt.str,
               "shape": list(shape), "maxshape": list(maxshape),
               "chunks": None if chunks is None else list(chunks),
               "compression": compression,
               "compression_opts": compression_opts,
               "shuffle": bool(shuffle), "fillvalue": fill, "offset": None,
               "attrs": {}, "dimlist": None, "reflist": []}
        with self._lock:
            if name in self._header["datasets"]:
                raise ValueError("Unable to synchronously create dataset "
                                 "(name already exists)")
            if strings:
                ent["strings"] = vals
            else:
                ent["offset"] = self._alloc(
                    int(np.prod(shape)) * dt.itemsize,
                    None if data is not None else _decode(fill))
                if data is not None and data.size:
                    self._pwrite_all(np.ascontiguousarray(data).reshape(-1)
                                     .view(np.uint8), ent["offset"])
            self._header["datasets"][name] = ent
        return Dataset(self, name)

    # ---- storage -------------------------------------------------------------
    def _pwrite_all(self, buf, off):
        mv = memoryview(buf).cast("B")
        while len(mv):
            n = os.pwrite(self._fd, mv, off)
            mv, off = mv[n:], off + n

    def _alloc(self, nbytes, fill):
        """A new region past the data and the live header; written with
        ``fill`` (None: left for the caller to write)."""
        ho, hn = self._hdr_at
        off = -(-max(self._data_end, ho + hn) // _ALIGN) * _ALIGN
        end = off + nbytes
        if end > self._size:
            os.ftruncate(self._fd, end)
        if fill is not None and nbytes:
            pat = np.full(max(1, _FILL_CHUNK // np.asarray(fill).itemsize),
                          fill).view(np.uint8)
            if pat.any() or off < self._size:
                for at in range(off, end, pat.size):
                    self._pwrite_all(pat[:min(pat.size, end - at)], at)
        self._size = max(self._size, end)
        self._data_end = end
        return off

    def _map(self, off, shape, dtype, write):
        start = off - off % mmap.ALLOCATIONGRANULARITY
        n = int(np.prod(shape)) * dtype.itemsize
        mm = mmap.mmap(self._fd, off + n - start, offset=start,
                       access=mmap.ACCESS_WRITE if write else mmap.ACCESS_READ)
        return mm, np.ndarray(shape, dtype, buffer=mm, offset=off - start)

    def _read(self, off, shape, dtype, key, into=None):
        self._open()
        if not int(np.prod(shape)):
            part = np.empty(shape, dtype)[key]
            if into is not None:
                into[...] = part
            return part
        mm, arr = self._map(off, shape, dtype, False)
        try:
            if into is None:
                return np.array(arr[key])
            into[...] = arr[key]
            return into
        finally:
            del arr
            mm.close()

    def _write(self, off, shape, dtype, key, value):
        if not int(np.prod(shape)):
            np.empty(shape, dtype)[key] = value  # shape errors as numpy's
            return
        mm, arr = self._map(off, shape, dtype, True)
        try:
            arr[key] = value
        finally:
            del arr
            mm.close()

    def flush(self):
        """Write the header and point the file at it. The new header goes
        where it cannot overwrite the live one."""
        self._open()
        if self.mode == "r":
            return
        with self._lock:
            at = struct.unpack("<QQ", os.pread(self._fd, 16, 16))
            if at != self._hdr_at:
                raise OSError(f"{self.filename!r} was rewritten by another "
                              "handle; refusing to overwrite its header")
            blob = json.dumps(self._header, separators=(",", ":")).encode()
            ho, hn = self._hdr_at
            off = -(-self._data_end // _ALIGN) * _ALIGN
            if off < ho + hn and off + len(blob) > ho:
                off = -(-(ho + hn) // _ALIGN) * _ALIGN
            self._pwrite_all(blob, off)
            self._size = max(self._size, off + len(blob))
            os.pwrite(self._fd, struct.pack("<QQ", off, len(blob)), 16)
            self._hdr_at = (off, len(blob))

    def close(self):
        if self._fd is None:
            return
        try:
            self.flush()
        finally:
            os.close(self._fd)
            self._fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        # an unclosed handle writes nothing more (as a crashed process)
        if getattr(self, "_fd", None) is not None:
            os.close(self._fd)
            self._fd = None

    def __repr__(self):
        state = "open" if self._fd is not None else "closed"
        return (f'<HDF5 file "{os.path.basename(self.filename)}" (mode '
                f'{self.mode}, numpy stand-in, {state})>')

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        raise _missing("File", name)
