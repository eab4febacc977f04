"""Device mesh for the cell axis.

Port of :mod:`xmhw_tpu.parallel.mesh`. Every kernel of the pipeline is
elementwise, or a scan or reduction along the time/doy axes, so cells are
independent and a block of cells splits over devices with **zero
collectives**. Torch has no sharded arrays: a mesh is an ordered tuple of
``torch.device`` (:class:`CellMesh`), a block's cell range is cut into one
contiguous range per mesh entry (:func:`cell_sharding`), each range runs
on its own device, and the host writes each range's results into place.

A mesh may name one device more than once (``[cuda:0, cuda:0]``, or
``[cpu] * 4``): its shards then run one after the other on that device,
which is how a single card or the CPU exercises the mesh path.
"""

from __future__ import annotations

import numpy as np
import torch

CELL_AXIS = "cells"


class CellMesh(tuple):
    """An ordered tuple of ``torch.device``, one per cell shard."""


def cell_mesh(devices=None) -> CellMesh:
    """Mesh over every visible CUDA device, or over ``devices`` (which may
    repeat a device). Raises without a GPU when no devices are given
    (there is no silent CPU mesh), for a CUDA entry without a GPU, for an
    empty list and for a mix of device types."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "cell_mesh() spans the visible CUDA devices and "
                "torch.cuda.is_available() is False; pass devices, e.g. "
                "cell_mesh([torch.device('cpu')] * 4)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("a cell mesh needs at least one device")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"a cell mesh holds one device type, got {devs}")
    if devs[0].type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"mesh {devs} requested but torch.cuda.is_available() is "
                "False")
        # an un-indexed "cuda" entry names the current device
        devs = [d if d.index is not None else
                torch.device("cuda", torch.cuda.current_device())
                for d in devs]
    return CellMesh(devs)


def check_mesh(mesh):
    """``mesh`` itself when it is None or a :class:`CellMesh`; raises
    TypeError otherwise."""
    if mesh is not None and not isinstance(mesh, CellMesh):
        raise TypeError(f"mesh must be None or a cell_mesh(...), got "
                        f"{type(mesh).__name__}")
    return mesh


def cell_sharding(mesh, lo: int, hi: int):
    """Cells [lo, hi) of a block as ``(device, lo_i, hi_i)``, one
    contiguous range per mesh entry in mesh order: the even split of a
    ``NamedSharding`` (ceil((hi - lo) / len(mesh)) cells each), the last
    ranges shorter; empty ranges are left out."""
    n = len(mesh)
    step = -(-(hi - lo) // n)
    out = []
    for i, dev in enumerate(mesh):
        a = lo + i * step
        b = min(a + step, hi)
        if a < b:
            out.append((dev, a, b))
    return out


def replicated(mesh, t: torch.Tensor) -> dict:
    """One copy of a small table per distinct device of the mesh:
    ``{device: tensor}``."""
    return {d: t.to(d) for d in dict.fromkeys(mesh)}


def pad_cells(arr: np.ndarray, multiple: int, fill=np.nan):
    """Pad the trailing cell axis to a multiple (NaN = land, dropped on
    output). Returns (padded, original_count)."""
    c = arr.shape[-1]
    target = -(-c // multiple) * multiple
    if target == c:
        return arr, c
    pad = [(0, 0)] * (arr.ndim - 1) + [(0, target - c)]
    return np.pad(arr, pad, constant_values=fill), c


def make_cell_array(mesh, global_shape, fill_fn):
    """A cell-sharded array as one tensor per shard, each on its device.

    ``fill_fn(index_tuple) -> np.ndarray`` supplies one shard's data, given
    the global index slices of the shard (all of the leading axes, its
    range of the trailing cell axis), so that a caller reads only the
    cells each device holds (e.g. stream.GridReader hyperslabs). Returns
    the list of (..., hi_i - lo_i) tensors in mesh order, as
    :func:`cell_sharding` cuts ``[0, global_shape[-1])``.
    """
    lead = (slice(None),) * (len(global_shape) - 1)
    out = []
    for dev, a, b in cell_sharding(mesh, 0, int(global_shape[-1])):
        idx = lead + (slice(a, b),)
        part = np.asarray(fill_fn(idx))
        want = tuple(global_shape[:-1]) + (b - a,)
        if part.shape != want:
            raise ValueError(f"fill_fn{idx} gave shape {part.shape}, "
                             f"want {want}")
        out.append(torch.from_numpy(np.ascontiguousarray(part)).to(dev))
    return out
