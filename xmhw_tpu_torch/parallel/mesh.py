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

Multi-process: inside an initialised default ``torch.distributed`` group
(one process per GPU, as ``torchrun`` starts them), :func:`cell_mesh`
with no ``devices`` is the GLOBAL mesh, its entries gathered from every
rank in rank order, and ``CellMesh.ranks`` records the rank that owns
each entry. Each process feeds only its own shards
(:func:`make_cell_array`) and runs the device-resident step on them
(``core.pipeline.fused_threshold_detect``), with zero collectives, as
the JAX package's processes do under ``jax.distributed``. The block
functions (``run_clim``/``run_detect``/``run_fused``) read data one
process holds whole, and refuse such a mesh.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..utils import count

CELL_AXIS = "cells"


class CellMesh(tuple):
    """An ordered tuple of ``torch.device``, one per cell shard.
    ``ranks``: the ``torch.distributed`` rank that owns each entry, as the
    global mesh of a group records them; None (a mesh of one process)
    means whichever process uses it, read at use."""

    def __new__(cls, devices, ranks=None):
        self = super().__new__(cls, devices)
        self.ranks = None if ranks is None else tuple(int(r) for r in ranks)
        if self.ranks is not None and len(self.ranks) != len(self):
            raise ValueError(f"{len(self.ranks)} ranks for {len(self)} "
                             "mesh entries")
        return self

    def owns(self, i: int) -> bool:
        """True when this process owns entry ``i``."""
        return self.ranks is None or self.ranks[i] == process_rank()

    def is_local(self) -> bool:
        """True when this process owns every entry."""
        return all(self.owns(i) for i in range(len(self)))


def in_process_group() -> bool:
    """True inside an initialised default torch.distributed group."""
    return torch.distributed.is_available() and \
        torch.distributed.is_initialized()


def process_rank() -> int:
    """This process's rank in the default group (0 outside a group)."""
    return torch.distributed.get_rank() if in_process_group() else 0


def process_device() -> torch.device:
    """This process's device in a group: ``cuda:(LOCAL_RANK %
    device_count)`` where a GPU is visible, else the CPU."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", process_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def _checked(devices):
    """``devices`` as torch.devices: raises for an empty list, a mix of
    device types and a CUDA entry without a GPU; an un-indexed "cuda"
    names the current device."""
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
        devs = [d if d.index is not None else
                torch.device("cuda", torch.cuda.current_device())
                for d in devs]
    return devs


def cell_mesh(devices=None, *, local_devices=None) -> CellMesh:
    """Mesh over every visible CUDA device, or over ``devices`` (which may
    repeat a device): a mesh of this process alone. Raises without a GPU
    when no devices are given (there is no silent CPU mesh), for a CUDA
    entry without a GPU, for an empty list and for a mix of device types.

    Inside an initialised default torch.distributed group, with no
    ``devices``, the mesh is global: each rank gives ``local_devices``
    (default: one entry, :func:`process_device`; a list may give a rank
    several entries), gathered in rank order, and ``ranks`` records the
    owner of each entry. This is a collective: every rank calls it.
    """
    if devices is not None:
        if local_devices is not None:
            raise ValueError("pass devices or local_devices, not both")
        return CellMesh(_checked(devices))
    if in_process_group():
        mine = _checked(local_devices if local_devices is not None
                        else [process_device()])
        every = [None] * torch.distributed.get_world_size()
        torch.distributed.all_gather_object(every, [str(d) for d in mine])
        devs = [torch.device(d) for part in every for d in part]
        if len({d.type for d in devs}) > 1:
            raise ValueError(f"a cell mesh holds one device type, got "
                             f"{devs}")
        return CellMesh(devs, [r for r, part in enumerate(every)
                               for _ in part])
    if local_devices is not None:
        raise ValueError("local_devices needs an initialised "
                         "torch.distributed group")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "cell_mesh() spans the visible CUDA devices and "
            "torch.cuda.is_available() is False; pass devices, e.g. "
            "cell_mesh([torch.device('cpu')] * 4)")
    return CellMesh([torch.device("cuda", i)
                     for i in range(torch.cuda.device_count())])


def check_mesh(mesh):
    """``mesh`` itself when it is None or a :class:`CellMesh` of this
    process alone. Raises TypeError for anything else, and ValueError for
    a mesh with entries of other ranks: the block functions read data that
    one process holds whole."""
    if mesh is not None and not isinstance(mesh, CellMesh):
        raise TypeError(f"mesh must be None or a cell_mesh(...), got "
                        f"{type(mesh).__name__}")
    if mesh is not None and not mesh.is_local():
        raise ValueError(
            f"this mesh has entries of ranks {sorted(set(mesh.ranks))}: "
            "run_clim/run_detect/run_fused and the streamed functions read "
            "data that one process holds whole; across processes each rank "
            "feeds its own shards with make_cell_array and runs "
            "core.pipeline.fused_threshold_detect on them")
    return mesh


def _ranges(mesh, lo: int, hi: int):
    """(entry index, device, lo_i, hi_i) of every non-empty range."""
    n = len(mesh)
    step = -(-(hi - lo) // n)
    for i, dev in enumerate(mesh):
        a = lo + i * step
        b = min(a + step, hi)
        if a < b:
            yield i, dev, a, b


def cell_sharding(mesh, lo: int, hi: int):
    """Cells [lo, hi) of a block as ``(device, lo_i, hi_i)``, one
    contiguous range per mesh entry in mesh order: the even split of a
    ``NamedSharding`` (ceil((hi - lo) / len(mesh)) cells each), the last
    ranges shorter; empty ranges are left out."""
    return [(dev, a, b) for _, dev, a, b in _ranges(mesh, lo, hi)]


def replicated(mesh, t: torch.Tensor) -> dict:
    """One copy of a small table per distinct device of the mesh:
    ``{device: tensor}``. Counts the copies' bytes in ``h2d_bytes``."""
    devs = dict.fromkeys(mesh)
    count("h2d_bytes", t.nbytes * len(devs))
    return {d: t.to(d) for d in devs}


def pad_cells(arr: np.ndarray, multiple: int, fill=np.nan):
    """Pad the trailing cell axis to a multiple (NaN = land, dropped on
    output). Returns (padded, original_count)."""
    c = arr.shape[-1]
    target = -(-c // multiple) * multiple
    if target == c:
        return arr, c
    pad = [(0, 0)] * (arr.ndim - 1) + [(0, target - c)]
    return np.pad(arr, pad, constant_values=fill), c


class CellShards(list):
    """This process's shards of a cell-sharded array: a list of tensors
    in mesh order, each on its device, and ``ranges``, the global cell
    range ``(lo, hi)`` of each."""

    def __init__(self, tensors, ranges):
        super().__init__(tensors)
        self.ranges = list(ranges)


def make_cell_array(mesh, global_shape, fill_fn) -> CellShards:
    """A cell-sharded array as one tensor per shard of this process, each
    on its device.

    ``fill_fn(index_tuple) -> np.ndarray`` supplies one shard's data, given
    the global index slices of the shard (all of the leading axes, its
    range of the trailing cell axis), so that a caller reads only the
    cells each device holds (e.g. stream.GridReader hyperslabs). It is
    called only for the entries this process owns (:meth:`CellMesh.owns`):
    in a global mesh of several processes each feeds its own shards and never
    holds the global grid. Returns a :class:`CellShards`: those shards in
    mesh order, as :func:`cell_sharding` cuts ``[0, global_shape[-1])``,
    with their global cell ranges; every shard in a single process.
    """
    lead = (slice(None),) * (len(global_shape) - 1)
    out, ranges = [], []
    for i, dev, a, b in _ranges(mesh, 0, int(global_shape[-1])):
        if not mesh.owns(i):
            continue
        idx = lead + (slice(a, b),)
        part = np.asarray(fill_fn(idx))
        want = tuple(global_shape[:-1]) + (b - a,)
        if part.shape != want:
            raise ValueError(f"fill_fn{idx} gave shape {part.shape}, "
                             f"want {want}")
        out.append(torch.from_numpy(np.ascontiguousarray(part)).to(dev))
        ranges.append((a, b))
    return CellShards(out, ranges)
