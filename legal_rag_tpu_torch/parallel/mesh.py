"""Device meshes, row-sharded arrays and their collectives.

The counterpart of ``legal_rag_tpu.parallel.mesh``. The document
dimension N is sharded over the 1-D ``shard`` axis of a mesh: each
device owns an equal row slice of the embedding matrix and scores only
its slice; query batches replicate or, on a 2-D ``(data, shard)`` mesh,
split over ``data``. Per-shard top-k candidates merge by one gather of
the ``[S, Q, C]`` candidates (k is small, so a gather beats any
reduction tree).

:class:`Mesh` holds a numpy array of ``torch.device`` s, shaped ``(S,)``
or ``(data, S)``, with its axis names, as ``jax.sharding.Mesh`` does. A
mesh built directly may name one device more than once: that is how a
CPU run, or a run on one card, holds several shards. :func:`make_mesh`
and :func:`make_mesh_2d` take distinct devices. After
:func:`initialize_distributed` they span the devices of every process,
each position owned by the process that holds its device, and the
collectives below go through ``torch.distributed`` (NCCL between CUDA
devices; gloo, through the host, between CPUs or where asked).

A :class:`GlobalArray` is an array placed on a mesh: each position the
process owns holds its row slice (or the whole array, replicated) on its
device. :func:`device_put_global` and :func:`replicate_global` make them
from host arrays; a position that shares its device and its slice with
another shares its tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

AXIS = "shard"


@dataclasses.dataclass
class _World:
    rank: int
    size: int
    backend: str
    devices: List[Tuple[int, torch.device]]    # every process's, in rank order


_WORLD: Optional[_World] = None


def _device_array(devices) -> np.ndarray:
    """An object array of ``torch.device`` s in the shape given; a bare
    ``"cuda"`` names the current card."""
    flat = np.asarray(devices, dtype=object)
    out = np.empty(flat.shape, dtype=object)
    for idx in np.ndindex(flat.shape):
        dev = torch.device(flat[idx])
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        out[idx] = dev
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: ``torch.device`` s shaped ``(S,)`` or ``(data, S)``;
    ``axis_names``: one name an axis; ``ranks``: the process that owns
    each position (None: this process owns all)."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]
    ranks: Optional[np.ndarray] = None

    def __post_init__(self):
        object.__setattr__(self, "devices", _device_array(self.devices))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")
        if self.ranks is not None:
            object.__setattr__(self, "ranks", np.asarray(self.ranks))

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def positions(self) -> List[Tuple[int, ...]]:
        return list(np.ndindex(self.devices.shape))

    def rank_of(self, pos: Tuple[int, ...]) -> int:
        return 0 if self.ranks is None else int(self.ranks[pos])

    def is_local(self, pos: Tuple[int, ...]) -> bool:
        return self.ranks is None or self.rank_of(pos) == _rank()

    def local_positions(self) -> List[Tuple[int, ...]]:
        return [p for p in self.positions() if self.is_local(p)]

    @property
    def multi_process(self) -> bool:
        """Built under :func:`initialize_distributed`: its collectives go
        through the process group (at world size 1 too)."""
        return self.ranks is not None


def _rank() -> int:
    return 0 if _WORLD is None else _WORLD.rank


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    *,
    device: str = "cuda",
    backend: Optional[str] = None,
) -> None:
    """Multi-process init: ``torch.distributed.init_process_group`` at
    ``tcp://coordinator_address`` (``host:port``; None reads the
    ``MASTER_ADDR`` / ``RANK`` / ``WORLD_SIZE`` environment, as
    ``torchrun`` sets it), NCCL for CUDA devices and gloo for the CPU
    unless ``backend`` says otherwise. ``local_device_ids``: this
    process's CUDA cards (default: every visible one), or on the CPU one
    mesh entry per id. Afterwards :func:`make_mesh` and
    :func:`make_mesh_2d` span every process's devices in rank order, and
    host arrays enter a mesh through :func:`device_put_global` and
    :func:`replicate_global`."""
    global _WORLD
    import torch.distributed as dist

    kind = torch.device(device).type
    if kind == "cuda":
        ids = (list(range(torch.cuda.device_count()))
               if local_device_ids is None else list(local_device_ids))
        local = [torch.device("cuda", i) for i in ids]
    else:
        local = [torch.device("cpu")] * (
            1 if local_device_ids is None else len(local_device_ids))
    if not local:
        raise ValueError("initialize_distributed: no local device")
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if kind == "cuda":
        torch.cuda.set_device(local[0])
    kwargs = {"backend": backend}
    if coordinator_address is not None:
        kwargs["init_method"] = f"tcp://{coordinator_address}"
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(**kwargs)
    rank, size = dist.get_rank(), dist.get_world_size()
    gathered: List[Optional[List[str]]] = [None] * size
    dist.all_gather_object(gathered, [str(d) for d in local])
    _WORLD = _World(rank, size, backend, [
        (r, torch.device(d)) for r, devs in enumerate(gathered) for d in devs
    ])


def shutdown_distributed() -> None:
    """Tear down what :func:`initialize_distributed` set up."""
    global _WORLD
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _WORLD = None


def _visible(device) -> List[Tuple[int, torch.device]]:
    if _WORLD is not None:
        return list(_WORLD.devices)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return [(0, torch.device("cuda", i))
                for i in range(torch.cuda.device_count())]
    return [(0, dev)]


def _mesh_from(devs, shape, axes) -> Mesh:
    ranks = np.array([r for r, _ in devs]).reshape(shape)
    return Mesh(np.array([d for _, d in devs], dtype=object).reshape(shape),
                axes, ranks if _WORLD is not None else None)


def make_mesh(num_shards: Optional[int] = None, axis: str = AXIS,
              device="cuda") -> Mesh:
    """A 1-D mesh over the first ``num_shards`` devices (None: all of
    them): every visible CUDA card for ``device="cuda"``, the one device
    named otherwise (``"cpu"``, ``"cuda:1"``), or every process's after
    :func:`initialize_distributed`."""
    devs = _visible(device)
    num_shards = num_shards or len(devs)
    if num_shards > len(devs):
        raise ValueError(
            f"requested {num_shards} shards but only {len(devs)} devices"
        )
    return _mesh_from(devs[:num_shards], (num_shards,), (axis,))


def make_mesh_2d(data: int, shards: int, data_axis: str = "data",
                 shard_axis: str = AXIS, device="cuda") -> Mesh:
    """A 2-D ``(data, shard)`` mesh: query batches split over ``data``
    (each row of devices serves its own queries) while documents shard
    over ``shard`` within each row, so the candidate merge stays within
    a row."""
    devs = _visible(device)
    need = data * shards
    if need > len(devs):
        raise ValueError(
            f"requested {data}x{shards} mesh but only {len(devs)} devices"
        )
    return _mesh_from(devs[:need], (data, shards), (data_axis, shard_axis))


@dataclasses.dataclass(eq=False)
class GlobalArray:
    """An array on a mesh: ``blocks`` maps each position this process
    owns to its tensor there, the row slice of ``axis`` (or, with
    ``axis`` None, the whole array)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    mesh: Mesh
    axis: Optional[str]
    blocks: Dict[Tuple[int, ...], torch.Tensor]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def device(self) -> torch.device:
        return next(iter(self.blocks.values())).device

    def local(self, pos: Tuple[int, ...]) -> torch.Tensor:
        return self.blocks[pos]

    def full(self) -> torch.Tensor:
        """The whole array on this process's first device (one process;
        a single shard returns its tensor as it is)."""
        if self.axis is None:
            return next(iter(self.blocks.values()))
        dim = self.mesh.axis_names.index(self.axis)
        parts = {}
        for pos, t in self.blocks.items():
            parts.setdefault(pos[dim], t)
        if len(parts) != self.mesh.shape[self.axis]:
            raise ValueError("full(): this process does not hold every shard")
        if len(parts) == 1:
            return parts[0]
        dev = self.device
        return torch.cat([parts[s].to(dev) for s in sorted(parts)])

    def numpy(self) -> np.ndarray:
        """The whole array on the host (one process)."""
        return self.full().cpu().numpy()


def _spec_axis(spec) -> Optional[str]:
    """The mesh axis that splits dim 0 in ``spec`` (a PartitionSpec-like
    tuple such as ``("shard", None)``, an axis name, or None)."""
    if spec is None or isinstance(spec, str):
        return spec
    spec = tuple(spec)
    if any(a is not None for a in spec[1:]):
        raise ValueError(f"only dim 0 may be sharded, got {spec}")
    return spec[0] if spec else None


def device_put_global(arr, mesh: Mesh, spec=(AXIS,),
                      dtype: Optional[torch.dtype] = None) -> GlobalArray:
    """Place a host array (numpy, or a tensor) on ``mesh``: each
    position this process owns keeps only its row slice of ``spec``'s
    axis (every process passes the same global array). ``dtype``
    converts on the device."""
    axis = _spec_axis(spec)
    if not isinstance(arr, torch.Tensor):
        arr = np.ascontiguousarray(arr)
        if not arr.flags.writeable:     # torch.from_numpy wants a writable one
            arr = arr.copy()
    host = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(arr)
    n = host.shape[0] if host.dim() else 0
    if axis is not None:
        n_shards = mesh.shape[axis]
        if n % n_shards:
            raise ValueError(f"{n} rows do not split over {n_shards} shards")
        dim = mesh.axis_names.index(axis)
        rows = n // n_shards
    made: Dict[Tuple[torch.device, int], torch.Tensor] = {}
    blocks = {}
    for pos in mesh.local_positions():
        dev = mesh.devices[pos]
        s = -1 if axis is None else pos[dim]
        key = (dev, s)
        if key not in made:
            part = host if axis is None else host[s * rows:(s + 1) * rows]
            t = part.to(dev)
            made[key] = t if dtype is None else t.to(dtype)
        blocks[pos] = made[key]
    return GlobalArray(tuple(host.shape), dtype or host.dtype, mesh, axis,
                       blocks)


def replicate_global(arr, mesh: Mesh,
                     dtype: Optional[torch.dtype] = None) -> GlobalArray:
    """The whole array on each local device of ``mesh`` (queries,
    postings, weights, codebooks)."""
    return device_put_global(arr, mesh, None, dtype=dtype)


def as_global(x, mesh: Mesh, axis: Optional[str]) -> GlobalArray:
    """``x`` as an array on ``mesh``: a GlobalArray as it is; a tensor
    split into row views on the devices it already lies on (no copy
    where a position's device is the tensor's)."""
    if isinstance(x, GlobalArray):
        return x
    return device_put_global(x, mesh, axis)


# -- collectives ------------------------------------------------------------


def _comm_device(t: torch.Tensor) -> torch.device:
    """Where a tensor meets the process group: gloo takes host tensors
    (the collective stages a CUDA tensor through the host), NCCL the
    process's card."""
    if _WORLD is not None and _WORLD.backend == "gloo":
        return torch.device("cpu")
    return t.device


def gather_items(mesh: Mesh, items: Dict[Tuple[int, int], torch.Tensor],
                 owners: Dict[Tuple[int, int], int], dest) -> Dict:
    """Every work item's tensor on ``dest``: ``items`` holds this
    process's, keyed ``(data slice, shard)``; ``owners`` names the
    process of each key (the same on every process). One process: moves
    only (none where a tensor lies on ``dest``). Several: one
    ``all_gather`` of a buffer that holds every key's slot."""
    if not mesh.multi_process:
        return {key: t.to(dest) for key, t in items.items()}
    import torch.distributed as dist

    keys = sorted(owners)
    like = next(iter(items.values()))
    comm = _comm_device(like)
    buf = torch.zeros((len(keys),) + tuple(like.shape), dtype=like.dtype,
                      device=comm)
    for j, key in enumerate(keys):
        if key in items:
            buf[j] = items[key].to(comm)
    out = [torch.empty_like(buf) for _ in range(_WORLD.size)]
    dist.all_gather(out, buf)
    return {key: out[owners[key]][j].to(dest) for j, key in enumerate(keys)}


def max_items(mesh: Mesh, items: Dict[Tuple[int, int], torch.Tensor],
              owners: Dict[Tuple[int, int], int], n_data: int,
              dest) -> List[torch.Tensor]:
    """The elementwise max over shards of each data slice's items (the
    reference's ``pmax``): one process stacks (a lone shard's tensor is
    returned as it is); several fill ``[n_data, ...]`` with -inf where
    they own nothing and ``all_reduce`` it with MAX."""
    if not mesh.multi_process:
        out = []
        for d in range(n_data):
            mine = [items[key].to(dest) for key in sorted(items) if key[0] == d]
            out.append(mine[0] if len(mine) == 1
                       else torch.stack(mine).amax(dim=0))
        return out
    import torch.distributed as dist

    like = next(iter(items.values()))
    comm = _comm_device(like)
    buf = torch.full((n_data,) + tuple(like.shape), float("-inf"),
                     dtype=like.dtype, device=comm)
    for (d, _), t in items.items():
        buf[d] = torch.maximum(buf[d], t.to(comm))
    dist.all_reduce(buf, op=dist.ReduceOp.MAX)
    return [buf[d].to(dest) for d in range(n_data)]


def all_reduce_sum_(tensors: Sequence[torch.Tensor]) -> None:
    """Sum each tensor across processes in place (gradients)."""
    import torch.distributed as dist

    for t in tensors:
        comm = _comm_device(t)
        buf = t if comm == t.device else t.to(comm)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM)
        if buf is not t:
            t.copy_(buf)


def positions_along(mesh: Mesh, axis: str = AXIS) -> List[Tuple[int, ...]]:
    """One position per index of ``axis``: the first in mesh order (the
    row of data index 0 on a 2-D mesh)."""
    dim = mesh.axis_names.index(axis)
    first: Dict[int, Tuple[int, ...]] = {}
    for pos in mesh.positions():
        first.setdefault(pos[dim], pos)
    return [first[s] for s in sorted(first)]


__all__ = [
    "AXIS", "GlobalArray", "Mesh", "all_reduce_sum_", "as_global",
    "device_put_global", "gather_items", "initialize_distributed",
    "make_mesh", "make_mesh_2d", "max_items", "positions_along",
    "replicate_global", "shutdown_distributed",
]
