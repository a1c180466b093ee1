"""Device mesh for the intra-replica-group axes — the port's counterpart of
``torchft_tpu/parallel/mesh.py``, over ``torch.distributed.device_mesh``.

The fault-tolerance replicate axis is not part of this mesh: the Manager
and its host collectives carry it, outside the group's process group, so a
change of quorum never touches the mesh or the tensors placed on it.

A mesh names its axes as :data:`AXES` does, in that order, but holds only
the axes of size above 1 (one axis, ``dp`` of size 1, when all are 1): an
absent axis is an inert one (:func:`axis_size` says 1), so one model and
one train step serve every layout. JAX keeps the size-1 axes in its mesh;
DTensor's sharding propagation enumerates its strategies over every mesh
dim, and with six dims one tiny step took minutes on the CPU. Each
rank of a group is one process holding one device, so a mesh of ``total``
ranks spans the group's ``torch.distributed`` world
(:func:`~torchft_tpu_torch.parallel.multihost.initialize_group`). A mesh of
total 1 with no process group up starts a one-rank group, so that a group
on one card runs the same DTensor code as a sharded one.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = [
    "MeshConfig", "make_mesh", "AXES", "axis_size", "P", "placements", "spec_entries",
    "local_index", "from_full", "from_shard", "is_dtensor", "place", "without_axis",
    "ppermute", "psum", "sum_grads",
]

# canonical axis order, the JAX package's: outermost first
AXES: Sequence[str] = ("dp", "fsdp", "pp", "ep", "sp", "tp")


@dataclass(frozen=True)
class MeshConfig:
    """Sizes for each named axis; 1 means the axis is inert (:func:`make_mesh`
    leaves it out of the mesh, and :func:`axis_size` reads it as 1, so one
    step function serves every layout)."""

    dp: int = 1
    fsdp: int = 1
    pp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    @property
    def sizes(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in AXES}

    @property
    def total(self) -> int:
        return int(np.prod(list(self.sizes.values())))


def _start_one_rank_group(backend: str) -> None:
    import torch.distributed as dist

    dist.init_process_group(backend=backend, store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(config: MeshConfig, devices: Union[str, Sequence[int], None] = None):
    """A ``DeviceMesh`` with the canonical axis names and order.

    ``devices`` is the device type (``"cuda"`` or ``"cpu"``; default: the
    card) or the ranks of the group's world that form the mesh, in mesh
    order (the first ``total`` ranks by default). The group's process group
    must be up (:func:`~torchft_tpu_torch.parallel.multihost.initialize_group`)
    unless the mesh has total 1."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    ranks = None if devices is None or isinstance(devices, str) else [int(r) for r in devices]
    if isinstance(devices, str):
        device_type = devices
    elif dist.is_initialized():
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    else:
        device_type = "cuda"
    if not dist.is_initialized():
        if config.total != 1:
            raise RuntimeError(
                f"a mesh of {config.total} ranks needs the group's process group: "
                "call parallel.multihost.initialize_group first"
            )
        _start_one_rank_group("nccl" if device_type == "cuda" else "gloo")
    world = dist.get_world_size()
    if ranks is None:
        ranks = list(range(config.total))
    if len(ranks) < config.total or max(ranks) >= world:
        raise ValueError(
            f"mesh needs {config.total} ranks, have {len(ranks)} of a world of {world}"
        )
    if device_type == "cuda":
        # the process's device as chosen (initialize_group: rank % cards),
        # not DeviceMesh's guess from the rank
        torch.cuda.current_device()
    names = tuple(a for a in AXES if config.sizes[a] > 1) or ("dp",)
    shape = tuple(config.sizes[a] for a in names)
    mesh = torch.tensor(ranks[: config.total], dtype=torch.int64).reshape(shape)
    return DeviceMesh(device_type, mesh, mesh_dim_names=names)


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` on ``mesh`` (1 without a mesh, or where the mesh
    leaves the axis out)."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 1
    return mesh.size(list(mesh.mesh_dim_names).index(axis))


# ---------------------------------------------------------------------------
# partition specs as DTensor placements
# ---------------------------------------------------------------------------


class P:
    """A partition spec, the ``jax.sharding.PartitionSpec`` of the port: per
    tensor dim ``None``, an axis name, or a tuple of axis names. Not a
    tuple, so that tree walks take it as a leaf."""

    __slots__ = ("entries",)

    def __init__(self, *entries) -> None:
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and other.entries == self.entries

    def __repr__(self) -> str:
        return f"P{self.entries!r}"


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def placements(spec, mesh) -> List[Any]:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` on each mesh
    axis the spec names for tensor dim ``dim``, ``Replicate()`` elsewhere.
    An axis of size 1 stays ``Replicate()`` (its shard is the whole). Where
    one tensor dim is split over several axes, DTensor nests the shards in
    the mesh's axis order (``dp`` outermost), whatever order the spec
    names them in."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: List[Any] = [Replicate()] * mesh.ndim
    for dim, entry in enumerate(spec):
        for axis in _axes(entry):
            if axis_size(mesh, axis) > 1:
                out[names.index(axis)] = Shard(dim)
    return out


def spec_entries(place: Sequence[Any], mesh, ndim: int) -> Tuple:
    """The inverse of :func:`placements`: per tensor dim, the axes that
    shard it (in the mesh's order), one name, or ``None``."""
    from torch.distributed.tensor import Shard

    names = list(mesh.mesh_dim_names)
    out = []
    for dim in range(ndim):
        axes = tuple(names[i] for i, p in enumerate(place)
                     if isinstance(p, Shard) and p.dim == dim)
        out.append(None if not axes else axes[0] if len(axes) == 1 else axes)
    return tuple(out)


def local_index(shape: Sequence[int], mesh, place: Sequence[Any]) -> Tuple[Tuple[int, int], ...]:
    """The ``(start, stop)`` of this rank's shard on every dim of a tensor
    of global ``shape`` placed by ``place`` on ``mesh`` (DTensor's
    ``torch.chunk`` split: chunks of ceil(n / m), nested in mesh order)."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    bounds = [[0, int(n)] for n in shape]
    for i, p in enumerate(place):
        if isinstance(p, Shard):
            a, b = bounds[p.dim]
            n, m = b - a, mesh.size(i)
            chunk = -(-n // m)
            lo = min(coord[i] * chunk, n)
            bounds[p.dim] = [a + lo, a + min(lo + chunk, n)]
    return tuple((a, b) for a, b in bounds)


def contiguous_stride(shape: Sequence[int]) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= int(n)
    return tuple(reversed(stride))


def from_full(full: torch.Tensor, mesh, place: Sequence[Any]):
    """A DTensor of ``full``'s global value on ``mesh`` with ``place``, built
    from this rank's slice of ``full`` (every rank holds ``full``; no
    collective runs)."""
    from torch.distributed.tensor import DTensor

    idx = local_index(full.shape, mesh, place)
    local = full[tuple(slice(a, b) for a, b in idx)].to(mesh.device_type).contiguous()
    return DTensor.from_local(local, mesh, place, shape=full.shape,
                              stride=contiguous_stride(full.shape))


def from_shard(local: torch.Tensor, shape: Sequence[int], mesh, place: Sequence[Any]):
    """A DTensor of global ``shape`` from this rank's shard ``local``."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local.to(mesh.device_type).contiguous(), mesh, place,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def is_dtensor(x: Any) -> bool:
    """Whether ``x`` is a DTensor, without importing DTensor's package (a
    process that never imported it holds none)."""
    mod = sys.modules.get("torch.distributed.tensor")
    cls = getattr(mod, "DTensor", None) if mod is not None else None
    return cls is not None and isinstance(x, cls)


def place(t: torch.Tensor, mesh, target: Sequence[Any]):
    """``t`` placed by ``target`` on ``mesh``: a DTensor is redistributed
    where its placements differ (and returned as it is where they match); a
    full tensor (every rank holds it) contributes this rank's slice."""
    if is_dtensor(t):
        return t if list(t.placements) == list(target) else t.redistribute(mesh, target)
    return from_full(t, mesh, target)


def without_axis(mesh, axis: str):
    """``mesh`` less ``axis``: the submesh of this rank's coordinate on it
    (``mesh`` itself where the axis is absent; None where it is the only
    axis, so that the region runs on plain tensors)."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return mesh
    names = tuple(n for n in mesh.mesh_dim_names if n != axis)
    if not names:
        return None
    return mesh[names] if len(names) > 1 else mesh[names[0]]


# ---------------------------------------------------------------------------
# collectives over one mesh axis that autograd differentiates as JAX
# transposes its own (a process group each: ``mesh.get_group(axis)``)
# ---------------------------------------------------------------------------


def _permute(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Send ``x`` to group rank ``(r + shift) % n``, receive from
    ``(r - shift) % n``: one ``batch_isend_irecv``, its ops posted in the
    same order on every rank."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    if shift % n == 0:
        return x.clone()
    r = dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, (r + shift) % n), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (r - shift) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _permute(x, group, shift)

    @staticmethod
    def backward(ctx, grad):
        return _permute(grad, ctx.group, -ctx.shift), None, None


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """``jax.lax.ppermute`` with the cyclic perm ``r -> r + shift`` over
    ``group``; its backward is the reverse permute. Every rank of the group
    calls it, in the same order."""
    return _PPermute.apply(x, group, shift)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, equal on every rank; its backward is
    the identity on each rank, as JAX transposes a ``psum`` whose result is
    replicated (``torch.distributed.nn``'s all-reduce sums the gradients
    again, which would scale them by the group's size)."""
    return _Psum.apply(x, group)


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def sum_grads(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself, whose gradient is summed over ``group``: a value
    replicated over the group that each rank uses in its own way (JAX's
    replicated ``shard_map`` input, whose transpose is a ``psum``)."""
    return _SumGrads.apply(x, group)
