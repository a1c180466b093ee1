"""Pipeline parallelism — the port of ``torchft_tpu/parallel/pipeline.py``:
a GPipe-style microbatched ring over the ``pp`` mesh axis.

Stage parameters carry a leading ``[pp, ...]`` axis sharded over ``pp``
(DTensors, ``Shard(0)`` on it); each rank runs its stage every tick,
activations hop stage -> stage with
:func:`~torchft_tpu_torch.parallel.mesh.ppermute`, and microbatch m leaves
stage P-1 at tick ``m + P - 1``. The fill/drain bubble is GPipe's: busy
M / (M + P - 1) of the time for M microbatches.

The JAX package runs the ticks inside a ``shard_map`` manual over ``pp``;
the port runs them on each rank's local tensors, with the other axes
(dp, fsdp, sp, tp) still DTensor's on the submesh of this rank's stage
(:func:`~torchft_tpu_torch.parallel.mesh.without_axis`). Autograd gives the
backward pipeline (the permutes' backward runs the ring in reverse). Every
rank builds the same graph, the JAX selects (``torch.where`` on the stage
index) included, so every rank runs the same point-to-point ops in the
backward too: a stage that dropped an unused input from its graph would
skip a permute its neighbour waits on.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from torchft_tpu_torch.parallel.mesh import (
    axis_size,
    contiguous_stride,
    is_dtensor,
    ppermute,
    psum,
    sum_grads,
    without_axis,
)
from torchft_tpu_torch.utils.tree import tree_leaves, tree_map

__all__ = ["pipeline_forward"]


def _inner_placements(t, mesh, axis: str, drop_dim: bool):
    """``t``'s placements less the ``axis`` mesh dim; with ``drop_dim`` the
    tensor's leading dim is gone too, so a Shard of dim d becomes d - 1."""
    from torch.distributed.tensor import Shard

    i = list(mesh.mesh_dim_names).index(axis)
    out = []
    for j, p in enumerate(t.placements):
        if j == i:
            continue
        out.append(Shard(p.dim - 1) if drop_dim and isinstance(p, Shard) else p)
    return out


def _on_inner(local, t, mesh, inner, axis, drop_dim):
    from torch.distributed.tensor import DTensor

    if inner is None:
        return local
    shape = tuple(t.shape[1:] if drop_dim else t.shape)
    return DTensor.from_local(local, inner, _inner_placements(t, mesh, axis, drop_dim),
                              shape=torch.Size(shape), stride=contiguous_stride(shape))


def _stage_slice(t, mesh, inner, axis):
    """This rank's stage of a ``[pp, ...]`` leaf sharded over ``axis``, on
    the inner mesh (autograd keeps its gradient this rank's shard)."""
    from torch.distributed.tensor import Shard

    i = list(mesh.mesh_dim_names).index(axis)
    if t.placements[i] != Shard(0):
        raise ValueError(f"a stage leaf must be sharded over {axis} on dim 0, got "
                         f"{t.placements}")
    return _on_inner(t.to_local()[0], t, mesh, inner, axis, drop_dim=True)


def _replicated(t, mesh, inner, axis, group):
    """A leaf replicated over ``axis``, on the inner mesh; its gradient is
    summed over the stages (only the stages that use it contribute)."""
    if not is_dtensor(t):
        return sum_grads(t, group)
    return _on_inner(sum_grads(t.to_local(), group), t, mesh, inner, axis, drop_dim=False)


def pipeline_forward(
    stage_params: Any,
    x_mb: torch.Tensor,
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    mesh,
    axis: str = "pp",
    head_fn: Callable[..., Any] = None,
    head_params: Any = None,
    head_extras: tuple = (),
) -> Any:
    """Run microbatches through the stage pipeline.

    Args:
        stage_params: tree, every leaf with leading axis ``pp`` (DTensors
            sharded over ``axis`` on dim 0 when ``mesh`` has the axis)
        x_mb: ``[M, mb, S, D]`` this rank's microbatched activations (its
            batch rows and sequence block), the same on every stage
        stage_fn: ``(params_for_one_stage, [mb, S, D]) -> [mb, S, D]`` on
            this rank's tensors; the stage's params are DTensors on the
            mesh less ``axis`` (plain tensors where nothing is left)
        head_fn: optional ``(head_params, outputs, *head_extras) -> tree``
            run on the last stage's ``[M, mb, S, D]`` outputs. Its leaves
            are the stage's totals (sums already reduced over the other
            axes): they are summed over ``axis``, the stages before the
            last computing on zeros and masked out, and come back equal on
            every rank. The cheap exit: a scalar sum instead of the
            activations replicated over ``axis``.
        head_params: tree for ``head_fn``, replicated over ``axis``
        head_extras: tensors for ``head_fn``, microbatched like ``x_mb``
    Returns:
        Without ``head_fn``: the final stage's ``[M, mb, S, D]`` outputs,
        replicated over ``axis``. With ``head_fn``: its reduced tree.
    """
    pp = axis_size(mesh, axis)
    for leaf in tree_leaves(stage_params):
        if leaf.shape[0] != pp:
            raise ValueError(
                f"stage_params leading axis {leaf.shape[0]} != mesh {axis} size {pp}: the "
                "model was configured for a different pipeline depth than the mesh provides"
            )
    m = x_mb.shape[0]
    if pp == 1:
        squeezed = tree_map(lambda a: a[0], stage_params)
        out = torch.stack([stage_fn(squeezed, x_mb[i]) for i in range(m)])
        return out if head_fn is None else head_fn(head_params, out, *head_extras)

    import torch.distributed as dist

    group = mesh.get_group(axis)
    inner = without_axis(mesh, axis)
    my = dist.get_rank(group)
    params = tree_map(lambda a: _stage_slice(a, mesh, inner, axis), stage_params)
    x_all = sum_grads(x_mb, group)
    # the JAX selects, as tensors: every stage keeps every input in its graph
    is_first = torch.tensor(my == 0, device=x_mb.device)
    is_last = torch.tensor(my == pp - 1, device=x_mb.device)
    cur = torch.zeros_like(x_all[0])
    outputs = [torch.zeros_like(x_all[0]) for _ in range(m)]
    ticks = m + pp - 1
    for t in range(ticks):
        inp = torch.where(is_first, x_all[min(t, m - 1)], cur)
        y = stage_fn(params, inp)
        out_idx = t - (pp - 1)
        ci = min(max(out_idx, 0), m - 1)
        valid = torch.logical_and(is_last, torch.tensor(out_idx >= 0, device=y.device))
        outputs[ci] = torch.where(valid, y, outputs[ci])
        if t + 1 < ticks:  # the last tick's hop would feed nothing
            cur = ppermute(y, group, 1)
    outputs = torch.stack(outputs)
    if head_fn is None:
        # only the last stage holds real outputs: replicate them over pp
        return psum(torch.where(is_last, outputs, torch.zeros_like(outputs)), group)
    hp = tree_map(lambda a: _replicated(a, mesh, inner, axis, group), head_params)
    res = head_fn(hp, outputs, *head_extras)
    return tree_map(lambda a: psum(torch.where(is_last, a, torch.zeros_like(a)), group), res)
