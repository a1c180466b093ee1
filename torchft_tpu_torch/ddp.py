"""Cross-replica-group gradient averaging — the port's counterpart of
``torchft_tpu/ddp.py`` (its host path).

Gradients are packed into ~25 MB same-dtype buckets (``plan_buckets``, a
copy of the JAX package's planner). Every bucket's device-to-host copies
are issued up front, non-blocking into pinned host memory, each bucket
closing with a CUDA event; then bucket by bucket the main thread waits for
that bucket's event only and hands it to the Manager, whose ring runs on
the collectives thread — so bucket k rides the ring while later buckets
are still copying. Averaged pieces go back host-to-device.

The bucket buffers own their memory: the ring reduces (and a healing
replica zeroes) in place, which must never write through to the caller's
gradients.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch

from torchft_tpu_torch.utils.tree import tree_flatten, tree_unflatten

__all__ = ["plan_buckets", "allreduce_gradients"]

_DEFAULT_BUCKET_BYTES = 25 * 1024 * 1024


def plan_buckets(
    meta: Sequence[Tuple[Any, int]], bucket_bytes: int = _DEFAULT_BUCKET_BYTES
) -> List[List[int]]:
    """Group item indices into ~``bucket_bytes`` same-dtype buckets from
    (dtype, nbytes) metadata alone."""
    plan: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    cur_dtype = None
    for i, (dtype, nbytes) in enumerate(meta):
        if cur and (dtype != cur_dtype or cur_bytes + nbytes > bucket_bytes):
            plan.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
        cur_dtype = dtype
    if cur:
        plan.append(cur)
    return plan


def allreduce_gradients(
    manager, grads: Any, bucket_bytes: Optional[int] = None
) -> Any:
    """Average a gradient tree (list or dict of tensors, all on one
    device) across replica groups through the Manager; returns a tree of
    the same shape on the same device."""
    if bucket_bytes is None:
        bucket_bytes = _DEFAULT_BUCKET_BYTES
    leaves, treedef = tree_flatten(grads)
    if not leaves:
        return grads
    device = leaves[0].device
    on_cuda = device.type == "cuda"
    plan = plan_buckets(
        [(leaf.dtype, leaf.numel() * leaf.element_size()) for leaf in leaves],
        bucket_bytes,
    )

    # stage 1: every bucket's D2H copies, issued before anything blocks
    staged = []
    for idxs in plan:
        n = sum(leaves[i].numel() for i in idxs)
        buf = torch.empty(n, dtype=leaves[idxs[0]].dtype, pin_memory=on_cuda)
        off = 0
        for i in idxs:
            k = leaves[i].numel()
            buf[off : off + k].copy_(leaves[i].detach().reshape(-1), non_blocking=on_cuda)
            off += k
        event = None
        if on_cuda:
            event = torch.cuda.Event()
            event.record()
        staged.append((idxs, buf, event))

    # stage 2: each bucket enters the ring as soon as its own copies land
    futs = []
    for idxs, buf, event in staged:
        if event is not None:
            event.synchronize()
        futs.append((idxs, buf, manager.allreduce_many([buf.numpy()])))

    # stage 3: averaged pieces back to the device
    out: List[Any] = [None] * len(leaves)
    for idxs, buf, fut in futs:
        fut.wait()
        off = 0
        for i in idxs:
            k = leaves[i].numel()
            piece = buf[off : off + k].view(leaves[i].shape)
            off += k
            out[i] = piece.to(device, non_blocking=True) if on_cuda else piece
    return tree_unflatten(treedef, out)
