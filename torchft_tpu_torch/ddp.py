"""Cross-replica-group gradient averaging — the port's counterpart of
``torchft_tpu/ddp.py``.

Two paths, chosen by the Manager's configured data plane:

* **device plane** (``CollectivesDevice``, groups in one process): the
  gradient tensors go straight into ``manager.allreduce_many`` and are
  averaged on the device into new tensors (one group alone gets its own
  tensors back, untouched); no bucket, no host copy.
* **host plane** (``CollectivesTcp``, groups in separate processes): below.

Gradients are packed into ~25 MB same-dtype buckets (``plan_buckets``, a
copy of the JAX package's planner). Every bucket's device-to-host copies
are issued up front, non-blocking into pinned host memory, each bucket
closing with a CUDA event; then bucket by bucket the main thread waits for
that bucket's event only and hands it to the Manager, whose ring runs on
the collectives thread — so bucket k rides the ring while later buckets
are still copying. Averaged pieces go back host-to-device.

The bucket buffers own their memory: the ring reduces (and a healing
replica zeroes) in place, which must never write through to the caller's
gradients. They are page-locked (``pin_memory``) and kept here, one set a
manager (``_STAGING``), so a step reuses the last one's instead of
allocating the gradient tree's size again; a new bucket plan replaces the
set. Before a buffer is
overwritten the call waits on the event recorded after the previous
step's host-to-device copies out of it. A set whose step failed is
dropped, not reused: a timed-out op may still be writing into it. On the
native CMA plane the neighbouring worker pulls these buckets with
``process_vm_readv``, which the kernel grants for ``cudaHostAlloc`` pages
as for any other (``scripts/torch_cma_pinned_probe.py``).

A DTensor gradient (a sharded group, ``parallel.train_step`` under a mesh)
is averaged by its local shard: each rank sends what it holds, and
same-rank peers across groups hold the same shard of every leaf, since
their meshes are congruent (the JAX package's shard-wise path). A rank
holds one shard a leaf, so a replicated copy is averaged once a rank; the
average comes back as a DTensor with the gradient's placements.

``error_feedback`` (a :class:`~torchft_tpu_torch.wire_codec.ErrorFeedback`,
host path only): each staged bucket is compensated with the committed
residual and projected onto the wire codec's grid in place before it
enters the ring; its fresh residual stays pending until the caller commits
or rolls it back with the step (``ManagedOptimizer`` does).

Step anatomy (``telemetry.anatomy``): on the host plane the main thread's
issue of the device-to-host copies and its waits on each bucket's event are
``host_copy``, the error feedback's projection ``quantize``, and its waits
on the averaged buckets ``wire`` (the ring's own socket time, on the
collectives thread, goes into the wire-stage totals, not the row). On the
device plane the wait on the average is ``wire``. The replayed graphs
return at once, so the device's tail of the backward lands in the first
wait that blocks on it: the first bucket's event on the host plane.
"""

from __future__ import annotations

import time
import weakref
from typing import Any, List, Optional, Sequence, Tuple

import torch

from torchft_tpu_torch.collectives import record_wire_stage
from torchft_tpu_torch.parallel.mesh import from_shard, is_dtensor
from torchft_tpu_torch.telemetry.anatomy import LEDGER
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


class _Staging:
    """The host buckets of one bucket plan, and the event recorded after
    the last step's host-to-device copies out of them."""

    def __init__(self, key: Any, bufs: List[torch.Tensor]) -> None:
        self.key = key
        self.bufs = bufs
        self.copies_done: Optional[Any] = None


# each manager's staging set, dropped with the manager
_STAGING: "weakref.WeakKeyDictionary[Any, _Staging]" = weakref.WeakKeyDictionary()


def allreduce_gradients(
    manager, grads: Any, bucket_bytes: Optional[int] = None, error_feedback: Any = None
) -> Any:
    """Average a gradient tree (list or dict of tensors, all on one
    device) across replica groups through the Manager; returns a tree of
    the same shape on the same device. The caller's tensors are never
    written. ``error_feedback``: see the module docstring."""
    if bucket_bytes is None:
        bucket_bytes = _DEFAULT_BUCKET_BYTES
    leaves, treedef = tree_flatten(grads)
    if not leaves:
        return grads
    sharded = [leaf if is_dtensor(leaf) else None for leaf in leaves]
    if any(d is not None for d in sharded):
        # average each rank's own shards, then give them their placements back
        local = [leaf.to_local() if d is not None else leaf for leaf, d in zip(leaves, sharded)]
        out = allreduce_gradients(manager, local, bucket_bytes, error_feedback)
        return tree_unflatten(treedef, [
            t if d is None else from_shard(t, d.shape, d.device_mesh, d.placements)
            for t, d in zip(out, sharded)])
    if getattr(manager, "device_data_plane", lambda: False)():
        t0 = time.perf_counter()
        averaged = manager.allreduce_many(leaves).wait()
        LEDGER.record("wire", time.perf_counter() - t0)
        return tree_unflatten(treedef, averaged)
    device = leaves[0].device
    on_cuda = device.type == "cuda"
    plan = plan_buckets(
        [(leaf.dtype, leaf.numel() * leaf.element_size()) for leaf in leaves],
        bucket_bytes,
    )

    sizes = [(leaves[idxs[0]].dtype, sum(leaves[i].numel() for i in idxs)) for idxs in plan]
    key = (device.type, tuple(sizes))
    # the wait on the last step's copies out of the buffers and the D2H
    # issue below are host_copy
    t0 = time.perf_counter()
    # taken out while in use: a step that fails does not put it back
    st = _STAGING.pop(manager, None)
    if st is None or st.key != key:
        st = _Staging(key, [torch.empty(n, dtype=dt, pin_memory=on_cuda) for dt, n in sizes])
    elif st.copies_done is not None:
        # the last step's host-to-device copies read these buffers
        st.copies_done.synchronize()

    # stage 1: every bucket's D2H copies, issued before anything blocks
    staged = []
    for idxs, buf in zip(plan, st.bufs):
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
    record_wire_stage("host_copy", time.perf_counter() - t0)

    # stage 2: each bucket enters the ring as soon as its own copies land
    futs = []
    for ordinal, (idxs, buf, event) in enumerate(staged):
        if event is not None:
            t0 = time.perf_counter()
            event.synchronize()
            record_wire_stage("host_copy", time.perf_counter() - t0)
        host = buf.numpy()
        if error_feedback is not None:
            # compensate and project before the ring; the key is stable
            # across steps while the bucket plan is
            t0 = time.perf_counter()
            error_feedback.apply(f"b{ordinal}_{host.size}", host)
            record_wire_stage("quantize", time.perf_counter() - t0)
        futs.append((idxs, buf, manager.allreduce_many([host])))

    # stage 3: averaged pieces back to the device. The main thread's wait
    # on the buckets is the step's `wire` phase (not record_wire_stage: the
    # collectives thread already counts its socket time into the totals)
    out: List[Any] = [None] * len(leaves)
    for idxs, buf, fut in futs:
        t0 = time.perf_counter()
        fut.wait()
        LEDGER.record("wire", time.perf_counter() - t0)
        off = 0
        for i in idxs:
            k = leaves[i].numel()
            piece = buf[off : off + k].view(leaves[i].shape)
            off += k
            # the buffers are reused next step: the CPU result is a copy
            out[i] = piece.to(device, non_blocking=True) if on_cuda else piece.clone()
    if on_cuda:
        st.copies_done = torch.cuda.Event()
        st.copies_done.record()
    if getattr(manager, "errored", lambda: None)() is None:
        _STAGING[manager] = st
    return tree_unflatten(treedef, out)
