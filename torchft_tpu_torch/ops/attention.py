"""Attention — counterpart of ``torchft_tpu/ops/attention.py``: plain
softmax attention (the plain version the flash kernels are held against),
chunked attention (one q-block at a time, the [S, S] scores never
materialised) and ring attention for sequence parallelism over the ``sp``
mesh axis.

Ring attention (Liu et al., arxiv 2310.01889): the sequence is sharded
over ``sp``; each rank holds a Q block and streams the K/V blocks around
the ring with :func:`~torchft_tpu_torch.parallel.mesh.ppermute`, keeping a
running float32 max and sum (the flash recurrence), so attention memory is
O(S/sp) a rank. The JAX package runs the body under a ``shard_map`` over
``sp``; the port runs it under ``local_map`` over the whole mesh, the
other axes' shards (batch, heads) passing through, with the ``sp``
subgroup's point-to-point ops.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from torchft_tpu_torch.parallel.mesh import P, axis_size, place, placements, ppermute

__all__ = ["attention", "chunked_attention", "ring_attention", "ring_attention_local"]

_NEG_INF = -1e30


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """Plain attention. q/k/v: [B, S, H, Dh] -> [B, S, H, Dh].

    Same numerics as the JAX reference: scores in the input dtype, masked
    with -1e30 (not -inf), softmax in float32, probabilities cast back to
    the input dtype before the product with V."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        s = q.shape[1]
        pos = torch.arange(s, device=q.device)
        keep = pos[None, :] <= pos[:, None]
        scores = torch.where(keep, scores, torch.full_like(scores, _NEG_INF))
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _q_block(qc: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q0: int,
             causal: bool) -> torch.Tensor:
    """One q-block [B, C, H, D] against keys [B, Sk, H, D] whose positions
    start at 0; the block's rows start at ``q0``. :func:`attention`'s
    numerics."""
    scores = torch.einsum("bqhd,bkhd->bhqk", qc, k) * qc.shape[-1] ** -0.5
    if causal:
        q_pos = q0 + torch.arange(qc.shape[1], device=qc.device)
        k_pos = torch.arange(k.shape[1], device=qc.device)
        keep = k_pos[None, :] <= q_pos[:, None]
        scores = torch.where(keep, scores, torch.full_like(scores, _NEG_INF))
    probs = torch.softmax(scores.float(), dim=-1).to(qc.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    chunk: int = 512,
    tiers: Optional[int] = None,
) -> torch.Tensor:
    """Plain attention one q-block at a time: :func:`attention`'s contract
    and numerics ([B, S, H, Dh] -> [B, S, H, Dh]), but each block of
    ``chunk`` query rows scores [chunk, S] under ``torch.utils.checkpoint``,
    so the backward recomputes one block's scores at a time and the
    [S, S] matrix never exists.

    Causal runs skip provably masked key blocks by static k-prefix tiers:
    q-segment t of ``tiers`` scores only keys ``[0, (t+1) S / tiers)``
    (62.5% of the S^2 products at 4 tiers). ``tiers=None`` picks 16 at
    S >= 16384, else 4; a count that does not divide S into whole chunks
    degrades to the largest one that does. Requires ``S % chunk == 0``."""
    b, s, h, d = q.shape
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    if tiers is None:
        tiers = 16 if s >= 16384 else 4
    while tiers > 1 and s % (tiers * chunk) != 0:
        tiers -= 1

    def segment(q_seg, k_seg, v_seg, q0):
        outs = [
            checkpoint(_q_block, q_seg[:, i:i + chunk], k_seg, v_seg, q0 + i, causal,
                       use_reentrant=False, preserve_rng_state=False)
            for i in range(0, q_seg.shape[1], chunk)
        ]
        return torch.cat(outs, dim=1)

    if not causal or tiers <= 1:
        return segment(q, k, v, 0)
    seg = s // tiers
    return torch.cat([
        segment(q[:, t * seg:(t + 1) * seg], k[:, :(t + 1) * seg], v[:, :(t + 1) * seg],
                t * seg)
        for t in range(tiers)
    ], dim=1)


def ring_attention_local(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    sp_size: int,
    causal: bool = True,
    group=None,
) -> torch.Tensor:
    """The per-rank ring body: q/k/v are this rank's [B, Sl, H, Dh] blocks
    of a sequence sharded over ``group`` (the ``sp`` subgroup, ``sp_size``
    ranks, block r at rank r). K/V rotate one rank right each step, so at
    step t a rank holds the block of rank (my - t) % sp; the last step's
    rotation is not needed and not sent."""
    import torch.distributed as dist

    my = dist.get_rank(group)
    b, sl, h, dh = q.shape
    scale = dh ** -0.5
    q_pos = my * sl + torch.arange(sl, device=q.device)
    qf = q.float()
    acc = torch.zeros(b, h, sl, dh, dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sl), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(b, h, sl, dtype=torch.float32, device=q.device)
    k_cur, v_cur, owner = k, v, my
    for step in range(sp_size):
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, k_cur.float()) * scale
        if causal:
            k_pos = owner * sl + torch.arange(sl, device=q.device)
            keep = k_pos[None, :] <= q_pos[:, None]
            scores = torch.where(keep, scores, torch.full_like(scores, _NEG_INF))
        new_m = torch.maximum(m, scores.amax(dim=-1))
        correction = torch.exp(m - new_m)
        p = torch.exp(scores - new_m[..., None])
        acc = acc * correction[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_cur.float())
        l = l * correction + p.sum(dim=-1)
        m = new_m
        if step + 1 < sp_size:
            k_cur = ppermute(k_cur, group, 1)
            v_cur = ppermute(v_cur, group, 1)
            owner = (owner - 1) % sp_size
    # rows with no visible key (none under causal self-attention) guard
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return torch.einsum("bhqd->bqhd", out).to(q.dtype)


# q/k/v under ring attention: batch over (dp, fsdp), sequence over sp,
# heads over tp; attention is independent per (batch, head)
RING_SPEC = P(("dp", "fsdp"), "sp", "tp", None)


def ring_attention(q, k, v, mesh, causal: bool = True) -> torch.Tensor:
    """Sequence-parallel attention over ``mesh``'s ``sp`` axis: q/k/v
    [B, S, H, Dh] (DTensors or full tensors) laid out by
    :data:`RING_SPEC` and the ring body run on each rank's block under
    ``local_map``. Plain attention where ``sp`` is 1."""
    sp = axis_size(mesh, "sp")
    if sp == 1:
        return attention(q, k, v, causal=causal)
    from torch.distributed.tensor.experimental import local_map

    spec = placements(RING_SPEC, mesh)
    q, k, v = (place(x, mesh, spec) for x in (q, k, v))
    body = functools.partial(ring_attention_local, sp_size=sp, causal=causal,
                             group=mesh.get_group("sp"))
    return local_map(body, out_placements=spec, in_placements=(spec, spec, spec),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)
