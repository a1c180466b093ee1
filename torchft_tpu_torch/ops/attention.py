"""Plain softmax attention — counterpart of ``torchft_tpu/ops/attention.py``
(``attention``), and the plain version the flash kernels are held against.

``chunked_attention`` and ring attention are not ported yet (ROADMAP).
"""

from __future__ import annotations

import torch

__all__ = ["attention"]

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
