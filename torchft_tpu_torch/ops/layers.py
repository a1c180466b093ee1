"""Building-block layers: RMSNorm, rotary embeddings, SwiGLU — counterparts
of ``torchft_tpu/ops/layers.py``.

Plain functions on tensors; the JAX package left these to XLA's fusion and
none of them is a kernel there. ``moe_dispatch`` is not ported yet: the
port's configuration has no experts (ROADMAP).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "rotary_embed", "swiglu"]


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalise in float32, cast back to ``x``'s dtype, THEN scale by the
    weight (the JAX order: the product runs in the input dtype)."""
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * weight


def rotary_embed(
    x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0
) -> torch.Tensor:
    """RoPE over INTERLEAVED pairs (``x[..., ::2]``, ``x[..., 1::2]``), in
    float32, restacked pairwise. x: [B, S, H, Dh], positions: [S]."""
    dh = x.shape[-1]
    freqs = theta ** (
        -torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh
    )
    angles = positions[:, None].float() * freqs[None, :]  # [S, Dh/2]
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = x[..., ::2].float(), x[..., 1::2].float()
    out1 = x1 * cos - x2 * sin
    out2 = x1 * sin + x2 * cos
    return torch.stack([out1, out2], dim=-1).reshape(x.shape).to(x.dtype)


def swiglu(
    x: torch.Tensor, w_gate: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor
) -> torch.Tensor:
    """SwiGLU FFN: (silu(x @ w_gate) * (x @ w_in)) @ w_out."""
    return (F.silu(x @ w_gate) * (x @ w_in)) @ w_out
