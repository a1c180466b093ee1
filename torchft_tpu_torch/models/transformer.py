"""Decoder-only transformer LM — the port's counterpart of
``torchft_tpu/models/transformer.py`` for ``pp=1``, no sequence
parallelism and a dense FFN.

Parameters are a plain tree of float32 master tensors with exactly the JAX
package's structure, leading ``[pp, Lp]`` axes included, so weights carry
across with :func:`params_from_jax`. Each forward casts them to
``cfg.dtype``; the embedding gather runs after the cast and the logits
come out in float32. Layers run in a Python loop, under the JAX package's
``remat`` / ``remat_policy``: ``remat=False`` keeps every activation;
``"all"`` wraps each layer in ``torch.utils.checkpoint`` (the backward
recomputes the whole layer); ``"dots"`` is a selective checkpoint that
saves the outputs of matrix products without batch dims (the projections,
``aten.mm``/``aten.addmm``) and recomputes the rest, batched products and
the flash op included (``jax.checkpoint_policies.
dots_with_no_batch_dims_saveable``). The loss head chunks the sequence
through the unembed when the logits would pass
``TORCHFT_TPU_LOSS_CHUNK_ELEMS``.

Attention routing: ``"flash"`` -> the flash op (its CUDA kernels on the
card, which raise for a shape they do not take), ``"plain"`` -> plain
attention, ``"auto"`` -> flash on a CUDA device when S % 128 == 0 and the
kernels take the dtype, head dim and S
(:func:`~torchft_tpu_torch.ops.flash_attention.supported`), else plain.
The JAX package's TPU thresholds are not carried over; ``"chunked"`` is
not ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any, Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from torchft_tpu_torch.ops.attention import attention
from torchft_tpu_torch.ops.flash_attention import flash_attention, supported
from torchft_tpu_torch.ops.layers import rms_norm, rotary_embed, swiglu
from torchft_tpu_torch.utils.platform import resolve_device
from torchft_tpu_torch.utils.tree import tree_map

__all__ = [
    "TransformerConfig",
    "headline_config",
    "init_params",
    "params_from_jax",
    "forward",
    "loss_fn",
]

_LAYER_KEYS = ("ln1", "ln2", "wq", "wk", "wv", "wo", "w_gate", "w_in", "w_out")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 8
    n_heads: int = 8
    head_dim: int = 64
    d_ff: int = 1408
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    remat: bool = True
    # checkpoint policy under remat: "all" recomputes the whole layer in
    # the backward; "dots" saves the projections' outputs and recomputes
    # the rest
    remat_policy: str = "all"
    attention_impl: str = "auto"  # "auto" | "plain" | "flash"

    @property
    def qkv_dim(self) -> int:
        return self.n_heads * self.head_dim


def headline_config() -> TransformerConfig:
    """The headline transformer of ``bench.py:341-357`` in bf16 on the flash
    kernels, trained at batch 8 x seq 1024 (``bench.py:366``)."""
    return TransformerConfig(
        vocab_size=32000, d_model=512, n_layers=8, n_heads=8, head_dim=64, d_ff=1408,
        dtype=torch.bfloat16, attention_impl="flash",
    )


def init_params(
    cfg: TransformerConfig,
    generator: torch.Generator,
    device: str = "cuda",
) -> Dict[str, Any]:
    """Random float32 params with the JAX tree's shapes (same scaling:
    normal * fan_in^-0.5, norms at one). The numbers differ from
    ``jax.random``'s; use :func:`params_from_jax` to match the JAX
    package."""
    dev = resolve_device(device)
    d, qkv, f, lp = cfg.d_model, cfg.qkv_dim, cfg.d_ff, cfg.n_layers

    def dense(*shape, fan_in):
        x = torch.randn(*shape, generator=generator, dtype=torch.float32)
        return (x * fan_in**-0.5).to(dev)

    def ones(*shape):
        return torch.ones(*shape, dtype=torch.float32, device=dev)

    return {
        "embed": dense(cfg.vocab_size, d, fan_in=1.0),
        "layers": {
            "ln1": ones(1, lp, d),
            "ln2": ones(1, lp, d),
            "wq": dense(1, lp, d, qkv, fan_in=d),
            "wk": dense(1, lp, d, qkv, fan_in=d),
            "wv": dense(1, lp, d, qkv, fan_in=d),
            "wo": dense(1, lp, qkv, d, fan_in=qkv),
            "w_gate": dense(1, lp, d, f, fan_in=d),
            "w_in": dense(1, lp, d, f, fan_in=d),
            "w_out": dense(1, lp, f, d, fan_in=f),
        },
        "final_norm": ones(d),
        "out": dense(d, cfg.vocab_size, fan_in=d),
    }


def params_from_jax(tree: Dict[str, Any], device: str = "cuda") -> Dict[str, Any]:
    """The JAX package's params (its tree with numpy leaves, e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``) as the port's params:
    the same tree of float32 tensors on ``device``."""
    dev = resolve_device(device)
    if tree["layers"]["wq"].shape[0] != 1 or set(tree["layers"]) != set(_LAYER_KEYS):
        raise ValueError("only pp=1 dense-FFN params are supported")
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(dev), tree
    )


def _use_flash(cfg: TransformerConfig, seq_len: int, device: torch.device) -> bool:
    if cfg.attention_impl == "flash":
        return True
    if cfg.attention_impl == "plain":
        return False
    if cfg.attention_impl == "chunked":
        raise NotImplementedError(
            "attention_impl='chunked' is not ported yet (ROADMAP: chunked and "
            "ring attention)"
        )
    if cfg.attention_impl != "auto":
        raise ValueError(
            f"attention_impl must be 'auto'|'plain'|'flash', got {cfg.attention_impl!r}"
        )
    return (
        device.type == "cuda"
        and seq_len % 128 == 0
        and supported(cfg.dtype, cfg.head_dim, seq_len)
    )


def _layer(x: torch.Tensor, lp: Dict[str, torch.Tensor], cfg: TransformerConfig) -> torch.Tensor:
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    b, s, _ = h.shape
    positions = torch.arange(s, device=x.device)
    q = (h @ lp["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (h @ lp["wk"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    v = (h @ lp["wv"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    q = rotary_embed(q, positions, cfg.rope_theta)
    k = rotary_embed(k, positions, cfg.rope_theta)
    if _use_flash(cfg, s, x.device):
        att = flash_attention(q, k, v, causal=True)
    else:
        att = attention(q, k, v, causal=True)
    x = x + att.reshape(b, s, cfg.qkv_dim) @ lp["wo"]
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + swiglu(h, lp["w_gate"], lp["w_in"], lp["w_out"])


# matrix products without batch dims: what "dots" saves
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _layer_fn(cfg: TransformerConfig) -> Callable[..., torch.Tensor]:
    """One layer under the config's remat policy (JAX's ``_make_stage_fn``)."""
    if not cfg.remat:
        return _layer
    # a layer draws no random numbers: no RNG state to keep (reading the
    # CUDA generator's state is also refused inside a graph capture)
    if cfg.remat_policy == "all":
        return functools.partial(checkpoint, _layer, use_reentrant=False,
                                 preserve_rng_state=False)
    if cfg.remat_policy == "dots":
        return functools.partial(
            checkpoint, _layer, use_reentrant=False, preserve_rng_state=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _save_dots),
        )
    raise ValueError(
        f"remat_policy={cfg.remat_policy!r}: expected 'all' or 'dots' (a typo "
        "here would silently pay full recompute)"
    )


def _hidden_states(
    params: Dict[str, Any], tokens: torch.Tensor, cfg: TransformerConfig
) -> torch.Tensor:
    """tokens [B, S] -> final-norm hidden states [B, S, D] in cfg.dtype."""
    layer = _layer_fn(cfg)
    dt = cfg.dtype
    x = params["embed"].to(dt)[tokens.long()]
    layers = {k: v.to(dt) for k, v in params["layers"].items()}
    for i in range(layers["wq"].shape[1]):
        lp = {k: v[0, i] for k, v in layers.items()}
        x = layer(x, lp, cfg)
    return rms_norm(x, params["final_norm"].to(dt), cfg.norm_eps)


def forward(
    params: Dict[str, Any], tokens: torch.Tensor, cfg: TransformerConfig
) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V] in float32."""
    x = _hidden_states(params, tokens, cfg)
    return (x @ params["out"].to(cfg.dtype)).float()


def _loss_chunk_elems() -> int:
    """Logit-element budget above which the loss head chunks the sequence
    (default 2^27); TORCHFT_TPU_LOSS_CHUNK_ELEMS overrides."""
    try:
        return int(os.environ.get("TORCHFT_TPU_LOSS_CHUNK_ELEMS", 1 << 27))
    except ValueError:
        return 1 << 27


def _shifted(tokens: torch.Tensor):
    """Targets (tokens shifted left) and the mask with position S-1 off."""
    targets = torch.roll(tokens.long(), -1, dims=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    return targets, mask


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets[..., None])[..., 0]


def loss_fn(
    params: Dict[str, Any], tokens: torch.Tensor, cfg: TransformerConfig
) -> torch.Tensor:
    """Next-token cross entropy; position S-1 is unsupervised."""
    b, s = tokens.shape
    if b * s * cfg.vocab_size > _loss_chunk_elems():
        return _chunked_loss(params, tokens, cfg)
    targets, mask = _shifted(tokens)
    nll = _nll(forward(params, tokens, cfg), targets)
    return torch.sum(nll * mask) / torch.sum(mask)


def _chunk_nll(h_c, out_w, t_c, m_c):
    return torch.sum(_nll((h_c @ out_w).float(), t_c) * m_c)


def _chunked_loss(
    params: Dict[str, Any], tokens: torch.Tensor, cfg: TransformerConfig
) -> torch.Tensor:
    """Cross entropy without materialising [B, S, V]: the unembed and
    softmax run over sequence chunks, each under ``torch.utils.checkpoint``
    so the backward recomputes one chunk's logits at a time."""
    b, s = tokens.shape
    h = _hidden_states(params, tokens, cfg)
    out_w = params["out"].to(cfg.dtype)
    targets, mask = _shifted(tokens)
    chunk = max(1, min(s, max(1, _loss_chunk_elems()) // (b * cfg.vocab_size)))
    if chunk >= 128:
        chunk -= chunk % 128  # lane-aligned chunks, as in the JAX head
    nll_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    for start in range(0, s, chunk):
        sl = slice(start, start + chunk)
        nll_sum = nll_sum + checkpoint(
            _chunk_nll, h[:, sl], out_w, targets[:, sl], mask[:, sl],
            use_reentrant=False, preserve_rng_state=False,
        )
    return nll_sum / torch.sum(mask)

