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

Sharded (``mesh`` given, a :func:`~torchft_tpu_torch.parallel.mesh.make_mesh`
mesh): every leaf is a DTensor placed by :func:`param_specs` (the JAX
``PartitionSpec`` per leaf, as DTensor placements). Each layer gathers its
weights over ``fsdp`` (the FSDP all-gather; under remat the backward
gathers again), activations are laid out batch over ``("dp", "fsdp")``
wherever the JAX code constrains them, and DTensor's propagation shards
the products over ``tp`` (heads and FFN hidden dim) and reduces their
partial sums. Rotary and attention, per (batch, head), run under
``local_map`` on each rank's shard, as the JAX ``_flash_sharded`` runs the
kernel under ``shard_map``; so does the loss's softmax, after the vocab
sharded over ``tp`` is gathered. pp, sp and ep above 1 are not ported
(ROADMAP queue 1 items 5, 7 and 8).

Attention routing: ``"flash"`` -> the flash op (its CUDA kernels on the
card, which raise for a shape they do not take), ``"plain"`` -> plain
attention, ``"auto"`` -> flash on a CUDA device when the op takes the
dtype, head dim and S
(:func:`~torchft_tpu_torch.ops.flash_attention.op_supported`: the
kernels' head dims 8, 16, 32 and 64 at any S, 128 in bf16 at S a multiple
of 64, and the op's block rule, the Pallas op's, S a multiple of
min(128, S)), else plain. The JAX package's TPU thresholds are not
carried over; ``"chunked"`` is not ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from torchft_tpu_torch.ops.attention import attention
from torchft_tpu_torch.ops.flash_attention import flash_attention, op_supported
from torchft_tpu_torch.ops.layers import rms_norm, rotary_embed, swiglu
from torchft_tpu_torch.parallel.mesh import P, axis_size, place, placements
from torchft_tpu_torch.utils.platform import resolve_device
from torchft_tpu_torch.utils.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

__all__ = [
    "TransformerConfig",
    "headline_config",
    "init_params",
    "params_from_jax",
    "param_specs",
    "param_placements",
    "place_params",
    "check_mesh",
    "forward",
    "loss_fn",
]

_LAYER_KEYS = ("ln1", "ln2", "wq", "wk", "wv", "wo", "w_gate", "w_in", "w_out")

# the mesh axes the port shards over, and what the others wait for
_UNPORTED_AXES = {
    "pp": "pp > 1 (pipeline stages) is not ported yet: ROADMAP queue 1 item 5",
    "sp": "sp > 1 (ring attention) is not ported yet: ROADMAP queue 1 item 7",
    "ep": "ep > 1 (MoE experts) is not ported yet: ROADMAP queue 1 item 8",
}


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


def param_specs(cfg: Optional[TransformerConfig] = None) -> Dict[str, Any]:
    """The JAX package's ``param_specs`` for ``pp=1`` and a dense FFN (the
    only configuration the port takes, so ``cfg`` changes nothing): a
    :class:`~torchft_tpu_torch.parallel.mesh.P` per leaf (same tree as
    :func:`init_params`)."""
    row, col = P("pp", None, "fsdp", "tp"), P("pp", None, "tp", "fsdp")
    return {
        # [V, D]: vocab unsharded, D over (tp, fsdp), so the token gather
        # is local to each rank
        "embed": P(None, ("tp", "fsdp")),
        "layers": {
            "ln1": P("pp", None, None),
            "ln2": P("pp", None, None),
            "wq": row, "wk": row, "wv": row, "wo": col,
            "w_gate": row, "w_in": row, "w_out": col,
        },
        "final_norm": P(None),
        "out": P("fsdp", "tp"),
    }


def check_mesh(mesh) -> None:
    """Raise ``NotImplementedError`` for a mesh axis the port does not
    shard over yet (pp, sp or ep above 1)."""
    for axis, why in _UNPORTED_AXES.items():
        if axis_size(mesh, axis) > 1:
            raise NotImplementedError(why)


def param_placements(mesh) -> list:
    """The DTensor placements of every leaf on ``mesh``, in leaf order."""
    check_mesh(mesh)
    return [placements(spec, mesh) for spec in tree_leaves(param_specs())]


def place_params(params: Dict[str, Any], mesh) -> Dict[str, Any]:
    """``params`` as DTensors on ``mesh`` with :func:`param_placements`: a
    full tensor (every rank holds it) contributes this rank's slice, a
    DTensor is redistributed where its placements differ."""
    leaves, spec = tree_flatten(params)
    return tree_unflatten(spec, [place(leaf, mesh, target)
                                 for leaf, target in zip(leaves, param_placements(mesh))])


def params_from_jax(tree: Dict[str, Any], device: str = "cuda", mesh=None) -> Dict[str, Any]:
    """The JAX package's params (its tree with numpy leaves, e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``) as the port's params:
    the same tree of float32 tensors on ``device``, or placed on ``mesh``
    (:func:`place_params`)."""
    if tree["layers"]["wq"].shape[0] != 1:
        raise NotImplementedError(_UNPORTED_AXES["pp"])
    if set(tree["layers"]) != set(_LAYER_KEYS):
        raise NotImplementedError(_UNPORTED_AXES["ep"])
    dev = resolve_device(device) if mesh is None else torch.device(mesh.device_type)
    params = tree_map(
        lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(dev), tree
    )
    return params if mesh is None else place_params(params, mesh)


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
    return device.type == "cuda" and op_supported(cfg.dtype, cfg.head_dim, seq_len)


# ---------------------------------------------------------------------------
# layouts under a mesh (the JAX package's sharding constraints)
# ---------------------------------------------------------------------------

# activations [B, S, D]: batch over (dp, fsdp), sequence over sp
_ACT = P(("dp", "fsdp"), "sp", None)
# q/k/v and attention's output [B, S, H, Dh]: heads over tp too
_HEADS = P(("dp", "fsdp"), None, "tp", None)
# tokens, targets and the loss mask [B, S]
_ROWS = P(("dp", "fsdp"), None)


def _constrain(x, mesh, spec: P):
    """``with_sharding_constraint``: ``x`` redistributed to ``spec`` on
    ``mesh`` (a no-op without a mesh, or where ``x`` is laid out so)."""
    return x if mesh is None else place(x, mesh, placements(spec, mesh))


def _gather_fsdp(w, mesh):
    """A weight gathered over ``fsdp`` (kept sharded over ``tp``): the FSDP
    all-gather before its use; its backward reduce-scatters the gradient."""
    if axis_size(mesh, "fsdp") == 1:
        return w
    from torch.distributed.tensor import Replicate

    i = list(mesh.mesh_dim_names).index("fsdp")
    target = list(w.placements)
    target[i] = Replicate()
    return w.redistribute(mesh, target)


def _attend(q, k, v, cfg: TransformerConfig):
    """Rotary embedding and causal attention of whole sequences, per
    (batch, head): what each rank runs on its shard."""
    s = q.shape[1]
    positions = torch.arange(s, device=q.device)
    q = rotary_embed(q, positions, cfg.rope_theta)
    k = rotary_embed(k, positions, cfg.rope_theta)
    if _use_flash(cfg, s, q.device):
        return flash_attention(q, k, v, causal=True)
    return attention(q, k, v, causal=True)


def _local_map(fn, out_placements, in_placements, mesh):
    """``local_map`` of ``fn`` over ``mesh``, inputs redistributed to
    ``in_placements`` (DTensor's package is imported here, not with the
    module: a process without a mesh never loads it)."""
    from torch.distributed.tensor.experimental import local_map

    return local_map(fn, out_placements=out_placements, in_placements=in_placements,
                     device_mesh=mesh, redistribute_inputs=True)


def _attention(q, k, v, cfg: TransformerConfig, mesh):
    """:func:`_attend`, under ``local_map`` over every mesh axis when
    sharded (the JAX ``_flash_sharded``): batch over (dp, fsdp), heads over
    tp, each rank on its own shard."""
    if mesh is None:
        return _attend(q, k, v, cfg)
    heads = placements(_HEADS, mesh)
    return _local_map(functools.partial(_attend, cfg=cfg), heads, (heads, heads, heads),
                      mesh)(q, k, v)


def _layer(x: torch.Tensor, lp: Dict[str, torch.Tensor], cfg: TransformerConfig,
           mesh=None) -> torch.Tensor:
    if mesh is not None:
        x = _constrain(x, mesh, _ACT)
        lp = {k: _gather_fsdp(w, mesh) for k, w in lp.items()}
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    b, s, _ = h.shape
    q = (h @ lp["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (h @ lp["wk"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    v = (h @ lp["wv"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    att = _attention(q, k, v, cfg, mesh)
    # under tp the projections' partial sums are reduced before the residual
    x = x + _constrain(att.reshape(b, s, cfg.qkv_dim) @ lp["wo"], mesh, _ACT)
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + _constrain(swiglu(h, lp["w_gate"], lp["w_in"], lp["w_out"]), mesh, _ACT)


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


def _embed_lookup(params: Dict[str, Any], tokens: torch.Tensor, dt: torch.dtype, mesh):
    """The embedding gather after the cast. Sharded, the table keeps its
    layout (D over tp and fsdp) and the tokens are gathered over fsdp, so
    the lookup is local; the [B, S, D] result then moves to the activation
    layout one axis at a time, as in the JAX package."""
    embed = params["embed"].to(dt)
    if mesh is None:
        return embed[tokens.long()]
    x = F.embedding(_constrain(tokens.long(), mesh, P("dp", "sp")), embed)
    x = _constrain(x, mesh, P(("dp", "fsdp"), "sp", "tp"))
    return _constrain(x, mesh, _ACT)


def _hidden_states(
    params: Dict[str, Any], tokens: torch.Tensor, cfg: TransformerConfig, mesh=None
) -> torch.Tensor:
    """tokens [B, S] -> final-norm hidden states [B, S, D] in cfg.dtype."""
    check_mesh(mesh)
    layer = _layer_fn(cfg)
    dt = cfg.dtype
    x = _embed_lookup(params, tokens, dt, mesh)
    layers = {k: v.to(dt) for k, v in params["layers"].items()}
    for i in range(layers["wq"].shape[1]):
        lp = {k: v[0, i] for k, v in layers.items()}
        x = layer(x, lp, cfg, mesh)
    return rms_norm(x, params["final_norm"].to(dt), cfg.norm_eps)


def forward(
    params: Dict[str, Any], tokens: torch.Tensor, cfg: TransformerConfig, mesh=None
) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V] in float32 (sharded: a DTensor,
    batch over (dp, fsdp), vocab over tp)."""
    x = _hidden_states(params, tokens, cfg, mesh)
    return (x @ _gather_fsdp(params["out"].to(cfg.dtype), mesh)).float()


def _loss_chunk_elems() -> int:
    """Logit-element budget above which the loss head chunks the sequence
    (default 2^27); TORCHFT_TPU_LOSS_CHUNK_ELEMS overrides."""
    try:
        return int(os.environ.get("TORCHFT_TPU_LOSS_CHUNK_ELEMS", 1 << 27))
    except ValueError:
        return 1 << 27


def _per_device_logit_elems(cfg: TransformerConfig, batch: int, seq_len: int, mesh) -> int:
    """Elements of one rank's share of the dense [B, S, V] logits: B over
    dp x fsdp, V over tp (the JAX package's)."""
    batch_shards = axis_size(mesh, "dp") * axis_size(mesh, "fsdp")
    vocab_shards = axis_size(mesh, "tp")
    return max(1, batch // batch_shards) * seq_len * max(1, cfg.vocab_size // vocab_shards)


def _shifted_local(tokens: torch.Tensor):
    """Targets (tokens shifted left) and the mask with position S-1 off."""
    targets = torch.roll(tokens.long(), -1, dims=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    return targets, mask


def _shifted(tokens: torch.Tensor, mesh=None):
    if mesh is None:
        return _shifted_local(tokens)
    rows = placements(_ROWS, mesh)
    return _local_map(_shifted_local, (rows, rows), (rows,), mesh)(tokens)


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets[..., None])[..., 0]


def _nll_sum_local(logits, targets, mask):
    return torch.sum(_nll(logits, targets) * mask)


def _nll_sum(logits, targets, mask, mesh=None):
    """sum(nll * mask) over the rows: each rank sums its rows (the vocab
    gathered over tp first), a partial sum over (dp, fsdp)."""
    if mesh is None:
        return _nll_sum_local(logits, targets, mask)
    from torch.distributed.tensor import Partial, Shard

    rows = placements(_ROWS, mesh)
    batch = [Partial() if isinstance(p, Shard) else p for p in rows]
    logit_rows = placements(P(("dp", "fsdp"), None, None), mesh)
    return _local_map(_nll_sum_local, batch, (logit_rows, rows, rows), mesh)(
        logits, targets, mask)


def _total(x, mesh):
    """A (partial) sum as a plain tensor, equal on every rank."""
    return x if mesh is None else x.full_tensor()


def loss_fn(
    params: Dict[str, Any], tokens: torch.Tensor, cfg: TransformerConfig, mesh=None
) -> torch.Tensor:
    """Next-token cross entropy; position S-1 is unsupervised. Sharded,
    ``tokens`` is a DTensor (``TrainStep.shard_batch``) and the loss comes
    back a plain tensor, equal on every rank."""
    b, s = tokens.shape
    if _per_device_logit_elems(cfg, b, s, mesh) > _loss_chunk_elems():
        return _chunked_loss(params, tokens, cfg, mesh)
    targets, mask = _shifted(tokens, mesh)
    nll = _nll_sum(forward(params, tokens, cfg, mesh), targets, mask, mesh)
    return _total(nll, mesh) / _total(torch.sum(mask), mesh)


def _chunk_nll(h_c, out_w, t_c, m_c, mesh=None):
    return _nll_sum((h_c @ out_w).float(), t_c, m_c, mesh)


def _chunked_loss(
    params: Dict[str, Any], tokens: torch.Tensor, cfg: TransformerConfig, mesh=None
) -> torch.Tensor:
    """Cross entropy without materialising [B, S, V]: the unembed and
    softmax run over sequence chunks, each under ``torch.utils.checkpoint``
    so the backward recomputes one chunk's logits at a time."""
    b, s = tokens.shape
    h = _hidden_states(params, tokens, cfg, mesh)
    out_w = _gather_fsdp(params["out"].to(cfg.dtype), mesh)
    targets, mask = _shifted(tokens, mesh)
    per_pos = _per_device_logit_elems(cfg, b, 1, mesh)
    chunk = max(1, min(s, max(1, _loss_chunk_elems()) // per_pos))
    if chunk >= 128:
        chunk -= chunk % 128  # lane-aligned chunks, as in the JAX head
    nll_sum = None
    for start in range(0, s, chunk):
        sl = slice(start, start + chunk)
        part = checkpoint(
            _chunk_nll, h[:, sl], out_w, targets[:, sl], mask[:, sl], mesh,
            use_reentrant=False, preserve_rng_state=False,
        )
        nll_sum = part if nll_sum is None else nll_sum + part
    return _total(nll_sum, mesh) / _total(torch.sum(mask), mesh)
