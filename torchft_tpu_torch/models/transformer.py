"""Decoder-only transformer LM — the port's counterpart of
``torchft_tpu/models/transformer.py`` with a dense FFN: dp, fsdp, tp,
pipeline stages (``pp``) and sequence parallelism by ring attention
(``sp``).

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
sharded over ``tp`` is gathered. Under ``sp`` the sequence stays
sharded through every layer; rotary positions are offset by the rank's
block and attention is the ring (``ops.attention.ring_attention_local``).
Under ``pp`` the layers' leading ``[pp, Lp]`` axis is sharded over ``pp``
and :func:`loss_fn` runs the microbatched GPipe ring
(``parallel.pipeline.pipeline_forward``), its head on the last stage with
only scalar sums crossing the stages. ``ep`` above 1 (MoE) is not ported
(ROADMAP queue 1).

Attention routing, in order: ``sp`` above 1 -> ring attention;
``"flash"`` -> the flash op (its CUDA kernels on the card, which raise for
a shape they do not take); ``"auto"`` -> flash on a CUDA device when the
op takes the dtype, head dim and S
(:func:`~torchft_tpu_torch.ops.flash_attention.op_supported`: float32
and bf16 at any head dim up to 256 and any S, a head dim the kernels are
not built at padded to the next, and the op's block rule, the Pallas
op's, S a multiple of min(128, S)); then ``"chunked"``, or ``"auto"`` at S of at least
``TORCHFT_TPU_ATTN_CHUNKED_MIN_S`` (1024), -> chunked attention where S is
a multiple of the chunk (:func:`_use_chunked`, the JAX package's rule and
variables); else plain. The JAX package engages flash under ``"auto"``
only on a TPU past a scores-memory ceiling; the port engages it wherever
the op takes the shape (ROADMAP queue 3, kept on purpose), so on the card
the headline stays on the kernels and on the CPU ``"auto"`` routes as the
JAX package does there.
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

from torchft_tpu_torch.ops.attention import attention, chunked_attention, ring_attention_local
from torchft_tpu_torch.ops.flash_attention import flash_attention, op_supported
from torchft_tpu_torch.ops.layers import rms_norm, rotary_embed
from torchft_tpu_torch.parallel.mesh import (
    P,
    axis_size,
    from_shard,
    place,
    placements,
    sum_grads,
    without_axis,
)
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

# the mesh axes the port does not shard over yet, and what they wait for
_UNPORTED_AXES = {
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
    pp: int = 1  # pipeline stages; n_layers % pp == 0
    microbatches: int = 0  # 0 => pp
    attention_impl: str = "auto"  # "auto" | "plain" | "chunked" | "flash"

    @property
    def layers_per_stage(self) -> int:
        if self.n_layers % max(self.pp, 1):
            raise ValueError(f"n_layers {self.n_layers} is not a multiple of pp {self.pp}")
        return self.n_layers // max(self.pp, 1)

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
    d, qkv, f = cfg.d_model, cfg.qkv_dim, cfg.d_ff
    pp, lp = max(cfg.pp, 1), cfg.layers_per_stage

    def dense(*shape, fan_in):
        x = torch.randn(*shape, generator=generator, dtype=torch.float32)
        return (x * fan_in**-0.5).to(dev)

    def ones(*shape):
        return torch.ones(*shape, dtype=torch.float32, device=dev)

    return {
        "embed": dense(cfg.vocab_size, d, fan_in=1.0),
        "layers": {
            "ln1": ones(pp, lp, d),
            "ln2": ones(pp, lp, d),
            "wq": dense(pp, lp, d, qkv, fan_in=d),
            "wk": dense(pp, lp, d, qkv, fan_in=d),
            "wv": dense(pp, lp, d, qkv, fan_in=d),
            "wo": dense(pp, lp, qkv, d, fan_in=qkv),
            "w_gate": dense(pp, lp, d, f, fan_in=d),
            "w_in": dense(pp, lp, d, f, fan_in=d),
            "w_out": dense(pp, lp, f, d, fan_in=f),
        },
        "final_norm": ones(d),
        "out": dense(d, cfg.vocab_size, fan_in=d),
    }


def param_specs(cfg: Optional[TransformerConfig] = None) -> Dict[str, Any]:
    """The JAX package's ``param_specs`` for a dense FFN (the only
    configuration the port takes, so ``cfg`` changes nothing): a
    :class:`~torchft_tpu_torch.parallel.mesh.P` per leaf (same tree as
    :func:`init_params`; the layers' leading axis over ``pp``)."""
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


def check_mesh(mesh, cfg: Optional[TransformerConfig] = None) -> None:
    """Raise ``NotImplementedError`` for a mesh axis the port does not
    shard over yet (ep above 1), and ``ValueError`` where ``cfg``'s
    pipeline depth is not the mesh's ``pp``."""
    for axis, why in _UNPORTED_AXES.items():
        if axis_size(mesh, axis) > 1:
            raise NotImplementedError(why)
    if cfg is not None and mesh is not None and max(cfg.pp, 1) != axis_size(mesh, "pp"):
        raise ValueError(f"cfg.pp={cfg.pp} but the mesh's pp is {axis_size(mesh, 'pp')}")


def param_placements(mesh, cfg: Optional[TransformerConfig] = None) -> list:
    """The DTensor placements of every leaf on ``mesh``, in leaf order."""
    check_mesh(mesh, cfg)
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
    (:func:`place_params`). The layers' leading axis is the tree's
    pipeline depth (``cfg.pp``), sharded over the mesh's ``pp``."""
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
    if cfg.attention_impl in ("plain", "chunked"):
        return False
    if cfg.attention_impl != "auto":
        raise ValueError(
            "attention_impl must be 'auto'|'plain'|'chunked'|'flash', "
            f"got {cfg.attention_impl!r}"
        )
    return device.type == "cuda" and op_supported(cfg.dtype, cfg.head_dim, seq_len)


def _env_int(name: str) -> Optional[int]:
    """An integer environment variable; unset or unparseable -> None (a
    malformed value is ignored, not taken as an override)."""
    try:
        return int(os.environ.get(name, ""))
    except ValueError:
        return None


def _attn_chunk(seq_len: int) -> int:
    """The q-block of chunked attention: 128 (256 at S 16384), the JAX
    package's picks; ``TORCHFT_TPU_ATTN_CHUNK`` overrides."""
    chunk = _env_int("TORCHFT_TPU_ATTN_CHUNK")
    if chunk:
        return chunk
    return 256 if seq_len == 16384 else 128


def _attn_tiers() -> Optional[int]:
    """The causal k-prefix tier count, ``TORCHFT_TPU_ATTN_TIERS``; unset or
    unparseable -> None, chunked attention's own pick."""
    return _env_int("TORCHFT_TPU_ATTN_TIERS")


def _use_chunked(cfg: TransformerConfig, seq_len: int) -> bool:
    """Chunked attention for ``"chunked"``, and for ``"auto"`` at S of at
    least ``TORCHFT_TPU_ATTN_CHUNKED_MIN_S`` (1024); never where S is not a
    multiple of the chunk (plain attention then, as in the JAX package)."""
    if seq_len % _attn_chunk(seq_len):
        return False
    if cfg.attention_impl == "chunked":
        return True
    if cfg.attention_impl != "auto":
        return False
    min_s = _env_int("TORCHFT_TPU_ATTN_CHUNKED_MIN_S")
    return seq_len >= (1024 if min_s is None else min_s)


# ---------------------------------------------------------------------------
# layouts under a mesh (the JAX package's sharding constraints)
# ---------------------------------------------------------------------------

# activations [B, S, D]: batch over (dp, fsdp), sequence over sp
_ACT = P(("dp", "fsdp"), "sp", None)
# q/k/v and attention's output [B, S, H, Dh]: heads over tp too
_HEADS = P(("dp", "fsdp"), "sp", "tp", None)
# targets and the loss mask [B, S], laid out as the activations
_ROWS = P(("dp", "fsdp"), "sp")
# tokens while the targets are shifted (the roll crosses the sp blocks)
_WHOLE_ROWS = P(("dp", "fsdp"), None)


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


def _mm(h, w, mesh):
    """``h @ w`` for an activation [..., K] and a weight [K, N]. Under sp
    the activation's sequence dim is sharded, and DTensor's matmul
    flattens [B, S] first, which torch 2.11 refuses for a sharded second
    dim: each rank multiplies its own shards under ``local_map`` instead.
    Per mesh dim: a contraction sharded on both sides gives a partial sum;
    a weight sharded over N shards the output's last dim, and the
    activation's gradient (each rank's share of N) is summed over that dim;
    the activation's batch or sequence shards carry over, and the weight's
    gradient (each rank's share of the rows) is summed over them."""
    if mesh is None or axis_size(mesh, "sp") == 1:
        return h @ w
    from torch.distributed.tensor import Partial, Replicate, Shard

    last = h.ndim - 1
    hp, wp, out, h_sums, w_sums = list(h.placements), list(w.placements), [], [], []
    for i in range(mesh.ndim):
        h_k = isinstance(hp[i], Shard) and hp[i].dim == last
        w_k = isinstance(wp[i], Shard) and wp[i].dim == 0
        if h_k and w_k:
            out.append(Partial())
            continue
        hp[i] = Replicate() if h_k else hp[i]  # contract whole on this mesh dim
        wp[i] = Replicate() if w_k else wp[i]
        if isinstance(wp[i], Shard):
            out.append(Shard(last))
            h_sums.append(mesh.get_group(i))
        else:
            out.append(hp[i])
            if isinstance(hp[i], Shard):
                w_sums.append(mesh.get_group(i))

    def local_mm(hl, wl):
        for group in h_sums:
            hl = sum_grads(hl, group)
        for group in w_sums:
            wl = sum_grads(wl, group)
        return hl @ wl

    return _local_map(local_mm, out, (hp, wp), mesh)(h, w)


def _attend(q, k, v, cfg: TransformerConfig, sp_group=None, sp_size: int = 1):
    """Rotary embedding and causal attention, per (batch, head): what each
    rank runs on its shard. Under ``sp`` (``sp_size`` above 1) q/k/v are
    this rank's block of the sequence, at positions offset by its rank in
    ``sp_group``, and attention is the ring."""
    s = q.shape[1]
    positions = torch.arange(s, device=q.device)
    if sp_size > 1:
        import torch.distributed as dist

        positions = positions + dist.get_rank(sp_group) * s
    q = rotary_embed(q, positions, cfg.rope_theta)
    k = rotary_embed(k, positions, cfg.rope_theta)
    if sp_size > 1:
        return ring_attention_local(q, k, v, sp_size, causal=True, group=sp_group)
    if _use_flash(cfg, s, q.device):
        return flash_attention(q, k, v, causal=True)
    if _use_chunked(cfg, s):
        return chunked_attention(q, k, v, causal=True, chunk=_attn_chunk(s),
                                 tiers=_attn_tiers())
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
    sharded (the JAX ``_flash_sharded``, and its ring's ``shard_map``):
    batch over (dp, fsdp), sequence over sp, heads over tp, each rank on
    its own shard."""
    if mesh is None:
        return _attend(q, k, v, cfg)
    heads = placements(_HEADS, mesh)
    sp = axis_size(mesh, "sp")
    fn = functools.partial(_attend, cfg=cfg, sp_size=sp,
                           sp_group=mesh.get_group("sp") if sp > 1 else None)
    return _local_map(fn, heads, (heads, heads, heads), mesh)(q, k, v)


def _layer(x: torch.Tensor, lp: Dict[str, torch.Tensor], cfg: TransformerConfig,
           mesh=None) -> torch.Tensor:
    if mesh is not None:
        x = _constrain(x, mesh, _ACT)
        lp = {k: _gather_fsdp(w, mesh) for k, w in lp.items()}
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    b, s, _ = h.shape
    q = _mm(h, lp["wq"], mesh).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = _mm(h, lp["wk"], mesh).reshape(b, s, cfg.n_heads, cfg.head_dim)
    v = _mm(h, lp["wv"], mesh).reshape(b, s, cfg.n_heads, cfg.head_dim)
    att = _attention(q, k, v, cfg, mesh)
    # under tp the projections' partial sums are reduced before the residual
    x = x + _constrain(_mm(att.reshape(b, s, cfg.qkv_dim), lp["wo"], mesh), mesh, _ACT)
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    # SwiGLU (``ops.layers.swiglu``), its products by _mm
    ffn = _mm(F.silu(_mm(h, lp["w_gate"], mesh)) * _mm(h, lp["w_in"], mesh), lp["w_out"], mesh)
    return x + _constrain(ffn, mesh, _ACT)


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


def _local(x, mesh, spec: P) -> torch.Tensor:
    """This rank's shard of ``x`` laid out by ``spec`` (``x`` itself
    without a mesh)."""
    return x if mesh is None else _constrain(x, mesh, spec).to_local()


def _global(x: torch.Tensor, mesh, spec: P):
    """The inverse of :func:`_local`: this rank's shard as the DTensor it
    is a shard of (every sharded dim split evenly)."""
    if mesh is None:
        return x
    from torch.distributed.tensor import Shard

    place_ = placements(spec, mesh)
    shape = list(x.shape)
    for i, p in enumerate(place_):
        if isinstance(p, Shard):
            shape[p.dim] *= mesh.size(i)
    return from_shard(x, shape, mesh, place_)


def _stage_fn(cfg: TransformerConfig, inner) -> Callable[..., torch.Tensor]:
    """One pipeline stage (the JAX ``_make_stage_fn``): its ``Lp`` layers on
    this rank's activations [mb, S, D], on the mesh less ``pp``."""
    layer = _layer_fn(cfg)

    def stage_fn(stage: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        x = _global(x, inner, _ACT)
        for i in range(stage["wq"].shape[0]):
            x = layer(x, {k: v[i] for k, v in stage.items()}, cfg, inner)
        return _local(x, inner, _ACT)

    return stage_fn


def _microbatched(x: torch.Tensor, m: int) -> torch.Tensor:
    """This rank's rows [B, ...] as ``m`` microbatches [m, B / m, ...]."""
    if x.shape[0] % m:
        raise ValueError(f"a rank's batch of {x.shape[0]} rows does not divide into {m} "
                         "microbatches")
    return x.reshape(m, x.shape[0] // m, *x.shape[1:])


def _hidden_states(
    params: Dict[str, Any], tokens: torch.Tensor, cfg: TransformerConfig, mesh=None
) -> torch.Tensor:
    """tokens [B, S] -> final-norm hidden states [B, S, D] in cfg.dtype."""
    check_mesh(mesh, cfg)
    dt = cfg.dtype
    x = _embed_lookup(params, tokens, dt, mesh)
    layers = {k: v.to(dt) for k, v in params["layers"].items()}
    if max(cfg.pp, 1) == 1:
        layer = _layer_fn(cfg)
        for i in range(layers["wq"].shape[1]):
            lp = {k: v[0, i] for k, v in layers.items()}
            x = layer(x, lp, cfg, mesh)
    else:
        from torchft_tpu_torch.parallel.pipeline import pipeline_forward

        x_loc = _local(x, mesh, _ACT)
        x_mb = _microbatched(x_loc, cfg.microbatches or cfg.pp)
        out = pipeline_forward(layers, x_mb, _stage_fn(cfg, without_axis(mesh, "pp")), mesh)
        x = _global(out.reshape(x_loc.shape), mesh, _ACT)
    return rms_norm(x, params["final_norm"].to(dt), cfg.norm_eps)


def forward(
    params: Dict[str, Any], tokens: torch.Tensor, cfg: TransformerConfig, mesh=None
) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V] in float32 (sharded: a DTensor,
    batch over (dp, fsdp), vocab over tp)."""
    x = _hidden_states(params, tokens, cfg, mesh)
    return _mm(x, _gather_fsdp(params["out"].to(cfg.dtype), mesh), mesh).float()


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
    """Targets and mask, laid out as the activations (the roll runs on
    whole sequences, across the sp blocks)."""
    if mesh is None:
        return _shifted_local(tokens)
    rows = placements(_WHOLE_ROWS, mesh)
    targets, mask = _local_map(_shifted_local, (rows, rows), (rows,), mesh)(tokens)
    return _constrain(targets, mesh, _ROWS), _constrain(mask, mesh, _ROWS)


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets[..., None])[..., 0]


def _nll_sum_local(logits, targets, mask):
    return torch.sum(_nll(logits, targets) * mask)


def _nll_sum(logits, targets, mask, mesh=None):
    """sum(nll * mask) over the rows: each rank sums its rows (the vocab
    gathered over tp first), a partial sum over (dp, fsdp, sp)."""
    if mesh is None:
        return _nll_sum_local(logits, targets, mask)
    from torch.distributed.tensor import Partial, Shard

    rows = placements(_ROWS, mesh)
    batch = [Partial() if isinstance(p, Shard) else p for p in rows]
    logit_rows = placements(P(("dp", "fsdp"), "sp", None), mesh)
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
    back a plain tensor, equal on every rank. With ``pp`` above 1 the head
    runs on the pipeline's last stage (:func:`_pipelined_loss`). Under
    ``sp`` the dense head stays (its logits are S / sp a rank), as in the
    JAX package."""
    if max(cfg.pp, 1) > 1 and mesh is not None:
        return _pipelined_loss(params, tokens, cfg, mesh)
    b, s = tokens.shape
    if (axis_size(mesh, "sp") == 1
            and _per_device_logit_elems(cfg, b, s, mesh) > _loss_chunk_elems()):
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


def _pipelined_loss(
    params: Dict[str, Any], tokens: torch.Tensor, cfg: TransformerConfig, mesh
) -> torch.Tensor:
    """The loss at ``pp`` above 1 with the pipeline's cheap exit: the final
    norm, unembed and NLL run on the last stage, and only the NLL sum and
    the token count cross the stages (the JAX ``_pipelined_loss``). The
    targets are shifted before the pipeline, on whole sequences."""
    from torchft_tpu_torch.parallel.pipeline import pipeline_forward

    dt = cfg.dtype
    m = cfg.microbatches or cfg.pp
    inner = without_axis(mesh, "pp")
    x = _local(_embed_lookup(params, tokens, dt, mesh), mesh, _ACT)
    targets, mask = _shifted(tokens, mesh)
    layers = {k: v.to(dt) for k, v in params["layers"].items()}
    head_params = {"final_norm": params["final_norm"].to(dt), "out": params["out"].to(dt)}

    def head_fn(hp, outs, t, msk):
        h = _global(outs.reshape(-1, *outs.shape[2:]), inner, _ACT)
        t = _global(t.reshape(-1, t.shape[-1]), inner, _ROWS)
        msk = _global(msk.reshape(-1, msk.shape[-1]), inner, _ROWS)
        h = rms_norm(h, hp["final_norm"], cfg.norm_eps)
        nll = _nll_sum(_mm(h, _gather_fsdp(hp["out"], inner), inner).float(), t, msk, inner)
        return {"nll": _total(nll, inner), "cnt": _total(torch.sum(msk), inner)}

    res = pipeline_forward(
        layers, _microbatched(x, m), _stage_fn(cfg, inner), mesh, head_fn=head_fn,
        head_params=head_params,
        head_extras=(_microbatched(_local(targets, mesh, _ROWS), m),
                     _microbatched(_local(mask, mesh, _ROWS), m)),
    )
    return res["nll"] / res["cnt"]
