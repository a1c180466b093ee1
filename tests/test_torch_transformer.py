"""The port's transformer against the JAX package's: the same params (the
JAX init carried across with ``params_from_jax``) and the same tokens give
the same loss and gradients, on the CPU in float32.

Tolerances: float32 end to end, so the loss agrees to summation order
(rtol 1e-5); gradients after two layers of attention and the vocabulary
softmax are compared at atol 2e-5, relative to values of order 1e-2..1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchft_tpu.models import transformer as J
from torchft_tpu_torch.models import transformer as T
from torchft_tpu_torch.ops import flash_attention as fa
from torchft_tpu_torch.utils.tree import tree_leaves

# the small configurations of tests/test_flash_attention.py
ATTN_BASE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64)
CHUNK_BASE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=16, d_ff=64)
# the head dims the card's flash kernels take beside 64: the Llama-2-7B
# preset's 128 (examples/train_hsdp.py) at two narrow layers, and
# examples/train_bytes.py's model (head dim 32) as it is
HD128_BASE = dict(vocab_size=64, d_model=256, n_layers=2, n_heads=2, head_dim=128, d_ff=256)
HD32_BASE = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=4, head_dim=32, d_ff=352)


def _jax_params(base):
    params = J.init_params(jax.random.PRNGKey(0), J.TransformerConfig(**base, dtype=jnp.float32))
    return jax.tree_util.tree_map(np.asarray, params)


def _tokens(shape, vocab=64):
    return np.random.default_rng(0).integers(0, vocab, shape).astype(np.int32)


def _port_loss_and_grads(np_params, tokens, cfg):
    params = T.params_from_jax(np_params, device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = T.loss_fn(params, torch.from_numpy(tokens), cfg)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.numpy() for g in grads]


def _jax_loss_and_grads(np_params, tokens, cfg):
    loss, grads = jax.value_and_grad(lambda p: J.loss_fn(p, jnp.asarray(tokens), cfg, None))(
        jax.tree_util.tree_map(jnp.asarray, np_params)
    )
    return float(loss), [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]


def test_params_from_jax_round_trip():
    np_params = _jax_params(ATTN_BASE)
    params = T.params_from_jax(np_params, device="cpu")
    jleaves, jdef = jax.tree_util.tree_flatten(np_params)
    tleaves = tree_leaves(params)
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, params)
    ) == jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0, np_params))
    assert len(jleaves) == len(tleaves)
    for a, t in zip(jleaves, tleaves):
        assert t.dtype == torch.float32 and t.shape == a.shape
        np.testing.assert_array_equal(t.numpy(), a)
    # and the port's own init has the same tree and shapes
    own = T.init_params(
        T.TransformerConfig(**ATTN_BASE, dtype=torch.float32), torch.Generator().manual_seed(0),
        device="cpu",
    )
    assert [tuple(t.shape) for t in tree_leaves(own)] == [a.shape for a in jleaves]


@pytest.mark.parametrize(
    "base,impl",
    [
        pytest.param(base, impl, id=impl if name == "hd8" else f"{name}-{impl}")
        for name, base in (("hd8", ATTN_BASE), ("hd128", HD128_BASE), ("hd32", HD32_BASE))
        for impl in ("flash", "plain")
    ],
)
def test_loss_and_grads_match_jax(base, impl):
    np_params = _jax_params(base)
    tokens = _tokens((4, 128), vocab=base["vocab_size"])
    jl, jg = _jax_loss_and_grads(
        np_params, tokens, J.TransformerConfig(**base, dtype=jnp.float32, attention_impl=impl)
    )
    tl, tg = _port_loss_and_grads(
        np_params, tokens, T.TransformerConfig(**base, dtype=torch.float32, attention_impl=impl)
    )
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, atol=2e-5)


def test_chunked_loss_head_matches_jax_and_dense(monkeypatch):
    """TORCHFT_TPU_LOSS_CHUNK_ELEMS=64 forces the chunked head on the tiny
    shape (as the JAX test does); it must equal both the JAX chunked head
    and the port's own dense head."""
    np_params = _jax_params(CHUNK_BASE)
    tokens = _tokens((2, 16))
    tcfg = T.TransformerConfig(**CHUNK_BASE, dtype=torch.float32)
    dense_l, dense_g = _port_loss_and_grads(np_params, tokens, tcfg)
    monkeypatch.setenv("TORCHFT_TPU_LOSS_CHUNK_ELEMS", "64")
    tl, tg = _port_loss_and_grads(np_params, tokens, tcfg)
    jl, jg = _jax_loss_and_grads(
        np_params, tokens, J.TransformerConfig(**CHUNK_BASE, dtype=jnp.float32)
    )
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tl, dense_l, rtol=1e-6)
    for a, b, c in zip(tg, jg, dense_g):
        np.testing.assert_allclose(a, b, atol=2e-5)
        np.testing.assert_allclose(a, c, atol=1e-6)


def test_bf16_forward_close_to_jax():
    """The headline's compute dtype: bf16 forward from the same f32 masters
    (logits in f32; bf16 rounding throughout, so 5e-2 absolute on logits
    of order 1)."""
    np_params = _jax_params(ATTN_BASE)
    tokens = _tokens((2, 128))
    jcfg = J.TransformerConfig(**ATTN_BASE, dtype=jnp.bfloat16, attention_impl="plain")
    tcfg = T.TransformerConfig(**ATTN_BASE, dtype=torch.bfloat16, attention_impl="plain")
    expect = np.asarray(J.forward(jax.tree_util.tree_map(jnp.asarray, np_params), jnp.asarray(tokens), jcfg))
    got = T.forward(T.params_from_jax(np_params, device="cpu"), torch.from_numpy(tokens), tcfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), expect, atol=5e-2)


def test_attention_routing():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    auto = T.TransformerConfig(attention_impl="auto")
    assert not T._use_flash(auto, 1024, cpu)
    assert T._use_flash(auto, 1024, cuda)
    # "auto" asks what the op takes: the kernels' shapes and the op's block
    # rule (the Pallas op's, S a multiple of min(128, S)); a short S passes,
    # an S past 128 that is not a multiple of it goes to plain attention
    assert not T._use_flash(auto, 1000, cuda)
    assert not T._use_flash(auto, 192, cuda)

    def auto_at(head_dim, dtype=torch.bfloat16):
        return T.TransformerConfig(head_dim=head_dim, dtype=dtype, attention_impl="auto")

    assert T._use_flash(auto_at(128), 4096, cuda)
    assert T._use_flash(auto_at(32), 128, cuda)
    assert T._use_flash(auto_at(8, torch.float32), 16, cuda)
    assert not T._use_flash(auto_at(8, torch.float32), 16, cpu)
    for head_dim in (8, 16):
        for dtype in (torch.float32, torch.bfloat16):
            assert T._use_flash(auto_at(head_dim, dtype), 48, cuda)
            assert not T._use_flash(auto_at(head_dim, dtype), 200, cuda)
    # every head dim up to 256 in both types at any S the op's blocks take
    # (96 padded to 128, float32 at 128 and 256 on the FMA kernels, bf16 at
    # 128 and S 16 on wgmma, the last tile masked) ...
    assert T._use_flash(auto_at(96), 128, cuda)
    assert T._use_flash(auto_at(128, torch.float32), 128, cuda)
    assert T._use_flash(auto_at(128), 100, cuda)
    assert T._use_flash(auto_at(128), 16, cuda)  # train_hsdp's llama2-7b at its SEQ 16
    assert T._use_flash(auto_at(256, torch.float32), 128, cuda)
    assert T._use_flash(auto_at(32, torch.float32), 128, cuda)
    # ... and sends a head dim above 256 to plain attention instead of to
    # the op, which raises there
    assert not T._use_flash(auto_at(257), 128, cuda)
    assert not T._use_flash(auto_at(512, torch.float32), 128, cuda)
    for head_dim in (8, 16, 32, 64, 96, 128, 256, 257):
        for dtype in (torch.float32, torch.bfloat16):
            for s in (16, 48, 100, 128, 192, 200, 320, 1000, 1024, 4096):
                routed = T._use_flash(auto_at(head_dim, dtype), s, cuda)
                assert routed == fa.op_supported(dtype, head_dim, s)
                assert routed == (s % min(128, s) == 0 and fa.supported(dtype, head_dim, s))
                if routed:
                    # the op's own shape check passes where "auto" routes to it
                    q = torch.zeros(1, s, 1, head_dim, dtype=dtype)
                    fa.flash_attention(q, q, q)
                elif fa.supported(dtype, head_dim, s):
                    q = torch.zeros(1, s, 1, head_dim, dtype=dtype)
                    with pytest.raises(ValueError, match="multiple of block sizes"):
                        fa.flash_attention(q, q, q)
    assert T._use_flash(T.TransformerConfig(attention_impl="flash"), 100, cpu)
    # "chunked" never goes to the flash op; it runs chunked attention
    # (tests/test_torch_chunked_attention.py), and "auto" takes it on the
    # CPU from S 1024, as the JAX package does there
    chunked = T.TransformerConfig(attention_impl="chunked")
    assert not T._use_flash(chunked, 1024, cuda) and T._use_chunked(chunked, 1024)
    assert T._use_chunked(auto, 1024) and not T._use_chunked(auto, 512)
    with pytest.raises(ValueError, match="attention_impl"):
        T._use_flash(T.TransformerConfig(attention_impl="xla"), 1024, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("seq", [16, 192])
def test_auto_forward_on_card(seq):
    """``"auto"`` on the card, head dim 8 in float32: at S 16 the flash
    kernels run (one forward launch a layer), at S 192 (past 128 and not a
    multiple of it, which the op refuses) plain attention does. Logits
    against the plain forward on the CPU at 2e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    np_params = _jax_params(ATTN_BASE)
    tokens = torch.from_numpy(_tokens((2, seq)))
    cfg = T.TransformerConfig(**ATTN_BASE, dtype=torch.float32, attention_impl="auto")
    expect = T.forward(T.params_from_jax(np_params, device="cpu"), tokens, cfg)
    fa.reset_launches()
    got = T.forward(T.params_from_jax(np_params, device="cuda"), tokens.cuda(), cfg)
    assert fa.LAUNCHES["flash_fwd"] == (ATTN_BASE["n_layers"] if seq == 16 else 0)
    np.testing.assert_allclose(got.cpu().numpy(), expect.numpy(), atol=2e-5)


def test_fused_train_step_matches_optax_adamw():
    """One fused step: the port's TrainStep (torch AdamW set to optax's
    defaults, weight decay 1e-4) vs the JAX TrainStep with
    ``optax.adamw(3e-4)``, from the same params and tokens. The update is
    ~3e-4 per element; the two AdamW formulations round differently at
    float32, so the new params agree to 1e-6."""
    import optax

    from torchft_tpu.parallel.mesh import MeshConfig, make_mesh
    from torchft_tpu.parallel.train_step import TrainStep as JTrainStep
    from torchft_tpu_torch.parallel.train_step import TrainStep

    np_params = _jax_params(ATTN_BASE)
    tokens = _tokens((2, 64))
    jts = JTrainStep(
        J.TransformerConfig(**ATTN_BASE, dtype=jnp.float32, attention_impl="plain"),
        optax.adamw(3e-4), make_mesh(MeshConfig(), jax.devices()[:1]),
    )
    jparams = jax.device_put(np_params, jts._param_shardings)
    jl, jnew, _ = jts.step(jparams, jts.init_opt(jparams), jts.shard_batch(jnp.asarray(tokens)))
    ts = TrainStep(T.TransformerConfig(**ATTN_BASE, dtype=torch.float32, attention_impl="plain"),
                   device="cpu")
    params = T.params_from_jax(np_params, device="cpu")
    tl, tnew, _ = ts.step(params, ts.init_opt(params), torch.from_numpy(tokens))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for t, j, before in zip(tree_leaves(tnew), jax.tree_util.tree_leaves(jnew),
                            jax.tree_util.tree_leaves(np_params)):
        assert not np.array_equal(t.detach().numpy(), before)  # the step moved it
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=1e-6)


@pytest.mark.parametrize(
    "remat,policy", [(False, "all"), (True, "all"), (True, "dots")],
    ids=["no-remat", "all", "dots"],
)
def test_remat_policies_match_jax(remat, policy):
    """Loss and gradients under each ``remat`` setting against the JAX
    package's same config (the recompute changes no value: same tolerances
    as above)."""
    np_params = _jax_params(ATTN_BASE)
    tokens = _tokens((4, 128))
    kw = dict(attention_impl="flash", remat=remat, remat_policy=policy)
    jl, jg = _jax_loss_and_grads(np_params, tokens,
                                 J.TransformerConfig(**ATTN_BASE, dtype=jnp.float32, **kw))
    tl, tg = _port_loss_and_grads(np_params, tokens,
                                  T.TransformerConfig(**ATTN_BASE, dtype=torch.float32, **kw))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, atol=2e-5)


def test_unknown_remat_policy_raises_as_jax_does():
    np_params = _jax_params(ATTN_BASE)
    tokens = _tokens((2, 16))
    with pytest.raises(ValueError, match="remat_policy"):
        _jax_loss_and_grads(np_params, tokens,
                            J.TransformerConfig(**ATTN_BASE, dtype=jnp.float32, remat_policy="dot"))
    with pytest.raises(ValueError, match="remat_policy"):
        _port_loss_and_grads(np_params, tokens,
                             T.TransformerConfig(**ATTN_BASE, dtype=torch.float32,
                                                 remat_policy="dot"))
    # without remat the policy is not read, in both packages
    cfg = T.TransformerConfig(**ATTN_BASE, dtype=torch.float32, remat=False, remat_policy="dot")
    _port_loss_and_grads(np_params, tokens, cfg)


def test_dots_policy_recomputes_no_projection():
    """What the backward runs, counted by ATen op: without remat it runs the
    7 projections' 14 gradient products per layer (plus 2 for the unembed);
    ``"all"`` also recomputes the forward, its projections included (but
    ``w_out``, whose output no backward needs: the recompute stops early);
    ``"dots"`` recomputes the attention's batched products (``bmm``) and no
    projection, as JAX's ``dots_with_no_batch_dims_saveable`` does."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[func] = self.ops.get(func, 0) + 1
            return func(*args, **(kwargs or {}))

    np_params = _jax_params(ATTN_BASE)
    tokens = torch.from_numpy(_tokens((2, 16)))
    layers = ATTN_BASE["n_layers"]
    counts = {}
    for name, remat, policy in (("none", False, "all"), ("all", True, "all"),
                                ("dots", True, "dots")):
        cfg = T.TransformerConfig(**ATTN_BASE, dtype=torch.float32, attention_impl="plain",
                                  remat=remat, remat_policy=policy)
        params = T.params_from_jax(np_params, device="cpu")
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = T.loss_fn(params, tokens, cfg)
        with Count() as c:
            torch.autograd.grad(loss, leaves)
        counts[name] = (c.ops.get(torch.ops.aten.mm.default, 0),
                        c.ops.get(torch.ops.aten.bmm.default, 0))
    assert counts["none"] == (14 * layers + 2, 4 * layers)
    assert counts["all"] == (20 * layers + 2, 6 * layers)
    assert counts["dots"] == (14 * layers + 2, 6 * layers)
