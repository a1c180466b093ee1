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
from torchft_tpu_torch.utils.tree import tree_leaves

# the small configurations of tests/test_flash_attention.py
ATTN_BASE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64)
CHUNK_BASE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=16, d_ff=64)


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


@pytest.mark.parametrize("impl", ["flash", "plain"])
def test_loss_and_grads_match_jax(impl):
    np_params = _jax_params(ATTN_BASE)
    tokens = _tokens((4, 128))
    jl, jg = _jax_loss_and_grads(
        np_params, tokens, J.TransformerConfig(**ATTN_BASE, dtype=jnp.float32, attention_impl=impl)
    )
    tl, tg = _port_loss_and_grads(
        np_params, tokens, T.TransformerConfig(**ATTN_BASE, dtype=torch.float32, attention_impl=impl)
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
    assert not T._use_flash(auto, 1000, cuda)
    assert T._use_flash(T.TransformerConfig(attention_impl="flash"), 100, cpu)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T._use_flash(T.TransformerConfig(attention_impl="chunked"), 1024, cuda)
    with pytest.raises(ValueError, match="attention_impl"):
        T._use_flash(T.TransformerConfig(attention_impl="xla"), 1024, cuda)


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
