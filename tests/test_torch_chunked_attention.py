"""The port's chunked attention against the JAX package's
(``tests/test_flash_attention.py::TestChunkedAttention``): the same numpy
q, k, v through JAX ``chunked_attention`` and the port's, on the CPU in
float32.

Bars: outputs at atol 2e-5 and rtol 2e-5 (the JAX test's bar against
plain attention); gradients of ``sum(out ** 2)`` at atol 1e-4 and rtol
1e-4 (the JAX test's). The model routes ``"chunked"`` and, past
``TORCHFT_TPU_ATTN_CHUNKED_MIN_S``, ``"auto"`` to it; its loss and
gradients agree with the JAX model's on the same route at the bars of
``tests/test_torch_transformer.py`` (rtol 1e-5, atol 2e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchft_tpu.models import transformer as J
from torchft_tpu.ops.attention import chunked_attention as jchunked
from torchft_tpu_torch.models import transformer as T
from torchft_tpu_torch.ops import attention as A
from torchft_tpu_torch.parallel.train_step import TrainStep
from torchft_tpu_torch.utils.tree import tree_leaves


def _qkv(s, b=2, h=4, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))


def _port(fn, qkv, **kw):
    return fn(*(torch.from_numpy(x) for x in qkv), **kw).numpy()


@pytest.mark.parametrize("s,chunk,tiers", [(512, 128, 4), (256, 64, 1), (384, 64, 3),
                                           (384, 64, 4)])
def test_matches_jax(s, chunk, tiers):
    """The JAX grid, and a tier count that does not divide S into whole
    chunks (4 at S 384, chunk 64: both degrade to 3)."""
    qkv = _qkv(s)
    want = np.asarray(jchunked(*map(jnp.asarray, qkv), causal=True, chunk=chunk, tiers=tiers))
    got = _port(A.chunked_attention, qkv, causal=True, chunk=chunk, tiers=tiers)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, _port(A.attention, qkv, causal=True), rtol=2e-5, atol=2e-5)


def test_non_causal_matches_jax():
    qkv = _qkv(256)
    want = np.asarray(jchunked(*map(jnp.asarray, qkv), causal=False, chunk=64))
    got = _port(A.chunked_attention, qkv, causal=False, chunk=64)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_grad_matches_jax():
    qkv = _qkv(256)
    want = jax.grad(lambda q, k, v: (jchunked(q, k, v, causal=True, chunk=64, tiers=4) ** 2)
                    .sum(), argnums=(0, 1, 2))(*map(jnp.asarray, qkv))
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in qkv)
    (A.chunked_attention(q, k, v, causal=True, chunk=64, tiers=4) ** 2).sum().backward()
    for g, w in zip((q.grad, k.grad, v.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


CFG = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, head_dim=16, d_ff=128)


def test_model_routes_chunked(monkeypatch):
    """``"chunked"`` runs chunked attention; ``"auto"`` engages it past the
    S threshold (lowered by the environment for a CPU-sized check); the
    loss and gradients equal the JAX model's on that route; a TrainStep
    step stays finite."""
    cfg = T.TransformerConfig(**CFG, dtype=torch.float32, attention_impl="chunked")
    assert T._use_chunked(cfg, 512)
    assert not T._use_chunked(cfg, 500)  # not a multiple of the chunk: plain
    monkeypatch.setenv("TORCHFT_TPU_ATTN_CHUNKED_MIN_S", "512")
    auto = T.TransformerConfig(**CFG, dtype=torch.float32, attention_impl="auto")
    assert T._use_chunked(auto, 512) and not T._use_chunked(auto, 256)
    monkeypatch.setenv("TORCHFT_TPU_ATTN_CHUNK", "64")
    monkeypatch.setenv("TORCHFT_TPU_ATTN_TIERS", "2")
    assert (T._attn_chunk(512), T._attn_tiers()) == (64, 2)

    calls = []

    def counted(*args, **kw):
        calls.append(kw)
        return A.chunked_attention(*args, **kw)

    monkeypatch.setattr(T, "chunked_attention", counted)
    jcfg = J.TransformerConfig(**CFG, dtype=jnp.float32, attention_impl="auto")
    np_params = jax.tree_util.tree_map(np.asarray, J.init_params(jax.random.PRNGKey(0), jcfg))
    tokens = np.random.default_rng(0).integers(0, CFG["vocab_size"], (2, 512)).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(lambda p: J.loss_fn(p, jnp.asarray(tokens), jcfg, None))(
        jax.tree_util.tree_map(jnp.asarray, np_params))
    params = T.params_from_jax(np_params, device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = T.loss_fn(params, torch.from_numpy(tokens), auto)
    # one call a layer in the forward (remat calls it again in the backward)
    assert calls == [dict(causal=True, chunk=64, tiers=2)] * CFG["n_layers"]
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for g, w in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)

    ts = TrainStep(cfg, device="cpu")
    params = ts.init_params(seed=0)
    loss, params, _ = ts.step(params, ts.init_opt(params), torch.from_numpy(tokens))
    assert np.isfinite(float(loss))
