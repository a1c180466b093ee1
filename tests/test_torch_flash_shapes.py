"""The port's flash attention op at the shapes the Pallas op takes beyond
head dims 8-64: 128 in float32, 256, and head dims the kernels are not
built at, which the op pads with zero columns.

The same numpy inputs go through ``torchft_tpu.ops.pallas.flash_attention``
(interpret mode on the CPU, as its own tests run it) and the port: the
forward and the three gradients, from one cotangent, at the JAX test bars
(float32: 2e-5 on the output, 3e-4 on the gradients). On the CPU the op
takes the plain route, so the padding path the card runs
(``flash_attention._flash_packed``: the zero columns, the true head dim's
scale, the slice back) is held here with the kernels' plain versions in
place of the kernels. The CUDA kernels at these shapes are held by
``tests/test_torch_flash_attention.py``'s card cases and ``chip_smoke.py``.
The port's transformer at head dim 256 (the shape of ``chip_smoke.py``
phase 23 (c), narrowed) is held against the JAX package's with its
``"flash"`` through the Pallas op in interpret mode.
"""

import functools

import numpy as np
import pytest
import torch

from torchft_tpu_torch.ops import flash_attention as fa

O_BAR, GRAD_BAR = 2e-5, 3e-4  # the JAX test bars (float32 summation order only)


def _inputs(s, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, s, 2, d)).astype(np.float32) for _ in range(4)]


@functools.lru_cache(maxsize=None)
def _jax_vjp(s, d, seed, causal, block):
    """The Pallas op's output and q/k/v gradients for the cotangent of
    ``_inputs(s, d, seed)``, in one jitted call (one compile of the
    forward and both backward kernels)."""
    jax = pytest.importorskip("jax")
    from torchft_tpu.ops.pallas.flash_attention import flash_attention

    @jax.jit
    def run(q, k, v, w):
        o, vjp = jax.vjp(lambda q, k, v: flash_attention(q, k, v, causal=causal, block_q=block,
                                                         block_k=block), q, k, v)
        return o, vjp(w)

    o, grads = run(*_inputs(s, d, seed))
    return np.asarray(o), [np.asarray(g) for g in grads]


def _port(op, q, k, v, w):
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = op(*ts)
    o.backward(torch.from_numpy(w))
    return o.detach().numpy(), [t.grad.numpy() for t in ts]


def _hold(got, expect):
    (o, grads), (eo, egrads) = got, expect
    np.testing.assert_allclose(o, eo, atol=O_BAR)
    for g, e in zip(grads, egrads):
        np.testing.assert_allclose(g, e, atol=GRAD_BAR)


@pytest.fixture
def plain_kernels(monkeypatch):
    """The kernels' plain versions in place of the kernels, recording the
    head dim and scale each call was given."""
    calls = []

    def recording(plain):
        def call(q, *args, scale=None, **kw):
            calls.append((q.shape[-1], scale))
            return plain(q, *args, scale=scale, **kw)
        return call

    for kernel, plain in (("fwd_kernel", fa.fwd_plain), ("dq_kernel", fa.dq_plain),
                          ("dkv_kernel", fa.dkv_plain)):
        monkeypatch.setattr(fa, kernel, recording(plain))
    return calls


def _padded_op(causal):
    return lambda q, k, v: fa._flash_packed(q, k, v, causal)


# S 96 takes blocks of 32 alone (the op's rule: S a multiple of the blocks)
GRID = [pytest.param(d, s, block, causal,
                     id=f"d{d}-s{s}-b{block}-{'causal' if causal else 'full'}")
        for d in (96, 128, 256) for s, block in ((96, 32), (128, 32), (128, 64))
        for causal in (True, False)]


@pytest.mark.parametrize("d,s,block,causal", GRID)
def test_op_matches_jax_kernels(d, s, block, causal, plain_kernels):
    """The op (its plain route on the CPU) against the Pallas op: forward
    and the q/k/v gradients. At head dim 96 also the padding route (96 to
    128, the kernels' plain versions in the kernels' place) against the
    same Pallas results."""
    q, k, v, w = _inputs(s, d, seed=d + s + block)
    expect = _jax_vjp(s, d, d + s + block, causal, block)
    _hold(_port(lambda *x: fa.flash_attention(*x, causal=causal, block_q=block,
                                              block_k=block), q, k, v, w), expect)
    if d == 96:
        _hold(_port(_padded_op(causal), q, k, v, w), expect)
        assert {c[0] for c in plain_kernels} == {128}
        assert {c[1] for c in plain_kernels} == {96 ** -0.5}


@pytest.mark.parametrize("d", [40, 80, 200])
def test_padding_matches_jax_kernels(d, plain_kernels):
    """The padding route at head dims the kernels are not built at (40 to
    64, 80 to 128, 200 to 256) against the Pallas op at the true head dim:
    the zero columns add exact zeros, and the scores scale by the true
    head dim's d^-0.5 (the padded one's would move every score)."""
    q, k, v, w = _inputs(64, d, seed=d)
    expect = _jax_vjp(64, d, d, True, 64)
    got = _port(_padded_op(True), q, k, v, w)
    _hold(got, expect)
    assert got[0].shape == (2, 64, 2, d)
    assert {c[0] for c in plain_kernels} == {fa.padded_head_dim(d)}
    assert {c[1] for c in plain_kernels} == {d ** -0.5}


def test_wrong_scale_is_caught(plain_kernels, monkeypatch):
    """The padding test's bar sees the likeliest fault: the padded head
    dim's scale in place of the true one."""
    real = fa._Flash.apply
    monkeypatch.setattr(fa._Flash, "apply",
                        lambda q, k, v, causal, scale: real(q, k, v, causal,
                                                            q.shape[-1] ** -0.5))
    q, k, v, w = _inputs(64, 80, seed=80)
    expect = _jax_vjp(64, 80, 80, True, 64)  # test_padding_matches_jax_kernels[80]'s
    with pytest.raises(AssertionError):
        _hold(_port(_padded_op(True), q, k, v, w), expect)


def test_padded_head_dims():
    assert [fa.padded_head_dim(d) for d in (1, 8, 9, 16, 17, 40, 64, 65, 80, 96, 128, 129,
                                            160, 200, 256)] == [
        8, 8, 16, 16, 32, 64, 64, 128, 128, 128, 128, 256, 256, 256, 256]
    assert fa.KERNEL_HEAD_DIMS == (8, 16, 32, 64, 128, 256) and fa.MAX_HEAD_DIM == 256
    with pytest.raises(ValueError, match="256"):
        fa.padded_head_dim(257)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_supported_grid(dtype):
    """``supported``: float32 and bf16 at every head dim 1-256 and S 1 to
    65535 tiles of 64; refused above 256, at S 0 or past the grid, and in
    other dtypes. ``op_supported`` adds the op's block rule (S a multiple
    of min(128, S))."""
    for d in range(1, 301):
        for s in (1, 16, 96, 100, 128, 192, 200, 1000, 1024, 4096, 65535 * 64):
            assert fa.supported(dtype, d, s) == (d <= 256)
            assert fa.op_supported(dtype, d, s) == (d <= 256 and s % min(128, s) == 0)
        assert not fa.supported(dtype, d, 0) and not fa.supported(dtype, d, 65536 * 64)
    assert not fa.supported(torch.float16, 128, 128)
    assert not fa.supported(dtype, 0, 128)


def test_op_takes_any_head_dim_on_the_cpu():
    """On the CPU the op runs plain attention at any head dim, 257 too (on
    the card it raises above 256: ``chip_smoke.py`` phase 2)."""
    x = torch.zeros(1, 16, 1, 257)
    assert fa.flash_attention(x, x, x).shape == x.shape


# phase 23 (c)'s model, the llama2-7b preset regrouped as heads of 256
# (Gemma-7B's head width), narrowed: 2 heads of 256 (d_model 512), 2 layers
HD256_BASE = dict(vocab_size=64, d_model=512, n_layers=2, n_heads=2, head_dim=256, d_ff=512)
HD256_TOKENS = (2, 64)


def _numpy_params(jcfg):
    """Weights of the JAX model's tree drawn with numpy (seed 0): matrices
    N(0, 1/fan_in), as the JAX init scales them, and norm gains 1 + N(0,
    0.1), so that the gains' gradients are not all alike."""
    from torchft_tpu.models import transformer as J

    jax = pytest.importorskip("jax")
    rng = np.random.default_rng(0)

    def leaf(path, shape):
        name = path[-1].key
        if name in ("ln1", "ln2", "final_norm"):
            return (1 + 0.1 * rng.standard_normal(shape.shape)).astype(np.float32)
        fan_in = 1 if name == "embed" else shape.shape[-2]
        return (rng.standard_normal(shape.shape) * fan_in ** -0.5).astype(np.float32)

    shapes = jax.eval_shape(lambda: J.init_params(jax.random.PRNGKey(0), jcfg))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def _jax_model_256():
    """The numpy weights, the tokens, and the JAX model's loss and gradients
    with ``"flash"``: the Pallas op, in interpret mode on the CPU."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from torchft_tpu.models import transformer as J

    jcfg = J.TransformerConfig(**HD256_BASE, dtype=jnp.float32, attention_impl="flash")
    np_params = _numpy_params(jcfg)
    tokens = np.random.default_rng(1).integers(0, HD256_BASE["vocab_size"],
                                               HD256_TOKENS).astype(np.int32)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t: J.loss_fn(p, t, jcfg, None)))(np_params, jnp.asarray(tokens))
    return np_params, tokens, float(loss), [np.asarray(g)
                                            for g in jax.tree_util.tree_leaves(grads)]


@pytest.mark.parametrize("impl", ["flash", "auto"])
def test_head_dim_256_model_matches_jax(impl):
    """The port's transformer at head dim 256 (``"flash"``, and ``"auto"``,
    which phase 23 (c) runs on the card; both take plain attention on the
    CPU) against the JAX transformer through the Pallas op, on the same
    numpy weights carried across by ``params_from_jax`` and the same
    tokens: the loss at rtol 1e-5 and every gradient at atol 2e-5 (float32
    end to end: summation order only, gradients of order 1e-3 to 1, as
    ``tests/test_torch_transformer.py``)."""
    from torchft_tpu_torch.models import transformer as T
    from torchft_tpu_torch.utils.tree import tree_leaves

    np_params, tokens, jax_loss, jax_grads = _jax_model_256()
    params = T.params_from_jax(np_params, device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    cfg = T.TransformerConfig(**HD256_BASE, dtype=torch.float32, attention_impl=impl)
    loss = T.loss_fn(params, torch.from_numpy(tokens), cfg)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), jax_loss, rtol=1e-5)
    assert len(grads) == len(jax_grads)
    for g, e in zip(grads, jax_grads):
        np.testing.assert_allclose(g.numpy(), e, atol=2e-5)
