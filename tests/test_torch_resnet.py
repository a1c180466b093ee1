"""The port's ResNet-18 (CIFAR variant) against the JAX package's: the same
params (the JAX init carried across with ``params_from_jax``) and the same
images give the same logits, new batch-norm stats, loss and gradients, on
the CPU in float32; one SGD-momentum step equals ``optax.sgd``'s.

The model is narrow (channels 4, 8, 16, 32) with every stage present, so
the stride-2 blocks, their ``"SAME"`` padding at the high end and the 1x1
downsample convs run; batch 4 of 32x32x3 images.

Tolerances: float32 end to end, differing in convolution algorithms and
summation order. Logits (order 1) at atol 1e-4; the running stats at atol
1e-5 (batch moments of order 1, times 0.1); the loss at rtol 1e-5;
gradients at atol 1e-4 beside values of order 1e-3..1 (a wrong padding or
a missing downsample moves them by their own size); SGD's new params at
atol 1e-6 (an update of 0.05 x the gradient, from equal gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchft_tpu.models import resnet as J
from torchft_tpu_torch.models import resnet as R
from torchft_tpu_torch.utils.tree import tree_leaves, tree_map

NARROW = dict(channels=(4, 8, 16, 32), blocks_per_stage=(2, 2, 2, 2))


def _jax_init(seed=0):
    params, stats = J.init(jax.random.PRNGKey(seed), J.ResNetConfig(**NARROW, dtype=jnp.float32))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return to_np(params), to_np(stats)


def _batch(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((n, 32, 32, 3), dtype=np.float32), rng.integers(0, 10, n).astype(np.int32)


def _hwio(t: torch.Tensor) -> np.ndarray:
    """A port leaf as the JAX tree holds it (conv weights OIHW -> HWIO)."""
    a = t.detach().numpy()
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a


TCFG = R.ResNetConfig(**NARROW, dtype=torch.float32)
JCFG = J.ResNetConfig(**NARROW, dtype=jnp.float32)


def test_params_from_jax_transposes_convs():
    jp, js = _jax_init()
    params, stats = R.params_from_jax(jp, js, device="cpu")
    assert jax.tree_util.tree_structure(tree_map(lambda t: 0, params)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0, jp))
    assert jax.tree_util.tree_structure(tree_map(lambda t: 0, stats)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0, js))
    for t, a in zip(tree_leaves(params), jax.tree_util.tree_leaves(jp)):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(_hwio(t), a)
    assert tuple(params["stem"]["conv"].shape) == (4, 3, 3, 3)  # OIHW
    assert tuple(params["stage1"][0]["down_conv"].shape) == (8, 4, 1, 1)
    # the port's own init has the same trees and (transposed) shapes, with
    # the residual's last BN scale at zero as in JAX
    own_p, own_s = R.init(torch.Generator().manual_seed(0), TCFG, device="cpu")
    assert [_hwio(t).shape for t in tree_leaves(own_p)] == \
        [a.shape for a in jax.tree_util.tree_leaves(jp)]
    assert [tuple(t.shape) for t in tree_leaves(own_s)] == \
        [a.shape for a in jax.tree_util.tree_leaves(js)]
    assert not own_p["stage0"][0]["bn2"]["scale"].any()


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_apply_matches_jax(train):
    jp, js = _jax_init()
    images, _ = _batch()
    if not train:  # running stats away from their init
        js = jax.tree_util.tree_map(lambda a: a * 0.5 + 0.25, js)
    jl, jst = J.apply(jax.tree_util.tree_map(jnp.asarray, jp),
                      jax.tree_util.tree_map(jnp.asarray, js), jnp.asarray(images), JCFG, train)
    params, stats = R.params_from_jax(jp, js, device="cpu")
    tl, tst = R.apply(params, stats, torch.from_numpy(images), TCFG, train)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (4, 10)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    jleaves = jax.tree_util.tree_leaves(jst)
    tleaves = tree_leaves(tst)
    assert len(jleaves) == len(tleaves)
    for t, a in zip(tleaves, jleaves):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), atol=1e-5)
    if train:  # the stats moved
        assert not np.allclose(tst["stage3"][1]["bn1"]["var"].numpy(), 1.0)


def _port_loss_grads(params, stats, images, labels):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, new_stats = R.loss_fn(params, stats, torch.from_numpy(images),
                                torch.from_numpy(labels), TCFG)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), list(grads), new_stats


@jax.jit
def _jax_value_and_grad(params, stats, images, labels):
    return jax.value_and_grad(
        lambda p: J.loss_fn(p, stats, images, labels, JCFG), has_aux=True)(params)


def _jax_loss_grads(jp, js, images, labels):
    (loss, new_stats), grads = _jax_value_and_grad(jp, js, images, labels)
    return float(loss), grads, new_stats


def test_loss_and_grads_match_jax():
    jp, js = _jax_init()
    # every BN scale away from its init, so the zero-init bn2 does not hide
    # the residual branch's gradients
    jp = jax.tree_util.tree_map(lambda a: a + 0.1 if a.ndim == 1 else a, jp)
    images, labels = _batch()
    jl, jg, jst = _jax_loss_grads(jp, js, images, labels)
    params, stats = R.params_from_jax(jp, js, device="cpu")
    tl, tg, tst = _port_loss_grads(params, stats, images, labels)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(tg) == len(jleaves)
    for t, a in zip(tg, jleaves):
        np.testing.assert_allclose(_hwio(t), np.asarray(a), atol=1e-4)
    assert max(float(t.abs().max()) for t in tg) > 1e-2  # gradients of substance
    for t, a in zip(tree_leaves(tst), jax.tree_util.tree_leaves(jst)):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), atol=1e-5)


def test_sgd_momentum_step_matches_optax():
    """Two steps of ``torch.optim.SGD(lr=0.05, momentum=0.9, dampening=0)``
    against ``optax.sgd(0.05, momentum=0.9)`` from the same gradients (the
    second step reads the momentum the first one left)."""
    jp, js = _jax_init()
    images, labels = _batch()
    tx = optax.sgd(0.05, momentum=0.9)
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    opt_state = tx.init(jparams)
    params, stats = R.params_from_jax(jp, js, device="cpu")
    opt = torch.optim.SGD(tree_leaves(params), lr=0.05, momentum=0.9, dampening=0)
    for _ in range(2):
        _, jg, _ = _jax_loss_grads(jax.tree_util.tree_map(np.asarray, jparams), js, images,
                                   labels)
        updates, opt_state = tx.update(jg, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        _, tg, _ = _port_loss_grads(params, stats, images, labels)
        for p, g in zip(tree_leaves(params), tg):
            p.grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)
        for t, a in zip(tree_leaves(params), jax.tree_util.tree_leaves(jparams)):
            np.testing.assert_allclose(_hwio(t), np.asarray(a), atol=1e-6)
        assert not np.array_equal(_hwio(tree_leaves(params)[0]),
                                  jax.tree_util.tree_leaves(jp)[0])


def test_bf16_forward_close_to_jax():
    """The card's compute dtype: bf16 convolutions from the same float32
    masters, batch-norm stats in float32 (logits of order 1 at 5e-2: bf16
    rounding through 17 convolutions)."""
    jp, js = _jax_init()
    images, _ = _batch()
    as_jnp = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    jl, _ = J.apply(as_jnp(jp), as_jnp(js), jnp.asarray(images),
                    J.ResNetConfig(**NARROW, dtype=jnp.bfloat16), True)
    params, stats = R.params_from_jax(jp, js, device="cpu")
    tl, _ = R.apply(params, stats, torch.from_numpy(images),
                    R.ResNetConfig(**NARROW, dtype=torch.bfloat16), True)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-2)


def test_same_padding_puts_the_odd_pixel_at_the_high_end():
    """A stride-2 3x3 conv on an even input against ``lax``'s "SAME"
    (padding (0, 1)), where ``padding=1`` would shift the output."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 5)).astype(np.float32)
    ref = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")))
    got = R._conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                  torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), 2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, atol=1e-5)
    shifted = torch.nn.functional.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                                         torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                                         stride=2, padding=1)
    assert not np.allclose(shifted.permute(0, 2, 3, 1).numpy(), ref, atol=1e-3)
