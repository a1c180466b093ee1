"""The port's pipeline stages and ring attention against the JAX package's:
the same numpy inputs through the JAX functions on its virtual CPU mesh
and through the port on a DTensor mesh of gloo processes
(``tests/torch_mesh_worker.py``, no JAX in the workers).

* Ring attention (``tests/test_parallel.py::TestRingAttention``): on
  (sp 4) and (sp 2, tp 2), the output and the gradients of q, k and v of
  ``sum(out * w)`` against JAX ``ring_attention``, atol 2e-5.
* The pipeline (``tests/test_parallel.py::test_pipeline_matches_sequential``):
  the transformer at pp 2 with two microbatches, the JAX pp 2 params, the
  loss against the JAX pp 2 loss and the port's own one-stage loss (rtol
  1e-5) and every gradient against the JAX gradients (atol 2e-5, the
  bars of ``tests/test_torch_mesh.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_mesh_worker import spawn
from torchft_tpu.models.transformer import TransformerConfig, init_params, loss_fn
from torchft_tpu.ops.attention import ring_attention
from torchft_tpu.parallel.mesh import MeshConfig, make_mesh

# tests/test_parallel.py:25-33
CFG = dict(vocab_size=128, d_model=32, n_layers=4, n_heads=4, head_dim=8, d_ff=64)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("mesh_sizes,shape", [(dict(sp=4), (2, 16, 4, 8)),
                                              (dict(sp=2, tp=2), (2, 16, 4, 8)),
                                              (dict(sp=4), (1, 8, 2, 4))],
                         ids=["sp4", "sp2-tp2", "sp4-small"])
def test_ring_attention_matches_jax(tmp_path, mesh_sizes, shape):
    rng = np.random.default_rng(0)
    q, k, v, w = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    n = int(np.prod(list(mesh_sizes.values())))
    mesh = make_mesh(MeshConfig(**mesh_sizes), devices=jax.devices()[:n])

    def loss(q, k, v):
        return (ring_attention(q, k, v, mesh, causal=True) * w).sum()

    with jax.set_mesh(mesh):
        out = jax.jit(lambda q, k, v: ring_attention(q, k, v, mesh))(q, k, v)
        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    np.savez(tmp_path / "qkv.npz", q=q, k=k, v=v, w=w)
    spawn("ring", n, tmp_path, {"mesh": mesh_sizes}, timeout=60)
    got = np.load(tmp_path / "out.npz")
    np.testing.assert_allclose(got["out"], np.asarray(out), atol=2e-5)
    for name, g in zip("qkv", grads):
        np.testing.assert_allclose(got[f"d{name}"], np.asarray(g), atol=2e-5)


def test_pipeline_matches_jax_pp2(tmp_path):
    piped = TransformerConfig(**CFG, pp=2, microbatches=2, dtype=jnp.float32)
    mesh = make_mesh(MeshConfig(pp=2), devices=jax.devices()[:2])
    params = init_params(jax.random.PRNGKey(0), piped)
    tokens = np.random.default_rng(0).integers(0, CFG["vocab_size"], (8, 16)).astype(np.int32)
    with jax.set_mesh(mesh):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, t: loss_fn(p, t, piped, mesh)))(params, jnp.asarray(tokens))
    np.savez(tmp_path / "params.npz", **_flat(params))
    np.save(tmp_path / "tokens.npy", tokens)
    spawn("pipeline", 2, tmp_path, {"mesh": {"pp": 2}, "cfg": dict(CFG, pp=2, microbatches=2)},
          timeout=60)
    got = np.load(tmp_path / "out.npz")
    np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-5)
    np.testing.assert_allclose(float(got["seq_loss"]), float(loss), rtol=1e-5)
    for i, g in enumerate(jax.tree_util.tree_leaves(grads)):
        np.testing.assert_allclose(got[f"g{i}"], np.asarray(g), atol=2e-5)
