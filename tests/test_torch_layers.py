"""The port's layers and plain attention against the JAX package's, on the
same numpy inputs, in float32 and bfloat16.

Tolerances: float32 agrees to summation order and libm differences
(1e-5 relative, 1e-6 absolute). bfloat16 keeps 8 significant bits, and
the two frameworks round intermediate results at different points, so
bfloat16 outputs are compared at two bf16 ulps (rtol 1.6e-2) with an
absolute floor for values near zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchft_tpu.ops.attention import attention as jax_attention
from torchft_tpu.ops import layers as jlayers
from torchft_tpu_torch.ops.attention import attention
from torchft_tpu_torch.ops import layers as tlayers

DTYPES = {
    "float32": (jnp.float32, torch.float32, dict(rtol=1e-5, atol=1e-6)),
    "bfloat16": (jnp.bfloat16, torch.bfloat16, dict(rtol=1.6e-2, atol=1.6e-2)),
}


def _inputs(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrays, name):
    jdt, tdt, tol = DTYPES[name]
    return (
        [jnp.asarray(a, jdt) for a in arrays],
        [torch.from_numpy(a).to(tdt) for a in arrays],
        tol,
    )


def _close(got: torch.Tensor, expect, tol):
    assert got.dtype in (torch.float32, torch.bfloat16)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(expect, dtype=np.float32), **tol
    )


@pytest.mark.parametrize("name", DTYPES)
def test_rms_norm(name):
    (jx, jw), (tx, tw), tol = _both(_inputs((2, 16, 32), (32,)), name)
    _close(tlayers.rms_norm(tx, tw, 1e-6), jlayers.rms_norm(jx, jw, 1e-6), tol)


@pytest.mark.parametrize("name", DTYPES)
def test_rotary_embed_interleaved(name):
    (jx,), (tx,), tol = _both(_inputs((2, 16, 4, 8)), name)
    pos = np.arange(16)
    _close(
        tlayers.rotary_embed(tx, torch.from_numpy(pos)),
        jlayers.rotary_embed(jx, jnp.asarray(pos)),
        tol,
    )


@pytest.mark.parametrize("name", DTYPES)
def test_swiglu(name):
    arrays = _inputs((2, 16, 32), (32, 64), (32, 64), (64, 32))
    arrays[1:] = [a * 32**-0.5 for a in arrays[1:]]
    j, t, tol = _both(arrays, name)
    _close(tlayers.swiglu(*t), jlayers.swiglu(*j), tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", DTYPES)
def test_plain_attention(name, causal):
    j, t, tol = _both(_inputs((2, 32, 2, 16), (2, 32, 2, 16), (2, 32, 2, 16)), name)
    _close(attention(*t, causal=causal), jax_attention(*j, causal=causal), tol)
