"""The port's flash attention op against the JAX package's Pallas kernels.

The same numpy inputs go through ``torchft_tpu.ops.pallas.flash_attention``
(interpret mode on the CPU, as its own tests run it) and through
``torchft_tpu_torch.ops.flash_attention`` (its plain version, since the
tensors lie on the CPU). The card test holds the CUDA kernels against
their plain versions and skips without a GPU; it imports no JAX, so on
the card it runs with ``python -m pytest --noconftest -m cuda
tests/test_torch_flash_attention.py``.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from torchft_tpu_torch.ops import flash_attention as fa
from torchft_tpu_torch.ops.attention import attention


def _qkv(b=2, s=256, h=2, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3)]


def _jax_flash():
    jax = pytest.importorskip("jax")
    from torchft_tpu.ops.pallas.flash_attention import flash_attention

    return jax, flash_attention


@pytest.mark.parametrize("s", [256, 192], ids=["s256", "s192"])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_jax_kernel(causal, s):
    # f32 at b2 h2 d64, blocks 64: the JAX test's own bar (2e-5) — the two
    # differ only in float32 summation order. S=192 is the ragged length the
    # card checks (not a multiple of the card kernels' 128-row tiles).
    jax, jax_flash = _jax_flash()
    q, k, v = _qkv(s=s)
    expect = np.asarray(jax_flash(q, k, v, causal=causal, block_q=64, block_k=64))
    got = fa.flash_attention(
        *map(torch.from_numpy, (q, k, v)), causal=causal, block_q=64, block_k=64
    )
    np.testing.assert_allclose(got.numpy(), expect, atol=2e-5)


@pytest.mark.parametrize("s", [128, 192], ids=["s128", "s192"])
def test_grads_match_jax_kernels(s):
    # gradients through the JAX dQ and dK/dV kernels vs the port's op under
    # autograd: the JAX test's bar (3e-4), f32 accumulation order only; at
    # the ragged S=192 that the card checks too
    jax, jax_flash = _jax_flash()
    q, k, v = _qkv(s=s)

    def loss(q, k, v):
        return (jax_flash(q, k, v, causal=True, block_q=64, block_k=64) ** 2).sum()

    expect = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    (fa.flash_attention(*ts, causal=True, block_q=64, block_k=64) ** 2).sum().backward()
    for t, e in zip(ts, expect):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(e), atol=3e-4)


def test_uneven_blocks_rejected():
    q, k, v = map(torch.from_numpy, _qkv(s=100))
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q, k, v, block_q=64, block_k=64)


def _pack(x):
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


@pytest.mark.parametrize("s", [128, 192], ids=["s128", "s192"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_kernel_versions_match_autograd(causal, s):
    """fwd_plain / dq_plain / dkv_plain — what the card holds the kernels
    against — equal plain attention and its autograd gradients (f32, same
    math in another order: 1e-5), at the ragged length S=192 too."""
    q, k, v, do = map(torch.from_numpy, _qkv(s=s) + _qkv(s=s, seed=1)[:1])
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = attention(*ts, causal=causal)
    o.backward(do)
    pq, pk, pv, pdo = map(_pack, (q, k, v, do))
    o_plain, lse = fa.fwd_plain(pq, pk, pv, causal)
    np.testing.assert_allclose(o_plain, _pack(o.detach()), atol=1e-5)
    delta = (pdo * o_plain).sum(-1)
    dq = fa.dq_plain(pq, pk, pv, pdo, lse, delta, causal)
    dk, dv = fa.dkv_plain(pq, pk, pv, pdo, lse, delta, causal)
    for got, t in zip((dq, dk, dv), ts):
        np.testing.assert_allclose(got, _pack(t.grad), atol=1e-5)


@pytest.mark.parametrize("name", sorted(os.listdir(fa.CSRC_DIR)))
def test_build_digest_covers_every_source(tmp_path, name):
    """The kernel library is keyed by every file under csrc/: an edit of any
    of them, a header included, must change the key, or a stale library
    would be loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(fa.CSRC_DIR, csrc)
    before = fa.source_digest(str(csrc))
    assert before == fa.source_digest()  # content, not location
    with open(csrc / name, "ab") as f:
        f.write(b" ")
    assert fa.source_digest(str(csrc)) != before


def test_nvcc_compiles_every_source_in_one_call():
    cmd = fa.nvcc_command("/tmp/lib.so")
    units = sorted(n for n in os.listdir(fa.CSRC_DIR) if n.endswith(".cu"))
    assert units and sorted(os.path.basename(a) for a in cmd if a.endswith(".cu")) == units
    assert "arch=compute_90a,code=sm_90a" in cmd


@pytest.mark.parametrize(
    "call",
    [
        lambda q: fa.fwd_kernel(q, q, q, True),
        lambda q: fa.dq_kernel(q, q, q, q, q[..., 0], q[..., 0], True),
        lambda q: fa.dkv_kernel(q, q, q, q, q[..., 0], q[..., 0], True),
    ],
    ids=["fwd", "dq", "dkv"],
)
def test_kernel_wrappers_reject_cpu_tensors(call):
    """A kernel wrapper launches or raises: it never computes on the CPU."""
    q = torch.zeros(2, 128, 64)
    with pytest.raises(ValueError, match="CUDA"):
        call(q)
    assert fa.LAUNCHES == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype,causal,bh,s",
    [
        (torch.bfloat16, True, 64, 256),
        # the headline shape (B8 H8 S1024): K2's diagonal-first ring over 8
        # key tiles per block at most
        (torch.bfloat16, True, 64, 1024),
        (torch.float32, False, 64, 256),
        (torch.float32, True, 64, 256),
        # ragged: S not a multiple of the 128-row tiles
        (torch.bfloat16, True, 4, 192),
        (torch.bfloat16, False, 4, 192),
    ],
)
def test_kernels_match_plain_on_card(dtype, causal, bh, s):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (
        torch.randn(bh, s, 64, device="cuda", generator=g).to(dtype) for _ in range(4)
    )
    o, lse = fa.fwd_kernel(q, k, v, causal)
    o_ref, lse_ref = fa.fwd_plain(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1)
    got = (fa.dq_kernel(q, k, v, do, lse, delta, causal),
           *fa.dkv_kernel(q, k, v, do, lse, delta, causal))
    ref = (fa.dq_plain(q, k, v, do, lse, delta, causal),
           *fa.dkv_plain(q, k, v, do, lse, delta, causal))
    if dtype == torch.float32:
        # the JAX test bars: float32 summation order only
        assert float((o - o_ref).abs().max()) <= 2e-5
        assert float((lse - lse_ref).abs().max()) <= 2e-5
        for a, r in zip(got, ref):
            assert float((a - r).abs().max()) <= 3e-4
        return
    # bf16: O, dQ, dK and dV elementwise within 2^-6 * (|ref| + rms of ref's
    # row) + 1e-5: two ulps of the output rounding, the kernels' bf16
    # rounding of P and dS, which scales with the row, and float32 summation
    # order in rows that are exactly 0 (dQ of query 0). lse (float32, about
    # 5 here) within 1e-4: exp2 vs exp and summation order move it by a few
    # ulps, a wrong tile by 1e-2 or more.
    for a, r in zip((o,) + got, (o_ref,) + ref):
        a, r = a.float(), r.float()
        bar = 2.0 ** -6 * (r.abs() + r.pow(2).mean(-1, keepdim=True).sqrt()) + 1e-5
        assert bool(((a - r).abs() <= bar).all())
    assert float((lse - lse_ref).abs().max()) <= 1e-4
    # deterministic: a second launch on the same inputs is bitwise equal
    o2, lse2 = fa.fwd_kernel(q, k, v, causal)
    dq2 = fa.dq_kernel(q, k, v, do, lse, delta, causal)
    dk2, dv2 = fa.dkv_kernel(q, k, v, do, lse, delta, causal)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert torch.equal(got[0], dq2)
    assert torch.equal(got[1], dk2) and torch.equal(got[2], dv2)
