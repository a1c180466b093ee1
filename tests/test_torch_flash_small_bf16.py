"""The bf16 arithmetic of the dQ and dK/dV kernels at head dims 8 and 16
(``flash_dq_small`` and ``flash_dkv_small`` in ``csrc/flash_attention.cu``)
against the JAX package's Pallas kernels on bf16 inputs.

On the card those kernels run every product on the tensor cores with bf16
operands and float32 sums: S = Q.K^T and dP = dO.V^T from the bf16
inputs, P = exp(S scale - lse) and dS = P (dP - delta) scale in float32,
then dQ = dS.K, dK = dS^T.Q and dV = P^T.dO with P and dS each taken as
two bf16 terms, hi = bf16(x) and lo = bf16(x - hi), summed in float32 and
rounded to bf16. The Pallas kernels round P and dS once
(``ds.astype(k_ref.dtype)``, ``p.astype(do_ref.dtype)``,
``ds.astype(q_ref.dtype)``). At head dim 8 that one rounding breaks the
bar the bf16 kernels are held to against their float32 plain versions on
the card (``chip_smoke.py``'s ``KERNEL_BAR``: |g - ref| <= 2^-6 (|ref| +
the rms of ref's row) + 1e-5, elementwise), since a row's rms over 8
columns is often small beside that rounding's error; hi + lo, within 2^-16
of x, leaves the output's rounding alone.

A CUDA kernel cannot run here, so this test emulates both orders with
torch on the CPU:
- the kernels' order against the Pallas op in interpret mode (its output
  and its q/k/v gradients from one bf16 cotangent, in one call) at head
  dims 8 and 16, S 16, 48 and 64, causal and not, at ``KERNEL_BAR``. The
  emulation takes lse from its own float32 scores and delta = rowsum(dO O)
  from the Pallas op's bf16 O, as the Pallas backward does: the Pallas
  forward rounds P to bf16 before P.V, which the port's forward at these
  head dims does not, and the difference in O moves delta where dP - delta
  cancels (the forward's, not the backward order's);
- the Pallas order (one rounding) against the same gradients, far inside
  the bar: the emulation is that of the Pallas kernels;
- both orders against float32 gradients over 200 draws at head dim 8: the
  one rounding breaks ``KERNEL_BAR`` in some draws, the kernels' order in
  none.
The CUDA kernels themselves are held against their plain versions on the
card (``tests/test_torch_flash_attention.py``'s card cases,
``chip_smoke.py``).
"""

import functools

import numpy as np
import pytest
import torch

# chip_smoke.KERNEL_BAR: two bf16 ulps of |ref| for the output's rounding,
# the row's rms for the rounding of P and dS (its error scales with the
# row, not with an element near zero by cancellation), 1e-5 for rows that
# are exactly 0 (dQ of query 0 under the causal mask)
RTOL, ATOL = 2.0 ** -6, 1e-5


def _inputs(s, d, seed):
    """q, k, v and the cotangent, [B2, S, H2, D], as bf16 values in float32."""
    rng = np.random.default_rng(seed)
    x = [rng.standard_normal((2, s, 2, d)).astype(np.float32) for _ in range(4)]
    return [torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in x]


@functools.lru_cache(maxsize=None)
def _jax_vjp(s, d, causal):
    """The Pallas op's output and q/k/v gradients on bf16 inputs (one
    block, min(128, S), as the op takes these lengths), as float32 numpy
    arrays."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from torchft_tpu.ops.pallas.flash_attention import flash_attention

    @jax.jit
    def run(q, k, v, w):
        o, vjp = jax.vjp(lambda q, k, v: flash_attention(q, k, v, causal=causal), q, k, v)
        return o, vjp(w)

    args = [jnp.asarray(a, dtype=jnp.bfloat16) for a in _inputs(s, d, s + d)]
    o, grads = run(*args)
    return np.array(o.astype(jnp.float32)), [np.array(g.astype(jnp.float32)) for g in grads]


def _pack(x: np.ndarray) -> torch.Tensor:
    b, s, h, d = x.shape
    return torch.from_numpy(x).transpose(1, 2).reshape(b * h, s, d)


def _unpack(x: torch.Tensor, b: int, h: int) -> np.ndarray:
    bh, s, d = x.shape
    return x.reshape(b, h, s, d).transpose(1, 2).float().numpy()


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _split(x: torch.Tensor) -> torch.Tensor:
    """x as the kernels take P and dS: hi + lo, two bf16 terms (each
    product of the sum is exact in float32)."""
    hi = _bf16(x)
    return hi + _bf16(x - hi)


def _backward(q, k, v, w, o, causal, take):
    """(dQ, dK, dV) on [BH, S, D] bf16 values held in float32, given the
    forward's bf16 output ``o``, with P and dS as ``take`` gives them to
    their products, each result rounded to bf16."""
    s_len, d = q.shape[1], q.shape[2]
    scale = d ** -0.5
    s = q @ k.transpose(1, 2) * scale
    if causal:
        keep = torch.ones(s_len, s_len, dtype=torch.bool).tril()
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    delta = (w * o).sum(-1)
    ds = p * (w @ v.transpose(1, 2) - delta[..., None]) * scale
    return (_bf16(take(ds) @ k), _bf16(take(ds).transpose(1, 2) @ q),
            _bf16(take(p).transpose(1, 2) @ w))


def _worst(got, ref) -> float:
    """Largest |got - ref| over the row-scaled bar."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    rms = np.sqrt((ref ** 2).mean(-1, keepdims=True))
    return float((np.abs(got - ref) / (RTOL * (np.abs(ref) + rms) + ATOL)).max())


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("s", [16, 48, 64])
@pytest.mark.parametrize("d", [8, 16])
def test_bf16_order_matches_pallas(d, s, causal):
    q, k, v, w = _inputs(s, d, s + d)
    o, grads = _jax_vjp(s, d, causal)
    got = _backward(*map(_pack, (q, k, v, w, o)), causal, _split)
    for name, g, e in zip(("dq", "dk", "dv"), got, grads):
        worst = _worst(_unpack(g, 2, 2), e)
        assert worst <= 1.0, f"{name}: worst err/bar {worst:.3f}"


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", [8, 16])
def test_pallas_order_is_one_rounding(d, causal):
    """The Pallas kernels' order (P and dS rounded once) emulated the same
    way lands far inside the bar of their gradients (most elements
    bitwise): what the kernels' order departs from is that rounding."""
    q, k, v, w = _inputs(64, d, 64 + d)
    o, grads = _jax_vjp(64, d, causal)
    got = _backward(*map(_pack, (q, k, v, w, o)), causal, _bf16)
    for name, g, e in zip(("dq", "dk", "dv"), got, grads):
        worst = _worst(_unpack(g, 2, 2), e)
        assert worst <= 0.3, f"{name}: worst err/bar {worst:.3f}"


def test_one_rounding_breaks_the_bar_at_head_dim_8():
    """200 draws at head dim 8, BH 3, S 64, causal, against float32
    gradients (the card's plain versions' arithmetic, rounded to bf16 at
    the end): P and dS rounded once break ``KERNEL_BAR`` in some draws; as
    two bf16 terms, in none."""
    broke, worst_split = 0, 0.0
    for seed in range(200):
        g = torch.Generator().manual_seed(seed)
        q, k, v, w = (_bf16(torch.randn(3, 64, 8, generator=g)) for _ in range(4))
        s = (q @ k.transpose(1, 2) * 8 ** -0.5).masked_fill(
            ~torch.ones(64, 64, dtype=torch.bool).tril(), -1e30)
        o = _bf16(torch.softmax(s, dim=-1) @ v)
        ref = _backward(q, k, v, w, o, True, lambda x: x)
        once = _backward(q, k, v, w, o, True, _bf16)
        split = _backward(q, k, v, w, o, True, _split)
        broke += max(_worst(a, r) for a, r in zip(once, ref)) > 1.0
        worst_split = max(worst_split, *(_worst(a, r) for a, r in zip(split, ref)))
    assert broke >= 1, "one rounding held the bar in every draw"
    assert worst_split <= 1.0, f"the kernels' order: worst err/bar {worst_split:.3f}"
