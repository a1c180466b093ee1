"""The arithmetic of the float32 dQ and dK/dV kernels on the tensor cores
(``flash_dq_f32`` and ``flash_dkv_f32`` in ``csrc/flash_attention.cu``)
against the JAX package's Pallas kernels.

The kernels run every product of the backward as three TF32 products
(3xTF32): each operand value x is split into hi, x with its 13 low bits
dropped (the tensor cores read only the top 19 bits of a TF32 operand),
and lo = x - hi, truncated in turn, and a.b is taken as lo_a.hi_b +
hi_a.lo_b + hi_a.hi_b summed in float32. A CUDA kernel cannot run here, so
this test emulates that arithmetic with torch on the CPU: S = Q.K^T, dP =
dO.V^T, P = exp(S scale - lse), dS = P (dP - delta) scale, then dQ = dS.K,
dK = dS^T.Q and dV = P^T.dO, every operand split as the kernels split it
(and, beside it, with hi and lo rounded to nearest), at head dims 128 and
256. The same numpy inputs go through the Pallas op in interpret mode (its
forward and q/k/v gradients from one cotangent), and the emulated
gradients must hold the JAX test bars. One TF32 product a matmul misses
them: that is why the kernels take three.

Those cases sum the three products with torch's float32 matmul, which
rounds to nearest; at S 128 and 200 the order of the sum matters little.
The tensor cores' float32 accumulation truncates instead, and over the
thousands of queries that dV sums at S 4096 that drift grows to the bar's
order. The kernels therefore sum the products of two k steps from zero
and add that to the accumulator rounded to nearest (``add4``). One more
case emulates that accumulation mma by mma (each mma's 8 products summed
exactly, the sum cut toward zero to float32) for dV at S 4096, causal,
with and without ``add4``. The CUDA kernels themselves are held against
their plain versions on the card (``tests/test_torch_flash_attention.py``'s
card cases, ``chip_smoke.py``).
"""

import functools

import numpy as np
import pytest
import torch

from torchft_tpu_torch.ops import flash_attention as fa

O_BAR, GRAD_BAR = 2e-5, 3e-4  # the JAX test bars (float32 summation order only)
_LOW = -8192  # 0xffffe000 as an int32: the 13 bits below a TF32 mantissa


def _tf32(x: torch.Tensor, rounded: bool) -> torch.Tensor:
    """x as a TF32 value: truncated (the tensor cores' reading of float32
    bits) or rounded to nearest, ties away (half a TF32 ulp added to the
    bits first)."""
    bits = x.contiguous().view(torch.int32)
    if rounded:
        bits = bits + 0x1000
    return (bits & _LOW).view(torch.float32)


def _split(x: torch.Tensor, rounded: bool):
    hi = _tf32(x, rounded)
    return hi, _tf32(x - hi, rounded)


def _mm3(rounded: bool):
    """a @ b as the kernels take it: three TF32 products, in float32."""

    def mm(a, b):
        ah, al = _split(a, rounded)
        bh, bl = _split(b, rounded)
        return al @ bh + ah @ bl + ah @ bh

    return mm


def _mm1(a, b):
    """a @ b as one TF32 product (operands rounded to nearest)."""
    return _tf32(a, True) @ _tf32(b, True)


def _backward(q, k, v, do, lse, delta, causal, mm):
    """K2's and K3's function on [BH, S, D] float32, every product by
    ``mm``: (dQ, dK, dV)."""
    s_len, d = q.shape[1], q.shape[2]
    scale = d ** -0.5
    s = mm(q, k.transpose(1, 2)) * scale
    if causal:
        keep = torch.ones(s_len, s_len, dtype=torch.bool).tril()
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    p = torch.exp(s - lse[..., None])
    dp = mm(do, v.transpose(1, 2))
    ds = p * (dp - delta[..., None]) * scale
    return mm(ds, k), mm(ds.transpose(1, 2), q), mm(p.transpose(1, 2), do)


def _inputs(s, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, s, 2, d)).astype(np.float32) for _ in range(4)]


# S 200 takes blocks of 40 (the Pallas op's rule: S a multiple of the blocks)
_BLOCK = {128: 64, 200: 40}


@functools.lru_cache(maxsize=None)
def _jax_vjp(s, d, seed, causal):
    """The Pallas op's output and q/k/v gradients for the cotangent of
    ``_inputs(s, d, seed)``, in one jitted call."""
    jax = pytest.importorskip("jax")
    from torchft_tpu.ops.pallas.flash_attention import flash_attention

    block = _BLOCK[s]

    @jax.jit
    def run(q, k, v, w):
        o, vjp = jax.vjp(lambda q, k, v: flash_attention(q, k, v, causal=causal, block_q=block,
                                                         block_k=block), q, k, v)
        return o, vjp(w)

    o, grads = run(*_inputs(s, d, seed))
    return np.asarray(o), [np.asarray(g) for g in grads]


def _pack(x: np.ndarray) -> torch.Tensor:
    b, s, h, d = x.shape
    return torch.from_numpy(x).transpose(1, 2).reshape(b * h, s, d).contiguous()


def _unpack(x: torch.Tensor, b: int, h: int) -> np.ndarray:
    bh, s, d = x.shape
    return x.reshape(b, h, s, d).transpose(1, 2).numpy()


def _emulated(s, d, seed, causal, mm):
    """The forward (the kernels' plain K1, float32) and the gradients of
    the emulated K2 and K3 on ``_inputs(s, d, seed)``, in the op's [B, S,
    H, D] layout."""
    q, k, v, w = map(_pack, _inputs(s, d, seed))
    o, lse = fa.fwd_plain(q, k, v, causal)
    delta = (w * o).sum(-1)
    grads = _backward(q, k, v, w, lse, delta, causal, mm)
    return _unpack(o, 2, 2), [_unpack(g, 2, 2) for g in grads]


CASES = [pytest.param(d, s, causal, id=f"d{d}-s{s}-{'causal' if causal else 'full'}")
         for d in (128, 256) for s in (128, 200) for causal in (True, False)]


@pytest.mark.parametrize("rounded", [False, True], ids=["truncated", "rounded"])
@pytest.mark.parametrize("d,s,causal", CASES)
def test_three_tf32_products_hold_the_jax_bars(d, s, causal, rounded):
    """dQ, dK and dV with every product of K2 and K3 as three TF32
    products (hi as the kernels take it, truncated, and rounded to nearest)
    against the Pallas kernels at the JAX bars."""
    seed = d + s + causal
    expect_o, expect = _jax_vjp(s, d, seed, causal)
    o, grads = _emulated(s, d, seed, causal, _mm3(rounded))
    np.testing.assert_allclose(o, expect_o, atol=O_BAR)
    for name, g, e in zip(("dq", "dk", "dv"), grads, expect):
        np.testing.assert_allclose(g, e, atol=GRAD_BAR, err_msg=name)


@pytest.mark.parametrize("d,s,causal", CASES)
def test_one_tf32_product_misses_the_bars(d, s, causal):
    """The same gradients with one TF32 product a matmul (operands
    rounded to nearest, about 2^-11 of each) land outside the JAX bar."""
    seed = d + s + causal
    _, expect = _jax_vjp(s, d, seed, causal)
    _, grads = _emulated(s, d, seed, causal, _mm1)
    worst = max(float(np.abs(g - e).max()) for g, e in zip(grads, expect))
    assert worst > GRAD_BAR, worst


def test_tf32_split_is_exact_and_small():
    """hi + lo equals x bit for bit, hi keeps a TF32 value's 10 mantissa
    bits, and the truncated lo is within 2^-20 of x (2^-21 rounded)."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    for rounded, bound in ((False, 2.0 ** -20), (True, 2.0 ** -21)):
        hi = _tf32(x, rounded)
        lo = x - hi
        assert torch.equal(hi + lo, x)
        assert not bool((hi.view(torch.int32) & ~_LOW).any())
        assert float(((x - hi - _tf32(lo, rounded)).abs() / x.abs()).max()) <= bound


def _add_truncated(acc: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
    """acc + part as an mma's float32 accumulator takes it: the sum cut
    toward zero to float32 (part, float64, is the mma's exact sum)."""
    exact = acc.double() + part
    near = exact.float()
    over = near.double().abs() > exact.abs()
    return torch.where(over, torch.nextafter(near, torch.zeros_like(near)), near)


def _dv_accumulated(p: torch.Tensor, do: torch.Tensor, add4: bool) -> torch.Tensor:
    """dV = P^T.dO ([BH, S, K] and [BH, S, D] float32) as K3's mma_cols takes
    it: k steps of 8 queries, each as three mma (lo_dO.hi_P, hi_dO.lo_P,
    hi_dO.hi_P) whose sums the accumulator truncates; ``add4``: two k steps'
    six mma into a zeroed accumulator, added to dV rounded to nearest, else
    every mma straight into dV."""
    ph, pl = _split(p, False)
    oh, ol = _split(do, False)
    dv = torch.zeros(p.shape[0], p.shape[2], do.shape[2])
    d = torch.zeros_like(dv)
    for step, q0 in enumerate(range(0, p.shape[1], 8)):
        rows = slice(q0, q0 + 8)
        for a, b in ((pl, oh), (ph, ol), (ph, oh)):
            part = a[:, rows].double().transpose(1, 2) @ b[:, rows].double()
            if add4:
                d = _add_truncated(d, part)
            else:
                dv = _add_truncated(dv, part)
        if add4 and step % 2 == 1:
            dv, d = dv + d, torch.zeros_like(d)
    return dv


def test_add4_keeps_truncated_accumulation_inside_the_bar():
    """dV of the first 64 keys (the longest sums) at S 4096, causal, D 128,
    4 heads: the products summed mma by mma into a truncating accumulator
    drift to the bar's order (on the card that form reached 0.97 of it over
    64 heads), summed from zero two k steps at a time and added they stay
    far inside it."""
    bh, s_len, d, keys = 4, 4096, 128, 64
    rng = np.random.default_rng(4096)
    q, k, do = (torch.from_numpy(rng.standard_normal((bh, s_len, d)).astype(np.float32))
                for _ in range(3))
    keep = torch.ones(s_len, s_len, dtype=torch.bool).tril()
    p = torch.empty(bh, s_len, keys)
    for h in range(bh):
        sc = torch.where(keep, (q[h] @ k[h].T) * d ** -0.5, torch.tensor(-1e30))
        p[h] = torch.exp(sc[:, :keys] - torch.logsumexp(sc, -1, keepdim=True))
    exact = p.double().transpose(1, 2) @ do.double()
    err = {add4: float((_dv_accumulated(p, do, add4).double() - exact).abs().max())
           for add4 in (True, False)}
    assert err[True] <= GRAD_BAR / 10, err
    assert err[False] >= GRAD_BAR / 3 and err[False] >= 20 * err[True], err
