"""The port's flash attention op against the JAX package's Pallas kernels.

The same numpy inputs go through ``torchft_tpu.ops.pallas.flash_attention``
(interpret mode on the CPU, as its own tests run it) and through
``torchft_tpu_torch.ops.flash_attention`` (its plain version, since the
tensors lie on the CPU), at head dims 32, 64 and 128, and at 8 and 16
with the short sequences the tiny models run (S 16, 32, 48 and 64). The card
tests hold the CUDA kernels against their plain
versions and skip without a GPU; they import no JAX, so on the card they
run with ``python -m pytest --noconftest -m cuda
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


HEAD_DIMS = (64, 32, 128)  # the paths' head dims (tests/test_torch_flash_shapes.py: 96, 256)


def _at_head_dims(cases):
    """``cases`` ({id: args}) at every head dim, d first; the head dim 64
    cases keep the ids they had before the others were added."""
    return [
        pytest.param(d, *args, id=case if d == 64 else f"d{d}-{case}")
        for d in HEAD_DIMS
        for case, args in cases.items()
    ]


def _jax_flash():
    jax = pytest.importorskip("jax")
    from torchft_tpu.ops.pallas.flash_attention import flash_attention

    return jax, flash_attention


@pytest.mark.parametrize(
    "d,causal,s",
    _at_head_dims({f"{c}-s{s}": (c, s) for s in (256, 192) for c in (True, False)}),
)
def test_forward_matches_jax_kernel(d, causal, s):
    # f32 at b2 h2, blocks 64: the JAX test's own bar (2e-5) — the two
    # differ only in float32 summation order. S=192 is the ragged length the
    # card checks (not a multiple of the card kernels' 128-row tiles).
    jax, jax_flash = _jax_flash()
    q, k, v = _qkv(s=s, d=d)
    expect = np.asarray(jax_flash(q, k, v, causal=causal, block_q=64, block_k=64))
    got = fa.flash_attention(
        *map(torch.from_numpy, (q, k, v)), causal=causal, block_q=64, block_k=64
    )
    np.testing.assert_allclose(got.numpy(), expect, atol=2e-5)


@pytest.mark.parametrize("d,s", _at_head_dims({f"s{s}": (s,) for s in (128, 192)}))
def test_grads_match_jax_kernels(d, s):
    # gradients through the JAX dQ and dK/dV kernels vs the port's op under
    # autograd: the JAX test's bar (3e-4), f32 accumulation order only; at
    # the ragged S=192 that the card checks too
    jax, jax_flash = _jax_flash()
    q, k, v = _qkv(s=s, d=d)

    def loss(q, k, v):
        return (jax_flash(q, k, v, causal=True, block_q=64, block_k=64) ** 2).sum()

    expect = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    (fa.flash_attention(*ts, causal=True, block_q=64, block_k=64) ** 2).sum().backward()
    for t, e in zip(ts, expect):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(e), atol=3e-4)


# S 16 (the tiny preset's), 32, 48 and 64: the card's K2 and K3 at these
# head dims take tiles of 16, 32 and 64 rows by S; the JAX op one block
SMALL = [pytest.param(d, s, c, id=f"d{d}-s{s}-{'causal' if c else 'full'}")
         for d in (8, 16) for s in (16, 48, 32, 64) for c in (True, False)]


@pytest.mark.parametrize("d,s,causal", SMALL)
def test_small_head_dims_match_jax_kernel(d, s, causal):
    """Head dims 8 and 16 at the short sequences of the tiny models (S 16,
    the tiny preset's; S 32, 48 and 64), each one block (min(128, S)) as the JAX op
    takes it: the forward and the gradients of the port's op (its plain
    version on the CPU) against the Pallas kernels in interpret mode, at
    the JAX test's float32 bar 2e-5."""
    jax, jax_flash = _jax_flash()
    q, k, v = _qkv(b=2, s=s, h=2, d=d, seed=d + s)

    def loss(q, k, v):
        return (jax_flash(q, k, v, causal=causal) ** 2).sum()

    expect_o = np.asarray(jax_flash(q, k, v, causal=causal))
    expect_g = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = fa.flash_attention(*ts, causal=causal)
    np.testing.assert_allclose(o.detach().numpy(), expect_o, atol=2e-5)
    (o ** 2).sum().backward()
    for t, e in zip(ts, expect_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(e), atol=2e-5)


@pytest.mark.parametrize("d,s,causal", SMALL + [
    pytest.param(d, 200, c, id=f"d{d}-s200-{'causal' if c else 'full'}")
    for d in (8, 16) for c in (True, False)])
def test_small_plain_kernel_versions_match_autograd(d, s, causal):
    """fwd_plain / dq_plain / dkv_plain at head dims 8 and 16, S 16, 32, 48,
    64 and the ragged 200 the card holds the kernels at, against plain
    attention and its autograd gradients (float32: 1e-5)."""
    test_plain_kernel_versions_match_autograd(d, causal, s)


def test_uneven_blocks_rejected():
    q, k, v = map(torch.from_numpy, _qkv(s=100))
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q, k, v, block_q=64, block_k=64)


def _pack(x):
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


@pytest.mark.parametrize(
    "d,causal,s",
    _at_head_dims({f"{c}-s{s}": (c, s) for s in (128, 192) for c in (True, False)}),
)
def test_plain_kernel_versions_match_autograd(d, causal, s):
    """fwd_plain / dq_plain / dkv_plain — what the card holds the kernels
    against — equal plain attention and its autograd gradients (f32, same
    math in another order: 1e-5), at the ragged length S=192 too."""
    q, k, v, do = map(torch.from_numpy, _qkv(s=s, d=d) + _qkv(s=s, d=d, seed=1)[:1])
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


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "non-causal"])
def test_plain_versions_on_rows_equal_whole(causal):
    """The plain versions over chunks of query rows (``rows=``, how the
    card holds the kernels at S 16384 and 32768) equal the whole ones: O,
    lse and dQ chunk by chunk, and dK and dV summed over the chunks in
    float32 (``out_dtype``), with dO random on every row (float32: 1e-6,
    and for the sums 1e-6 of |ref| more: the chunks' summation order)."""
    q, k, v, do = map(torch.from_numpy, _qkv(s=256, d=64) + _qkv(s=256, d=64, seed=1)[:1])
    pq, pk, pv, pdo = map(_pack, (q, k, v, do))
    o, lse = fa.fwd_plain(pq, pk, pv, causal)
    delta = (pdo * o).sum(-1)
    dq = fa.dq_plain(pq, pk, pv, pdo, lse, delta, causal)
    dk_sum = dv_sum = 0
    for r0 in range(0, 256, 64):
        rows = (r0, r0 + 64)
        o_r, lse_r = fa.fwd_plain(pq, pk, pv, causal, rows=rows)
        np.testing.assert_allclose(o_r, o[:, r0:r0 + 64], atol=1e-6)
        np.testing.assert_allclose(lse_r, lse[:, r0:r0 + 64], atol=1e-6)
        np.testing.assert_allclose(fa.dq_plain(pq, pk, pv, pdo, lse, delta, causal, rows=rows),
                                   dq[:, r0:r0 + 64], atol=1e-6)
        dk_r, dv_r = fa.dkv_plain(pq, pk, pv, pdo, lse, delta, causal, rows=rows,
                                  out_dtype=torch.float32)
        dk_sum, dv_sum = dk_sum + dk_r, dv_sum + dv_r
    for got, ref in zip((dk_sum, dv_sum), fa.dkv_plain(pq, pk, pv, pdo, lse, delta, causal)):
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


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


def test_supported_shapes():
    """The predicate that routes ``"auto"`` and guards the op: float32 and
    bf16 at any head dim up to 256 (8, 16, 32, 64, 128 and 256 as built,
    the others padded to the next) and any S (the kernels mask the last
    tile), at most 65535 tiles of 64; head dims above 256 refused."""
    bf16, f32 = torch.bfloat16, torch.float32
    for d in (32, 64, 128):
        assert fa.supported(bf16, d, 4096) and fa.supported(bf16, d, 192)
    # S a multiple of 64 but not of 128: K3 at 128 keys a block gets a
    # half-filled last block, which the predicate does not refuse
    assert fa.supported(bf16, 128, 320) and fa.supported(bf16, 128, 4096)
    assert fa.supported(f32, 32, 128) and fa.supported(f32, 64, 128)
    assert fa.supported(f32, 128, 128)  # K1 register-blocked, K2 and K3 on the tensor cores
    # the tiny models' shapes: head dims 8 and 16, short and ragged S
    for d in (8, 16):
        for dtype in (f32, bf16):
            for s in (1, 16, 48, 100, 128, 200, 4096):
                assert fa.supported(dtype, d, s)
    # S not a multiple of 64: the FMA kernels at D <= 64, wgmma at 128
    assert fa.supported(bf16, 64, 100) and fa.supported(f32, 32, 48)
    assert fa.supported(bf16, 128, 100) and fa.supported(bf16, 128, 48)
    # 96 runs padded to 128, 256 on the FMA kernels; above 256 refused
    for d in (96, 256):
        assert fa.supported(bf16, d, 128) and fa.supported(f32, d, 128)
    for d in (257, 512):
        assert not fa.supported(bf16, d, 128) and not fa.supported(f32, d, 128)
    assert not fa.supported(bf16, 64, 0)
    assert fa.supported(bf16, 64, 65535 * 64) and not fa.supported(bf16, 64, 65536 * 64)
    assert not fa.supported(torch.float16, 64, 128)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_c_predicate_agrees_on_card():
    """csrc/flash_attention.cu's ``supported`` (what the op takes) and the
    Python predicate agree on every dtype, head dim 1-300 and length
    tried."""
    _need_card()
    lib = fa._load()
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for d in range(1, 301):
            for s in (0, 64, 100, 128, 192, 4096, 65535 * 64, 65536 * 64):
                assert bool(lib.tft_flash_supported(code, d, s)) == fa.supported(dtype, d, s)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "d,dtype,causal,bh,s",
    [
        (64, torch.bfloat16, True, 64, 256),
        # the headline shape (B8 H8 S1024): K2's diagonal-first ring over 8
        # key tiles per block at most
        (64, torch.bfloat16, True, 64, 1024),
        (64, torch.float32, False, 64, 256),
        (64, torch.float32, True, 64, 256),
        # ragged: S not a multiple of the 128-row tiles
        (64, torch.bfloat16, True, 4, 192),
        (64, torch.bfloat16, False, 4, 192),
        # head dim 128 (two 64-column blocks a row): wgmma
        (128, torch.bfloat16, True, 8, 1024),
        (128, torch.bfloat16, True, 4, 192),
        (128, torch.bfloat16, False, 4, 192),
        # the Llama-2-7B width (B2 H32 S4096), K3's half-filled last block
        # of 128 keys (S 320; non-causal, K2's half-filled last q-tile
        # without the mask), and the unmasked loops at S 1024
        (128, torch.bfloat16, True, 64, 4096),
        # the long-context bench's S 4096 (B2 H8) and S 8192 (B1 H8) at
        # head dim 64
        (64, torch.bfloat16, True, 16, 4096),
        (64, torch.bfloat16, True, 8, 8192),
        (128, torch.bfloat16, True, 4, 320),
        (128, torch.bfloat16, False, 4, 320),
        (128, torch.bfloat16, False, 8, 1024),
        # head dim 32: bf16 on wgmma (64-byte rows); float32 on FMA. S 1024
        # wraps the rings, S 320 gives K3 a half-filled last block of 128
        # keys
        (32, torch.bfloat16, True, 32, 128),
        (32, torch.bfloat16, False, 4, 192),
        (32, torch.bfloat16, True, 8, 1024),
        (32, torch.bfloat16, False, 8, 1024),
        (32, torch.bfloat16, True, 4, 320),
        (32, torch.float32, True, 32, 256),
        (32, torch.float32, False, 4, 192),
        # head dims 8 and 16 in both dtypes (K1 on the FMA kernel, K2 and K3
        # on the small kernels' tiles of 16, 32 and 64 rows): the tiny
        # preset's B8 H2 S16, one tile with its rows past S (S 48), and a
        # ragged last tile (S 200); at each tile's edges (S 1, 15, 17, 32,
        # 33, 64, 65) causal and not, at an odd BH; bf16 at 32 and 64 where
        # S is not a multiple of 64 (the FMA kernels)
        *[(d, dtype, causal, bh, s) for d in (8, 16) for dtype in (torch.float32, torch.bfloat16)
          for causal, bh, s in ((True, 16, 16), (True, 4, 48), (False, 4, 48), (True, 4, 200))],
        *[(d, dtype, causal, 3, s) for d in (8, 16) for dtype in (torch.float32, torch.bfloat16)
          for s in (1, 15, 17, 32, 33, 64, 65) for causal in (True, False)],
        (32, torch.bfloat16, True, 4, 48),
        (64, torch.bfloat16, False, 4, 200),
        # bf16 at 128 at any S on wgmma (the last tile masked, K3's last
        # q-tile ragged); float32 at 128 and 256 (K1 on the
        # register-blocked kernel, K2 and K3 on the tensor cores); 96, 80
        # and 40 padded to 128 and 64 at their true scale
        *[(128, torch.bfloat16, True, 4, s) for s in (16, 100, 1000)],
        (128, torch.bfloat16, False, 4, 100),
        (128, torch.float32, True, 4, 256),
        (128, torch.float32, False, 4, 256),
        (128, torch.float32, True, 4, 200),
        *[(256, dtype, True, 4, s) for dtype in (torch.float32, torch.bfloat16)
          for s in (128, 200)],
        # at 256 in bf16: K1-K3 on wgmma (K1 64-key stages, K2 32-key
        # stages, K3's consumers splitting D); in float32: K1 on 32-key
        # cp.async stages of the register-blocked kernel, K2 and K3 on
        # the tensor cores (3xTF32); at one tile, ragged lengths and the
        # rings wrapping, with an odd BH
        *[(256, dtype, causal, 3, s) for dtype in (torch.bfloat16, torch.float32)
          for s in (64, 200, 1000, 2048) for causal in (True, False)],
        *[(d, dtype, True, 4, 192) for d in (96, 80, 40)
          for dtype in (torch.float32, torch.bfloat16)],
        # float32 at 128 on 256's grid (K2 and K3 on the tensor cores: one
        # tile, ragged, the stages wrapping) and at the timed shape (B2
        # H32 S4096)
        *[(128, torch.float32, causal, 3, s) for s in (64, 200, 1000, 2048)
          for causal in (True, False)],
        (128, torch.float32, True, 64, 4096),
    ],
)
def test_kernels_match_plain_on_card(d, dtype, causal, bh, s):
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (
        torch.randn(bh, s, d, device="cuda", generator=g).to(dtype) for _ in range(4)
    )
    # a head dim the kernels are not built at runs as the op runs it:
    # zero-padded, at its own scale, the first d columns kept
    dp, scale = fa.padded_head_dim(d), d ** -0.5

    def pad(x):
        return torch.nn.functional.pad(x, (0, dp - d))

    def cut(x):
        return x[..., :d]

    kq, kk, kv, kdo = map(pad, (q, k, v, do))
    o, lse = fa.fwd_kernel(kq, kk, kv, causal, scale=scale)
    o = cut(o)
    o_ref, lse_ref = fa.fwd_plain(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1)
    got = (cut(fa.dq_kernel(kq, kk, kv, kdo, lse, delta, causal, scale=scale)),
           *map(cut, fa.dkv_kernel(kq, kk, kv, kdo, lse, delta, causal, scale=scale)))
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
    o2, lse2 = fa.fwd_kernel(kq, kk, kv, causal, scale=scale)
    dq2 = fa.dq_kernel(kq, kk, kv, kdo, lse, delta, causal, scale=scale)
    dk2, dv2 = fa.dkv_kernel(kq, kk, kv, kdo, lse, delta, causal, scale=scale)
    assert torch.equal(o, cut(o2)) and torch.equal(lse, lse2)
    assert torch.equal(got[0], cut(dq2))
    assert torch.equal(got[1], cut(dk2)) and torch.equal(got[2], cut(dv2))


def _profiled_kernels(fn):
    """The names of the kernels that ``fn()`` ran on the card."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events() if e.device_type.name == "CUDA"}


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "non-causal"])
def test_mixed_backward_at_256_on_card(causal):
    """bf16 at head dim 256 through the op's ``autograd.Function``: K1, K2
    and K3 on wgmma, K2 reading the lse that K1 wrote ([BH, S] float32).
    The output and the three gradients
    against the plain versions (lse and delta from the op's own forward) at
    the bf16 bars of ``test_kernels_match_plain_on_card``; one launch of
    each kernel, and the kernels the profiler saw named by route."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    bh, s, d = 3, 1000, 256
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do = (torch.randn(bh, s, d, device="cuda", generator=g).to(torch.bfloat16)
                   for _ in range(4))
    qs, ks, vs = (x.clone().requires_grad_(True) for x in (q, k, v))
    fa.reset_launches()

    out = []

    def run():
        out.append(fa._Flash.apply(qs, ks, vs, causal, d ** -0.5))
        out[0].backward(do)

    names = _profiled_kernels(run)
    o = out[0].detach()
    assert fa.LAUNCHES == {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
    assert any("flash_fwd_wgmma<256" in n for n in names), names
    assert any("flash_dkv_wgmma<256" in n for n in names), names
    assert any("flash_dq_wgmma<256" in n for n in names), names
    assert not any(k in n for n in names
                   for k in ("flash_fwd_kernel<", "flash_dq_kernel<", "flash_dkv_kernel<")), names

    o_ref, lse = fa.fwd_plain(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1)
    ref = (o_ref, fa.dq_plain(q, k, v, do, lse, delta, causal),
           *fa.dkv_plain(q, k, v, do, lse, delta, causal))
    for a, r in zip((o, qs.grad, ks.grad, vs.grad), ref):
        a, r = a.float(), r.float()
        bar = 2.0 ** -6 * (r.abs() + r.pow(2).mean(-1, keepdim=True).sqrt()) + 1e-5
        assert bool(((a - r).abs() <= bar).all())


@pytest.mark.cuda
def test_op_refuses_head_dims_above_256_on_card():
    """``"flash"`` on the card raises above head dim 256 rather than run
    plain attention."""
    _need_card()
    x = torch.zeros(1, 16, 1, 257, device="cuda")
    with pytest.raises(ValueError, match="257"):
        fa.flash_attention(x, x, x)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [16384, 32768])
def test_kernels_match_plain_by_chunks_on_card(s):
    """K1-K3 at the long-context bench's longest lengths (B1 H8 D64, bf16,
    causal), where the plain versions' [S, S] scores (34 GB in float32 at
    S 32768) do not fit, held over chunks of 4096 query rows with dO
    random on every row: O, lse and dQ chunk by chunk, dK and dV against
    the chunks' float32 sum, at the bars of
    ``test_kernels_match_plain_on_card``; a second launch is bitwise
    equal."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    bh, d, chunk = 8, 64, 4096
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(bh, s, d, device="cuda", generator=g).to(torch.bfloat16)
                   for _ in range(4))
    o, lse = fa.fwd_kernel(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1)
    dq = fa.dq_kernel(q, k, v, do, lse, delta, True)
    dk, dv = fa.dkv_kernel(q, k, v, do, lse, delta, True)

    def held(a, r):
        a, r = a.float(), r.float()
        bar = 2.0 ** -6 * (r.abs() + r.pow(2).mean(-1, keepdim=True).sqrt()) + 1e-5
        return bool(((a - r).abs() <= bar).all())

    dk_ref = dv_ref = 0
    for r0 in range(0, s, chunk):
        rows = (r0, r0 + chunk)
        o_ref, lse_ref = fa.fwd_plain(q, k, v, True, rows=rows)
        assert held(o[:, r0:r0 + chunk], o_ref)
        assert float((lse[:, r0:r0 + chunk] - lse_ref).abs().max()) <= 1e-4
        assert held(dq[:, r0:r0 + chunk], fa.dq_plain(q, k, v, do, lse, delta, True, rows=rows))
        dk_r, dv_r = fa.dkv_plain(q, k, v, do, lse, delta, True, rows=rows,
                                  out_dtype=torch.float32)
        dk_ref, dv_ref = dk_ref + dk_r, dv_ref + dv_r
        del o_ref, lse_ref, dk_r, dv_r
    assert held(dk, dk_ref) and held(dv, dv_ref)
    o2, lse2 = fa.fwd_kernel(q, k, v, True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert torch.equal(dq, fa.dq_kernel(q, k, v, do, lse, delta, True))
    dk2, dv2 = fa.dkv_kernel(q, k, v, do, lse, delta, True)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
