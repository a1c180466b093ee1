"""On-card smoke run of the PyTorch/H100 port (``torchft_tpu_torch``).

Usage (repo root, one NVIDIA GPU): ``python3 chip_smoke.py``

Phases, each of which either passes or ends the run with a non-zero exit:

1. the card's name and power limit; TF32 off for float32 matmuls.
2. kernel parity at the headline attention shapes (B8 S1024 H8 D64, bf16,
   causal) and at a ragged length (B2 S192 H2): K1 (forward), K2 (dQ) and
   K3 (dK/dV) each against its plain PyTorch version on the same inputs,
   elementwise, and bitwise equal across two launches; the autograd op
   against plain attention evaluated in float32; float32 cases at the JAX
   test bars.
3. timing of each kernel: launched eagerly between CUDA events (``ms``),
   and replayed from a CUDA graph (device time alone) with its inputs warm
   in the L2 and L2-cold; its host cost per call, its plain version, the
   ``scaled_dot_product_attention`` yardsticks by both methods and the
   roofline bound.
4. the headline fault-tolerant training loop on one replica group:
   in-process lighthouse + store, Manager over CollectivesTcp, TrainStep
   at d512 L8 h8 ff1408 vocab 32000 bf16, batch 8 x seq 1024; 2 warm-up
   and 5 timed steps; kernel launch counts checked per step.
5. two replica groups as threads on the card: the second joins late,
   heals from the first over HTTP, both commit 3 steps together and end
   with bit-identical parameters.

Prints the kernels' JSON line and, last, ``{"ok": true, "device": ...}``.
The native core and the kernels are built from the checkout on first use;
ptxas must report 0 spill bytes for each bf16 (wgmma) kernel of a fresh
build.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
HEADLINE = dict(batch=8, seq=1024, heads=8, head_dim=64)
REPLACES = {
    "flash_fwd": "torchft_tpu/ops/pallas/flash_attention.py:67",
    "flash_dq": "torchft_tpu/ops/pallas/flash_attention.py:145",
    "flash_dkv": "torchft_tpu/ops/pallas/flash_attention.py:177",
}
SOURCE = "torchft_tpu_torch/csrc/flash_attention.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def gpu_time_ms(fns, reps: int = 25, inner: int = 5, graph: bool = False) -> float:
    """Median over ``reps`` of the mean time of one call, from ``inner``
    back-to-back rounds between CUDA events. ``fns`` is one callable, or a
    list called in turn each round: over inputs whose sum exceeds the L2,
    each call then finds its own inputs evicted (an L2-cold time).

    Launched eagerly, each timed round starts from an idle card, so the
    host's cost of the first launch (tens of microseconds through a
    kernel's Python wrapper, see ``host_us_per_call``) is in the time.
    ``graph=True`` captures the rounds in a CUDA graph and replays it: the
    device's time alone."""
    fns = fns if isinstance(fns, (list, tuple)) else [fns]

    def rounds():
        for _ in range(inner):
            for fn in fns:
                fn()

    for _ in range(3):
        for fn in fns:
            fn()
    torch.cuda.synchronize()
    run = rounds
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            rounds()
        run = g.replay
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / (inner * len(fns)))
    return statistics.median(times)


def host_us_per_call(fn, calls: int = 200) -> float:
    """Host time of one call (at a size where the device keeps up)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


WGMMA_KERNELS = ("flash_fwd_wgmma", "flash_dq_wgmma", "flash_dkv_wgmma")


def check_no_spills(build_log: str) -> None:
    """Each wgmma kernel's section of a ptxas -v log reports 0 spill bytes
    (a spill of a wgmma accumulator serialises the tensor cores). An empty
    log (a library built earlier) is not checked."""
    if not build_log:
        return
    sections = build_log.split("Compiling entry function")[1:]
    for name in WGMMA_KERNELS:
        found = [sec for sec in sections if name in sec.splitlines()[0]]
        check(len(found) == 1, f"ptxas log: no single entry for {name}")
        check("0 bytes spill stores, 0 bytes spill loads" in found[0],
              f"{name} spills registers")


# ---------------------------------------------------------------------------
# phase 2 / 3: kernels
# ---------------------------------------------------------------------------


def _qkv(b, s, h, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [
        torch.randn(b, s, h, d, device="cuda", generator=g).to(dtype)
        for _ in range(4)
    ]


def _pack(x):
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def _plain_grads(q, k, v, do, causal):
    """Plain attention under autograd in float32 from the same inputs."""
    from torchft_tpu_torch.ops.attention import attention

    qf, kf, vf = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    o = attention(qf, kf, vf, causal=causal)
    o.backward(do.float())
    return o.detach(), qf.grad, kf.grad, vf.grad


def _op_grads(q, k, v, do, causal):
    from torchft_tpu_torch.ops.flash_attention import flash_attention

    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    o = flash_attention(qs, ks, vs, causal=causal)
    o.backward(do)
    return o.detach(), qs.grad, ks.grad, vs.grad


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# bfloat16 bars for gradients, elementwise: |g - ref| <= rtol * (|ref| +
# rms of ref's row over the head dim) + atol.
#
# Kernel vs its plain version (same inputs, lse and delta): rtol 2^-6,
# atol 1e-5. Two bf16 ulps of |ref| cover the rounding of the output; the
# row's rms covers the bf16 rounding of P and dS inside the kernels, whose
# error scales with the row, not with the element (entries near zero by
# cancellation); the atol covers rows that are exactly 0 (dQ of query 0
# under the causal mask, where dP - delta cancels), where float32
# summation order leaves about 5e-7. A wrong tile, a dropped diagonal
# block or a wrong mask moves an element by about its row's rms, dozens of
# times the bar, at every key position.
KERNEL_BAR = dict(rtol=2.0 ** -6, atol=1e-5, row_scaled=True)
# K1's float32 lse against its plain version, absolute: lse is about 7 at
# S=1024, where one float32 ulp is 4.8e-7; exp2 with the scale folded in
# versus exp, and another summation order, move it by a few ulps. A wrong
# tile moves it by about log(1 + its share of the row's mass), 1e-2 or more.
LSE_TOL = 1e-4
# The autograd op vs plain attention in float32: rtol 2^-7 (the output's
# bf16 rounding, with a 2x margin) and atol 2e-2, twice the largest excess
# that scripts/torch_flash_grad_errors.py measured over four seeds and
# shapes on an H100 80GB HBM3 at 700 W (1.0e-2). The op computes
# delta from its bf16 output, as the JAX backward does; the float32
# reference does not, and in the first few causal rows, where dS sums to
# zero by cancellation, that difference is not small beside the row. This
# check holds the op's wiring (packing, delta, argument order), whose
# faults are of the size of the gradients; the tile logic is held above
# and by the float32 cases below.
OP_BAR = dict(rtol=2.0 ** -7, atol=2e-2, row_scaled=False)


def _hold(name, got, ref, what, rtol, atol, row_scaled) -> float:
    """Hold ``got`` to ``ref`` elementwise at a bar above; print the error,
    the bar and the typical |ref| beside it. Returns max |err|."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    scale = ref.abs()
    if row_scaled:
        scale = scale + ref.pow(2).mean(-1, keepdim=True).sqrt()
    worst = float((err / (rtol * scale + atol)).max())
    rows = "(|ref|+row rms)" if row_scaled else "|ref|"
    log(f"{name} bf16: max|g-{what}|={float(err.max()):.3e} median|ref|="
        f"{float(ref.abs().median()):.3e} max|ref|={float(ref.abs().max()):.3e} "
        f"worst err/bar={worst:.3f} (bar {rtol:.4g}*{rows}+{atol:g}, fail >1)")
    check(worst <= 1.0, f"{name} disagrees with {what}")
    return float(err.max())


def _hold_lse(name, got, ref) -> float:
    err = _max_err(got, ref)
    log(f"{name}: max|lse-ref|={err:.3e} (tol {LSE_TOL:g})")
    check(err <= LSE_TOL, f"{name}: lse disagrees with its plain version")
    return err


def _check_kernels(fa, shape, seed, tag):
    """K1, K2 and K3 against their plain versions on the same bf16 causal
    inputs, and each launched twice on those inputs with bitwise equal
    results. Returns each kernel's max |err|."""
    b, s, h, d = shape
    q, k, v, do = _qkv(b, s, h, d, torch.bfloat16, seed=seed)
    pq, pk, pv, pdo = map(_pack, (q, k, v, do))
    plain = "its plain version"
    res = {}

    # K1: O elementwise at the kernel bar, lse at LSE_TOL
    o, lse = fa.fwd_kernel(pq, pk, pv, True)
    o_ref, lse_ref = fa.fwd_plain(pq, pk, pv, True)
    torch.cuda.synchronize()
    res["flash_fwd"] = max(_hold(f"K1 flash_fwd O {tag}", o, o_ref, plain, **KERNEL_BAR),
                           _hold_lse(f"K1 flash_fwd {tag}", lse, lse_ref))

    # K2 / K3 vs their plain versions on the same (kernel) lse and delta
    delta = (pdo.float() * o.float()).sum(-1)
    dq = fa.dq_kernel(pq, pk, pv, pdo, lse, delta, True)
    dk, dv = fa.dkv_kernel(pq, pk, pv, pdo, lse, delta, True)
    dq_ref = fa.dq_plain(pq, pk, pv, pdo, lse, delta, True)
    dk_ref, dv_ref = fa.dkv_plain(pq, pk, pv, pdo, lse, delta, True)
    torch.cuda.synchronize()
    res["flash_dq"] = _hold(f"K2 flash_dq {tag}", dq, dq_ref, plain, **KERNEL_BAR)
    res["flash_dkv"] = max(_hold(f"K3 flash_dk {tag}", dk, dk_ref, plain, **KERNEL_BAR),
                           _hold(f"K3 flash_dv {tag}", dv, dv_ref, plain, **KERNEL_BAR))

    # determinism: the checkpoint recompute must reproduce the forward
    # bit for bit (phase 5's identical checksums rest on it)
    o2, lse2 = fa.fwd_kernel(pq, pk, pv, True)
    dq2 = fa.dq_kernel(pq, pk, pv, pdo, lse, delta, True)
    dk2, dv2 = fa.dkv_kernel(pq, pk, pv, pdo, lse, delta, True)
    torch.cuda.synchronize()
    same = {"flash_fwd": torch.equal(o, o2) and torch.equal(lse, lse2),
            "flash_dq": torch.equal(dq, dq2),
            "flash_dkv": torch.equal(dk, dk2) and torch.equal(dv, dv2)}
    log(f"bitwise equal across two launches {tag}: {same}")
    check(all(same.values()), f"a kernel is not deterministic {tag}: {same}")
    return res


def phase_kernels():
    """Each kernel against its plain version at the headline shapes and at
    a ragged length (S=192, not a multiple of 128), the autograd op against
    plain attention, and float32 cases at the JAX test bars: causal at the
    headline shapes, non-causal at a small size."""
    from torchft_tpu_torch.ops import flash_attention as fa

    b, s, h, d = (HEADLINE[k] for k in ("batch", "seq", "heads", "head_dim"))
    res = _check_kernels(fa, (b, s, h, d), 1, f"b{b} s{s} h{h}")
    ragged = _check_kernels(fa, (2, 192, 2, d), 4, "b2 s192 h2")
    res = {n: max(res[n], ragged[n]) for n in res}

    # the autograd op (K1 forward, K2/K3 via backward) vs plain float32 attention
    q, k, v, do = _qkv(b, s, h, d, torch.bfloat16, seed=1)
    o_op, *g_op = _op_grads(q, k, v, do, True)
    o_pl, *g_pl = _plain_grads(q, k, v, do, True)
    err = _max_err(o_op, o_pl)
    log(f"op bf16 causal: max|O-plain_f32|={err:.3e} (tol 2e-2)")
    check(err <= 2e-2, "flash op forward disagrees with plain attention")
    for name, a, r in zip(("dq", "dk", "dv"), g_op, g_pl):
        _hold(f"op {name}", a, r, "plain float32 attention", **OP_BAR)

    # float32: the JAX test bars (2e-5 for O, 3e-4 for grads). Causal at the
    # headline shapes holds every tile position, the diagonal blocks and the
    # mask tightly; non-causal at b2 s256 h2 holds the unmasked loops.
    for shape, causal, seed in (((b, s, h, d), True, 2), ((2, 256, 2, d), False, 3)):
        q, k, v, do = _qkv(*shape, torch.float32, seed=seed)
        o_op, *g_op = _op_grads(q, k, v, do, causal)
        o_pl, *g_pl = _plain_grads(q, k, v, do, causal)
        tag = f"op f32 {'causal' if causal else 'non-causal'} b{shape[0]} s{shape[1]} h{shape[2]}"
        err = _max_err(o_op, o_pl)
        log(f"{tag}: max|O-plain|={err:.3e} (tol 2e-5)")
        check(err <= 2e-5, f"{tag}: forward disagrees with plain attention")
        for name, a, r in zip(("dq", "dk", "dv"), g_op, g_pl):
            err = _max_err(a, r)
            log(f"{tag}: max|{name}-plain|={err:.3e} (tol 3e-4) "
                f"max|ref|={float(r.abs().max()):.3e}")
            check(err <= 3e-4, f"{tag}: {name} disagrees with plain attention")
    return res


def _bounds():
    """Least time for each kernel's work at the headline shapes: the bytes
    it must move (inputs read once, outputs written once) over HBM rate,
    and the causal matmul FLOPs these inputs need over the bf16 peak."""
    b, s, h, d = (HEADLINE[k] for k in ("batch", "seq", "heads", "head_dim"))
    bh = b * h
    tensor = bh * s * d * 2  # one bf16 [BH,S,D]
    row = bh * s * 4  # one f32 [BH,S]
    pairs = bh * s * (s + 1) // 2  # causal (q, k) pairs
    work = {  # (matmuls of 2*D flops per pair, bytes)
        "flash_fwd": (2, 4 * tensor + row),  # q,k,v in; o, lse out
        "flash_dq": (3, 5 * tensor + 2 * row),  # q,k,v,dO,lse,delta in; dq out
        "flash_dkv": (4, 6 * tensor + 2 * row),  # ... in; dk, dv out
    }
    out = {}
    for name, (mms, nbytes) in work.items():
        flops = mms * 2 * d * pairs
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        out[name] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
                     flops, nbytes)
    return out


COLD_SETS = 4  # input sets rotated for L2-cold times: 135-200 MB, over the 50 MB L2


def phase_timing():
    """Each kernel's time launched eagerly (``ms``, the method of the first
    slice's records); its device time replayed from a CUDA graph with its
    inputs warm (one set, called back to back: ``ms_graph``) and L2-cold
    (``COLD_SETS`` independent sets in turn: ``ms_cold``); its host cost per
    call; its plain version's time; and the ``scaled_dot_product_attention``
    yardsticks, each by both methods."""
    import torch.nn.functional as F

    from torchft_tpu_torch.ops import flash_attention as fa

    b, s, h, d = (HEADLINE[k] for k in ("batch", "seq", "heads", "head_dim"))
    sets = []
    for seed in range(3, 3 + COLD_SETS):
        q, k, v, do = _qkv(b, s, h, d, torch.bfloat16, seed=seed)
        pq, pk, pv, pdo = map(_pack, (q, k, v, do))
        o, lse = fa.fwd_kernel(pq, pk, pv, True)
        delta = (pdo.float() * o.float()).sum(-1)
        sets.append((pq, pk, pv, pdo, lse, delta))
    tiny = [x[:, :128].contiguous() for x in sets[0]]  # device keeps up: host cost
    calls = {
        "flash_fwd": (lambda x: fa.fwd_kernel(*x[:3], True),
                      lambda x: fa.fwd_plain(*x[:3], True)),
        "flash_dq": (lambda x: fa.dq_kernel(*x, True), lambda x: fa.dq_plain(*x, True)),
        "flash_dkv": (lambda x: fa.dkv_kernel(*x, True), lambda x: fa.dkv_plain(*x, True)),
    }
    t = {}
    for name, (kernel, plain) in calls.items():
        t[name] = dict(
            ms=gpu_time_ms(lambda: kernel(sets[0])),
            ms_graph=gpu_time_ms(lambda: kernel(sets[0]), graph=True),
            ms_cold=gpu_time_ms([lambda x=x: kernel(x) for x in sets], graph=True),
            host_us=host_us_per_call(lambda: kernel(tiny)),
            plain_ms=gpu_time_ms(lambda: plain(sets[0])),
        )
    del sets

    # yardsticks only: PyTorch's own fused attention, never called by the port
    q, k, v, do = _qkv(b, s, h, d, torch.bfloat16, seed=3)
    qh, kh, vh, doh = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (qh, kh, vh))

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        return torch.autograd.grad(o, (qg, kg, vg), doh)

    sdpa = {  # (eager, CUDA graph)
        "fwd": (gpu_time_ms(sdpa_fwd), gpu_time_ms(sdpa_fwd, graph=True)),
        "fwd_bwd": (gpu_time_ms(sdpa_fwd_bwd), gpu_time_ms(sdpa_fwd_bwd, graph=True)),
    }
    bounds = _bounds()
    for name, r in t.items():
        bound, by, flops, nbytes = bounds[name]
        log(f"{name}: {r['ms']:.4f} ms eager (host launches included); CUDA graph "
            f"(device time) {r['ms_graph']:.4f} ms warm, {r['ms_cold']:.4f} ms L2-cold; host "
            f"{r['host_us']:.1f} us/call; plain {r['plain_ms']:.4f} ms; bound {bound:.4f} ms "
            f"by {by}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB")
    for i, method in enumerate(("eager", "CUDA graph")):
        fwd, both = sdpa["fwd"][i], sdpa["fwd_bwd"][i]
        key = "ms" if i == 0 else "ms_graph"
        ours = {n: t[n][key] for n in t}
        log(f"sdpa(is_causal), {method}: forward {fwd:.4f} ms, forward+backward {both:.4f} "
            f"ms vs flash fwd+dq+dkv {sum(ours.values()):.4f} ms; backward alone "
            f"(fwd+bwd - fwd) {both - fwd:.4f} ms vs flash dq+dkv "
            f"{ours['flash_dq'] + ours['flash_dkv']:.4f} ms")
    return t, bounds, sdpa["fwd"]


# ---------------------------------------------------------------------------
# phase 4 / 5: the fault-tolerant training step
# ---------------------------------------------------------------------------


def headline_config():
    from torchft_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(
        vocab_size=32000, d_model=512, n_layers=8, n_heads=8, head_dim=64,
        d_ff=1408, dtype=torch.bfloat16, attention_impl="flash",
    )


def make_tokens(cfg, seed, batch, seq):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq))).to("cuda")


def make_manager(lighthouse_addr, store, replica_id):
    """The headline loop's Manager: CollectivesTcp and the HTTP heal."""
    from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport
    from torchft_tpu_torch.collectives import CollectivesTcp
    from torchft_tpu_torch.manager import Manager

    timeout = timedelta(seconds=120)
    return Manager(
        collectives=CollectivesTcp(timeout=timeout),
        load_state_dict=None,
        state_dict=None,
        min_replica_size=1,
        replica_id=replica_id,
        store_addr=store.address(),
        rank=0,
        world_size=1,
        lighthouse_addr=lighthouse_addr,
        timeout=timeout,
        checkpoint_transport=HTTPTransport(timeout=timeout),
    )


def phase_ft_loop(warmup: int = 2, steps: int = 5):
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.parallel.ft import FTTrainer
    from torchft_tpu_torch.parallel.train_step import TrainStep
    from torchft_tpu_torch.store import StoreServer

    cfg = headline_config()
    batch, seq = HEADLINE["batch"], HEADLINE["seq"]
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=1)
    store = StoreServer()
    manager = make_manager(lighthouse.address(), store, "smoke")
    try:
        trainer = FTTrainer(manager, TrainStep(cfg, device="cuda"))
        trainer.init(seed=0)
        tokens = make_tokens(cfg, 0, batch, seq)
        for i in range(warmup):
            loss, committed = trainer.step(tokens)
            log(f"warmup step {i}: loss={loss:.5f} committed={committed}")
        torch.cuda.synchronize()
        fa.reset_launches()
        t0 = time.perf_counter()
        losses = []
        for _ in range(steps):
            loss, committed = trainer.step(tokens)
            check(committed, "a headline step did not commit")
            losses.append(loss)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES)
    finally:
        manager.shutdown(wait=False)
        store.shutdown()
        lighthouse.shutdown()
    for i, loss in enumerate(losses):
        log(f"step {i}: loss={loss:.5f}")
    check(all(np.isfinite(losses)), "non-finite loss")
    sps = steps / elapsed
    log(f"headline FT loop: {sps:.4f} steps/s, {sps * batch * seq:.1f} tokens/s "
        f"({steps} steps, batch {batch} x seq {seq}, {cfg.n_layers} layers)")
    per_step = {n: c / steps for n, c in launches.items()}
    log(f"kernel launches per step: {per_step}")
    expect = _launches_per_step(cfg)
    check(per_step == expect, f"launches per step {per_step} != {expect}")
    return launches


def _launches_per_step(cfg):
    # forward + checkpoint recompute per layer; one backward per layer
    return {"flash_fwd": 2 * cfg.n_layers, "flash_dq": cfg.n_layers,
            "flash_dkv": cfg.n_layers}


def _param_digest(params) -> str:
    from torchft_tpu_torch.utils.tree import tree_leaves

    h = hashlib.sha256()
    for leaf in tree_leaves(params):
        h.update(leaf.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def phase_two_groups(together: int = 3):
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.parallel.ft import FTTrainer
    from torchft_tpu_torch.parallel.train_step import TrainStep
    from torchft_tpu_torch.store import StoreServer

    cfg = headline_config()
    batch, seq = HEADLINE["batch"], HEADLINE["seq"]
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=1)
    first_commit = threading.Event()
    results = {}
    errors = []
    calls = {0: 0, 1: 0}  # trainer.step calls per group

    def group(gid: int) -> None:
        try:
            if gid == 1:
                if not first_commit.wait(timeout=600):
                    raise TimeoutError("group 0 never committed")
            store = StoreServer()
            manager = make_manager(lighthouse.address(), store, f"group{gid}")
            try:
                trainer = FTTrainer(manager, TrainStep(cfg, device="cuda"))
                trainer.init(seed=100 + gid)  # different inits: the heal must matter
                tokens = make_tokens(cfg, 10 + gid, batch, seq)
                joint = healed_at = 0
                while joint < together:
                    step_before = manager.current_step()
                    loss, committed = trainer.step(tokens)
                    calls[gid] += 1
                    if gid == 1 and manager.current_step() > step_before + 1:
                        healed_at = manager.current_step()
                    if committed and manager.num_participants() == 2:
                        joint += 1
                    if gid == 0 and committed:
                        first_commit.set()
                    log(f"group{gid}: step={manager.current_step()} loss={loss:.5f} "
                        f"committed={committed} participants={manager.num_participants()}")
                torch.cuda.synchronize()
                results[gid] = (manager.current_step(), _param_digest(trainer.params),
                                healed_at)
            finally:
                manager.shutdown(wait=False)
                store.shutdown()
        except Exception as e:  # noqa: BLE001 — reported by the main thread
            first_commit.set()
            errors.append(f"group{gid}: {e!r}")

    threads = [threading.Thread(target=group, args=(g,)) for g in (0, 1)]
    torch.cuda.synchronize()
    fa.reset_launches()
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
    finally:
        lighthouse.shutdown()
    check(not errors, f"two-group phase failed: {errors}")
    check(all(not th.is_alive() for th in threads), "two-group phase hung")
    (s0, d0, _), (s1, d1, healed_at) = results[0], results[1]
    log(f"group0 step={s0} checksum={d0}")
    log(f"group1 step={s1} checksum={d1} (healed to step {healed_at})")
    check(healed_at > 0, "group 1 never healed from group 0")
    check(s0 == s1 and d0 == d1, "groups ended with different parameters")
    # every step of either group, committed or not, runs forward + backward
    launches = dict(fa.LAUNCHES)
    expect = {n: c * (calls[0] + calls[1]) for n, c in _launches_per_step(cfg).items()}
    log(f"two groups: {calls[0]} + {calls[1]} steps, kernel launches {launches}")
    check(launches == expect, f"two-group launches {launches} != {expect}")


# ---------------------------------------------------------------------------


def main() -> None:
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from torchft_tpu_torch import _native
    from torchft_tpu_torch.ops import flash_attention as fa

    # build the native core and the kernels together; a failed build ends the run
    t0 = time.perf_counter()

    def timed(fn):
        start = time.perf_counter()
        fn()
        return time.perf_counter() - start

    with ThreadPoolExecutor(max_workers=2) as pool:
        native_s, kernels_s = (f.result() for f in [pool.submit(timed, _native.build),
                                                    pool.submit(timed, fa.build)])
    log(f"builds done in {time.perf_counter() - t0:.1f}s (native core {native_s:.1f}s, "
        f"kernels {kernels_s:.1f}s, in parallel)")
    # ptxas -v: each kernel's entry, registers and spills, and any warning
    # (a setmaxnreg that was ignored shows here)
    keep = ("entry function", "Used", "spill", "warning")
    build_log = fa.build_log()
    for line in (build_log or "(no build log: the library was built earlier)").splitlines():
        if any(word in line for word in keep):
            log(f"ptxas | {line.strip()}")
    check_no_spills(build_log)

    errs = phase_kernels()
    t, bounds, sdpa_fwd = phase_timing()
    launches = phase_ft_loop()
    phase_two_groups()

    kernels = [
        {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": t[name]["ms"], "ms_graph": t[name]["ms_graph"],
            "ms_cold": t[name]["ms_cold"], "plain_ms": t[name]["plain_ms"],
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            "library_ms": sdpa_fwd[0] if name == "flash_fwd" else None,
            "library_ms_graph": sdpa_fwd[1] if name == "flash_fwd" else None,
        }
        for name in ("flash_fwd", "flash_dq", "flash_dkv")
    ]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
