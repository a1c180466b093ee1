"""Flash attention: the three hand-written Hopper kernels (forward, dQ,
dK/dV in ``csrc/flash_attention.cu``) behind one ``torch.autograd.Function``
— the counterpart of ``torchft_tpu/ops/pallas/flash_attention.py`` and its
``jax.custom_vjp``.

Each kernel has a plain PyTorch version of the same function here
(``fwd_plain``, ``dq_plain``, ``dkv_plain``), used to check the kernel on
the card. The public op takes the plain route only for tensors on the
CPU (plain :func:`~torchft_tpu_torch.ops.attention.attention` under
autograd); a CUDA tensor launches the kernels or raises.

:func:`supported` is the one statement of what the op takes: float32
and bf16 at any head dim up to :data:`MAX_HEAD_DIM` (256) and any S up to
65535 tiles of :data:`TILE`. The kernels are built at the head dims of
:data:`KERNEL_HEAD_DIMS` (8, 16, 32, 64, 128, 256); the op pads any other
with zero columns to the next of them (:func:`padded_head_dim`) inside its
packing copy, hands the kernels the true head dim's scale, and slices the
result back. bf16 at 128 and 256 (any S), and at 32 and 64 with S a
multiple of :data:`TILE`, runs on the wgmma kernels; float32 K1 at 128
and 256 on the register-blocked FMA kernel; every other shape on the FMA
kernels (32-row tiles at 128 and 256). All mask the last tile. The JAX op
also takes head dims above 256; the port's does not.

The kernels are built with ``nvcc`` at first use into
``build/torch_kernels/``, keyed by a digest of every file under ``csrc/``,
and loaded with ctypes (a plain C interface).
Every launch adds one to :data:`LAUNCHES`, keyed by kernel name. A call
made while its stream is being captured into a CUDA graph launches
nothing: inside :func:`recorded_launches` it is counted for the graph, and
the graph's owner adds those counts once per replay (:func:`add_launches`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import threading
from contextlib import contextmanager
from typing import Dict, Iterator, Optional, Tuple

import torch

from torchft_tpu_torch.ops.attention import attention
from torchft_tpu_torch.utils.platform import build_dir, run_locked_build

__all__ = [
    "flash_attention",
    "LAUNCHES",
    "reset_launches",
    "recorded_launches",
    "add_launches",
    "build",
    "bind",
    "nvcc_command",
    "fwd_kernel",
    "dq_kernel",
    "dkv_kernel",
    "fwd_plain",
    "dq_plain",
    "dkv_plain",
    "CSRC_DIR",
    "source_digest",
    "build_log",
    "supported",
    "op_supported",
    "padded_head_dim",
    "TILE",
    "BLOCK",
    "KERNEL_HEAD_DIMS",
    "MAX_HEAD_DIM",
]

CSRC_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc"
)
TILE = 64  # the wgmma kernels' tile rows; S up to 65535 of them
# the op's default blocks, the Pallas op's: S must be a multiple of min(BLOCK, S)
BLOCK = 128
# the head dims the kernels are built at, in float32 and bf16 at any S; the
# op pads every other head dim up to MAX_HEAD_DIM to the next of them.
# csrc/flash_attention.cu's `supported` and `instantiated` say the same
KERNEL_HEAD_DIMS = (8, 16, 32, 64, 128, 256)
MAX_HEAD_DIM = KERNEL_HEAD_DIMS[-1]
_MAX_SEQ = 65535 * TILE
_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# launches of each kernel since the last reset_launches()
LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
# replica groups may run as threads of one process: the counts stay exact
_launches_lock = threading.Lock()
# launches recorded into a CUDA graph, by the handle of the capturing stream
_recorders: Dict[int, Dict[str, int]] = {}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    with _launches_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count_launch(name: str, stream: int) -> None:
    with _launches_lock:
        _recorders.get(stream, LAUNCHES)[name] += 1


@contextmanager
def recorded_launches(stream: "torch.cuda.Stream") -> Iterator[Dict[str, int]]:
    """While ``stream`` is captured into a CUDA graph: count the calls made
    on it (from any thread: autograd runs the backward on its own) into the
    yielded dict instead of :data:`LAUNCHES`."""
    counts = {name: 0 for name in LAUNCHES}
    with _launches_lock:
        _recorders[stream.cuda_stream] = counts
    try:
        yield counts
    finally:
        with _launches_lock:
            del _recorders[stream.cuda_stream]


def add_launches(counts: Dict[str, int]) -> None:
    """Add a graph's recorded launches (one replay) to :data:`LAUNCHES`."""
    with _launches_lock:
        for name, n in counts.items():
            LAUNCHES[name] += n


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def _csrc_files(csrc: str):
    return sorted(
        os.path.relpath(os.path.join(root, name), csrc)
        for root, _, names in os.walk(csrc)
        for name in names
    )


def source_digest(csrc: str = CSRC_DIR) -> str:
    """sha256 over the names and bytes of every file under ``csrc``: the
    library's key, so an edit of any source or header rebuilds it."""
    h = hashlib.sha256()
    for rel in _csrc_files(csrc):
        with open(os.path.join(csrc, rel), "rb") as f:
            data = f.read()
        h.update(f"{rel}\0{len(data)}\0".encode())
        h.update(data)
    return h.hexdigest()[:16]


def _library_path() -> str:
    return os.path.join(build_dir("torch_kernels"), f"libtft_flash_{source_digest()}.so")


def nvcc_command(out: str, csrc: str = CSRC_DIR):
    """One ``nvcc`` call over every ``.cu`` file under ``csrc``; ``-Xptxas -v``
    reports each kernel's registers and spills into the build log."""
    sources = [os.path.join(csrc, rel) for rel in _csrc_files(csrc) if rel.endswith(".cu")]
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", "-o", out, *sources,
    ]


def build() -> str:
    """Compile the kernels (once per source content) and return the
    shared library's path."""
    out = _library_path()
    return run_locked_build(out, nvcc_command(out), log=out + ".log")


def build_log() -> str:
    """The output of the build that made the current library (ptxas'
    registers and spills per kernel); empty if it was built elsewhere."""
    log = _library_path() + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()


def bind(path: str) -> ctypes.CDLL:
    """Load a kernel library built from ``csrc/`` (or from a variant of it)
    and declare its C interface."""
    lib = ctypes.CDLL(path)
    c = ctypes
    vp, i, f = c.c_void_p, c.c_int, c.c_float
    lib.tft_flash_fwd.argtypes = [i, vp, vp, vp, vp, vp, i, i, i, f, i, vp]
    lib.tft_flash_dq.argtypes = [i, vp, vp, vp, vp, vp, vp, vp, i, i, i, f, i, vp]
    lib.tft_flash_dkv.argtypes = [i, vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, f, i, vp]
    for fn in (lib.tft_flash_fwd, lib.tft_flash_dq, lib.tft_flash_dkv):
        fn.restype = c.c_int
    lib.tft_flash_supported.argtypes = [i, i, i]
    lib.tft_flash_supported.restype = i
    lib.tft_cuda_error_string.argtypes = [i]
    lib.tft_cuda_error_string.restype = c.c_char_p
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind(build())
        return _lib


def _check(name: str, *tensors: torch.Tensor, dtype: torch.dtype) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")


def supported(dtype: torch.dtype, head_dim: int, seq_len: int) -> bool:
    """Whether the kernels take q/k/v of this dtype, head dim and sequence
    length, padded to :func:`padded_head_dim` where the head dim is not one
    of :data:`KERNEL_HEAD_DIMS` (the model's ``"auto"`` attention routes by
    it)."""
    return (dtype in _DTYPE_CODE and 0 < head_dim <= MAX_HEAD_DIM
            and 0 < seq_len <= _MAX_SEQ)


def padded_head_dim(head_dim: int) -> int:
    """The kernels' head dim that takes ``head_dim`` (the next of
    :data:`KERNEL_HEAD_DIMS` at or above it); raises above
    :data:`MAX_HEAD_DIM`."""
    for d in KERNEL_HEAD_DIMS:
        if head_dim <= d:
            return d
    raise ValueError(f"head dim {head_dim} above {MAX_HEAD_DIM} not supported")


def op_supported(dtype: torch.dtype, head_dim: int, seq_len: int) -> bool:
    """Whether :func:`flash_attention` at its default blocks takes q/k/v of
    this dtype, head dim and sequence length on the card: the kernels take
    them (:func:`supported`) and S is a multiple of min(``BLOCK``, S)."""
    return seq_len % min(BLOCK, max(seq_len, 1)) == 0 and supported(dtype, head_dim, seq_len)


def _check_qkv(name: str, q, k, v) -> Tuple[int, int, int]:
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: dtype {q.dtype} not supported (float32, bfloat16)")
    _check(name, q, k, v, dtype=q.dtype)
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"{name}: q/k/v must share one [BH, S, D] shape")
    bh, s, d = q.shape
    if d not in KERNEL_HEAD_DIMS or not supported(q.dtype, d, s):
        raise ValueError(
            f"{name}: {q.dtype} at head dim {d}, seq len {s} not supported (head dims "
            f"{KERNEL_HEAD_DIMS} at any seq len up to {_MAX_SEQ}; flash_attention pads "
            f"the others up to {MAX_HEAD_DIM})"
        )
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q/k/v on different devices")
    return bh, s, d


def _raise_if_failed(name: str, lib: ctypes.CDLL, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed: {lib.tft_cuda_error_string(rc).decode()} ({rc})"
        )


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _scale(scale: Optional[float], head_dim: int) -> float:
    return head_dim ** -0.5 if scale is None else scale


def fwd_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on the card: ``(o [BH,S,D] in q's dtype, lse [BH,S] float32)``.
    ``scale`` multiplies the scores (default D^-0.5; a padded call passes
    its true head dim's)."""
    bh, s, d = _check_qkv("flash_fwd", q, k, v)
    lib = _load()
    o = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    stream = _stream(q)
    with torch.cuda.device(q.device):
        rc = lib.tft_flash_fwd(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), bh, s, d, _scale(scale, d), int(causal),
            stream,
        )
    _raise_if_failed("flash_fwd", lib, rc)
    _count_launch("flash_fwd", stream)
    return o, lse


def _check_bwd(name, q, k, v, do, lse, delta):
    bh, s, d = _check_qkv(name, q, k, v)
    _check(name, do, dtype=q.dtype)
    _check(name, lse, delta, dtype=torch.float32)
    if do.shape != q.shape or lse.shape != (bh, s) or delta.shape != (bh, s):
        raise ValueError(f"{name}: dO must be [BH,S,D] and lse/delta [BH,S]")
    return bh, s, d


def dq_kernel(q, k, v, do, lse, delta, causal: bool, scale=None) -> torch.Tensor:
    """K2 on the card: dQ in q's dtype (``scale`` as :func:`fwd_kernel`'s)."""
    bh, s, d = _check_bwd("flash_dq", q, k, v, do, lse, delta)
    lib = _load()
    dq = torch.empty_like(q)
    stream = _stream(q)
    with torch.cuda.device(q.device):
        rc = lib.tft_flash_dq(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            bh, s, d, _scale(scale, d), int(causal), stream,
        )
    _raise_if_failed("flash_dq", lib, rc)
    _count_launch("flash_dq", stream)
    return dq


def dkv_kernel(q, k, v, do, lse, delta, causal: bool,
               scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 on the card: (dK, dV) in k's / v's dtype (``scale`` as
    :func:`fwd_kernel`'s)."""
    bh, s, d = _check_bwd("flash_dkv", q, k, v, do, lse, delta)
    lib = _load()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    stream = _stream(q)
    with torch.cuda.device(q.device):
        rc = lib.tft_flash_dkv(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), bh, s, d, _scale(scale, d), int(causal), stream,
        )
    _raise_if_failed("flash_dkv", lib, rc)
    _count_launch("flash_dkv", stream)
    return dk, dv


# ---------------------------------------------------------------------------
# plain versions of the three kernels ([BH, S, D] layout, float32 math)
# ---------------------------------------------------------------------------


def _scores(q, k, causal, rows=None, scale=None):
    """Scaled scores of query rows ``rows`` = (r0, r1) (default all) against
    every key, in float32, masked where a key lies past its query."""
    r0, r1 = rows if rows is not None else (0, q.shape[1])
    scores = torch.einsum("bqd,bkd->bqk", q[:, r0:r1].float(), k.float()) * _scale(
        scale, q.shape[-1])
    if causal:
        qpos = torch.arange(r0, r1, device=q.device)
        kpos = torch.arange(k.shape[1], device=q.device)
        keep = kpos[None, :] <= qpos[:, None]
        scores = torch.where(keep, scores, torch.full_like(scores, _NEG_INF))
    return scores


# Each plain version takes ``rows`` = (r0, r1): it then computes its kernel's
# outputs for query rows [r0, r1) only, against every key: O, lse and dQ of
# those rows, and those rows' share of the sums that make dK and dV (summed
# over chunks of rows in float32, ``out_dtype``, they give all of dK and dV).
# That holds the kernels at lengths whose [S, S] scores do not fit. Each
# takes its kernel's ``scale`` too (default D^-0.5).


def fwd_plain(q, k, v, causal: bool, rows=None,
              scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """What K1 computes: (o in q's dtype, lse float32)."""
    scores = _scores(q, k, causal, rows, scale)
    lse = torch.logsumexp(scores, dim=-1)
    p = torch.exp(scores - lse[..., None])
    o = torch.einsum("bqk,bkd->bqd", p, v.float())
    return o.to(q.dtype), lse


def _dscores(q, k, v, do, lse, delta, causal, rows, scale):
    r0, r1 = rows if rows is not None else (0, q.shape[1])
    p = torch.exp(_scores(q, k, causal, rows, scale) - lse[:, r0:r1, None])
    dp = torch.einsum("bqd,bkd->bqk", do[:, r0:r1].float(), v.float())
    ds = p * (dp - delta[:, r0:r1, None]) * _scale(scale, q.shape[-1])
    return p, ds, (r0, r1)


def dq_plain(q, k, v, do, lse, delta, causal: bool, rows=None, scale=None) -> torch.Tensor:
    """What K2 computes: dQ = sum_j dS_ij K_j, P recomputed from lse."""
    _, ds, _ = _dscores(q, k, v, do, lse, delta, causal, rows, scale)
    return torch.einsum("bqk,bkd->bqd", ds, k.float()).to(q.dtype)


def dkv_plain(q, k, v, do, lse, delta, causal: bool, rows=None, out_dtype=None,
              scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """What K3 computes: dK = sum_i dS_ij^T Q_i, dV = sum_i P_ij^T dO_i, in
    ``out_dtype`` (default k's and v's)."""
    p, ds, (r0, r1) = _dscores(q, k, v, do, lse, delta, causal, rows, scale)
    dk = torch.einsum("bqk,bqd->bkd", ds, q[:, r0:r1].float()).to(out_dtype or k.dtype)
    dv = torch.einsum("bqk,bqd->bkd", p, do[:, r0:r1].float()).to(out_dtype or v.dtype)
    return dk, dv


# ---------------------------------------------------------------------------
# public op
# ---------------------------------------------------------------------------


class _Flash(torch.autograd.Function):
    """The kernels' custom gradient (the ``_flash`` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = fwd_kernel(q, k, v, causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        # delta = rowsum(dO * O): a plain reduction outside the kernels,
        # as in the JAX backward; the named range lets a profile report
        # its device time (scripts/torch_step_profile.py)
        with torch.profiler.record_function("flash_attention.delta"):
            delta = (do.float() * o.float()).sum(dim=-1)
        dq = dq_kernel(q, k, v, do, lse, delta, ctx.causal, scale=ctx.scale)
        dk, dv = dkv_kernel(q, k, v, do, lse, delta, ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    block_q: int = BLOCK,
    block_k: int = BLOCK,
) -> torch.Tensor:
    """Flash attention. q/k/v: [B, S, H, Dh] -> [B, S, H, Dh], scale Dh^-0.5.

    Raises ``ValueError`` unless S is a multiple of the block sizes (as the
    JAX op does). The blocks only validate the shape: the CUDA kernels use
    their own tiles. On the card it takes float32 and bf16 at any Dh up to
    256 (:func:`supported`; a Dh that is not one of :data:`KERNEL_HEAD_DIMS`
    runs padded with zero columns, :func:`padded_head_dim`) and raises
    ``ValueError`` above 256, where the JAX op takes any Dh.
    Differentiable through the dQ and dK/dV kernels."""
    b, s, h, d = q.shape
    bq, bk = min(block_q, s), min(block_k, s)
    if s % bq or s % bk:
        raise ValueError(f"seq len {s} must be a multiple of block sizes ({bq},{bk})")
    if q.device.type == "cpu":
        return attention(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _flash_packed(q, k, v, causal)


def _flash_packed(q, k, v, causal: bool) -> torch.Tensor:
    """The op's kernel route: q/k/v [B, S, H, Dh] packed to [B*H, S, Dp] by
    one copy each, Dp = :func:`padded_head_dim` (Dh), which raises above
    256: zero columns past Dh come with the copy (a concatenation, no pass
    of their own); the kernels scale by Dh^-0.5, the true head dim's, and
    refuse what else :func:`supported` refuses; the output is a view of the
    first Dh columns."""
    b, s, h, d = q.shape
    dp = padded_head_dim(d)

    def pack(x):
        x = x.transpose(1, 2)
        if dp != d:
            x = torch.cat((x, x.new_zeros(()).expand(b, h, s, dp - d)), dim=-1)
        return x.reshape(b * h, s, dp).contiguous()

    o = _Flash.apply(pack(q), pack(k), pack(v), causal, d ** -0.5)
    return o.reshape(b, h, s, dp)[..., :d].transpose(1, 2)
