"""Flash attention: the three hand-written Hopper kernels (forward, dQ,
dK/dV in ``csrc/flash_attention.cu``) behind one ``torch.autograd.Function``
— the counterpart of ``torchft_tpu/ops/pallas/flash_attention.py`` and its
``jax.custom_vjp``.

Each kernel has a plain PyTorch version of the same function here
(``fwd_plain``, ``dq_plain``, ``dkv_plain``), used to check the kernel on
the card. The public op takes the plain route only for tensors on the
CPU (plain :func:`~torchft_tpu_torch.ops.attention.attention` under
autograd); a CUDA tensor launches the kernels or raises.

:func:`supported` is the one statement of what the kernels take: float32
and bf16 at head dims 8, 16, 32 and 64 at any S, and bf16 at 128 with S a
multiple of :data:`TILE`. bf16 at 32, 64 and 128 with S a multiple of
:data:`TILE` runs on the wgmma kernels; every other shape on the FMA
kernels, which mask the last tile. The JAX op takes any head dim; the
port's does not.

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
    "TILE",
    "BLOCK",
]

CSRC_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc"
)
TILE = 64  # the kernels' tile rows: the wgmma kernels take S a multiple of it
# the op's default blocks, the Pallas op's: S must be a multiple of min(BLOCK, S)
BLOCK = 128
# head dims the FMA kernels take in both dtypes at any S (float32 tiles at
# 128 pass the shared memory); bf16 at 128 runs on wgmma alone.
# csrc/flash_attention.cu's `supported` says the same
_FMA_HEAD_DIMS = (8, 16, 32, 64)
_MAX_SEQ = 65535 * TILE  # a launch's grid holds at most 65535 tiles of S
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
    length (the model's ``"auto"`` attention routes by it)."""
    if dtype not in _DTYPE_CODE or not 0 < seq_len <= _MAX_SEQ:
        return False
    if head_dim in _FMA_HEAD_DIMS:
        return True
    return head_dim == 128 and dtype == torch.bfloat16 and seq_len % TILE == 0


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
    if not supported(q.dtype, d, s):
        raise ValueError(
            f"{name}: {q.dtype} at head dim {d}, seq len {s} not supported (head dims "
            f"{_FMA_HEAD_DIMS} at any seq len up to {_MAX_SEQ}, and 128 in bfloat16 at a "
            f"multiple of {TILE})"
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


def fwd_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on the card: ``(o [BH,S,D] in q's dtype, lse [BH,S] float32)``."""
    bh, s, d = _check_qkv("flash_fwd", q, k, v)
    lib = _load()
    o = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    stream = _stream(q)
    with torch.cuda.device(q.device):
        rc = lib.tft_flash_fwd(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), bh, s, d, d ** -0.5, int(causal),
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


def dq_kernel(q, k, v, do, lse, delta, causal: bool) -> torch.Tensor:
    """K2 on the card: dQ in q's dtype."""
    bh, s, d = _check_bwd("flash_dq", q, k, v, do, lse, delta)
    lib = _load()
    dq = torch.empty_like(q)
    stream = _stream(q)
    with torch.cuda.device(q.device):
        rc = lib.tft_flash_dq(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            bh, s, d, d ** -0.5, int(causal), stream,
        )
    _raise_if_failed("flash_dq", lib, rc)
    _count_launch("flash_dq", stream)
    return dq


def dkv_kernel(q, k, v, do, lse, delta, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 on the card: (dK, dV) in k's / v's dtype."""
    bh, s, d = _check_bwd("flash_dkv", q, k, v, do, lse, delta)
    lib = _load()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    stream = _stream(q)
    with torch.cuda.device(q.device):
        rc = lib.tft_flash_dkv(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), bh, s, d, d ** -0.5, int(causal), stream,
        )
    _raise_if_failed("flash_dkv", lib, rc)
    _count_launch("flash_dkv", stream)
    return dk, dv


# ---------------------------------------------------------------------------
# plain versions of the three kernels ([BH, S, D] layout, float32 math)
# ---------------------------------------------------------------------------


def _scores(q, k, causal, rows=None):
    """Scaled scores of query rows ``rows`` = (r0, r1) (default all) against
    every key, in float32, masked where a key lies past its query."""
    r0, r1 = rows if rows is not None else (0, q.shape[1])
    scores = torch.einsum("bqd,bkd->bqk", q[:, r0:r1].float(), k.float()) * q.shape[-1] ** -0.5
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
# That holds the kernels at lengths whose [S, S] scores do not fit.


def fwd_plain(q, k, v, causal: bool, rows=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """What K1 computes: (o in q's dtype, lse float32)."""
    scores = _scores(q, k, causal, rows)
    lse = torch.logsumexp(scores, dim=-1)
    p = torch.exp(scores - lse[..., None])
    o = torch.einsum("bqk,bkd->bqd", p, v.float())
    return o.to(q.dtype), lse


def _dscores(q, k, v, do, lse, delta, causal, rows):
    r0, r1 = rows if rows is not None else (0, q.shape[1])
    p = torch.exp(_scores(q, k, causal, rows) - lse[:, r0:r1, None])
    dp = torch.einsum("bqd,bkd->bqk", do[:, r0:r1].float(), v.float())
    ds = p * (dp - delta[:, r0:r1, None]) * q.shape[-1] ** -0.5
    return p, ds, (r0, r1)


def dq_plain(q, k, v, do, lse, delta, causal: bool, rows=None) -> torch.Tensor:
    """What K2 computes: dQ = sum_j dS_ij K_j, P recomputed from lse."""
    _, ds, _ = _dscores(q, k, v, do, lse, delta, causal, rows)
    return torch.einsum("bqk,bkd->bqd", ds, k.float()).to(q.dtype)


def dkv_plain(q, k, v, do, lse, delta, causal: bool, rows=None,
              out_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """What K3 computes: dK = sum_i dS_ij^T Q_i, dV = sum_i P_ij^T dO_i, in
    ``out_dtype`` (default k's and v's)."""
    p, ds, (r0, r1) = _dscores(q, k, v, do, lse, delta, causal, rows)
    dk = torch.einsum("bqk,bqd->bkd", ds, q[:, r0:r1].float()).to(out_dtype or k.dtype)
    dv = torch.einsum("bqk,bqd->bkd", p, do[:, r0:r1].float()).to(out_dtype or v.dtype)
    return dk, dv


# ---------------------------------------------------------------------------
# public op
# ---------------------------------------------------------------------------


class _Flash(torch.autograd.Function):
    """The kernels' custom gradient (the ``_flash`` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = fwd_kernel(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
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
        dq = dq_kernel(q, k, v, do, lse, delta, ctx.causal)
        dk, dv = dkv_kernel(q, k, v, do, lse, delta, ctx.causal)
        return dq, dk, dv, None


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
    their own 64-row tiles, and on the card raise ``ValueError`` for what
    :func:`supported` refuses (a head dim other than 8, 16, 32, 64 or 128,
    float32 at 128, or bf16 at 128 with S not a multiple of 64), where the
    JAX op takes any Dh. Differentiable through the dQ and dK/dV kernels."""
    b, s, h, d = q.shape
    bq, bk = min(block_q, s), min(block_k, s)
    if s % bq or s % bk:
        raise ValueError(f"seq len {s} must be a multiple of block sizes ({bq},{bk})")
    if q.device.type == "cpu":
        return attention(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")

    def pack(x):
        return x.transpose(1, 2).reshape(b * h, s, d).contiguous()

    o = _Flash.apply(pack(q), pack(k), pack(v), causal)
    return o.reshape(b, h, s, d).transpose(1, 2)
