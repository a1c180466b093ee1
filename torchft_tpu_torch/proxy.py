"""Subprocess-isolated collectives — the port's copy of ``torchft_tpu/proxy.py``.

Reference: ProcessGroupBabyGloo/BabyNCCL (process_group.py:795-1329): the
real transport runs in a *spawned child process* so a wedged or crashed
backend can be SIGKILLed and respawned without taking down the trainer.
The port's host planes (``CollectivesTcp``) take host numpy arrays (``ddp``
copies the device gradients down), so the proxy is a host-side module:
``CollectivesProxy`` wraps any ``Collectives`` backend,

* ``configure`` kills the previous child and spawns a fresh one that
  builds the backend from a picklable factory and rendezvouses;
* every op ships its arrays to the child over monitored queues, executes
  synchronously there, and the result is copied back into the caller's
  buffers (in-place semantics preserved);
* child death surfaces as RuntimeError on every pending op within ~1 s
  (the drain thread of the child's generation fails them) — the Manager
  latches it and reconfigures at the next quorum.

Large ``allreduce`` payloads (gradient buckets) travel through POSIX
shared memory — the ``_maybe_share_tensors`` analogue
(process_group.py:775-786): the parent stages the buffers into a per-op
segment, the child runs the backend's in-place allreduce directly on the
mapped views, and the parent copies the reduced bytes back — one copy
each way instead of pickling megabytes through a pipe twice. Small or
non-contiguous payloads stay on the pickle path.

``plane_info()`` reads ``proxy:<inner>`` and ``wire_codec()`` the child
backend's codec, both fetched once per ``configure``. The fault point
``collective.issue`` fires parent-side with ``match="proxy.<op>"``; the
child's backend fires its own sites (it inherits
``TORCHFT_FAULT_SCHEDULE`` through the spawn environment).
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import os
import threading
from datetime import timedelta
from multiprocessing import shared_memory
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from torchft_tpu_torch.checkpointing.serialization import _resolve_dtype
from torchft_tpu_torch.collectives import Collectives, ReduceOp, Work
from torchft_tpu_torch.faultinject.core import fault_point
from torchft_tpu_torch.futures import Future, future_wait
from torchft_tpu_torch.multiprocessing import MonitoredQueue

logger = logging.getLogger(__name__)

__all__ = ["CollectivesProxy"]

# below this total, pickling through the queue beats shm setup syscalls
_SHM_MIN_BYTES = 1 << 16
# the child attaches via /dev/shm/{name}, which only exists on Linux; on
# other POSIX platforms the pickle path works everywhere
_HAS_DEV_SHM = os.path.isdir("/dev/shm")


def _buf_views(buf, metas: List[Tuple[int, Tuple[int, ...], str]]) -> List[np.ndarray]:
    # go through a uint8 view: ml_dtypes (bfloat16/fp8) reject the raw
    # buffer protocol that np.ndarray(buffer=...) uses
    views = []
    for off, shape, dt in metas:
        dtype = _resolve_dtype(dt)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        views.append(
            np.frombuffer(buf, np.uint8, count=nbytes, offset=off).view(dtype).reshape(shape)
        )
    return views


def _safe_close(shm: shared_memory.SharedMemory) -> None:
    """Close the mapping; numpy views hold buffer exports until refcounts
    drop, so fall back to a gc pass (a still-open mapping only holds
    virtual memory — unlink is what frees /dev/shm space, and it never
    fails on open mappings)."""
    try:
        shm.close()
    except BufferError:
        import gc

        gc.collect()
        try:
            shm.close()
        except BufferError:
            pass


def _child_allreduce(backend: Collectives, buf, metas, op) -> None:
    # scoped so the views (and the Work future that captures them) are
    # dropped before the caller closes the mapping
    backend.allreduce(_buf_views(buf, metas), op).wait()


def _copy_out(shm, metas, arrays: List[np.ndarray]) -> None:
    for dst, view in zip(arrays, _buf_views(shm.buf, metas)):
        np.copyto(dst, view)


def _copy_in(shm, metas, arrays: List[np.ndarray]) -> None:
    for view, a in zip(_buf_views(shm.buf, metas), arrays):
        np.copyto(view, a)


def _attach(shm_name: str):
    """Map the parent's segment by raw mmap: ``SharedMemory``'s attach path
    registers with the resource tracker (CPython <= 3.12 has no
    ``track=False``), which would leak a registration per op and let a
    dying child's tracker unlink segments the parent still owns."""
    import mmap

    fd = os.open(f"/dev/shm/{shm_name}", os.O_RDWR)
    try:
        return mmap.mmap(fd, 0)
    finally:
        os.close(fd)


def _worker(factory, store_addr, rank, world_size, tx, rx) -> None:
    """Child main: build the backend, rendezvous, serve ops sequentially."""
    try:
        backend: Collectives = factory()
        backend.configure(store_addr, rank, world_size)
        rx.put(("ready", None, None))
    except Exception as e:  # noqa: BLE001
        rx.put(("err", None, e))
        return
    while True:
        cmd = tx.get()
        if cmd is None:
            backend.shutdown()
            return
        op_id, name, args, kwargs = cmd
        try:
            if name == "allreduce_shm":
                shm_name, metas, op = args
                buf = _attach(shm_name)
                try:
                    # the backend reduces IN PLACE on the mapped views; the
                    # reduced bytes are visible to the parent with no
                    # return payload
                    _child_allreduce(backend, buf, metas, op)
                    result = None
                finally:
                    try:
                        buf.close()
                    except BufferError:
                        pass  # views freed with the op; the mapping dies with us
            elif name in ("plane_info", "wire_codec"):
                # metadata query, not an op: returns a plain string
                result = getattr(backend, name)()
            else:
                result = getattr(backend, name)(*args, **kwargs).wait()
            rx.put(("ok", op_id, result))
        except Exception as e:  # noqa: BLE001
            rx.put(("err", op_id, e))


class CollectivesProxy(Collectives):
    """Run a Collectives backend in a kill-safe child process."""

    def __init__(
        self,
        factory: Callable[[], Collectives],
        timeout: timedelta = timedelta(seconds=60),
    ) -> None:
        """``factory`` must be picklable (a module-level callable, or a
        ``functools.partial`` of one) — it runs in the spawned child to
        build the real backend."""
        self._factory = factory
        self._timeout = timeout
        self._ctx = mp.get_context("spawn")
        self._proc: Optional[mp.Process] = None
        self._tx: Optional[mp.Queue] = None
        self._rx: Optional[mp.Queue] = None
        self._rank = -1
        self._world = 0
        self._op_id = 0  # guarded-by: _lock
        self._generation = 0  # guarded-by: _lock
        self._pending: Dict[int, Future] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self._drain: Optional[threading.Thread] = None
        self._inner_plane = ""  # the child backend's live plane label
        self._inner_codec = ""  # the child backend's live wire codec

    def plane_info(self) -> str:
        # the inner backend lives in the child; report its live transport
        # under the isolation layer's prefix (fetched once per configure),
        # so a silent CMA -> TCP fallback stays visible
        inner = self._inner_plane
        return f"proxy:{inner}" if inner else "proxy"

    def wire_codec(self) -> str:
        # fetched with the plane label at configure: the codec the child
        # backend actually rides (error feedback keys off it)
        return self._inner_codec or "f32"

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        self.shutdown()
        self._rank, self._world = rank, world_size
        with self._lock:
            self._generation += 1
            gen = self._generation
        tx = self._ctx.Queue()
        rx_q = self._ctx.Queue()
        rx = MonitoredQueue(rx_q)
        proc = self._ctx.Process(
            target=_worker, args=(self._factory, store_addr, rank, world_size, tx, rx_q),
            daemon=True, name=f"tft_proxy_child_r{rank}",
        )
        proc.start()
        try:
            status, _, err = rx.get(proc, timeout=self._timeout)
            if status == "err":
                raise err
        except BaseException:
            # never leave a live undrained child behind a failed handshake
            proc.kill()
            proc.join(timeout=2)
            raise
        self._proc, self._tx, self._rx = proc, tx, rx_q
        # the drain thread closes over its own generation's proc and queue,
        # so a stale thread of an earlier child never touches the new
        # pending map
        self._drain = threading.Thread(
            target=self._drain_loop, args=(proc, rx, gen), daemon=True, name="tft_proxy_drain",
        )
        self._drain.start()
        # the child's live plane label and codec, once per epoch: configure
        # is where a backend settles its transport, so one query here keeps
        # plane_info() truthful and free
        self._inner_plane = ""
        self._inner_codec = ""
        try:
            wait = timedelta(seconds=5)
            self._inner_plane = str(future_wait(self._submit("plane_info").get_future(), wait))
            self._inner_codec = str(future_wait(self._submit("wire_codec").get_future(), wait))
        except Exception:  # noqa: BLE001 — the labels are best effort
            pass

    def _drain_loop(self, proc, rx: MonitoredQueue, gen: int) -> None:
        while True:
            try:
                status, op_id, payload = rx.get(proc, timeout=None)
                if status == "closed":
                    raise RuntimeError("the proxy shut down")
            except Exception as e:  # noqa: BLE001 — child died: fail all pending
                with self._lock:
                    if gen != self._generation:
                        return  # a newer generation owns the pending map
                    pending, self._pending = self._pending, {}
                for fut in pending.values():
                    fut.set_exception(RuntimeError(f"collectives child died: {e}"))
                return
            with self._lock:
                if gen != self._generation:
                    return
                fut = self._pending.pop(op_id, None)
            if fut is None:
                continue
            if status == "ok":
                fut.set_result(payload)
            else:
                fut.set_exception(payload)

    def _submit(self, name: str, *args, **kwargs) -> Work:
        # the parent's site; the child backend's own sites fire too
        fault_point("collective.issue", match=f"proxy.{name}")
        proc = self._proc
        if proc is None or not proc.is_alive():
            return Work(Future.failed(RuntimeError("collectives child is not running")))
        fut: Future = Future()
        with self._lock:
            self._op_id += 1
            op_id = self._op_id
            self._pending[op_id] = fut
        try:
            MonitoredQueue(self._tx).put((op_id, name, args, kwargs), proc, timeout=self._timeout)
        except Exception as e:  # noqa: BLE001
            with self._lock:
                self._pending.pop(op_id, None)
            return Work(Future.failed(e))
        return Work(fut)

    def _copy_back(self, work: Work, arrays: List[np.ndarray]) -> Work:
        """In-place semantics: copy the child's result into the caller's
        buffers, and resolve to those buffers (as the shared-memory path
        does), so a caller that post-processes the result in place (the
        Manager's average) and one that reads its own buffers see the same
        arrays."""

        def copy(fut: Future):
            result = fut.value()
            out = result if isinstance(result, list) else [result]
            if len(out) != len(arrays):
                raise RuntimeError(
                    f"proxy result count mismatch: sent {len(arrays)} arrays, "
                    f"child returned {len(out)}"
                )
            for dst, src in zip(arrays, out):
                if not isinstance(src, np.ndarray) or dst.shape != src.shape:
                    # a silent skip would leave the caller's buffer stale
                    # while the Work reports success
                    raise RuntimeError(
                        f"proxy result mismatch: expected ndarray{dst.shape}, got "
                        f"{type(src).__name__}{getattr(src, 'shape', '')}"
                    )
                np.copyto(dst, src)
            return list(arrays) if isinstance(result, list) else arrays[0]

        return Work(work.get_future().then(copy))

    # -- collectives --

    def allreduce(self, arrays, op: ReduceOp = ReduceOp.SUM) -> Work:
        total = sum(getattr(a, "nbytes", 0) for a in arrays)
        if (
            total >= _SHM_MIN_BYTES
            and _HAS_DEV_SHM
            and all(isinstance(a, np.ndarray) and a.flags.c_contiguous for a in arrays)
        ):
            return self._allreduce_shm(arrays, op)
        return self._copy_back(self._submit("allreduce", arrays, op), arrays)

    def _allreduce_shm(self, arrays: List[np.ndarray], op: ReduceOp) -> Work:
        """Hot path: stage buffers in a per-op shared-memory segment; the
        child reduces in place on the mapping, the parent copies back."""
        total = sum(a.nbytes for a in arrays)
        shm = shared_memory.SharedMemory(create=True, size=total)
        metas: List[Tuple[int, Tuple[int, ...], str]] = []
        off = 0
        for a in arrays:
            metas.append((off, a.shape, a.dtype.name))
            off += a.nbytes
        try:
            _copy_in(shm, metas, arrays)
        except BaseException:
            _safe_close(shm)
            shm.unlink()
            raise

        work = self._submit("allreduce_shm", shm.name, metas, op)

        def copy_back(fut: Future):
            try:
                fut.value()  # surface the child's error
                _copy_out(shm, metas, arrays)
                return arrays
            finally:
                try:
                    shm.unlink()  # frees /dev/shm even with open mappings
                except FileNotFoundError:
                    pass
                _safe_close(shm)

        return Work(work.get_future().then(copy_back))

    def allgather(self, arr) -> Work:
        return self._submit("allgather", arr)

    def broadcast(self, arr, root: int = 0) -> Work:
        return self._copy_back(self._submit("broadcast", arr, root), [arr])

    def reduce_scatter(self, arrays, op: ReduceOp = ReduceOp.SUM) -> Work:
        return self._submit("reduce_scatter", arrays, op)

    def alltoall(self, arrays) -> Work:
        return self._submit("alltoall", arrays)

    def send(self, arr, dst: int, tag: int = 0) -> Work:
        return self._submit("send", arr, dst, tag)

    def recv(self, arr, src: int, tag: int = 0) -> Work:
        return self._copy_back(self._submit("recv", arr, src, tag), [arr])

    def barrier(self) -> Work:
        return self._submit("barrier")

    def size(self) -> int:
        return self._world

    def rank(self) -> int:
        return self._rank

    def num_active_work(self) -> int:
        with self._lock:
            return len(self._pending)

    def kill_child(self) -> None:
        """Test hook and emergency hatch: SIGKILL the child (a wedged
        backend)."""
        if self._proc is not None and self._proc.is_alive():
            self._proc.kill()

    def shutdown(self) -> None:
        if self._proc is not None:
            try:
                if self._proc.is_alive():
                    self._tx.put(None)
                self._proc.join(timeout=2)
                if self._proc.is_alive():
                    self._proc.kill()
                    self._proc.join(timeout=2)
            except Exception:  # noqa: BLE001
                pass
            self._proc = None
            self._tx = None
        if self._drain is not None:
            # wake the drain thread: it fails the pending ops of its
            # generation and ends
            self._rx.put(("closed", None, None))
            self._drain.join(timeout=5)
            self._drain = None
            self._rx = None
