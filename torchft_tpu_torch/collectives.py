"""Reconfigurable collectives across replica groups — the port's copy of
``torchft_tpu/collectives.py``, trimmed to the host data plane the FT step
uses: ``CollectivesTcp`` with its pure-Python ring allreduce, store
rendezvous and the send / recv / broadcast / barrier around it, plus
``ErrorSwallowingCollectives``.

Membership changes every quorum, so these collectives live outside the
compiled model on host buffers (numpy arrays, averaged in place).
``configure(store_addr, rank, world_size)`` abandons the previous epoch's
sockets and re-rendezvouses through the epoch-prefixed store namespace
``{store}/torchft/{quorum_id}/{rank}``.

Left out (ROADMAP): the native striped plane, CMA, wire codecs, the death
watch, fault points and the flight recorder.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
from abc import ABC, abstractmethod
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta
from enum import Enum
from typing import Callable, Dict, List, Optional

import numpy as np

from torchft_tpu_torch.futures import Future
from torchft_tpu_torch.store import create_store_client

logger = logging.getLogger(__name__)

__all__ = [
    "ReduceOp",
    "Work",
    "Collectives",
    "CollectivesTcp",
    "ErrorSwallowingCollectives",
    "PeerGoneError",
]


class PeerGoneError(ConnectionError):
    """A socket-level failure talking to a specific peer rank."""

    def __init__(self, peer_rank: int, msg: str = "") -> None:
        super().__init__(msg or f"connection to peer {peer_rank} failed")
        self.peer_rank = peer_rank

    def __reduce__(self):
        return (PeerGoneError, (self.peer_rank, str(self)))


class ReduceOp(Enum):
    SUM = "sum"
    AVG = "avg"
    MAX = "max"
    MIN = "min"


_REDUCE_FNS: Dict[ReduceOp, Callable[[np.ndarray, np.ndarray], np.ndarray]] = {
    ReduceOp.SUM: lambda a, b: np.add(a, b, out=a),
    ReduceOp.AVG: lambda a, b: np.add(a, b, out=a),  # divided at the end
    ReduceOp.MAX: lambda a, b: np.maximum(a, b, out=a),
    ReduceOp.MIN: lambda a, b: np.minimum(a, b, out=a),
}


class Work:
    """Async op handle (torch Work analogue)."""

    def __init__(self, fut: Future) -> None:
        self._fut = fut

    def wait(self, timeout: Optional[timedelta] = None):
        return self._fut.wait(timeout)

    def get_future(self) -> Future:
        return self._fut

    @staticmethod
    def completed(value=None) -> "Work":
        return Work(Future.completed(value))


class Collectives(ABC):
    """Abstract reconfigurable collectives over a replica axis."""

    @abstractmethod
    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        """Tear down the previous epoch and rendezvous a fresh one. Safe to
        call repeatedly; each call fully replaces connectivity."""

    @abstractmethod
    def allreduce(self, arrays: List[np.ndarray], op: ReduceOp = ReduceOp.SUM) -> Work:
        """In-place allreduce of each array; future resolves to the list."""

    @abstractmethod
    def broadcast(self, arr: np.ndarray, root: int = 0) -> Work:
        """In-place broadcast from ``root``; future resolves to the array."""

    @abstractmethod
    def send(self, arr: np.ndarray, dst: int, tag: int = 0) -> Work: ...

    @abstractmethod
    def recv(self, arr: np.ndarray, src: int, tag: int = 0) -> Work:
        """In-place receive into ``arr``. Frames are matched by ``tag``."""

    @abstractmethod
    def barrier(self) -> Work: ...

    @abstractmethod
    def size(self) -> int: ...

    @abstractmethod
    def rank(self) -> int: ...

    def shutdown(self) -> None:  # noqa: B027 — optional hook
        pass


# ---------------------------------------------------------------------------
# TCP backend
# ---------------------------------------------------------------------------

_HELLO_MAGIC = 0x7F7A0001
_FRAME_HDR = struct.Struct("<II")  # (tag, length) — tag catches desync bugs
_P2P_WORKERS = 8  # concurrent point-to-point ops
_STASH_LIMIT = 1 << 30  # bytes parked for unclaimed tags: the desync tripwire


def _send_frame(sock: socket.socket, tag: int, payload: memoryview) -> None:
    sock.sendall(_FRAME_HDR.pack(tag, len(payload)))
    sock.sendall(payload)


def _recv_exact_into(sock: socket.socket, view: memoryview) -> None:
    n = len(view)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if k == 0:
            raise ConnectionError("peer closed connection")
        got += k


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    _recv_exact_into(sock, memoryview(buf))
    return buf


def _bytes_view(arr: np.ndarray) -> memoryview:
    """Byte-level view of an array (frame lengths are in bytes)."""
    return memoryview(np.ascontiguousarray(arr)).cast("B")


def _flat_view(arr: np.ndarray) -> np.ndarray:
    """Flat in-place view; in-place collectives need contiguous arrays."""
    v = arr.reshape(-1)
    if v.size and not np.shares_memory(v, arr):
        raise ValueError("in-place collectives require contiguous arrays")
    return v


class _Peer:
    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        # one lock per direction: a ring step sends to and receives from
        # the same peer at once
        self.send_lock = threading.Lock()
        self.recv_lock = threading.Lock()
        # tag-matched receive: frames for tags other ops wait on are
        # stashed instead of declared a desync
        self.cond = threading.Condition(self.recv_lock)
        self.stash: Dict[int, List[bytearray]] = {}
        self.stash_bytes = 0
        self.reader_busy = False
        self.recv_error: Optional[BaseException] = None


class CollectivesTcp(Collectives):
    """Cross-replica-group collectives over TCP (Gloo analogue).

    Full-duplex mesh: both sides publish listeners through the store; for
    the pair (i, j) the higher rank dials the lower. The ring allreduce
    (reduce-scatter + allgather) moves ``2 * nbytes / world`` per rank and
    forwards the chunk owner's bytes verbatim in the allgather, so every
    rank ends with bit-identical results.
    """

    def __init__(
        self,
        timeout: timedelta = timedelta(seconds=60),
        hostname: Optional[str] = None,
    ) -> None:
        self._timeout = timeout
        self._hostname = hostname or socket.gethostname()
        self._scratch: Dict[str, np.ndarray] = {}
        self._rank = -1
        self._world = 0
        self._generation = 0
        self._peers: Dict[int, _Peer] = {}  # guarded-by: _peers_lock
        self._peers_lock = threading.Lock()
        self._listener: Optional[socket.socket] = None
        self._acceptor: Optional[threading.Thread] = None
        self._store = None
        self._executor: Optional[ThreadPoolExecutor] = None
        self._ring_send_worker: Optional[ThreadPoolExecutor] = None
        self._p2p: Optional[ThreadPoolExecutor] = None
        self._op_seq = 0

    # -- lifecycle --

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        self._teardown()  # bumps _generation, so stale acceptors are fenced
        self._rank = rank
        self._world = world_size
        # tags order ops SPMD-style: every member restarts the sequence here
        self._op_seq = 0
        with self._peers_lock:
            gen = self._generation
        self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="tft_coll")
        self._ring_send_worker = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="tft_ring_send"
        )
        self._p2p = ThreadPoolExecutor(
            max_workers=_P2P_WORKERS, thread_name_prefix="tft_p2p"
        )
        if world_size == 1:
            return

        self._store = create_store_client(store_addr, connect_timeout=self._timeout)
        listener = socket.socket(socket.AF_INET6, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind(("::", 0))
        listener.listen(64)
        self._listener = listener
        port = listener.getsockname()[1]
        self._store.set(f"coll/addr/{rank}", f"{self._hostname}:{port}")
        self._acceptor = threading.Thread(
            target=self._accept_loop, args=(listener, gen), daemon=True,
            name="tft_accept",
        )
        self._acceptor.start()
        # eagerly build the full mesh so configure() surfaces connectivity
        # failures (and later ops can't stall on a dial)
        for peer in range(rank):
            self._dial(peer, self._timeout)
        self._wait_for_peers(set(range(rank + 1, world_size)))

    def _wait_for_peers(self, expected: set) -> None:
        import time

        deadline = time.monotonic() + self._timeout.total_seconds()
        while True:
            with self._peers_lock:
                missing = expected - set(self._peers)
            if not missing:
                return
            if time.monotonic() > deadline:
                raise TimeoutError(f"peers never connected: {sorted(missing)}")
            time.sleep(0.01)

    def _accept_loop(self, listener: socket.socket, gen: int) -> None:
        while True:
            try:
                sock, _ = listener.accept()
            except OSError:
                return  # listener closed by teardown
            try:
                # deadline BEFORE the hello too: a silent dialer must not
                # wedge the acceptor past the op timeout
                sock.settimeout(self._timeout.total_seconds())
                magic, peer_rank = struct.unpack("<II", bytes(_recv_exact(sock, 8)))
                if magic != _HELLO_MAGIC:
                    sock.close()
                    continue
            except Exception:
                sock.close()
                continue
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._peers_lock:
                if gen != self._generation:
                    sock.close()
                    return
                self._peers[peer_rank] = _Peer(sock)

    def _dial(self, peer: int, timeout: timedelta) -> None:
        addr = self._store.get(f"coll/addr/{peer}", timeout=timeout).decode()
        host, port = addr.rsplit(":", 1)
        sock = socket.create_connection((host, int(port)), timeout=timeout.total_seconds())
        # keep the op deadline on the connected socket: a dead peer mid-ring
        # must not wedge the op thread past the timeout
        sock.settimeout(self._timeout.total_seconds())
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.sendall(struct.pack("<II", _HELLO_MAGIC, self._rank))
        with self._peers_lock:
            self._peers[peer] = _Peer(sock)

    def _teardown(self) -> None:
        # fence stale acceptors, then unblock any op thread stuck in a
        # socket syscall (shutdown() wakes a blocked recv/send; close()
        # alone does not on Linux), THEN join the executors
        with self._peers_lock:
            self._generation += 1
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
            self._listener = None
        with self._peers_lock:
            for p in self._peers.values():
                try:
                    p.sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    p.sock.close()
                except OSError:
                    pass
            self._peers.clear()
        for name in ("_executor", "_ring_send_worker", "_p2p"):
            ex = getattr(self, name)
            if ex is not None:
                ex.shutdown(wait=True, cancel_futures=True)
                setattr(self, name, None)
        self._scratch.clear()
        if self._store is not None:
            self._store.close()
            self._store = None

    def shutdown(self) -> None:
        self._teardown()

    def size(self) -> int:
        return self._world

    def rank(self) -> int:
        return self._rank

    # -- plumbing --

    def _peer(self, rank: int) -> _Peer:
        with self._peers_lock:
            p = self._peers.get(rank)
        if p is None:
            raise RuntimeError(f"no connection to peer {rank}")
        return p

    def _submit(self, fn: Callable, p2p: bool = False) -> Work:
        """Run ``fn`` async. Collective ops share ONE ordered thread (SPMD
        tag sequencing); point-to-point ops go to the p2p pool."""
        executor = self._p2p if p2p else self._executor
        if executor is None:
            raise RuntimeError("configure() must be called first")
        out: Future = Future()

        def run() -> None:
            try:
                out.set_result(fn())
            except BaseException as e:  # noqa: BLE001 — propagate via future
                out.set_exception(e)

        task = executor.submit(run)

        def on_done(t) -> None:
            # teardown cancels queued tasks whose run() never executes; the
            # caller's future must still resolve
            if t.cancelled() and not out.done():
                out.set_exception(RuntimeError("collectives reconfigured before op ran"))

        task.add_done_callback(on_done)
        return Work(out)

    def _send_to(self, rank: int, tag: int, data: memoryview) -> None:
        p = self._peer(rank)
        try:
            with p.send_lock:
                _send_frame(p.sock, tag, data)
        except (ConnectionError, OSError) as e:
            if isinstance(e, (socket.timeout, TimeoutError)):
                raise  # slow-but-alive peer: latch the error, don't accuse
            raise PeerGoneError(rank, f"send to peer {rank} failed: {e}") from e

    def _recv_from(
        self, rank: int, tag: int, into: Optional[memoryview] = None
    ) -> Optional[bytearray]:
        """Tag-matched receive. With ``into``, a frame of exactly
        ``len(into)`` bytes lands in the caller's buffer and None is
        returned; otherwise the frame bytes are returned."""
        p = self._peer(rank)
        try:
            return self._recv_matched(p, tag, into)
        except (ConnectionError, OSError) as e:
            if isinstance(e, (socket.timeout, TimeoutError)):
                raise
            raise PeerGoneError(rank, f"recv from peer {rank} failed: {e}") from e

    def _recv_matched(
        self, p: _Peer, tag: int, into: Optional[memoryview]
    ) -> Optional[bytearray]:
        """One thread at a time reads the socket; frames for other tags are
        stashed for their waiters. A stash cap keeps a real desync loud."""
        import time

        deadline = time.monotonic() + self._timeout.total_seconds()
        while True:
            with p.cond:
                while True:
                    if p.recv_error is not None:
                        if isinstance(p.recv_error, (socket.timeout, TimeoutError)):
                            raise TimeoutError(
                                f"receive stream timed out: {p.recv_error!r}"
                            ) from p.recv_error
                        raise ConnectionError(
                            f"receive stream broken: {p.recv_error!r}"
                        ) from p.recv_error
                    q = p.stash.get(tag)
                    if q:
                        if into is not None and len(into) != len(q[0]):
                            raise RuntimeError(
                                f"tag {tag:#x}: frame is {len(q[0])} bytes, "
                                f"recv buffer is {len(into)}"
                            )
                        data = q.pop(0)
                        if not q:
                            del p.stash[tag]
                        p.stash_bytes -= len(data)
                        if into is not None:
                            into[:] = data
                            return None
                        return data
                    if not p.reader_busy:
                        p.reader_busy = True
                        break  # this thread reads the socket
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(f"recv tag {tag:#x} timed out waiting for reader")
                    p.cond.wait(remaining)
            got_tag = -1
            filled = False
            data = None
            try:
                got_tag, length = _FRAME_HDR.unpack(bytes(_recv_exact(p.sock, _FRAME_HDR.size)))
                if got_tag == tag and into is not None and len(into) == length:
                    _recv_exact_into(p.sock, into)
                    filled = True
                else:
                    data = _recv_exact(p.sock, length)
            except BaseException as e:
                with p.cond:
                    p.reader_busy = False
                    # the stream position is undefined (possibly mid-frame):
                    # the epoch is poisoned until reconfigure
                    p.recv_error = e
                    p.cond.notify_all()
                raise
            with p.cond:
                p.reader_busy = False
                if got_tag == tag:
                    if into is not None and not filled:
                        p.stash.setdefault(got_tag, []).append(data)
                        p.stash_bytes += len(data)
                        p.cond.notify_all()
                        raise RuntimeError(
                            f"tag {tag:#x}: frame is {len(data)} bytes, "
                            f"recv buffer is {len(into)}"
                        )
                    p.cond.notify_all()
                    return None if filled else data
                p.stash.setdefault(got_tag, []).append(data)
                p.stash_bytes += len(data)
                over = p.stash_bytes > _STASH_LIMIT
                p.cond.notify_all()
                if over:
                    raise RuntimeError(
                        f"collective desync: {p.stash_bytes} bytes stashed "
                        f"while waiting for tag {tag:#x}"
                    )

    def _exchange(
        self, dst: int, send_data: memoryview, src: int, tag: int, into: memoryview
    ) -> None:
        """Send to ``dst`` while receiving from ``src`` into ``into`` (one
        ring step); the send runs on a persistent helper so large frames
        cannot deadlock on full socket buffers."""
        send_fut = self._ring_send_worker.submit(self._send_to, dst, tag, send_data)
        recv_exc: Optional[BaseException] = None
        try:
            self._recv_from(src, tag, into=into)
        except BaseException as e:  # noqa: BLE001
            recv_exc = e
            # the epoch is doomed: unwedge a send parked on a full buffer
            try:
                self._peer(dst).sock.shutdown(socket.SHUT_RDWR)
            except Exception:  # noqa: BLE001
                pass
        send_exc: Optional[BaseException] = None
        try:
            send_fut.result()
        except BaseException as e:  # noqa: BLE001
            send_exc = e
        if recv_exc is not None:
            # prefer the error that names the dead peer
            if isinstance(send_exc, PeerGoneError) and not isinstance(recv_exc, PeerGoneError):
                raise send_exc from recv_exc
            raise recv_exc
        if send_exc is not None:
            raise send_exc

    def _next_tag(self) -> int:
        self._op_seq = (self._op_seq + 1) & 0x00FFFFFF
        return self._op_seq

    def _scratch_for(self, dtype: np.dtype, nelems: int) -> np.ndarray:
        """Per-epoch reusable receive buffer, grown monotonically."""
        key = np.dtype(dtype).str
        buf = self._scratch.get(key)
        if buf is None or buf.size < nelems:
            buf = np.empty(max(nelems, 1), dtype=dtype)
            self._scratch[key] = buf
        return buf[:nelems]

    # -- collectives (all run on the op thread, SPMD-ordered) --

    def allreduce(self, arrays: List[np.ndarray], op: ReduceOp = ReduceOp.SUM) -> Work:
        world = self._world
        tag = self._next_tag() | 0x01000000

        def run() -> List[np.ndarray]:
            if world > 1:
                for arr in arrays:
                    self._ring_allreduce(arr, op, tag)
                    if op == ReduceOp.AVG:
                        np.divide(arr, world, out=arr)
            return arrays

        return self._submit(run)

    def _ring_allreduce(self, arr: np.ndarray, op: ReduceOp, tag: int) -> None:
        world, rank = self._world, self._rank
        right, left = (rank + 1) % world, (rank - 1) % world
        reduce_fn = _REDUCE_FNS[op]
        flat = _flat_view(arr)
        bounds = np.linspace(0, flat.size, world + 1).astype(np.int64)
        chunks = [flat[bounds[i] : bounds[i + 1]] for i in range(world)]
        scratch = self._scratch_for(arr.dtype, max(int(c.size) for c in chunks))

        # reduce-scatter
        for step in range(world - 1):
            send_idx, recv_idx = (rank - step) % world, (rank - step - 1) % world
            view = scratch[: chunks[recv_idx].size]
            self._exchange(right, _bytes_view(chunks[send_idx]), left, tag, _bytes_view(view))
            reduce_fn(chunks[recv_idx], view)
        # allgather: every rank forwards the owner's exact bytes, so the
        # result is bitwise identical everywhere by construction
        for step in range(world - 1):
            send_idx, recv_idx = (rank + 1 - step) % world, (rank - step) % world
            view = scratch[: chunks[recv_idx].size]
            self._exchange(right, _bytes_view(chunks[send_idx]), left, tag, _bytes_view(view))
            chunks[recv_idx][:] = view

    def broadcast(self, arr: np.ndarray, root: int = 0) -> Work:
        world, rank = self._world, self._rank
        tag = self._next_tag() | 0x03000000

        def run() -> np.ndarray:
            if world > 1:
                if rank == root:
                    data = _bytes_view(arr)
                    for peer in range(world):
                        if peer != rank:
                            self._send_to(peer, tag, data)
                else:
                    self._recv_from(root, tag, into=_bytes_view(_flat_view(arr)))
            return arr

        return self._submit(run)

    def send(self, arr: np.ndarray, dst: int, tag: int = 0) -> Work:
        wire_tag = 0x06000000 | (tag & 0xFFFFFF)
        return self._submit(lambda: self._send_to(dst, wire_tag, _bytes_view(arr)), p2p=True)

    def recv(self, arr: np.ndarray, src: int, tag: int = 0) -> Work:
        wire_tag = 0x06000000 | (tag & 0xFFFFFF)

        def run() -> np.ndarray:
            self._recv_from(src, wire_tag, into=_bytes_view(_flat_view(arr)))
            return arr

        return self._submit(run, p2p=True)

    def barrier(self) -> Work:
        token = np.zeros(1, dtype=np.int32)
        world = self._world
        tag = self._next_tag() | 0x07000000

        def run() -> None:
            if world > 1:
                self._ring_allreduce(token, ReduceOp.SUM, tag)

        return self._submit(run)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


class ErrorSwallowingCollectives(Collectives):
    """First error latches; later ops are no-ops until the next configure().
    Keeps a failed replica from hanging its group mid-step — the Manager
    discards the step at commit time."""

    def __init__(self, inner: Collectives) -> None:
        self._inner = inner
        self._error: Optional[Exception] = None

    def error(self) -> Optional[Exception]:
        return self._error

    def report_error(self, e: Exception) -> None:
        self._error = e

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        self._error = None
        self._inner.configure(store_addr, rank, world_size)

    def _guard(self, fn: Callable[[], Work], default) -> Work:
        if self._error is not None:
            return Work.completed(default)
        try:
            work = fn()
        except Exception as e:
            self.report_error(e)
            return Work.completed(default)

        def swallow(fut: Future):
            exc = fut.exception()
            if exc is not None and self._error is None:
                logger.exception("collective failed; latching error: %s", exc)
                self.report_error(exc if isinstance(exc, Exception) else RuntimeError(str(exc)))
                return default
            return fut.value() if exc is None else default

        return Work(work.get_future().then(swallow))

    def allreduce(self, arrays, op=ReduceOp.SUM):
        return self._guard(lambda: self._inner.allreduce(arrays, op), arrays)

    def broadcast(self, arr, root=0):
        return self._guard(lambda: self._inner.broadcast(arr, root), arr)

    def send(self, arr, dst, tag=0):
        return self._guard(lambda: self._inner.send(arr, dst, tag), None)

    def recv(self, arr, src, tag=0):
        return self._guard(lambda: self._inner.recv(arr, src, tag), arr)

    def barrier(self):
        return self._guard(lambda: self._inner.barrier(), None)

    def size(self) -> int:
        return self._inner.size()

    def rank(self) -> int:
        return self._inner.rank()

    def shutdown(self) -> None:
        self._inner.shutdown()
