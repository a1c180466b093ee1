"""Reconfigurable collectives across replica groups — the port's copy of
``torchft_tpu/collectives.py``, trimmed to its host data plane:
``CollectivesTcp`` with its Python ring (allreduce, allgather,
reduce-scatter, alltoall), store rendezvous and the send / recv /
broadcast / barrier around it, plus the wrappers ``CollectivesDummy``
(every op completes at once with its identity result),
``ErrorSwallowingCollectives`` and ``ManagedCollectives`` (an allreduce
through a Manager). The in-process device plane is
``collectives_device.CollectivesDevice``.

Large float32 allreduces ride the striped C++ plane
(``native/dataplane.cc`` through ``_native.NativeDataPlane``: GIL-free,
``DP_STRIPES`` sockets a peer, the wire codec in C++) unless
``native_plane=False`` or ``TORCHFT_NATIVE_PLANE=0``. On one host, when
every rank proves it can read its left neighbour's memory, the plane
switches to cross-memory attach (CMA: one-copy ``process_vm_readv``
pulls), and so do point-to-point frames of ``CMA_P2P_MIN`` bytes or more,
such as heals (``TORCHFT_DP_CMA=0`` opts out). ``wire_dtype`` quantizes
the wire to bfloat16 or int8 (``wire_codec.py``); CMA moves exact float32 and bypasses
it. ``plane_info()`` says which transport carries the average
(``python-ring``, ``tcp-striped`` or ``cma``) and ``wire_codec()`` which
codec.

Membership changes every quorum, so these collectives live outside the
compiled model on host buffers (numpy arrays, averaged in place).
``configure(store_addr, rank, world_size)`` abandons the previous epoch's
sockets and re-rendezvouses through the epoch-prefixed store namespace
``{store}/torchft/{quorum_id}/{rank}``.

The death watch (``set_death_watch``) polls the epoch's peer sockets and
reports a peer whose socket closed, so the Manager can evict it and
re-quorum while the doomed step still runs.

Every op is counted when issued (``tft_collective_ops_total``) and recorded
in the flight recorder (issue and completion); an allreduce's bytes and
latency are recorded at completion. The wire plane's stage seconds
(``host_copy`` / ``quantize`` / ``wire`` / ``dequant_reduce``) go into the
step-anatomy ledger through :func:`record_wire_stage`, and
:func:`wire_stage_snapshot` reads their totals back.

The fault points (``faultinject.core``), at the JAX package's sites:
``collective.issue`` as an op is issued (after its flight record, so an op
a kill stops there stays in flight in the black box), ``collective.complete``
on the op thread once it finished (``corrupt`` perturbs this replica's
result), ``rpc.send`` (``drop`` leaves a frame unsent, ``torn`` ships a
full-length header and part of the payload, then cuts the socket),
``rpc.recv``, and ``cma.pull`` (``torn`` fills a prefix, then fails).
"""

from __future__ import annotations

import logging
import os
import select
import socket
import struct
import threading
import time
from abc import ABC, abstractmethod
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta
from enum import Enum
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from torchft_tpu_torch.faultinject.core import fault_point
from torchft_tpu_torch.futures import Future
from torchft_tpu_torch.telemetry.anatomy import LEDGER as _ANATOMY_LEDGER
from torchft_tpu_torch.telemetry.anatomy import WIRE_STAGES
from torchft_tpu_torch.store import create_store_client
from torchft_tpu_torch.wire_codec import WireCodec, get_codec

logger = logging.getLogger(__name__)

__all__ = [
    "ReduceOp",
    "Work",
    "Collectives",
    "CollectivesTcp",
    "CollectivesDummy",
    "ErrorSwallowingCollectives",
    "ManagedCollectives",
    "PeerGoneError",
    "WIRE_STAGES",
    "record_wire_stage",
    "wire_stage_snapshot",
]


def record_wire_stage(stage: str, seconds: float) -> None:
    """Add wall clock to a wire-plane stage: a shim over
    ``telemetry.anatomy.LEDGER.record(..., wire_total=True)``. Records made
    on the main thread also join the current step-anatomy row."""
    _ANATOMY_LEDGER.record(stage, seconds, wire_total=True)


def wire_stage_snapshot(reset: bool = False) -> Dict[str, float]:
    """Process-wide seconds per wire-plane stage since the last
    ``reset=True``; the reset moves a mark (the ledger's totals and the
    counters stay monotonic)."""
    return _ANATOMY_LEDGER.wire_stage_snapshot(reset)


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

    @staticmethod
    def failed(exc: BaseException) -> "Work":
        fut: Future = Future()
        fut.set_exception(exc)
        return Work(fut)


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
    def allgather(self, arr: np.ndarray) -> Work:
        """Future resolves to a list of ``world_size`` arrays, rank order."""

    @abstractmethod
    def broadcast(self, arr: np.ndarray, root: int = 0) -> Work:
        """In-place broadcast from ``root``; future resolves to the array."""

    @abstractmethod
    def reduce_scatter(
        self, arrays: List[np.ndarray], op: ReduceOp = ReduceOp.SUM
    ) -> Work:
        """Reduce ``world_size`` per-rank inputs; future resolves to this
        rank's reduced shard (``arrays[rank]``-shaped)."""

    @abstractmethod
    def alltoall(self, arrays: List[np.ndarray]) -> Work:
        """Exchange ``arrays[j]`` to rank j; future resolves to the received
        list in rank order. Shapes may vary per slot but must be symmetric:
        this rank's ``arrays[j]`` shape equals rank j's
        ``arrays[this_rank]`` shape."""

    @abstractmethod
    def send(self, arr: np.ndarray, dst: int, tag: int = 0) -> Work: ...

    @abstractmethod
    def recv(self, arr: np.ndarray, src: int, tag: int = 0) -> Work:
        """In-place receive into ``arr``. Frames are matched by ``tag``:
        several outstanding recvs from one peer are safe with distinct
        tags (see checkpointing/collectives_transport.py)."""

    @abstractmethod
    def barrier(self) -> Work: ...

    @abstractmethod
    def size(self) -> int: ...

    @abstractmethod
    def rank(self) -> int: ...

    def plane_info(self) -> str:
        """Transport label; wrappers delegate to the inner backend."""
        return type(self).__name__

    def wire_codec(self) -> str:
        """Codec large float32 allreduces ride the wire with (``"f32"`` =
        exact; ``"bfloat16"`` and ``"int8"`` are what
        :class:`~torchft_tpu_torch.wire_codec.ErrorFeedback` compensates);
        wrappers delegate."""
        return "f32"

    def shutdown(self) -> None:  # noqa: B027 — optional hook
        pass


# ---------------------------------------------------------------------------
# TCP backend
# ---------------------------------------------------------------------------

_HELLO_MAGIC = 0x7F7A0001
_FRAME_HDR = struct.Struct("<II")  # (tag, length) — tag catches desync bugs
_P2P_WORKERS = 8  # concurrent point-to-point ops
_STASH_LIMIT = 1 << 30  # bytes parked for unclaimed tags: the desync tripwire
# the death watch's poll interval bounds detection latency, and so a
# survivor's blackout; 40 wake-ups a second per plane cost nothing measurable
_DEATH_WATCH_POLL_MS = 25

# CMA for large point-to-point frames once the data plane's probe proved
# the peers same-host: the sender ships a 16-byte {addr, nbytes}
# descriptor (tag | _CMA_FLAG), the receiver pulls the bytes out of the
# sender's address space (process_vm_readv) and acks (tag | _ACK_FLAG) so
# the sender may reuse the buffer. The top two tag bits belong to this
# protocol: user tags are masked to 24 bits and every internal tag space
# tops out below 0x0E000000.
_CMA_FLAG = 0x80000000
_ACK_FLAG = 0x40000000
_CMA_DESC = struct.Struct("<QQ")  # (addr, nbytes)
# point-to-point frames this large go by CMA once the plane proved it
CMA_P2P_MIN = 1 << 20
# sockets a peer on the native plane
DP_STRIPES = 4


# Buffers whose pull-ack never arrived, process-wide and never dropped:
# the pull needs no socket, so a peer that already holds the descriptor
# can pull after this epoch's sockets closed; the memory stays alive for
# the life of the process.
_CMA_QUARANTINE: List[np.ndarray] = []

# Process-wide latch: the probe proves a read of the left neighbour only,
# but a passing vote arms pulls between any two ranks. Where permission
# is asymmetric between pairs (differing uids, YAMA ptrace_scope) a pull
# fails at op time while every epoch's probe passes again; a pull refused
# for permission sets this flag, and the next negotiation votes no, so the
# group settles on TCP.
_CMA_BROKEN = False


def _cma_pull(pid: int, addr: int, view: memoryview) -> None:
    """process_vm_readv the peer's [addr, addr + len) into ``view``."""
    global _CMA_BROKEN
    import errno

    from torchft_tpu_torch._native import cma_read_into

    inj = fault_point("cma.pull", match=f"pid{pid}", wire=True, nbytes=len(view))
    if inj is not None and inj.action in ("torn", "drop"):
        # torn read: fill only a prefix of the caller's buffer (what a pull
        # from a peer dying mid-op leaves), then fail the stream loudly so
        # the step latches instead of committing the partial bytes
        k = int(len(view) * inj.frac) if inj.action == "torn" else 0
        if k:
            cma_read_into(pid, addr, view[:k])
        raise ConnectionError(
            f"fault injection: torn CMA pull ({k}/{len(view)} bytes from pid {pid})"
        )
    try:
        cma_read_into(pid, addr, view)
    except OSError as e:
        # permission only: ESRCH or EFAULT from a peer that just died is
        # the normal fault-tolerance case, and CMA stays for the next
        # cohort
        if e.errno in (errno.EPERM, errno.EACCES):
            _CMA_BROKEN = True
            logger.warning(
                "CMA pull from pid %d denied (%s); latching CMA off: the "
                "next reconfigure settles the group on TCP", pid, e,
            )
        raise


def _corrupt_buffers(result: Any, frac: float) -> None:
    """``corrupt(frac)`` at ``collective.complete``: +1 on the leading
    ``frac`` of the first finished buffer's elements, on this replica only.
    Finite, so nothing downstream errors: the corruption shows only as a
    divergence between the groups' states."""
    arrays = result if isinstance(result, (list, tuple)) else [result]
    for arr in arrays:
        if isinstance(arr, np.ndarray) and arr.size:
            n = max(1, int(arr.size * frac))
            flat = arr.reshape(-1)
            flat[:n] += flat.dtype.type(1)
            return


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
        wire_dtype: Optional[str] = None,
        native_plane: Optional[bool] = None,
    ) -> None:
        """
        Args:
            wire_dtype: the wire codec of float32 allreduces, a name from
                :mod:`torchft_tpu_torch.wire_codec` (``"bfloat16"`` halves
                the bytes, ``"int8"`` quarters them); partial sums
                re-quantize each hop, accumulation stays float32, and the
                decoded average is bitwise identical on every rank.
                Defaults to exact float32. Pair a lossy codec with error feedback.
            native_plane: route large float32 allreduces through the
                striped C++ plane (default on; ``TORCHFT_NATIVE_PLANE=0``
                turns it off). It must agree across ranks, so a failed
                set-up raises rather than falling back.
        """
        if native_plane is None:
            native_plane = os.environ.get("TORCHFT_NATIVE_PLANE", "1") != "0"
        self._native_plane = native_plane
        self._dp = None  # NativeDataPlane of the current epoch
        self._dp_cma = False
        self._dp_cma_pids: Optional[List[int]] = None  # arms p2p CMA
        self._dp_probe_buf = None  # the CMA probe's token, read by peers
        self._codec: WireCodec = get_codec(wire_dtype)
        self._timeout = timeout
        self._hostname = hostname or socket.gethostname()
        self._death_watch_cb: Optional[Callable[[int, int], None]] = None
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
        if self._native_plane:
            self._configure_dp(rank, world_size)
        if self._death_watch_cb is not None:
            threading.Thread(
                target=self._death_watch_loop, args=(gen,), daemon=True,
                name="tft_death_watch",
            ).start()

    def set_death_watch(self, cb: Callable[[int, int], None]) -> None:
        """Register a peer-death callback, called ``cb(ring_rank, gen)``
        with the ring rank whose socket hit EOF or an error and the plane
        generation that rank belongs to (pair it with
        :meth:`plane_generation` to drop a callback that raced a
        reconfigure: one ring rank is another replica in another epoch).
        Armed at the next ``configure()``. A SIGKILLed peer's FIN reaches
        every survivor within milliseconds, long before their next op
        touches the socket. A false report (a peer tearing down an old
        epoch early) is safe: the lighthouse probes the victim before it
        evicts."""
        self._death_watch_cb = cb

    def plane_generation(self) -> int:
        """Epoch counter, bumped by every ``configure()`` and teardown;
        death-watch callbacks carry the generation they were armed for."""
        with self._peers_lock:
            return self._generation

    def _death_watch_loop(self, gen: int) -> None:
        poll_rdhup = getattr(select, "POLLRDHUP", 0x2000)
        poller = select.poll()
        with self._peers_lock:
            if gen != self._generation:
                return
            fds = {}
            for r, p in self._peers.items():
                try:
                    fds[p.sock.fileno()] = r
                except OSError:
                    continue
        for fd in fds:
            poller.register(fd, select.POLLERR | select.POLLHUP | poll_rdhup)
        reported: set = set()
        while True:
            with self._peers_lock:
                if gen != self._generation:
                    return
            try:
                events = poller.poll(_DEATH_WATCH_POLL_MS)
            except OSError:
                return
            for fd, ev in events:
                if ev & select.POLLNVAL:
                    try:
                        poller.unregister(fd)
                    except (KeyError, OSError):
                        pass
                    continue
                rank = fds.get(fd)
                if rank is None or rank in reported:
                    continue
                reported.add(rank)
                try:
                    poller.unregister(fd)
                except (KeyError, OSError):
                    pass
                with self._peers_lock:
                    if gen != self._generation:
                        return
                cb = self._death_watch_cb
                if cb is not None:
                    try:
                        cb(rank, gen)
                    except Exception:  # noqa: BLE001 — the watch keeps running
                        logger.exception("death-watch callback failed")

    def _configure_dp(self, rank: int, world_size: int) -> None:
        """Stand up the striped C++ plane for this epoch: the Python mesh's
        rendezvous (store-published listeners, higher ranks dial lower)
        under one deadline for all of it. Failures raise: every rank must
        land on the same plane, or the group waits on different sockets."""
        from torchft_tpu_torch._native import NativeDataPlane

        deadline = time.monotonic() + self._timeout.total_seconds()

        def left() -> timedelta:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError("data-plane rendezvous deadline exceeded")
            return timedelta(seconds=remaining)

        dp = NativeDataPlane(rank, world_size, DP_STRIPES)
        self._dp_cma = False
        try:
            self._store.set(f"coll/dpaddr/{rank}", f"{self._hostname}:{dp.port}")
            for peer in range(rank):
                addr = self._store.get(f"coll/dpaddr/{peer}", timeout=left()).decode()
                host, port = addr.rsplit(":", 1)
                dp.connect(peer, host, int(port), int(left().total_seconds() * 1000))
            dp.wait_ready(int(left().total_seconds() * 1000))
            self._maybe_enable_cma(dp, rank, world_size, left)
        except BaseException:
            dp.close()
            raise
        self._dp = dp

    def _maybe_enable_cma(self, dp, rank: int, world_size: int, remaining) -> None:
        """Negotiate the one-copy CMA transport: every rank reads a token
        from its left ring neighbour (proving the same pid namespace and a
        ptrace policy that allows it, not just the same hostname) and
        publishes the result; CMA turns on only when all ranks succeeded,
        so the ring stays homogeneous. ``TORCHFT_DP_CMA=0`` opts out."""
        import ctypes
        import secrets

        from torchft_tpu_torch._native import cma_read

        # an opted-out rank (or one whose CMA latched broken) still
        # publishes its keys, voting no: peers would otherwise wait out
        # their deadline on keys that never appear
        opt_out = os.environ.get("TORCHFT_DP_CMA", "1") == "0" or _CMA_BROKEN
        if _CMA_BROKEN:
            logger.info("CMA disabled this epoch: a pull failed earlier in this process")
        token = secrets.token_bytes(16)
        # the probe's target lives for the epoch (peers read it remotely)
        self._dp_probe_buf = ctypes.create_string_buffer(token, 16)
        self._store.set(
            f"coll/dpcma/{rank}",
            f"{self._hostname}|{os.getpid()}|{token.hex()}"
            f"|{ctypes.addressof(self._dp_probe_buf)}",
        )
        left = (rank - 1) % world_size
        ok = False
        if not opt_out:
            try:
                ent = self._store.get(f"coll/dpcma/{left}", timeout=remaining()).decode()
                lhost, lpid, ltok, laddr = ent.split("|")
                if lhost == self._hostname:
                    ok = cma_read(int(lpid), int(laddr), 16) == bytes.fromhex(ltok)
            except (OSError, ValueError, RuntimeError) as e:  # any failure: TCP
                logger.info("CMA probe of rank %d failed (%s); staying on TCP", left, e)
        self._store.set(f"coll/dpcmaok/{rank}", "1" if ok else "0")
        pids = []
        all_ok = True
        for p in range(world_size):
            flag = self._store.get(f"coll/dpcmaok/{p}", timeout=remaining()).decode()
            ent = self._store.get(f"coll/dpcma/{p}", timeout=remaining()).decode()
            pids.append(int(ent.split("|")[1]))
            all_ok = all_ok and flag == "1"
        if all_ok:
            dp.enable_cma(pids)
            self._dp_cma = True
            self._dp_cma_pids = pids  # arms the point-to-point CMA path too
            logger.info("data plane: CMA transport enabled (%d ranks, one host)", world_size)

    def plane_info(self) -> str:
        """Which transport carries large float32 allreduces this epoch:
        ``"cma"`` (one-copy pulls), ``"tcp-striped"`` (the C++ ring over
        ``DP_STRIPES`` sockets a peer) or ``"python-ring"``."""
        if self._dp is None:
            return "python-ring"
        return "cma" if self._dp_cma else "tcp-striped"

    def wire_codec(self) -> str:
        # CMA pulls exact float32 out of the peer's memory: a configured
        # lossy codec is bypassed there
        if self._dp is not None and self._dp_cma:
            return "f32"
        return self._codec.name

    def _wait_for_peers(self, expected: set) -> None:
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
            # shutdown() wakes the acceptor blocked in accept(); close()
            # alone leaves it parked for the life of the process, holding
            # this plane (and, through the death watch, the Manager)
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
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
        if self._dp is not None:
            # before joining the executors: closing the plane's sockets
            # wakes an op thread parked inside the native allreduce
            self._dp.close()
            self._dp = None
        self._dp_cma = False
        self._dp_cma_pids = None
        for name in ("_executor", "_ring_send_worker", "_p2p"):
            ex = getattr(self, name)
            if ex is not None:
                ex.shutdown(wait=True, cancel_futures=True)
                setattr(self, name, None)
        # after the executors drained: no op thread still writes through
        # these views (nor reads the probe token's epoch)
        self._scratch.clear()
        self._dp_probe_buf = None
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

    def _submit(self, fn: Callable, p2p: bool = False, op: str = "") -> Work:
        """Run ``fn`` async. Collective ops share ONE ordered thread (SPMD
        tag sequencing); point-to-point ops go to the p2p pool. ``op`` names
        the op at the ``collective.complete`` fault point."""
        executor = self._p2p if p2p else self._executor
        if executor is None:
            raise RuntimeError("configure() must be called first")
        out: Future = Future()

        def run() -> None:
            try:
                result = fn()
                if op:
                    # completion-side injection: a delay holds the op thread
                    # (a wedged peer), an error fails the finished op before
                    # its future resolves, and corrupt perturbs this
                    # replica's result silently
                    inj = fault_point("collective.complete", match=op, rank=self._rank,
                                      wire=True)
                    if inj is not None:
                        if inj.action == "corrupt":
                            _corrupt_buffers(result, inj.frac)
                        elif inj.action in ("drop", "torn"):
                            # no wire semantics here: an error, never a
                            # silent no-op (delay and kill ran inline)
                            raise inj.make_exception()
                out.set_result(result)
            except BaseException as e:  # noqa: BLE001 — propagate via future
                out.set_exception(e)

        task = executor.submit(run)

        def on_done(t) -> None:
            # teardown cancels queued tasks whose run() never executes; the
            # caller's future must still resolve
            if t.cancelled() and not out.done():
                from torchft_tpu_torch import telemetry

                telemetry.FUTURE_CANCELS.inc()
                out.set_exception(RuntimeError("collectives reconfigured before op ran"))

        task.add_done_callback(on_done)
        return Work(out)

    def _send_to(self, rank: int, tag: int, data: memoryview) -> None:
        inj = fault_point("rpc.send", match=f"peer{rank}", wire=True, tag=tag,
                          nbytes=len(data), rank=self._rank)
        if inj is not None:
            if inj.action == "drop":
                return  # silently unsent: the peer's receive hits its deadline
            if inj.action == "torn":
                self._torn_send(rank, tag, data, inj.frac)  # raises
        if (
            self._dp_cma_pids is not None
            and len(data) >= CMA_P2P_MIN
            and not (tag & (_CMA_FLAG | _ACK_FLAG))
        ):
            self._send_cma(rank, tag, data)
            return
        p = self._peer(rank)
        try:
            with p.send_lock:
                _send_frame(p.sock, tag, data)
        except (ConnectionError, OSError) as e:
            if isinstance(e, (socket.timeout, TimeoutError)):
                raise  # slow-but-alive peer: latch the error, don't accuse
            raise PeerGoneError(rank, f"send to peer {rank} failed: {e}") from e

    def _torn_send(self, rank: int, tag: int, data: memoryview, frac: float) -> None:
        """The ``torn`` wire primitive: a full-length frame header, ``frac``
        of the payload, then a hard cut of the socket, as a peer dying
        mid-send leaves it. The receiver sees a mid-frame EOF (never
        half-filled data reported as success); this side fails as a send
        to a dead peer does."""
        p = self._peer(rank)
        k = int(len(data) * frac)
        try:
            with p.send_lock:
                p.sock.sendall(_FRAME_HDR.pack(tag, len(data)) + bytes(data[:k]))
        finally:
            try:
                p.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        raise PeerGoneError(rank, f"fault injection: torn send to peer {rank} "
                                  f"({k}/{len(data)} bytes)")

    def _send_cma(self, rank: int, tag: int, data: memoryview) -> None:
        """Ship a pull descriptor instead of the payload, then wait for the
        peer's ack: the buffer stays untouched until the pull is done."""
        arr = np.frombuffer(data, dtype=np.uint8)
        desc = _CMA_DESC.pack(arr.ctypes.data, len(data))
        p = self._peer(rank)
        try:
            with p.send_lock:
                _send_frame(p.sock, tag | _CMA_FLAG, memoryview(desc))
        except (ConnectionError, OSError) as e:
            if isinstance(e, (socket.timeout, TimeoutError)):
                raise
            raise PeerGoneError(rank, f"send to peer {rank} failed: {e}") from e
        # the ack rides the tag-matched receive (it interleaves safely with
        # any other traffic on this socket)
        try:
            self._recv_from(rank, tag | _ACK_FLAG)
        except BaseException as e:
            # without the ack the descriptor dangles: the peer may still
            # pull that address (it needs no socket for it). Keep the
            # buffer alive for the life of the process and poison the
            # stream, so both sides reconfigure.
            _CMA_QUARANTINE.append(arr)
            logger.warning(
                "CMA pull-ack from peer %d failed (%s); buffer quarantined "
                "(%d buffers, %.1f MB kept process-wide)", rank, e,
                len(_CMA_QUARANTINE), sum(a.nbytes for a in _CMA_QUARANTINE) / 1e6,
            )
            with p.cond:
                p.recv_error = e
                p.cond.notify_all()
            try:
                p.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            if isinstance(e, TimeoutError):
                raise ConnectionError(
                    f"CMA pull-ack from peer {rank} timed out; epoch poisoned "
                    f"(descriptor quarantined)"
                ) from e
            raise
        del arr  # the source buffer stays referenced until the ack

    def _recv_from(
        self, rank: int, tag: int, into: Optional[memoryview] = None
    ) -> Optional[bytearray]:
        """Tag-matched receive. With ``into``, a frame of exactly
        ``len(into)`` bytes lands in the caller's buffer and None is
        returned; otherwise the frame bytes are returned."""
        p = self._peer(rank)
        try:
            fault_point("rpc.recv", match=f"peer{rank}", tag=tag, rank=self._rank)
            return self._recv_matched(p, rank, tag, into)
        except (ConnectionError, OSError) as e:
            if isinstance(e, (socket.timeout, TimeoutError)):
                raise
            raise PeerGoneError(rank, f"recv from peer {rank} failed: {e}") from e

    def _recv_matched(
        self, p: _Peer, rank: int, tag: int, into: Optional[memoryview]
    ) -> Optional[bytearray]:
        """One thread at a time reads the socket; frames for other tags are
        stashed for their waiters. A stash cap keeps a real desync loud. A
        CMA descriptor is pulled from the sender's memory and acked."""
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
                if got_tag & _CMA_FLAG:
                    # a pull descriptor: fetch the payload from the sender's
                    # address space, then ack so it may reuse the buffer
                    got_tag &= ~_CMA_FLAG
                    addr, nbytes = _CMA_DESC.unpack(bytes(_recv_exact(p.sock, length)))
                    pids = self._dp_cma_pids  # teardown may clear the field
                    if pids is None:
                        raise ConnectionError("CMA descriptor arrived during teardown")
                    if got_tag == tag and into is not None and len(into) == nbytes:
                        _cma_pull(pids[rank], addr, into)
                        filled = True
                    else:
                        data = bytearray(nbytes)
                        _cma_pull(pids[rank], addr, memoryview(data))
                    self._send_to(rank, got_tag | _ACK_FLAG, memoryview(b""))
                elif got_tag == tag and into is not None and len(into) == length:
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
        self,
        dst: int,
        send_data: memoryview,
        src: int,
        tag: int,
        into: Optional[memoryview] = None,
    ) -> Optional[bytearray]:
        """Send to ``dst`` while receiving from ``src`` (one ring step): into
        ``into`` when given, else the frame's bytes are returned. The send
        runs on a persistent helper so large frames cannot deadlock on full
        socket buffers."""
        send_fut = self._ring_send_worker.submit(self._send_to, dst, tag, send_data)
        recv_exc: Optional[BaseException] = None
        data = None
        try:
            data = self._recv_from(src, tag, into=into)
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
        return data

    def _next_tag(self) -> int:
        self._op_seq = (self._op_seq + 1) & 0x00FFFFFF
        return self._op_seq

    def _epoch_scratch(self, dtype: np.dtype, nelems: int, slot: str = "") -> np.ndarray:
        """Per-epoch reusable buffer, grown monotonically and dropped with
        the epoch: the ring never allocates per chunk per round."""
        key = f"{slot}:{np.dtype(dtype).str}"
        buf = self._scratch.get(key)
        if buf is None or buf.size < nelems:
            buf = np.empty(max(nelems, 1), dtype=dtype)
            self._scratch[key] = buf
        return buf[:nelems]

    def _count_op(self, op_name: str, nbytes: int = 0, tag: int = 0) -> int:
        """Count the op, record its issue in the flight recorder and pass
        the ``collective.issue`` fault point; returns the flight record's
        sequence id. The point comes after the record (the JAX package
        passes it first), so an op a ``kill`` stops here is in flight in
        the black box; an ``error`` completes the record as failed."""
        from torchft_tpu_torch import telemetry

        plane = self.plane_info()
        telemetry.COLLECTIVE_OPS.labels(op=op_name, plane=plane).inc()
        fid = telemetry.FLIGHT.record_issue(op_name, plane, nbytes, tag=tag, rank=self._rank)
        try:
            fault_point("collective.issue", match=op_name, nbytes=nbytes, tag=tag,
                        rank=self._rank)
        except BaseException as e:
            telemetry.FLIGHT.record_complete(fid, error=e)
            raise
        return fid

    def _track_flight(self, work: Work, fid: int) -> Work:
        """Mark the flight record completed or failed when the op resolves."""
        from torchft_tpu_torch import telemetry

        work.get_future().then(
            lambda f: telemetry.FLIGHT.record_complete(fid, error=f.exception())
        )
        return work

    # -- collectives (all run on the op thread, SPMD-ordered) --

    def allreduce(self, arrays: List[np.ndarray], op: ReduceOp = ReduceOp.SUM) -> Work:
        world = self._world
        tag = self._next_tag() | 0x01000000
        nbytes = sum(int(a.nbytes) for a in arrays)
        # counted at issue like every op; bytes and latency at completion
        fid = self._count_op("allreduce", nbytes, tag)

        def run() -> List[np.ndarray]:
            from torchft_tpu_torch import telemetry

            t0 = time.perf_counter()
            if world > 1:
                # the op thread serializes ops, so the arrays of one
                # allreduce may share the tag (a desync check, not a
                # demultiplexer; the native plane offsets it per stripe)
                for arr in arrays:
                    if self._dp_eligible(arr):
                        self._dp_allreduce(arr, op, tag)
                    else:
                        self._ring_allreduce(arr, op, tag)
                        if op == ReduceOp.AVG:
                            np.divide(arr, world, out=arr)
            telemetry.record_collective("allreduce", nbytes, time.perf_counter() - t0,
                                        self.plane_info(), count_op=False)
            return arrays

        return self._track_flight(self._submit(run, op="allreduce"), fid)

    def _dp_eligible(self, arr: np.ndarray) -> bool:
        from torchft_tpu_torch._native import NativeDataPlane

        return (
            self._dp is not None
            and arr.dtype == np.float32
            and arr.flags["C_CONTIGUOUS"]
            and self._codec.name in NativeDataPlane.CODEC
        )

    def _dp_allreduce(self, arr: np.ndarray, op: ReduceOp, tag: int) -> None:
        """The striped C++ ring: AVG divides natively, the codec runs in
        C++, and the allgather forwards the owner's bytes verbatim, so the
        result is bitwise identical on every rank. A failure naming a peer
        becomes :class:`PeerGoneError`, for the eviction report."""
        from torchft_tpu_torch._native import DataPlaneError

        dp = self._dp  # teardown may clear the field mid-op
        if dp is None:
            raise RuntimeError("data plane torn down")
        t0 = time.perf_counter()
        try:
            # ``arr`` stays referenced by this frame until the GIL-free
            # call returns
            dp.allreduce(
                arr.ctypes.data, arr.size, op.value, self._codec.name, tag,
                int(self._timeout.total_seconds() * 1000),
            )
        except DataPlaneError as e:
            if e.peer_rank >= 0:
                raise PeerGoneError(e.peer_rank, str(e)) from e
            raise
        finally:
            # the codec runs inside the C++ stripe workers, not separable
            # from here: the whole native op is "wire"
            record_wire_stage("wire", time.perf_counter() - t0)

    def _ring_allreduce(self, arr: np.ndarray, op: ReduceOp, tag: int) -> None:
        world, rank = self._world, self._rank
        right, left = (rank + 1) % world, (rank - 1) % world
        reduce_fn = _REDUCE_FNS[op]
        flat = _flat_view(arr)
        bounds = np.linspace(0, flat.size, world + 1).astype(np.int64)
        chunks = [flat[bounds[i] : bounds[i + 1]] for i in range(world)]
        max_elems = max(int(c.size) for c in chunks)
        if self._codec.lossy and arr.dtype == np.float32 and flat.size > 0:
            self._ring_allreduce_codec(op, tag, chunks, max_elems, reduce_fn)
            return
        scratch = self._epoch_scratch(arr.dtype, max_elems)
        t_wire = 0.0

        # reduce-scatter
        for step in range(world - 1):
            send_idx, recv_idx = (rank - step) % world, (rank - step - 1) % world
            view = scratch[: chunks[recv_idx].size]
            t0 = time.perf_counter()
            self._exchange(right, _bytes_view(chunks[send_idx]), left, tag, _bytes_view(view))
            t_wire += time.perf_counter() - t0
            reduce_fn(chunks[recv_idx], view)
        # allgather: every rank forwards the owner's exact bytes, so the
        # result is bitwise identical everywhere by construction
        for step in range(world - 1):
            send_idx, recv_idx = (rank + 1 - step) % world, (rank - step) % world
            view = scratch[: chunks[recv_idx].size]
            t0 = time.perf_counter()
            self._exchange(right, _bytes_view(chunks[send_idx]), left, tag, _bytes_view(view))
            t_wire += time.perf_counter() - t0
            chunks[recv_idx][:] = view
        record_wire_stage("wire", t_wire)

    def _ring_allreduce_codec(
        self, op: ReduceOp, tag: int, chunks: List[np.ndarray], max_elems: int,
        reduce_fn,
    ) -> None:
        """The lossy-codec ring. The reduce-scatter ships freshly encoded
        partial sums a hop (re-quantized at each hop's own magnitude); then
        the owner of each reduced chunk encodes it once, keeps the decode
        of its own bytes, and the allgather forwards those bytes verbatim,
        so every rank decodes identical bytes."""
        world, rank = self._world, self._rank
        right, left = (rank + 1) % world, (rank - 1) % world
        codec = self._codec
        codec.ensure_capacity(max_elems)
        max_wire = codec.wire_nbytes(max_elems)
        # double buffer: at each allgather hop one holds the bytes being
        # forwarded while the other receives the next chunk's
        buf_a = self._epoch_scratch(np.uint8, max_wire, slot="wireA")
        buf_b = self._epoch_scratch(np.uint8, max_wire, slot="wireB")
        t_quant = t_wire = t_dq = 0.0

        # reduce-scatter
        for step in range(world - 1):
            send_idx, recv_idx = (rank - step) % world, (rank - step - 1) % world
            n = int(chunks[recv_idx].size)
            t0 = time.perf_counter()
            sv = codec.encode_into(chunks[send_idx])
            t1 = time.perf_counter()
            rv = buf_a[: codec.wire_nbytes(n)]
            self._exchange(right, sv, left, tag, _bytes_view(rv))
            t2 = time.perf_counter()
            reduce_fn(chunks[recv_idx], codec.decode_tmp(rv, n))
            t_quant += t1 - t0
            t_wire += t2 - t1
            t_dq += time.perf_counter() - t2

        t0 = time.perf_counter()
        owned = chunks[(rank + 1) % world]
        ow = codec.encode_into(owned)
        cur = buf_b[: len(ow)]
        cur[:] = np.frombuffer(ow, dtype=np.uint8)
        codec.decode_into(cur, owned)
        t_quant += time.perf_counter() - t0

        # allgather: forward the received wire bytes untouched
        bufs = (buf_a, buf_b)
        cur_i = 1  # cur lives in buf_b; buf_a is free to receive into
        for step in range(world - 1):
            recv_idx = (rank - step) % world
            n = int(chunks[recv_idx].size)
            rv = bufs[1 - cur_i][: codec.wire_nbytes(n)]
            t0 = time.perf_counter()
            self._exchange(right, _bytes_view(cur), left, tag, _bytes_view(rv))
            t1 = time.perf_counter()
            codec.decode_into(rv, chunks[recv_idx])
            t_wire += t1 - t0
            t_dq += time.perf_counter() - t1
            cur, cur_i = rv, 1 - cur_i  # rv is the next hop's outgoing frame
        record_wire_stage("quantize", t_quant)
        record_wire_stage("wire", t_wire)
        record_wire_stage("dequant_reduce", t_dq)

    def allgather(self, arr: np.ndarray) -> Work:
        world, rank = self._world, self._rank
        tag = self._next_tag() | 0x02000000
        fid = self._count_op("allgather", int(arr.nbytes), tag)

        def run() -> List[np.ndarray]:
            out: List[Optional[np.ndarray]] = [None] * world
            out[rank] = arr.copy()
            right, left = (rank + 1) % world, (rank - 1) % world
            cur, cur_idx = np.ascontiguousarray(arr), rank
            for _ in range(world - 1):
                data = self._exchange(right, _bytes_view(cur), left, tag)
                cur_idx = (cur_idx - 1) % world
                cur = np.frombuffer(data, dtype=arr.dtype).reshape(arr.shape).copy()
                out[cur_idx] = cur
            return out  # type: ignore[return-value]

        return self._track_flight(self._submit(run, op="allgather"), fid)

    def broadcast(self, arr: np.ndarray, root: int = 0) -> Work:
        world, rank = self._world, self._rank
        tag = self._next_tag() | 0x03000000
        fid = self._count_op("broadcast", int(arr.nbytes), tag)

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

        return self._track_flight(self._submit(run, op="broadcast"), fid)

    def reduce_scatter(
        self, arrays: List[np.ndarray], op: ReduceOp = ReduceOp.SUM
    ) -> Work:
        world, rank = self._world, self._rank
        if len(arrays) != world:
            raise ValueError(f"reduce_scatter needs {world} inputs, got {len(arrays)}")
        tag = self._next_tag() | 0x04000000
        fid = self._count_op("reduce_scatter", sum(int(a.nbytes) for a in arrays), tag)
        reduce_fn = _REDUCE_FNS[op]

        def run() -> np.ndarray:
            # the allreduce's reduce-scatter schedule leaves rank r owning
            # slot (r+1)%world, so slot i holds input (i-1)%world: each rank
            # ends with the reduction of its own input index
            right, left = (rank + 1) % world, (rank - 1) % world
            local = [np.ascontiguousarray(arrays[(i - 1) % world]).copy()
                     for i in range(world)]
            for step in range(world - 1):
                send_idx, recv_idx = (rank - step) % world, (rank - step - 1) % world
                data = self._exchange(right, _bytes_view(local[send_idx]), left, tag)
                incoming = np.frombuffer(data, dtype=local[recv_idx].dtype)
                reduce_fn(local[recv_idx], incoming.reshape(local[recv_idx].shape))
            acc = local[(rank + 1) % world]
            if op == ReduceOp.AVG:
                np.divide(acc, world, out=acc)
            return acc

        return self._track_flight(self._submit(run, op="reduce_scatter"), fid)

    def alltoall(self, arrays: List[np.ndarray]) -> Work:
        world, rank = self._world, self._rank
        if len(arrays) != world:
            raise ValueError(f"alltoall needs {world} inputs, got {len(arrays)}")
        tag = self._next_tag() | 0x05000000
        fid = self._count_op("alltoall", sum(int(a.nbytes) for a in arrays), tag)

        def run() -> List[np.ndarray]:
            out: List[Optional[np.ndarray]] = [None] * world
            out[rank] = arrays[rank].copy()
            # round r sends to rank+r while receiving from rank-r (full
            # duplex): deadlock-free for any world size
            for r in range(1, world):
                dst, src = (rank + r) % world, (rank - r) % world
                data = self._exchange(dst, _bytes_view(arrays[dst]), src, tag)
                out[src] = (np.frombuffer(data, dtype=arrays[src].dtype)
                            .reshape(arrays[src].shape).copy())
            return out  # type: ignore[return-value]

        return self._track_flight(self._submit(run, op="alltoall"), fid)

    def send(self, arr: np.ndarray, dst: int, tag: int = 0) -> Work:
        wire_tag = 0x06000000 | (tag & 0xFFFFFF)
        fid = self._count_op("send", int(arr.nbytes), wire_tag)
        return self._track_flight(
            self._submit(lambda: self._send_to(dst, wire_tag, _bytes_view(arr)), p2p=True,
                         op="send"), fid)

    def recv(self, arr: np.ndarray, src: int, tag: int = 0) -> Work:
        wire_tag = 0x06000000 | (tag & 0xFFFFFF)
        fid = self._count_op("recv", int(arr.nbytes), wire_tag)

        def run() -> np.ndarray:
            self._recv_from(src, wire_tag, into=_bytes_view(_flat_view(arr)))
            return arr

        return self._track_flight(self._submit(run, p2p=True, op="recv"), fid)

    def barrier(self) -> Work:
        token = np.zeros(1, dtype=np.int32)
        world = self._world
        tag = self._next_tag() | 0x07000000
        fid = self._count_op("barrier", 0, tag)

        def run() -> None:
            if world > 1:
                self._ring_allreduce(token, ReduceOp.SUM, tag)

        return self._track_flight(self._submit(run, op="barrier"), fid)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


class CollectivesDummy(Collectives):
    """No-op backend: every op completes at once with its identity result
    (the JAX tests' harness backend)."""

    def __init__(self, rank: int = 0, world_size: int = 1) -> None:
        self._rank = rank
        self._world = world_size
        self.configure_count = 0

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        self._rank, self._world = rank, world_size
        self.configure_count += 1

    def allreduce(self, arrays, op=ReduceOp.SUM):
        return Work.completed(arrays)

    def allgather(self, arr):
        return Work.completed([arr.copy() for _ in range(self._world)])

    def broadcast(self, arr, root=0):
        return Work.completed(arr)

    def reduce_scatter(self, arrays, op=ReduceOp.SUM):
        return Work.completed(arrays[self._rank].copy())

    def alltoall(self, arrays):
        return Work.completed([a.copy() for a in arrays])

    def send(self, arr, dst, tag=0):
        return Work.completed(None)

    def recv(self, arr, src, tag=0):
        return Work.completed(arr)

    def barrier(self):
        return Work.completed(None)

    def size(self) -> int:
        return self._world

    def rank(self) -> int:
        return self._rank


class ErrorSwallowingCollectives(Collectives):
    """First error latches; later ops are no-ops until the next configure().
    Keeps a failed replica from hanging its group mid-step — the Manager
    discards the step at commit time."""

    def __init__(self, inner: Collectives) -> None:
        self._inner = inner
        self._error: Optional[Exception] = None

    @property
    def device_arrays(self) -> bool:
        return bool(getattr(self._inner, "device_arrays", False))

    def error(self) -> Optional[Exception]:
        return self._error

    def plane_info(self) -> str:
        return self._inner.plane_info()

    def wire_codec(self) -> str:
        return self._inner.wire_codec()

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

    def allgather(self, arr):
        return self._guard(
            lambda: self._inner.allgather(arr),
            [arr.copy() for _ in range(max(1, self._inner.size()))],
        )

    def broadcast(self, arr, root=0):
        return self._guard(lambda: self._inner.broadcast(arr, root), arr)

    def reduce_scatter(self, arrays, op=ReduceOp.SUM):
        return self._guard(
            lambda: self._inner.reduce_scatter(arrays, op), arrays[0].copy()
        )

    def alltoall(self, arrays):
        return self._guard(lambda: self._inner.alltoall(arrays), arrays)

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


class ManagedCollectives(Collectives):
    """Routes an allreduce through a Manager, so its quorum wait, a healing
    group's zeros and its error latch apply. ``size()`` is the
    participating world, which keeps dynamic membership out of user code;
    the ops that are not managed raise."""

    def __init__(self, manager) -> None:
        self._manager = manager

    def wire_codec(self) -> str:
        return self._manager.wire_codec()

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        raise RuntimeError("ManagedCollectives is configured by its Manager")

    def allreduce(self, arrays, op=ReduceOp.SUM):
        if len(arrays) != 1:
            raise ValueError("ManagedCollectives.allreduce takes a single array")
        return Work(self._manager.allreduce(arrays[0]))

    def allgather(self, arr):
        raise NotImplementedError("only allreduce is managed")

    def broadcast(self, arr, root=0):
        raise NotImplementedError("only allreduce is managed")

    def reduce_scatter(self, arrays, op=ReduceOp.SUM):
        raise NotImplementedError("only allreduce is managed")

    def alltoall(self, arrays):
        raise NotImplementedError("only allreduce is managed")

    def send(self, arr, dst, tag=0):
        raise NotImplementedError("only allreduce is managed")

    def recv(self, arr, src, tag=0):
        raise NotImplementedError("only allreduce is managed")

    def barrier(self):
        raise NotImplementedError("only allreduce is managed")

    def size(self) -> int:
        return self._manager.num_participants()

    def rank(self) -> int:
        rank = self._manager.participating_rank()
        return rank if rank is not None else 0
