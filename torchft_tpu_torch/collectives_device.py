"""In-process device data plane across replica groups — the port's
counterpart of ``torchft_tpu/collectives_device.py``.

When replica groups share one process (threads driving one card or
several), the cross-group average can stay on the device end to end: no
copy to the host, no ring. ``CollectivesDevice`` is that backend. Its
protocol is the JAX package's:

* the rendezvous is the epoch namespace the TCP backend uses
  (``{store}/torchft/{quorum_id}/{rank}``), resolved through an in-process
  registry keyed by the prefix without the rank; ``configure`` waits until
  every member of the epoch has joined;
* ops match across groups by an SPMD sequence number, and a kind or meta
  mismatch at one slot raises "collective desync" in every group;
* the last group to arrive at a slot computes every group's result and
  resolves its future; every future fails with ``TimeoutError`` past the op
  deadline, and a member leaving (``configure`` / ``shutdown``) fails all
  pending ops of the abandoned epoch, with the futures resolved outside the
  epoch lock;
* ``send`` is buffered and ``recv`` matches on ``(src, dst, tag)``; a numpy
  buffer handed to ``recv`` is filled in place.

What changes for torch:

* **The reduction.** JAX stacks the groups over an ``'ft'`` mesh axis and
  runs one jitted ``shard_map`` psum, which needs every group on a device
  of its own. Here the last group to arrive reduces with plain torch ops on
  the tensors' devices: SUM and AVG as a sum in rank order (then one
  division for AVG), MAX and MIN elementwise. The psum is XLA's, outside
  any Pallas kernel, so plain torch ops are its counterpart.
* **Where results go.** Every group gets result tensors of its own on its
  own device (a peer copy where the devices differ), so two groups may
  share one card. Inputs are never written, as JAX arrays are immutable; at
  world size 1 an allreduce hands back the caller's own tensors, with no
  copy and no kernel. Numpy inputs are placed on the plane's ``device``.
* **Streams.** The reducing thread is another group's. Each op records an
  event on the issuing thread's current stream; the reducer's stream waits
  on every input's event before it reads, and each group's issue stream
  waits on an event the reducer records after it writes. Tensors that cross
  streams are marked with ``record_stream``, so the caching allocator does
  not hand their memory out while the other stream may still use it. A
  group's futures resolve with its issue stream current, so continuations
  (the Manager's division) run on that stream. Use a result on the stream
  that issued the op.

Every op is counted (``tft_collective_ops_total{plane="device"}``) and
recorded in the flight recorder at issue and completion; an allreduce's
bytes count at issue (``numel() * element_size()``, never a tensor's value)
and its latency, from issue to the rendezvous' result, at completion. At
world size 1 the allreduce is counted with its bytes and no latency.

The fault points (``faultinject.core``) sit at the JAX plane's sites:
``collective.issue`` (``match="device.<op>"``) before an op takes its SPMD
slot, and ``collective.complete`` as this group's
result resolves, where ``corrupt`` perturbs that result on the device
(+1 on the leading ``frac`` of its first output's elements: torch ops on
the result's own device and stream, no host copy).

Left out (ROADMAP): the sharded-group case, which waits for
in-group parallelism; one process per group over NCCL (the JAX package's
``CollectivesDeviceDist``).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from torchft_tpu_torch.collectives import Collectives, ReduceOp, Work
from torchft_tpu_torch.faultinject.core import fault_point
from torchft_tpu_torch.futures import Future, future_timeout
from torchft_tpu_torch.utils.platform import resolve_device

__all__ = ["CollectivesDevice"]


def _epoch_key(store_addr: str) -> str:
    # `{store}/torchft/{quorum_id}/{rank}` → drop the rank: all members of
    # one epoch share the prefix
    return store_addr.rsplit("/", 1)[0]


def _nbytes(payload: Any) -> int:
    """Bytes of the tensors in ``payload`` from their shapes, not their
    values: nothing here may sync the device or break a capture."""
    return sum(t.numel() * t.element_size() for t in _tensors(payload))


def _tensors(payload: Any) -> List[torch.Tensor]:
    if payload is None:
        return []
    if isinstance(payload, torch.Tensor):
        return [payload]
    return list(payload)


def _on_stream(stream: Optional[torch.cuda.Stream]):
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


class _Deposit:
    """One group's input to an op, with where it was issued: the issuing
    thread's current stream and an event recorded on it (None on the CPU)."""

    __slots__ = ("payload", "stream", "event")

    def __init__(self, payload: Any) -> None:
        self.payload = payload
        self.stream: Optional[torch.cuda.Stream] = None
        self.event: Optional[torch.cuda.Event] = None
        tensors = _tensors(payload)
        if not tensors:
            return
        device = tensors[0].device
        if any(t.device != device for t in tensors):
            raise ValueError("the tensors of one op must lie on one device")
        if device.type == "cuda":
            self.stream = torch.cuda.current_stream(device)
            self.event = torch.cuda.Event()
            self.event.record(self.stream)

    def take(self) -> None:
        """Reducer side: order this thread's stream after the deposit, and
        keep the allocator from reusing the inputs' memory before that
        stream is done with them."""
        if self.event is None:
            return
        stream = torch.cuda.current_stream(self.stream.device)
        stream.wait_event(self.event)
        for t in _tensors(self.payload):
            t.record_stream(stream)


class _Op:
    def __init__(self, kind: str, world: int, meta: Tuple) -> None:
        self.kind = kind
        self.world = world
        self.meta = meta
        self.inputs: Dict[int, _Deposit] = {}
        self.futures: Dict[int, Future] = {}


class _Epoch:
    """One quorum epoch's in-process rendezvous state."""

    def __init__(self, key: str, world: int) -> None:
        self.key = key
        self.world = world
        self.lock = threading.Lock()
        self.joined: set = set()
        self.left: set = set()
        self.dead: Optional[Exception] = None
        self.ops: Dict[int, _Op] = {}  # seq tag → op
        self.sends: Dict[Tuple[int, int, int], deque] = {}  # buffered _Deposits
        self.recvs: Dict[Tuple[int, int, int], deque] = {}  # waiting Futures

    def fail_pending(self, exc: Exception) -> List[Future]:
        """Called under self.lock: detach every waiter and return the doomed
        futures for the caller to resolve after releasing the lock
        (continuations run inline and may re-enter the collectives)."""
        self.dead = exc
        doomed: List[Future] = []
        for op in self.ops.values():
            doomed.extend(op.futures.values())
        self.ops.clear()
        for waiters in self.recvs.values():
            doomed.extend(waiters)
        self.recvs.clear()
        self.sends.clear()
        return doomed


_REGISTRY: Dict[str, _Epoch] = {}
_REGISTRY_LOCK = threading.Lock()


class CollectivesDevice(Collectives):
    """Device data plane for replica groups in one process.

    Ops take and return torch tensors (``device_arrays = True``). All groups
    must issue the same ops in the same order (SPMD), as with every
    backend. ``device`` is where numpy inputs are placed; it defaults to
    the card and raises without one unless the caller names ``"cpu"``."""

    device_arrays = True

    def __init__(
        self,
        timeout: timedelta = timedelta(seconds=60),
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        self._timeout = timeout
        self._device = resolve_device(device)
        self._rank = -1
        self._world = 0
        self._epoch: Optional[_Epoch] = None
        self._op_seq = 0

    # -- lifecycle --

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        self._leave()
        key = _epoch_key(store_addr)
        with _REGISTRY_LOCK:
            ep = _REGISTRY.get(key)
            if ep is None:
                ep = _Epoch(key, world_size)
                _REGISTRY[key] = ep
        with ep.lock:
            if ep.dead is not None:
                raise RuntimeError(f"epoch {key} already failed: {ep.dead}")
            if ep.world != world_size:
                raise RuntimeError(
                    f"epoch {key}: world_size mismatch ({world_size} vs {ep.world})"
                )
            ep.joined.add(rank)
        self._rank = rank
        self._world = world_size
        self._epoch = ep
        self._op_seq = 0
        # rendezvous barrier: surface missing members at configure() time,
        # like the TCP backend's eager mesh dial
        deadline = time.monotonic() + self._timeout.total_seconds()
        while True:
            with ep.lock:
                if ep.dead is not None:
                    raise RuntimeError(f"epoch {key} failed: {ep.dead}")
                missing = set(range(world_size)) - ep.joined
            if not missing:
                return
            if time.monotonic() > deadline:
                raise TimeoutError(f"groups never joined epoch: {sorted(missing)}")
            time.sleep(0.005)

    def _leave(self) -> None:
        ep, self._epoch = self._epoch, None
        if ep is None:
            return
        exc = RuntimeError("collectives reconfigured before op completed")
        with ep.lock:
            ep.left.add(self._rank)
            # a departing member strands every in-flight op of the epoch
            doomed = ep.fail_pending(exc)
            # members that never joined must not pin the epoch forever
            all_gone = ep.left >= ep.joined
        for fut in doomed:
            fut.set_exception(exc)
        if all_gone:
            with _REGISTRY_LOCK:
                if _REGISTRY.get(ep.key) is ep:
                    del _REGISTRY[ep.key]

    def shutdown(self) -> None:
        self._leave()

    def size(self) -> int:
        return self._world

    def rank(self) -> int:
        return self._rank

    def plane_info(self) -> str:
        return "device"

    def wire_codec(self) -> str:
        # the plane moves exact device bytes: no wire codec applies
        return "f32"

    # -- rendezvous plumbing --

    def _live_epoch(self) -> _Epoch:
        if self._epoch is None:
            raise RuntimeError("configure() must be called first")
        return self._epoch

    def _next_tag(self) -> int:
        self._op_seq += 1
        return self._op_seq

    def _as_tensor(self, arr: Any) -> torch.Tensor:
        if isinstance(arr, torch.Tensor):
            return arr
        return torch.as_tensor(np.asarray(arr), device=self._device)

    def _rendezvous(self, kind: str, payload: Any, meta: Tuple = ()) -> Work:
        """Deposit this group's input for the next SPMD op slot; the last
        group to arrive computes and resolves everyone's future."""
        from torchft_tpu_torch import telemetry

        # before the op takes its SPMD slot, as in the JAX plane: an error
        # here leaves the slot to this group's next op
        fault_point("collective.issue", match=f"device.{kind}", rank=self._rank)
        ep = self._live_epoch()
        if kind != "allreduce":  # allreduce accounts its bytes and latency itself
            telemetry.COLLECTIVE_OPS.labels(op=kind, plane="device").inc()
        tag = self._next_tag()
        fid = telemetry.FLIGHT.record_issue(kind, "device", _nbytes(payload), tag=tag,
                                            rank=self._rank)
        deposit = _Deposit(payload)
        fut: Future = Future()
        run_op: Optional[_Op] = None
        dead: Optional[Exception] = None
        desync: Optional[RuntimeError] = None
        doomed: List[Future] = []
        with ep.lock:
            if ep.dead is not None:
                dead = ep.dead
            else:
                op = ep.ops.get(tag)
                if op is None:
                    op = _Op(kind, ep.world, meta)
                    ep.ops[tag] = op
                if op.kind != kind or op.meta != meta:
                    desync = RuntimeError(
                        f"collective desync: op {tag} is {op.kind}{op.meta}, "
                        f"this group issued {kind}{meta}"
                    )
                    # a desynced epoch can never make progress: fail everyone
                    doomed = ep.fail_pending(desync)
                else:
                    op.inputs[self._rank] = deposit
                    op.futures[self._rank] = fut
                    if len(op.inputs) == op.world:
                        del ep.ops[tag]
                        run_op = op
        if dead is not None:
            fut.set_exception(dead)
            telemetry.FLIGHT.record_complete(fid, error=dead)
            return Work(future_timeout(fut, self._timeout))
        if desync is not None:
            for f in doomed:
                f.set_exception(desync)
            telemetry.FLIGHT.record_complete(fid, error=desync)
            raise desync
        if run_op is not None:
            _run(run_op)
        out = future_timeout(fut, self._timeout)

        def complete(f: Future) -> Any:
            telemetry.FLIGHT.record_complete(fid, error=f.exception())
            value = f.value()  # re-raises the op's failure, if any
            # completion-side injection, the host plane's too: corrupt
            # perturbs this group's finished output silently
            inj = fault_point("collective.complete", match=f"device.{kind}", rank=self._rank,
                              wire=True)
            if inj is not None:
                if inj.action == "corrupt":
                    value = _corrupt_device_result(value, inj.frac)
                elif inj.action in ("drop", "torn"):
                    # no wire semantics here: an error, never a silent
                    # no-op (delay and kill ran inline)
                    raise inj.make_exception()
            return value

        return Work(out.then(complete))

    # -- collectives --

    def allreduce(self, arrays: List[Any], op: ReduceOp = ReduceOp.SUM) -> Work:
        from torchft_tpu_torch import telemetry

        arrays = [self._as_tensor(a) for a in arrays]
        nbytes = _nbytes(arrays)
        telemetry.COLLECTIVE_OPS.labels(op="allreduce", plane="device").inc()
        if self._world == 1:
            # the reduction of one input is itself: no copy, no kernel. The
            # bytes count; no latency is observed (a constant 0.0 would
            # drown the histogram's real cross-group latencies)
            telemetry.ALLREDUCE_BYTES.labels(plane="device").inc(nbytes)
            return Work.completed(arrays)
        t0 = time.perf_counter()
        work = self._rendezvous("allreduce", arrays, (op,))

        def observe(f: Future) -> None:
            # the rendezvous and the enqueued reduction, host clock (the
            # device work is asynchronous; its completion is the stream's)
            if f.exception() is None:
                telemetry.record_collective("allreduce", nbytes, time.perf_counter() - t0,
                                            "device", count_op=False)

        work.get_future().then(observe)
        return work

    def allgather(self, arr: Any) -> Work:
        return self._rendezvous("allgather", self._as_tensor(arr))

    def broadcast(self, arr: Any, root: int = 0) -> Work:
        return self._rendezvous("broadcast", self._as_tensor(arr), (root,))

    def reduce_scatter(self, arrays: List[Any], op: ReduceOp = ReduceOp.SUM) -> Work:
        if len(arrays) != self._world:
            raise ValueError(
                f"reduce_scatter needs {self._world} inputs, got {len(arrays)}"
            )
        return self._rendezvous(
            "reduce_scatter", [self._as_tensor(a) for a in arrays], (op,)
        )

    def alltoall(self, arrays: List[Any]) -> Work:
        if len(arrays) != self._world:
            raise ValueError(f"alltoall needs {self._world} inputs, got {len(arrays)}")
        return self._rendezvous("alltoall", [self._as_tensor(a) for a in arrays])

    def barrier(self) -> Work:
        if self._world == 1:
            return Work.completed(None)
        return self._rendezvous("barrier", None)

    def send(self, arr: Any, dst: int, tag: int = 0) -> Work:
        """Buffered, like TCP's sendall: the payload is copied at the call,
        so the caller may reuse ``arr`` at once."""
        ep = self._live_epoch()
        key = (self._rank, dst, tag)
        if isinstance(arr, torch.Tensor):
            copy = arr.detach().clone()
        else:
            arr = np.asarray(arr)
            if not arr.flags.writeable:  # torch.from_numpy needs a writable array
                arr = arr.copy()
            copy = torch.from_numpy(arr).to(self._device, copy=True)
        deposit = _Deposit(copy)
        matched: Optional[Future] = None
        with ep.lock:
            dead = ep.dead
            if dead is None:
                waiters = ep.recvs.get(key)
                if waiters:
                    matched = waiters.popleft()
                else:
                    ep.sends.setdefault(key, deque()).append(deposit)
        if dead is not None:
            return Work.failed(dead)
        if matched is not None:
            # resolved outside the lock: the receiver's `place` runs inline
            matched.set_result(deposit)
        return Work.completed(None)

    def recv(self, arr: Any, src: int, tag: int = 0) -> Work:
        """Resolves to ``arr`` filled in place when it is a numpy array, else
        to the received tensor (a new one, on the sender's device)."""
        ep = self._live_epoch()
        key = (src, self._rank, tag)
        stream = (torch.cuda.current_stream(self._device)
                  if self._device.type == "cuda" else None)
        fut: Future = Future()
        got: Optional[_Deposit] = None
        with ep.lock:
            dead = ep.dead
            if dead is None:
                buffered = ep.sends.get(key)
                if buffered:
                    got = buffered.popleft()
                else:
                    ep.recvs.setdefault(key, deque()).append(fut)
        if dead is not None:
            fut.set_exception(dead)
            return Work(future_timeout(fut, self._timeout))
        if got is not None:
            fut.set_result(got)  # outside the lock: continuations run inline

        def place(f: Future) -> Any:
            deposit: _Deposit = f.value()
            t = deposit.payload
            if deposit.event is not None and stream is not None:
                stream.wait_event(deposit.event)
                t.record_stream(stream)
            if isinstance(arr, np.ndarray):
                with _on_stream(stream):
                    torch.from_numpy(arr).copy_(t.reshape(arr.shape))
                return arr
            return t

        return Work(future_timeout(fut, self._timeout).then(place))


def _corrupt_device_result(value: Any, frac: float) -> Any:
    """``corrupt(frac)`` on the device plane: +1 on the leading ``frac`` of
    the first output's elements, this group only, as a perturbed copy that
    replaces the result (the inputs and the other groups' results are
    untouched). Torch ops on the tensor's own device: no host copy."""
    outs = list(value) if isinstance(value, (list, tuple)) else [value]
    for i, t in enumerate(outs):
        if isinstance(t, torch.Tensor) and t.numel():
            n = max(1, int(t.numel() * frac))
            bumped = t.clone()
            bumped.view(-1)[:n] += 1
            outs[i] = bumped
            break
    if isinstance(value, (list, tuple)):
        return type(value)(outs)
    return outs[0]


def _run(op: _Op) -> None:
    """Compute an op whose every group has arrived (on the last arriver's
    thread and current streams) and resolve each group's future with its
    issue stream current."""
    try:
        with torch.no_grad():
            for deposit in op.inputs.values():
                deposit.take()
            results = _COMPUTE[op.kind](
                {r: d.payload for r, d in op.inputs.items()}, op.meta
            )
            _hand_over(results, op.inputs)
    except BaseException as e:  # noqa: BLE001 — propagate via the futures
        for fut in op.futures.values():
            fut.set_exception(e)
        return
    for rank, fut in op.futures.items():
        with _on_stream(op.inputs[rank].stream):
            fut.set_result(results[rank])


def _hand_over(results: Dict[int, Any], inputs: Dict[int, _Deposit]) -> None:
    """Order each group's issue stream after the reducer's writes, and keep
    the allocator from reusing a result's memory (allocated on the
    reducer's stream) before the group's stream is done with it."""
    done: Dict[torch.device, torch.cuda.Event] = {}
    for rank, result in results.items():
        stream = inputs[rank].stream
        if stream is None:
            continue
        for t in _tensors(result):
            if t.device not in done:
                done[t.device] = torch.cuda.Event()
                done[t.device].record(torch.cuda.current_stream(t.device))
            stream.wait_event(done[t.device])
            t.record_stream(stream)


# ---------------------------------------------------------------------------
# op implementations: run once per rendezvous, on the last arriver's thread;
# the data never leaves the devices
# ---------------------------------------------------------------------------

_BINARY: Dict[ReduceOp, Callable] = {
    ReduceOp.SUM: torch.add,
    ReduceOp.AVG: torch.add,
    ReduceOp.MAX: torch.maximum,
    ReduceOp.MIN: torch.minimum,
}


def _reduce(parts: List[torch.Tensor], op: ReduceOp, device: torch.device) -> torch.Tensor:
    """A new tensor on ``device`` reducing ``parts`` (rank order): the sum
    is ((x0 + x1) + x2) + ..., one IEEE add at a time; AVG then divides."""
    fn = _BINARY[op]
    parts = [p.to(device) for p in parts]
    acc = parts[0].clone() if len(parts) == 1 else fn(parts[0], parts[1])
    for p in parts[2:]:
        fn(acc, p, out=acc)
    if op == ReduceOp.AVG:
        acc = (acc / len(parts)).to(acc.dtype)
    return acc


def _own_copies(t: torch.Tensor, devices: List[torch.device]) -> List[torch.Tensor]:
    """One tensor per rank on that rank's device: ``t`` itself for the first
    rank on ``t``'s device, copies for the others."""
    out, given = [], False
    for device in devices:
        if device == t.device and not given:
            out.append(t)
            given = True
        else:
            out.append(t.to(device, copy=True))
    return out


def _congruent(inputs: Dict[int, List[torch.Tensor]], i: int) -> None:
    """All groups' i-th tensors must agree on shape and dtype."""
    base = None
    for rank in sorted(inputs):
        t = inputs[rank][i]
        sig = (tuple(t.shape), t.dtype)
        if base is None:
            base = sig
        elif sig != base:
            raise RuntimeError(
                f"collective desync: group tensors not congruent for tensor {i}: "
                f"{sig} vs {base}"
            )


def _compute_allreduce(
    inputs: Dict[int, List[torch.Tensor]], meta: Tuple
) -> Dict[int, List[torch.Tensor]]:
    (op,) = meta
    ranks = sorted(inputs)
    counts = {len(v) for v in inputs.values()}
    if len(counts) != 1:
        raise RuntimeError(f"collective desync: tensor counts differ: {sorted(counts)}")
    out: Dict[int, List[torch.Tensor]] = {r: [] for r in ranks}
    for i in range(counts.pop()):
        _congruent(inputs, i)
        devices = [inputs[r][i].device for r in ranks]
        acc = _reduce([inputs[r][i] for r in ranks], op, devices[0])
        for r, t in zip(ranks, _own_copies(acc, devices)):
            out[r].append(t)
    return out


def _compute_allgather(inputs: Dict[int, torch.Tensor], meta: Tuple) -> Dict[int, Any]:
    ranks = sorted(inputs)
    return {
        r: [inputs[j].to(inputs[r].device, copy=True) for j in ranks] for r in ranks
    }


def _compute_broadcast(inputs: Dict[int, torch.Tensor], meta: Tuple) -> Dict[int, Any]:
    (root,) = meta
    src = inputs[root]
    return {
        r: src if r == root else src.to(inputs[r].device, copy=True)
        for r in sorted(inputs)
    }


def _compute_reduce_scatter(
    inputs: Dict[int, List[torch.Tensor]], meta: Tuple
) -> Dict[int, Any]:
    (op,) = meta
    ranks = sorted(inputs)
    return {
        r: _reduce([inputs[j][r] for j in ranks], op, inputs[r][r].device)
        for r in ranks
    }


def _compute_alltoall(inputs: Dict[int, List[torch.Tensor]], meta: Tuple) -> Dict[int, Any]:
    ranks = sorted(inputs)
    return {
        r: [inputs[j][r].to(inputs[r][r].device, copy=True) for j in ranks]
        for r in ranks
    }


def _compute_barrier(inputs: Dict[int, Any], meta: Tuple) -> Dict[int, Any]:
    return {r: None for r in inputs}


_COMPUTE: Dict[str, Callable[[Dict[int, Any], Tuple], Dict[int, Any]]] = {
    "allreduce": _compute_allreduce,
    "allgather": _compute_allgather,
    "broadcast": _compute_broadcast,
    "reduce_scatter": _compute_reduce_scatter,
    "alltoall": _compute_alltoall,
    "barrier": _compute_barrier,
}
