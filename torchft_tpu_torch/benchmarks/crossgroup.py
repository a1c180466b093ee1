"""Cross-process gradient-plane benchmark — the port's copy of
``torchft_tpu/benchmarks/crossgroup.py``.

Two replica groups as separate OS processes, the topology of any job with
one process per group, run a list of jobs in turn (start-up is paid once):

* ``probe``: can group 1 pull group 0's page-locked staging memory (plain
  memory on the CPU) with ``process_vm_readv``? Its errno if not; the
  jobs on the ``cma`` plane after a refused probe are skipped and say so;
* ``raw``: one large float32 allreduce (AVG), no Manager: what the
  transport itself moves, on a plane (``python-ring``, ``tcp-striped`` or
  ``cma``) and a wire codec;
* ``heal``: a state tree of tensors over ``CollectivesTransport`` from
  group 0 to group 1, with point-to-point CMA or over TCP; both groups
  hash the tree;
* ``e2e``: the training step: a fresh lighthouse, ``Manager`` (sync
  quorum, HTTP heal) and ``CollectivesTcp`` on the plane and codec, then
  ``ManagedOptimizer`` over ``TrainStep`` (error feedback automatic on a
  lossy wire) for warm-up and timed steps from the same seeded params,
  each group on its own tokens; quorum and commit every step, the
  gradients through ``allreduce_gradients``;
* ``tree``: the JAX worker's round: a synthetic float32 gradient tree (4 MB
  leaves, unit normals from the group's seed) on the device through a
  fresh lighthouse and ``Manager`` (sync quorum), in the round-2 serial
  schedule (every leaf to the host, one managed op over all buckets, each
  bucket back) or ``allreduce_gradients``' per-bucket pipeline (streamed);
  the first round's average against the exact one (``wire_error``).

The model is the headline transformer on the card (its step replayed from
a CUDA graph, captured once per worker across all jobs) and a tiny float32
one on the CPU (``--device cpu``, the tests). A failed job fails the run.

Usage::

    python -m torchft_tpu_torch.benchmarks.crossgroup [--total-mb 256] [--rounds 3] \
        [--device cpu] [--compressed]

prints one JSON object: the raw rows (seconds per round, GB/s of float32
tree bytes, the time the llama2-7b preset's gradient tree would take at
that rate, derived, not measured), the heal rows, the end-to-end rows,
the synthetic tree's serial and streamed rows and the striped heal rows
(:func:`measure_striped_heal`: ``heal_striped_1src`` and
``heal_striped_2src``, the state staged by one or two source processes
and pulled over the blob plane by the orchestrator, and
``heal_striped_speedup``). ``--compressed`` runs the
``crossgroup_compressed`` matrix instead (:func:`measure_compressed`: the
tree on the int8 wire of the forced striped TCP plane, serial and
streamed). ``chip_smoke.py`` phase 13 drives :func:`run_pair` with its own
jobs, and phase 15 :func:`measure_striped_heal`.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["run_pair", "measure_crossgroup", "measure_compressed", "wire_error", "PLANES",
           "LLAMA2_7B_PARAMS"]

# llama2-7b preset (examples/train_hsdp.py) parameter count: embeddings +
# 32 x (4 d^2 attention + 3 d d_ff MLP + 2 d norms) + final norm + output head
_7B_D, _7B_FF, _7B_L, _7B_V = 4096, 11008, 32, 32000
LLAMA2_7B_PARAMS = (
    _7B_V * _7B_D
    + _7B_L * (4 * _7B_D * _7B_D + 3 * _7B_D * _7B_FF + 2 * _7B_D)
    + _7B_D
    + _7B_V * _7B_D
)

# plane -> (native_plane, TORCHFT_DP_CMA)
PLANES = {"python-ring": (False, "1"), "tcp-striped": (True, "0"), "cma": (True, "1")}
_TIMEOUT = timedelta(seconds=120)
_HEAL_TIMEOUT = timedelta(seconds=600)


# ---------------------------------------------------------------------------
# worker (subprocess entry, TORCHFT_CROSSGROUP_JOBS set)
# ---------------------------------------------------------------------------


def _collectives(plane: str, codec: Optional[str]):
    from torchft_tpu_torch.collectives import CollectivesTcp

    native, cma = PLANES[plane]
    os.environ["TORCHFT_DP_CMA"] = cma  # read at configure
    return CollectivesTcp(timeout=_TIMEOUT, hostname="localhost", wire_dtype=codec or None,
                          native_plane=native)


def _digest(tensors) -> str:
    """sha256 over the tensors' bytes, in order."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _raw(job: Dict[str, Any], gid: int, store: str, grad_bytes: int) -> Dict[str, Any]:
    import numpy as np

    from torchft_tpu_torch.collectives import ReduceOp

    c = _collectives(job["plane"], job.get("codec"))
    try:
        c.configure(f"{store}/{job['name']}", gid, 2)
        n = (job.get("nbytes") or grad_bytes) // 4
        arr = np.full(n, float(gid + 1), dtype=np.float32)
        c.allreduce([arr], ReduceOp.AVG).wait(_TIMEOUT)  # warm-up
        t0 = time.perf_counter()
        for _ in range(job["rounds"]):
            c.allreduce([arr], ReduceOp.AVG).wait(_TIMEOUT)
        secs = (time.perf_counter() - t0) / job["rounds"]
        # 1.5 is exact in every codec: a wrong average shows
        return {"seconds_per_round": secs, "total_bytes": n * 4, "plane": c.plane_info(),
                "wire_codec": c.wire_codec(), "correct": bool(np.all(arr == 1.5))}
    finally:
        c.shutdown()


def _probe(job: Dict[str, Any], gid: int, store: str, device) -> Dict[str, Any]:
    import torch

    from torchft_tpu_torch._native import cma_read
    from torchft_tpu_torch.store import create_store_client

    client = create_store_client(f"{store}/{job['name']}", connect_timeout=_TIMEOUT)
    try:
        if gid == 0:
            # what the CMA ring pulls from: allreduce_gradients' staging
            buf = torch.full((1 << 18,), 7.0, pin_memory=device.type == "cuda")
            client.set("addr", f"{os.getpid()}|{buf.data_ptr()}|{buf.numel() * 4}")
            # the reader reports after its pull, so buf outlives it
            return {"result": client.get("result", timeout=_TIMEOUT).decode()}
        pid, addr, n = client.get("addr", timeout=_TIMEOUT).decode().split("|")
        try:
            got = cma_read(int(pid), int(addr), int(n))
            want = torch.full((int(n) // 4,), 7.0).numpy().tobytes()
            result = "ok" if got == want else "wrong bytes"
        except OSError as e:
            result = f"errno {e.errno} ({os.strerror(e.errno or 0)})"
        client.set("result", result)
        return {"result": result}
    finally:
        client.close()


def heal_state(nbytes: int, device) -> Dict[str, Any]:
    """Eight float32 leaves of ``nbytes`` in all (to a multiple of 32),
    random from fixed seeds, made on ``device``."""
    import torch

    n = nbytes // 32
    out = {}
    for i in range(8):
        g = torch.Generator(device=device).manual_seed(i)
        out[f"w{i}"] = torch.randn(n, generator=g, device=device)
    return out


def _heal(job: Dict[str, Any], gid: int, store: str, device) -> Dict[str, Any]:
    from torchft_tpu_torch.checkpointing.collectives_transport import CollectivesTransport

    c = _collectives(job["plane"], None)
    try:
        c.configure(f"{store}/{job['name']}", gid, 2)
        t = CollectivesTransport(c, timeout=_TIMEOUT)
        if gid == 0:
            state = heal_state(job["nbytes"], device)
            t.send_checkpoint([1], 0, state, _TIMEOUT)
            return {"plane": c.plane_info(), "digest": _digest(state[k] for k in sorted(state))}
        t0 = time.perf_counter()
        got = t.recv_checkpoint(0, t.metadata(), 0, _TIMEOUT)
        secs = time.perf_counter() - t0
        return {"plane": c.plane_info(), "seconds": secs,
                "total_bytes": sum(v.nbytes for v in got.values()),
                "digest": _digest(got[k] for k in sorted(got))}
    finally:
        c.shutdown()


def _striped_heal_server(nbytes: int, device: str) -> None:
    """A stripe source (``--striped-heal-server``): stage ``heal_state`` on
    an ``HTTPTransport`` (the blob plane serves its bytes), print one JSON
    line (metadata URL, pid, sha256, blob port, staging seconds) and serve
    until stdin closes."""
    from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport
    from torchft_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    state = heal_state(nbytes, dev)
    t = HTTPTransport(timeout=_HEAL_TIMEOUT, hostname="localhost")
    try:
        t0 = time.perf_counter()
        t.send_checkpoint([1], 0, state, _HEAL_TIMEOUT)
        stage_s = time.perf_counter() - t0
        print(json.dumps({"metadata": t.metadata(), "pid": os.getpid(),
                          "digest": _digest(state[k] for k in sorted(state)),
                          "blob_port": getattr(t._blob, "port", None), "stage_s": stage_s}),
              flush=True)
        sys.stdin.readline()  # the healer closes stdin when it is done
    finally:
        t.shutdown()


def measure_striped_heal(nbytes: int, plans: List[Tuple[int, bool]], device: str = "cuda",
                         timeout_s: float = 600.0) -> List[Dict[str, Any]]:
    """The ``heal_striped_{n}src`` rows, one per plan ``(nsources,
    kill_one)``: worker processes stage the same state
    (``heal_state(nbytes)``, made on ``device``), all started at once, and
    this process pulls it striped over the first ``nsources`` of those
    still alive (``HTTPTransport.recv_checkpoint_multi``, the bulk bytes
    over the blob plane), then copies it onto ``device`` as a Manager's
    ``load_state_dict`` does. With ``kill_one`` the plan's last source
    takes SIGKILL from ``header_cb``: after the plan, before any bulk
    byte, so its ranges re-stripe over the others. A row: seconds and GB/s
    of the receive, the transport's heal stats (``nsources``, per-source
    bytes, ranges, GB/s and route, the stages, failures), the copy onto
    the device, and the sha256 of each source's state and of the healed
    one."""
    import signal

    import torch

    from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport
    from torchft_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    # each plan needs its sources alive: the kills of earlier plans use some up
    needed = max(n + sum(k for _, k in plans[:i]) for i, (n, _) in enumerate(plans))
    tmp = tempfile.mkdtemp(prefix="tft_torch_striped_heal_")
    env = dict(os.environ)
    pkg_parent = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (pkg_parent, env.get("PYTHONPATH")) if p)
    procs: List[subprocess.Popen] = []
    logs = [os.path.join(tmp, f"src{i}.stderr") for i in range(needed)]
    try:
        for i in range(needed):
            with open(logs[i], "wb") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "torchft_tpu_torch.benchmarks.crossgroup",
                     "--striped-heal-server", "--nbytes", str(nbytes), "--device", dev.type],
                    env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err,
                ))
        sources = []
        for i, p in enumerate(procs):
            line = p.stdout.readline().decode().strip()
            if not line:
                raise RuntimeError(f"stripe source {i} died:\n{_tail(logs[i])}")
            sources.append(json.loads(line))
        alive = list(range(needed))
        rows = []
        for nsources, kill_one in plans:
            use = alive[:nsources]

            def kill_last(header: bytes) -> None:
                procs[use[-1]].send_signal(signal.SIGKILL)
                procs[use[-1]].wait()

            rx = HTTPTransport(timeout=timedelta(seconds=timeout_s), hostname="localhost")
            try:
                t0 = time.perf_counter()
                got = rx.recv_checkpoint_multi([sources[i]["metadata"] for i in use], 0,
                                               timedelta(seconds=timeout_s),
                                               header_cb=kill_last if kill_one else None)
                secs = time.perf_counter() - t0
                stats = dict(rx.last_heal_stats)
            finally:
                rx.shutdown()
            if kill_one:
                alive.remove(use[-1])
            t0 = time.perf_counter()
            on_dev = {k: v.to(dev) for k, v in got.items()}
            if dev.type == "cuda":
                torch.cuda.current_stream().synchronize()
            load_s = time.perf_counter() - t0
            total = sum(v.nbytes for v in got.values())
            rows.append({
                "seconds": secs, "gb_per_sec": total / secs / 1e9, "total_bytes": total,
                "nsources": stats["nsources"], "sources_started": nsources, "killed": kill_one,
                "per_source": {url: {k: v[k] for k in ("bytes", "ranges", "seconds",
                                                       "gb_per_sec", "route")}
                               for url, v in stats["sources"].items()},
                "failures": stats["failures"], "stages_s": stats["stages"],
                "blob_ports": [sources[i]["blob_port"] for i in use],
                "source_stage_s": [sources[i]["stage_s"] for i in use],
                "load_to_device_s": load_s, "device": dev.type,
                "sha256_sources": [sources[i]["digest"] for i in use],
                "sha256_healed": _digest(on_dev[k] for k in sorted(on_dev)),
            })
            del got, on_dev
        return rows
    finally:
        for p in procs:
            try:
                p.stdin.close()
            except OSError:
                pass
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


class _Model:
    """A worker's train step and its params, kept across the e2e jobs: each
    job starts from the same values in the same tensors, so the gradient
    graph is captured once."""

    def __init__(self, device) -> None:
        from torchft_tpu_torch.benchmarks.recovery import _model_config
        from torchft_tpu_torch.parallel.train_step import TrainStep
        from torchft_tpu_torch.utils.tree import tree_leaves

        self.cfg, (self.batch, self.seq) = _model_config(device.type)
        self.device = device
        self.ts = TrainStep(self.cfg, device=device)
        self.params = self.ts.init_params(seed=0)
        self.init = [v.detach().clone() for v in tree_leaves(self.params)]
        self.grad_bytes = sum(v.numel() * 4 for v in self.init)
        self.reference = None  # the first exact arm's first averaged gradients

    def reset(self) -> None:
        import torch

        from torchft_tpu_torch.utils.tree import tree_leaves

        with torch.no_grad():
            for v, v0 in zip(tree_leaves(self.params), self.init):
                v.copy_(v0)

    def tokens(self, gid: int, step: int):
        import numpy as np
        import torch

        rng = np.random.default_rng([gid, step])
        return torch.from_numpy(
            rng.integers(0, self.cfg.vocab_size, (self.batch, self.seq))
        ).to(self.device)


def wire_error(got: List[Any], ref: List[Any]) -> Dict[str, float]:
    """How far an average lies from the exact one, in the exact one's
    units, in float64: ``||got - ref|| / ||ref||`` over the whole tree
    (``tree``) and over the leaf where that ratio is largest (``leaf``),
    and ``max |got - ref| / max |ref|`` over the tree (``peak``). A
    bfloat16 wire's error is relative to each element, so ``leaf`` bounds
    it; an int8 wire's is relative to its chunk's largest element, so
    ``peak`` does."""
    import torch

    num = den = leaf = err_max = ref_max = 0.0
    for g, r in zip(got, ref):
        d = g.detach().double() - r.double()
        e = float(torch.linalg.vector_norm(d)) ** 2
        n = float(torch.linalg.vector_norm(r.double())) ** 2
        num, den = num + e, den + n
        if n > 0:
            leaf = max(leaf, (e / n) ** 0.5)
        if d.numel():
            err_max = max(err_max, float(d.abs().max()))
            ref_max = max(ref_max, float(r.abs().max()))
    return {"tree": (num / den) ** 0.5 if den > 0 else 0.0, "leaf": leaf,
            "peak": err_max / ref_max if ref_max > 0 else 0.0}


def _e2e(job: Dict[str, Any], gid: int, model: _Model) -> Dict[str, Any]:
    import torch

    from torchft_tpu_torch import optim
    from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.parallel.train_step import synchronize
    from torchft_tpu_torch.store import StoreServer
    from torchft_tpu_torch.utils.tree import tree_leaves

    store = StoreServer()
    coll = _collectives(job["plane"], job.get("codec"))
    manager = Manager(
        collectives=coll, load_state_dict=None, state_dict=None, min_replica_size=2,
        replica_id=f"{job['name']}_g{gid}", store_addr=store.address(), rank=0, world_size=1,
        lighthouse_addr=job["lighthouse"], timeout=_TIMEOUT, use_async_quorum=False,
        checkpoint_transport=HTTPTransport(timeout=_TIMEOUT, hostname="localhost"),
    )
    model.reset()
    opt = optim.ManagedOptimizer(manager, model.ts.init_opt)
    opt.init(model.params)
    rec: Dict[str, List[Any]] = {"avg_ms": [], "pending_at_vote": [], "committed": [],
                                 "pending_after": [], "launches": []}
    average, vote = optim.allreduce_gradients, manager.should_commit
    first: Dict[str, Any] = {}

    def timed_average(mgr, grads, **kwargs):
        t0 = time.perf_counter()
        out = average(mgr, grads, **kwargs)
        synchronize(model.device)  # the averaged gradients are on the device
        rec["avg_ms"].append((time.perf_counter() - t0) * 1e3)
        if not first:
            leaves = list(tree_leaves(out))
            first["digest"] = _digest(leaves)
            first["dtypes"] = sorted({str(g.dtype) for g in tree_leaves(grads)})
            if job.get("exact") and model.reference is None:
                model.reference = [g.detach().clone() for g in leaves]
            elif not job.get("exact") and model.reference is not None:
                ref = model.reference
                first["wire_err"] = wire_error(leaves, ref)
                # what a broken wire would hand back, through the same measure
                first["controls"] = {
                    "zeros": wire_error([torch.zeros_like(r) for r in ref], ref),
                    "own": wire_error(list(tree_leaves(grads)), ref),
                }
        return out

    def counted_vote(*args, **kwargs):
        ef = opt.error_feedback
        rec["pending_at_vote"].append(len(ef.pending_keys()) if ef is not None else None)
        committed = vote(*args, **kwargs)
        rec["committed"].append(committed)
        return committed

    optim.allreduce_gradients = timed_average
    manager.should_commit = counted_vote
    walls = []
    try:
        for step in range(job["warmup"] + job["steps"]):
            tokens = model.tokens(gid, step)
            before = dict(fa.LAUNCHES)
            synchronize(model.device)
            t0 = time.perf_counter()
            opt.begin_step()
            _, grads = model.ts.grads(opt.params, tokens)
            opt.step(grads)
            synchronize(model.device)
            walls.append(time.perf_counter() - t0)
            rec["launches"].append({k: fa.LAUNCHES[k] - before[k] for k in before})
            ef = opt.error_feedback
            rec["pending_after"].append(len(ef.pending_keys()) if ef is not None else None)
        timed = walls[job["warmup"]:]
        return {
            "plane": coll.plane_info(), "wire_codec": manager.wire_codec(),
            "error_feedback": opt.error_feedback is not None,
            "steps": len(walls), "step": manager.current_step(),
            "step_s": timed, "median_step_s": statistics.median(timed),
            "avg_ms": rec["avg_ms"], "pending_at_vote": rec["pending_at_vote"],
            "pending_after": rec["pending_after"], "committed": rec["committed"],
            "launches_per_step": [x for i, x in enumerate(rec["launches"])
                                  if x not in rec["launches"][:i]],
            "first_avg_digest": first.get("digest"), "grad_dtypes": first.get("dtypes"),
            "first_avg_wire_err": first.get("wire_err"),
            "first_avg_controls": first.get("controls"),
            "final_digest": _digest(tree_leaves(opt.params)),
            "total_bytes": model.grad_bytes,
        }
    finally:
        optim.allreduce_gradients = average
        manager.shutdown(wait=False)
        store.shutdown()


def _tree_leaves(gid: int, n_leaves: int, leaf_elems: int) -> List[Any]:
    """Group ``gid``'s synthetic gradient tree: unit normals from its seed,
    in ~4 MB float32 leaves (the JAX worker's tree)."""
    import numpy as np

    rng = np.random.default_rng(gid)
    return [rng.standard_normal(leaf_elems).astype(np.float32) for _ in range(n_leaves)]


def _tree(job: Dict[str, Any], gid: int, device) -> Dict[str, Any]:
    """The JAX worker's round (``crossgroup.py:324-421``): a synthetic
    gradient tree of ``total_mb`` on the device, averaged through a Manager
    (sync quorum) each round, quorum and commit every round. ``serial``:
    the round-2 schedule, every leaf to the host first, then one managed
    op over all buckets, then each bucket back; else
    ``allreduce_gradients``' per-bucket pipeline. The first round's average
    is held against the exact one (both groups' trees, averaged in float64)
    by :func:`wire_error`."""
    import numpy as np
    import torch

    from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport
    from torchft_tpu_torch.collectives import wire_stage_snapshot
    from torchft_tpu_torch.ddp import _DEFAULT_BUCKET_BYTES, allreduce_gradients, plan_buckets
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.parallel.train_step import synchronize
    from torchft_tpu_torch.store import StoreServer

    leaf_elems = 1 << 20
    n_leaves = max(1, int(job["total_mb"] * 1024 * 1024 / 4 / leaf_elems))
    mine = _tree_leaves(gid, n_leaves, leaf_elems)
    grads = {f"g{i}": torch.from_numpy(a).to(device) for i, a in enumerate(mine)}
    exact = [torch.from_numpy((a.astype(np.float64) + b) / 2)
             for a, b in zip(mine, _tree_leaves(1 - gid, n_leaves, leaf_elems))]
    plan = plan_buckets([(np.float32, leaf_elems * 4)] * n_leaves, _DEFAULT_BUCKET_BYTES)

    store = StoreServer()
    coll = _collectives(job["plane"], job.get("codec"))
    manager = Manager(
        collectives=coll, load_state_dict=lambda s: None, state_dict=lambda: {},
        min_replica_size=2, replica_id=f"{job['name']}_g{gid}", store_addr=store.address(),
        rank=0, world_size=1, lighthouse_addr=job["lighthouse"], timeout=_TIMEOUT,
        quorum_timeout=_TIMEOUT, use_async_quorum=False,
        checkpoint_transport=HTTPTransport(timeout=_TIMEOUT, hostname="localhost"),
    )

    stages = {"host_copy": 0.0, "wire": 0.0, "device_copy": 0.0}

    def serial_round() -> List[Any]:
        t0 = time.perf_counter()
        host = [v.cpu().numpy() for v in grads.values()]
        buckets = [np.concatenate([host[i] for i in idxs]) for idxs in plan]
        t1 = time.perf_counter()
        manager.allreduce_many(buckets).wait()
        t2 = time.perf_counter()
        back = [torch.from_numpy(b).to(device) for b in buckets]
        synchronize(device)
        stages["host_copy"] += t1 - t0
        stages["wire"] += t2 - t1
        stages["device_copy"] += time.perf_counter() - t2
        # the averaged leaves, as views of the buckets
        return [piece for b in back for piece in b.split(leaf_elems)]

    def pipelined_round() -> List[Any]:
        out = allreduce_gradients(manager, grads)
        return [out[k] for k in grads]  # in the leaves' order, not the keys' sorted one

    run = serial_round if job["serial"] else pipelined_round
    try:
        # warm-up (also forms the quorum); its average is the first one
        manager.start_quorum()
        first = run()
        synchronize(device)
        err = wire_error([t.cpu() for t in first], exact)
        committed = [manager.should_commit()]
        stages.update(dict.fromkeys(stages, 0.0))  # the timed rounds only
        wire_stage_snapshot(reset=True)
        t0 = time.perf_counter()
        for _ in range(job["rounds"]):
            manager.start_quorum()
            run()
            synchronize(device)  # the averaged tree is on the device
            committed.append(manager.should_commit())
        secs = (time.perf_counter() - t0) / job["rounds"]
        if not job["serial"]:
            # the streamed schedule overlaps its legs per bucket: its stages
            # are the wire plane's own counters (host_copy and quantize on
            # the main thread, wire and dequant_reduce on the collectives
            # thread), as the JAX worker reads them
            stages = wire_stage_snapshot()
        return {"seconds_per_round": secs, "total_bytes": n_leaves * leaf_elems * 4,
                "plane": coll.plane_info(), "wire_codec": coll.wire_codec(),
                "committed": committed, "first_avg_wire_err": err,
                # the serial schedule's legs, host clock
                "stages_per_round_s": {k: v / job["rounds"] for k, v in stages.items()}}
    finally:
        manager.shutdown(wait=False)
        store.shutdown()


def _worker() -> None:
    import logging

    import torch

    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.utils.platform import resolve_device

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    gid = int(os.environ["REPLICA_GROUP_ID"])
    store = os.environ["TORCHFT_CROSSGROUP_STORE"]
    with open(os.environ["TORCHFT_CROSSGROUP_JOBS"]) as f:
        jobs = json.load(f)
    device = resolve_device(os.environ.get("DEVICE", "cuda"))
    if device.type == "cpu":
        # the groups share the host's cores: intra-op pools would spin
        # against each other
        torch.set_num_threads(1)
    else:
        fa.build()  # built by the orchestrator: a lookup here
    model: Optional[_Model] = None
    refused = None  # the probe's answer when the kernel refused the pull
    for job in jobs:
        if job["kind"] in ("raw", "e2e") and model is None:
            model = _Model(device)
        if refused is not None and job.get("plane") == "cma":
            out = {"skipped": refused}
        elif job["kind"] == "probe":
            out = _probe(job, gid, store, device)
            refused = None if out["result"] == "ok" else out["result"]
        elif job["kind"] == "raw":
            out = _raw(job, gid, store, model.grad_bytes)
        elif job["kind"] == "heal":
            out = _heal(job, gid, store, device)
        elif job["kind"] == "tree":
            out = _tree(job, gid, device)
        else:
            out = _e2e(job, gid, model)
        print(json.dumps({"job": job["name"], "gid": gid, **out}), flush=True)
    graphs = model.ts.graphs if model is not None else None
    print(json.dumps({"job": "captures", "gid": gid,
                      "captures": dict(graphs.captures) if graphs is not None else None}),
          flush=True)


# ---------------------------------------------------------------------------
# orchestrator
# ---------------------------------------------------------------------------


def run_pair(jobs: List[Dict[str, Any]], device: str = "cuda",
             timeout_s: float = 900.0) -> Dict[str, List[Dict[str, Any]]]:
    """Run ``jobs`` in two worker processes, in order; returns each job's
    results by name, one per worker in group order (and ``captures``: the
    gradient graph's captures per worker). ``e2e`` and ``tree`` jobs get a
    lighthouse of their own. A worker that fails, or outlasts ``timeout_s``,
    raises with its log's tail."""
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.store import StoreServer
    from torchft_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        from torchft_tpu_torch.ops import flash_attention as fa

        fa.build()  # once, here: no worker's timings include a build
    tmp = tempfile.mkdtemp(prefix="tft_torch_crossgroup_")
    store = StoreServer()
    lighthouses = []
    procs: List[subprocess.Popen] = []
    logs = [os.path.join(tmp, f"g{g}.stderr") for g in range(2)]
    try:
        jobs = [dict(j) for j in jobs]
        for job in jobs:
            if job["kind"] in ("e2e", "tree"):
                lighthouses.append(LighthouseServer(bind="[::]:0", min_replicas=2))
                job["lighthouse"] = lighthouses[-1].address()
        path = os.path.join(tmp, "jobs.json")
        with open(path, "w") as f:
            json.dump(jobs, f)
        env = dict(os.environ)
        pkg_parent = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(p for p in (pkg_parent, env.get("PYTHONPATH")) if p)
        env.update(TORCHFT_CROSSGROUP_JOBS=path, TORCHFT_CROSSGROUP_STORE=store.address(),
                   DEVICE=dev.type)
        for gid in range(2):
            with open(logs[gid], "wb") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "torchft_tpu_torch.benchmarks.crossgroup"],
                    env={**env, "REPLICA_GROUP_ID": str(gid)},
                    stdout=subprocess.PIPE, stderr=err,
                ))
        deadline = time.monotonic() + timeout_s
        outs = []
        for gid, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise TimeoutError(f"crossgroup worker {gid} did not finish:\n{_tail(logs[gid])}")
            if p.returncode != 0:
                raise RuntimeError(
                    f"crossgroup worker {gid} exited rc={p.returncode}:\n{_tail(logs[gid])}")
            outs.append([json.loads(line) for line in out.decode().splitlines()
                         if line.startswith("{")])
        results: Dict[str, List[Dict[str, Any]]] = {}
        for gid_out in outs:
            for r in gid_out:
                results.setdefault(r["job"], []).append(r)
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for lh in lighthouses:
            lh.shutdown()
        store.shutdown()


def _tail(path: str, n: int = 3000) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except FileNotFoundError:
        return ""


def measure_crossgroup(total_mb: float = 256.0, rounds: int = 3,
                       device: str = "cuda") -> Dict[str, Any]:
    """The JAX harness's matrix on the port: raw rows per plane, the heal
    with and without CMA, the end-to-end rows (exact on the default
    plane; bf16 on the forced striped TCP plane, where CMA does not
    bypass the codec), and the synthetic tree's serial round-2 schedule
    (``serial_r2``) against its streamed one on the default plane."""
    nbytes = int(total_mb * 1024 * 1024)
    jobs: List[Dict[str, Any]] = []
    raw = {"raw_cma": ("cma", None), "raw_tcp_striped": ("tcp-striped", None),
           "raw_tcp_striped_bf16": ("tcp-striped", "bfloat16"),
           "raw_python_ring": ("python-ring", None)}
    for name, (plane, codec) in raw.items():
        jobs.append({"kind": "raw", "name": name, "plane": plane, "codec": codec,
                     "nbytes": nbytes, "rounds": rounds})
    for name, plane in (("heal_cma", "cma"), ("heal_tcp", "tcp-striped")):
        jobs.append({"kind": "heal", "name": name, "plane": plane, "nbytes": nbytes})
    for name, plane, codec in (("pipelined", "cma", None),
                               ("pipelined_bf16_wire", "tcp-striped", "bfloat16")):
        jobs.append({"kind": "e2e", "name": name, "plane": plane, "codec": codec,
                     "warmup": 1, "steps": rounds})
    # the synthetic tree on the default plane: the round-2 serial schedule
    # against the per-bucket pipeline
    jobs += _tree_jobs(("serial_r2", "streamed"), total_mb, rounds, "cma", None)
    res = run_pair(jobs, device)
    grad_bytes_7b = LLAMA2_7B_PARAMS * 4
    out: Dict[str, Any] = {
        "topology": "2 replica groups, separate OS processes; raw rows one allreduce "
                    "without a Manager, e2e rows quorum + commit + allreduce_gradients",
        "tree_mb": total_mb, "device": device,
    }
    for name in raw:
        r = max(res[name], key=lambda x: x["seconds_per_round"])
        if not all(x["correct"] for x in res[name]):
            raise RuntimeError(f"{name}: a wrong average")
        out[name] = {"seconds_per_round": r["seconds_per_round"],
                     "gb_per_sec": r["total_bytes"] / r["seconds_per_round"] / 1e9,
                     "plane": r["plane"], "wire_codec": r["wire_codec"],
                     "derived_llama2_7b_avg_s": grad_bytes_7b * r["seconds_per_round"]
                     / r["total_bytes"]}
    for name in ("heal_cma", "heal_tcp"):
        sent, got = res[name]
        if sent["digest"] != got["digest"]:
            raise RuntimeError(f"{name}: the healed tree's sha256 differs")
        out[name] = {"seconds": got["seconds"],
                     "gb_per_sec": got["total_bytes"] / got["seconds"] / 1e9,
                     "plane": got["plane"]}
    for name in ("pipelined", "pipelined_bf16_wire"):
        rs = res[name]
        if not all(all(r["committed"]) for r in rs):
            raise RuntimeError(f"{name}: a step did not commit")
        secs = max(r["median_step_s"] for r in rs)
        out[name] = {"seconds_per_round": secs, "gb_per_sec": rs[0]["total_bytes"] / secs / 1e9,
                     "plane": rs[0]["plane"], "wire_codec": rs[0]["wire_codec"],
                     "avg_ms_median": statistics.median(rs[0]["avg_ms"][1:] or rs[0]["avg_ms"]),
                     "derived_llama2_7b_avg_s": grad_bytes_7b * secs / rs[0]["total_bytes"]}
    for name in ("serial_r2", "streamed"):
        out[name] = _tree_row(res[name])
    out["pipeline_speedup"] = (out["serial_r2"]["seconds_per_round"]
                               / out["streamed"]["seconds_per_round"])
    # the striped heal: the same bytes from one and from two sources over
    # the blob plane; the speedup is the second's GB/s over the first's
    striped = measure_striped_heal(nbytes, [(1, False), (2, False)], device)
    for name, row in zip(("heal_striped_1src", "heal_striped_2src"), striped):
        if set(row["sha256_sources"]) != {row["sha256_healed"]}:
            raise RuntimeError(f"{name}: the healed state's sha256 differs from the sources'")
        out[name] = row
    out["heal_striped_speedup"] = (out["heal_striped_2src"]["gb_per_sec"]
                                   / out["heal_striped_1src"]["gb_per_sec"])
    return out


def _tree_jobs(names, total_mb: float, rounds: int, plane: str,
               codec: Optional[str]) -> List[Dict[str, Any]]:
    return [{"kind": "tree", "name": name, "plane": plane, "codec": codec,
             "total_mb": total_mb, "rounds": rounds, "serial": name.startswith("serial")}
            for name in names]


def _tree_row(rs: List[Dict[str, Any]]) -> Dict[str, Any]:
    """A ``tree`` job's row: the slower worker's seconds per round, GB/s of
    float32 tree bytes and the derived llama2-7b time, and the first
    average's distance from the exact one (the worse worker's)."""
    if not all(all(r["committed"]) for r in rs):
        raise RuntimeError(f"{rs[0]['job']}: a round did not commit")
    slow = max(rs, key=lambda r: r["seconds_per_round"])
    secs, nbytes = slow["seconds_per_round"], slow["total_bytes"]
    return {"seconds_per_round": secs, "gb_per_sec": nbytes / secs / 1e9,
            "plane": slow["plane"], "wire_codec": slow["wire_codec"],
            # the slower worker's: the rank the row's seconds measure
            "stages_per_round_s": slow["stages_per_round_s"],
            "derived_llama2_7b_avg_s": LLAMA2_7B_PARAMS * 4 * secs / nbytes,
            "first_avg_wire_err": {k: max(r["first_avg_wire_err"][k] for r in rs)
                                   for k in rs[0]["first_avg_wire_err"]}}


def measure_compressed(total_mb: float = 128.0, rounds: int = 2,
                       device: str = "cuda") -> Dict[str, Any]:
    """The ``crossgroup_compressed`` row (``crossgroup.py:643-687``): the
    synthetic tree on the int8 wire of the forced striped TCP plane (no
    CMA: the cross-host model, where compression is the point), in the
    serial and the streamed schedule. ``gb_per_sec`` counts the float32
    tree's bytes, so the row compares with the uncompressed ones."""
    res = run_pair(_tree_jobs(("serial", "streamed"), total_mb, rounds, "tcp-striped",
                              "int8"), device)
    out: Dict[str, Any] = {
        "topology": "2 replica groups, separate OS processes, int8 wire codec on the forced "
                    "tcp-striped native plane (TORCHFT_DP_CMA=0, the cross-host model); "
                    "gb_per_sec counts float32 tree bytes",
        "tree_mb": total_mb, "codec": "int8", "device": device,
    }
    for name in ("serial", "streamed"):
        out[name] = _tree_row(res[name])
    return out


def main() -> None:
    if "TORCHFT_CROSSGROUP_JOBS" in os.environ:
        _worker()
        return
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--total-mb", type=float, default=256.0)
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--compressed", action="store_true",
                        help="run only the crossgroup_compressed matrix (int8 wire, serial "
                        "and streamed)")
    parser.add_argument("--striped-heal-server", action="store_true",
                        help="serve as one stripe source of measure_striped_heal (internal)")
    parser.add_argument("--nbytes", type=int, default=0)
    args = parser.parse_args()
    if args.striped_heal_server:
        _striped_heal_server(args.nbytes, args.device)
        return
    fn = measure_compressed if args.compressed else measure_crossgroup
    print(json.dumps(fn(args.total_mb, args.rounds, args.device)), flush=True)


if __name__ == "__main__":
    main()
