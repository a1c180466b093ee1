"""Recovery wall clock: SIGKILL one replica group, time the survivor's
blackout and the rejoiner's time to its first commit — the port's copy of
``torchft_tpu/benchmarks/recovery.py``.

The groups are worker processes (``python -m
torchft_tpu_torch.benchmarks.recovery`` with ``TORCHFT_EVENT_LOG`` set),
each training the transformer through the port's entry points: a
``Manager`` on ``CollectivesTcp`` (the plane the environment selects:
the native one by default, CMA on one host) with the ``HTTPTransport``
heal, and
``FTTrainer`` over ``TrainStep`` (replayed from CUDA graphs on the card).
One lighthouse (``min_replicas=1``; a join timeout of 100 ms for two
groups, ``JOIN_TIMEOUT_MANY_MS`` for three or more) and one
``StoreServer`` per group live in the orchestrator. Once every group has
committed a step (a group that starts slowly may join after the first
quorums) and the last group has committed ``kill_at_step``, the last group
takes SIGKILL (no cleanup, no goodbye: its manager server and heartbeats
die with it) and is respawned by hand, so the respawn time is known
exactly; it heals from a survivor. A kill during a group's first join
would land in an open fault of both packages (ROADMAP queue 3: the
survivors wait out the op timeout), which the measurement leaves out.

The device comes from the environment, as in ``examples/train_cifar.py``:
``DEVICE`` is ``cuda`` (the default) or ``cpu``, and a worker asked for
the card where there is none raises. On the card the workers train the
headline (d512 L8 h8 ff1408 vocab 32000 bf16, batch 8 x seq 1024,
``attention_impl="flash"``), on the CPU a tiny float32 model (the tests).

Each worker appends JSON lines to its event log (a SIGKILL may leave a
torn last line, which the reader skips): ``start`` (imports done),
``ready`` (CUDA, the kernel library and the model on the device),
``manager`` (the Manager up), ``trainer`` (the optimizer made and the
trainer registered), ``configured`` (a quorum delivered and the plane
rebuilt; which plane), ``heal_begin`` / ``heal_end`` (bytes, seconds),
``eviction`` (victim, evicted), ``commit`` / ``abort`` (step, loss,
participants, the latched error and whether a deadline caused it),
``timeout_retry`` (a step that hit a deadline, retried) and
``final`` (a sha256 of params and optimizer state, the
graph captures, the flash launches per step, the heal).

Reported (seconds, host wall clock):

* ``survivor_blackout_s``: the survivor's last commit before the kill to
  its first after it: death detection, the eviction report, the
  re-quorum and the plane's rebuild, and the doomed step;
* ``rejoin_to_commit_s``: the respawn to the rejoiner's first commit,
  split in ``rejoin_parts_s`` by the events above: process start and
  ``import torch``; CUDA, kernels and model; Manager up; optimizer and
  trainer; the first quorum; the heal; the rest of the first step (its forward and backward
  overlap the quorum and the heal, so they show in the parts they
  overlap);
* ``steady_step_s``: the median interval between the survivor's commits
  before the kill, and ``survivor_steps_lost``;
* ``timeout_retries`` and ``deadline_aborts``: per group, the steps that
  hit a deadline (the worker retries them; phase 12 of ``chip_smoke.py``
  fails on any);
* ``rejoin_heal``: the rejoiner's heal as the transport saw it (mode,
  ``nsources``, bytes, per-source bytes, ranges and GB/s, the stages);
* ``observability``: what the workers' own telemetry recorded. Each worker
  writes its FT event trail (``TORCHFT_EVENT_TRAIL``) and its spans
  (``TORCHFT_TRACE_PATH``) beside its event log, and dumps its flight
  recorder under ``TORCHFT_FLIGHT_DIR``. Read back: the survivors'
  ``eviction`` and ``quorum_ready`` records after the kill, whether the
  rejoiner's ``heal_recv`` span and the survivors' ``checkpoint_serve``
  spans share one trace id (the ``X-TFT-Trace`` header), and the flight
  dump a ``SIGUSR2`` to the first survivor writes after its first commit
  past the kill (its last allreduces).

:func:`measure_recovery` with ``victim_env`` lets the victim's first
incarnation kill itself by a fault schedule (``faultinject``: a ``kill``
at a site) instead of the harness's SIGKILL, and waits for its death; the
lighthouse then forms quorums of every group only, so the schedule's hits
count joint steps from the first.

:func:`run_fleet` runs the same workers with no kill, one of them slowed
by a host sleep in its local time from a given step, and reads the
fleet plane while they linger after their last step: the lighthouse's
``/cluster.json``, ``/fleet.json``, ``/timeseries.json``, ``/trace`` and
``/diagnosis.json``, and each worker's ``/metrics`` and
``/critical_path.json``. A worker's ``final`` event also lists the
diagnosis bundles its Manager's engine wrote (``TORCHFT_DIAG_DIR``) and
its samplers' sample counts, and ``TORCHFT_BENCH_STRAGGLER`` ("factor,k")
sets the straggler detector's factor and K in it.

Usage: ``python -m torchft_tpu_torch.benchmarks.recovery`` (the card) or
``DEVICE=cpu python -m torchft_tpu_torch.benchmarks.recovery``; prints
the result as one JSON line.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["measure_recovery", "RecoveryResult", "run_fleet", "JOIN_TIMEOUT_MANY_MS"]

# The lighthouse's join timeout with three groups or more. A steady step
# longer than the join timeout splits three groups into quorums that never
# again hold all of them (ROADMAP queue 3, shared with the JAX package): a
# request left out of one quorum waits at the lighthouse, and when the
# next group asks, that old request has outlived the join timeout, so the
# quorum forms at once without the third. The headline's step on the card
# (0.33-0.38 s between four processes) and the tiny CPU step on a loaded
# host (0.14 s in a whole 6-worker test run) both pass 100 ms. Two groups
# keep the lighthouse's 100 ms: a quorum there needs both (a strict
# majority of the heartbeating groups).
JOIN_TIMEOUT_MANY_MS = 1000


def _model_config(device_type: str):
    """The model and (batch, seq) a worker trains: the headline on the
    card, two narrow float32 layers on the CPU."""
    import torch

    from torchft_tpu_torch.models.transformer import TransformerConfig, headline_config

    if device_type == "cuda":
        return headline_config(), (8, 1024)
    return TransformerConfig(
        vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64,
        dtype=torch.float32, attention_impl="flash",
    ), (2, 128)


# ---------------------------------------------------------------------------
# worker (subprocess entry: python -m torchft_tpu_torch.benchmarks.recovery)
# ---------------------------------------------------------------------------


class _EventLog:
    """Appends one JSON object per line; any thread may write."""

    def __init__(self, path: str) -> None:
        self._f = open(path, "a")
        self._lock = threading.Lock()

    def emit(self, **event: Any) -> None:
        event["t"] = time.time()
        with self._lock:
            self._f.write(json.dumps(event) + "\n")
            self._f.flush()

    def close(self) -> None:
        self._f.close()


def _state_digest(trainer) -> str:
    """sha256 over the params and the optimizer's per-param state."""
    import hashlib

    import torch

    from torchft_tpu_torch.utils.tree import tree_leaves

    h = hashlib.sha256()
    leaves = list(tree_leaves(trainer.params))
    state = trainer.opt.state_dict()["state"]
    for i in sorted(state):
        leaves += [state[i][k] for k in sorted(state[i])]
    for leaf in leaves:
        h.update(leaf.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _instrument(manager, log: _EventLog, heal: Dict[str, Any], blobs: List[int]) -> None:
    """Wrap the Manager's plane, heal transport and eviction report so each
    writes its event, and its telemetry encoder so each blob's size lands
    in ``blobs``."""
    import torch

    from torchft_tpu_torch.utils.tree import tree_leaves

    configure = manager._collectives.configure

    def configured(store_addr, rank, world_size):
        configure(store_addr, rank, world_size)
        log.emit(event="configured", rank=rank, world_size=world_size,
                 plane=manager._collectives.plane_info())

    manager._collectives.configure = configured
    transport = manager._checkpoint_transport

    def timed(recv):
        def timed_recv(*args, **kwargs):
            log.emit(event="heal_begin")
            t0 = time.perf_counter()
            state = recv(*args, **kwargs)
            heal["seconds"] = time.perf_counter() - t0
            heal["bytes"] = sum(x.nbytes for x in tree_leaves(state)
                                if isinstance(x, torch.Tensor))
            # the striped heal's own account: mode, sources, per-source
            # bytes and rates, the stages
            heal["stats"] = dict(getattr(transport, "last_heal_stats", None) or {}) or None
            log.emit(event="heal_end", bytes=heal["bytes"], seconds=heal["seconds"],
                     stats=heal["stats"])
            return state

        return timed_recv

    transport.recv_checkpoint = timed(transport.recv_checkpoint)
    if hasattr(transport, "recv_checkpoint_multi"):
        transport.recv_checkpoint_multi = timed(transport.recv_checkpoint_multi)
    report = manager._report_eviction

    def reported(victim):
        evicted = report(victim)
        log.emit(event="eviction", victim=victim, evicted=evicted)
        return evicted

    manager._report_eviction = reported
    encoder = manager._delta_encoder()
    encode = encoder.encode

    def sized(report):
        blob = encode(report)
        blobs.append(len(blob))
        return blob

    encoder.encode = sized


def _piggyback_sizes(manager, blobs: List[int]) -> Dict[str, Any]:
    """What this worker's telemetry piggyback weighed: every blob's bytes
    (the first the full state), and for the report as it stands now, its
    full blob and the full-JSON payload (wire-encoded, spans left out: they
    ride beside either)."""
    from torchft_tpu_torch.telemetry.fleetdelta import DeltaEncoder
    from torchft_tpu_torch.utils import wire

    payload = dict(manager._telemetry_payload_json() or {})
    payload.pop("spans", None)
    enc = manager._delta_encoder()
    return {"blobs": list(blobs), "fulls": enc.fulls_total,
            "full_blob_now": len(DeltaEncoder().encode(manager._telemetry_report())),
            "json_payload_now": len(wire.encode(payload))}

def _hit_deadline(err: Optional[BaseException]) -> bool:
    """Whether a step's latched error is, or was caused by, a deadline."""
    seen = 0
    while err is not None and seen < 8:
        if isinstance(err, TimeoutError):
            return True
        err = err.__cause__ or err.__context__
        seen += 1
    return False


def _participants(manager) -> Optional[int]:
    """The groups in the step just taken, or None when reading it timed out:
    an early re-quorum that the death watch started during the step is the
    quorum ``num_participants`` waits for, and its deadline may pass on a
    loaded host. The next step retries that quorum."""
    try:
        return manager.num_participants()
    except TimeoutError:
        return None


def _shutdown_bounded(servers, timeout_s: float = 10.0) -> int:
    """Shut ``servers`` down, each on a thread of its own, waiting at most
    ``timeout_s`` for all of them; returns how many had not finished. A
    ``StoreServer``'s shutdown once blocked for good in this cleanup
    (ROADMAP queue 3), and the harness must end."""
    threads = [threading.Thread(target=s.shutdown, daemon=True, name="tft_recovery_shutdown")
               for s in servers]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout_s
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    return sum(t.is_alive() for t in threads)


def _worker() -> None:
    import logging

    import numpy as np
    import torch

    from datetime import timedelta

    from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport
    from torchft_tpu_torch.collectives import CollectivesTcp
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.parallel.ft import FTTrainer
    from torchft_tpu_torch.parallel.train_step import TrainStep, synchronize
    from torchft_tpu_torch.telemetry.profiler import PROFILER, poll_native_samples
    from torchft_tpu_torch.utils.platform import resolve_device

    # the Manager's log (quorums, heals, eviction reports) goes to the
    # worker's stderr file beside its event log
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    gid = int(os.environ["REPLICA_GROUP_ID"])
    num_groups = int(os.environ["NUM_REPLICA_GROUPS"])
    total_steps = int(os.environ["TORCHFT_BENCH_STEPS"])
    step_sleep = float(os.environ.get("TORCHFT_BENCH_STEP_SLEEP", "0"))
    # run_fleet's slowed group: from this step on, a host sleep of this
    # many of its own steady steps
    slow_from = int(os.environ.get("TORCHFT_BENCH_SLOW_FROM", "-1"))
    slow_steps = float(os.environ.get("TORCHFT_BENCH_SLOW_STEPS", "0"))
    linger = os.environ.get("TORCHFT_BENCH_LINGER")
    # the straggler detector's factor and K ("2.0,3"), set before the
    # Manager makes its monitor (module constants of telemetry.slo)
    straggler = os.environ.get("TORCHFT_BENCH_STRAGGLER")
    if straggler:
        from torchft_tpu_torch.telemetry import slo

        factor, k = straggler.split(",")
        slo.STRAGGLER_FACTOR, slo.STRAGGLER_K = float(factor), int(k)
    op_timeout = timedelta(seconds=float(os.environ["TORCHFT_BENCH_OP_TIMEOUT"]))
    log = _EventLog(os.environ["TORCHFT_EVENT_LOG"])
    log.emit(event="start", gid=gid, pid=os.getpid())

    device = resolve_device(os.environ.get("DEVICE", "cuda"))
    if device.type == "cpu":
        # the groups share the host's cores: intra-op thread pools in every
        # process spin against each other (a tiny step takes 40x longer)
        torch.set_num_threads(1)
    cfg, (batch, seq) = _model_config(device.type)
    if device.type == "cuda":
        fa.build()  # built by the orchestrator: a lookup here
    ts = TrainStep(cfg, device=device)
    params = ts.init_params(seed=0)
    synchronize(device)
    log.emit(event="ready", device=str(device))

    manager = Manager(
        collectives=CollectivesTcp(timeout=op_timeout),
        load_state_dict=None,
        state_dict=None,
        min_replica_size=1,
        replica_id=f"group{gid}_",
        rank=0,
        world_size=1,
        timeout=op_timeout,
        quorum_timeout=timedelta(seconds=60),
        connect_timeout=timedelta(seconds=30),
        checkpoint_transport=HTTPTransport(timeout=op_timeout),
    )
    heal: Dict[str, Any] = {}
    blobs: List[int] = []
    _instrument(manager, log, heal, blobs)
    log.emit(event="manager", replica_id=manager._replica_id,
             http=manager._checkpoint_transport.metadata())
    commit_times: List[float] = []
    slow: Dict[str, float] = {}
    if step_sleep or slow_steps:
        # paced as the JAX worker's toy step: the sleep comes between the
        # quorum request and the allreduce, so every group's request leaves
        # right after its previous commit, and a sleep that overruns on a
        # loaded host does not make its group a straggler at the quorum.
        # The slowed group's sleep sits there too: in its local time (the
        # ledger's idle), while the others wait for it in their wire phase
        start_quorum = manager.start_quorum

        def paced(*args, **kwargs):
            start_quorum(*args, **kwargs)
            extra = 0.0
            if slow_steps and 0 <= slow_from <= manager.current_step():
                if "s" not in slow:
                    # its steady step: the median interval of the last
                    # commits before the onset
                    gaps = sorted(b - a for a, b in zip(commit_times[-6:], commit_times[-5:]))
                    slow["s"] = slow_steps * (gaps[len(gaps) // 2] if gaps else 0.1)
                    log.emit(event="slowed", gid=gid, step=manager.current_step(),
                             sleep_s=slow["s"])
                extra = slow["s"]
            time.sleep(step_sleep + extra)

        manager.start_quorum = paced
    trainer = FTTrainer(manager, ts)
    trainer.init(params=params)
    del params
    log.emit(event="trainer")
    launches_per_step: List[Dict[str, int]] = []
    try:
        while True:
            step = manager.current_step()
            tokens = torch.from_numpy(
                np.random.default_rng([gid, step]).integers(0, cfg.vocab_size, (batch, seq))
            ).to(device)
            before = dict(fa.LAUNCHES)
            try:
                loss, committed = trainer.step(tokens)
            except TimeoutError as e:
                # a real trainer retries the step; the orchestrator's own
                # deadline still bounds a wedge, and the result counts the
                # retries (``RecoveryResult.timeout_retries``)
                log.emit(event="timeout_retry", gid=gid, err=str(e)[:200])
                continue
            launches_per_step.append({k: fa.LAUNCHES[k] - before[k] for k in before})
            if committed:
                commit_times.append(time.monotonic())
            participants = _participants(manager)
            err = manager.errored()
            log.emit(event="commit" if committed else "abort", gid=gid,
                     step=manager.current_step(), loss=loss, participants=participants,
                     pid=os.getpid(), err=None if err is None else str(err)[:200],
                     deadline=_hit_deadline(err))
            # every group leaves after the same joint step, so each ends
            # with the state the others hold
            if committed and manager.current_step() >= total_steps and participants == num_groups:
                break
        synchronize(device)
        diagnosis = manager._diagnosis
        if diagnosis is not None:
            diagnosis.wait_idle(30.0)  # a bundle being written lands whole
        log.emit(
            event="final", gid=gid, step=manager.current_step(), digest=_state_digest(trainer),
            diag_bundles=list(diagnosis.bundles) if diagnosis is not None else [],
            prof_samples={"py": PROFILER.samples_total(), "native": poll_native_samples()},
            captures=dict(ts.graphs.captures) if ts.graphs is not None else None,
            launches=dict(fa.LAUNCHES), steps=len(launches_per_step),
            # the distinct per-step counts: one entry when every step ran
            # the same kernels
            launches_per_step=[x for i, x in enumerate(launches_per_step)
                               if x not in launches_per_step[:i]],
            heal=heal or None, telemetry=_piggyback_sizes(manager, blobs),
        )
        if linger:
            # run_fleet reads the fleet plane while every worker still runs
            deadline = time.monotonic() + 300
            while not os.path.exists(linger) and time.monotonic() < deadline:
                time.sleep(0.05)
    finally:
        manager.shutdown(wait=False)
        log.emit(event="exit", gid=gid, pid=os.getpid())
        log.close()


# ---------------------------------------------------------------------------
# orchestrator
# ---------------------------------------------------------------------------


@dataclass
class RecoveryResult:
    survivor_blackout_s: float
    rejoin_to_commit_s: float
    steady_step_s: float
    survivor_steps_lost: int
    total_steps: int
    # the rejoiner's start-up, split by its events (see the module doc)
    rejoin_parts_s: Dict[str, float] = field(default_factory=dict)
    # each group's last incarnation's ``final`` event, by group id
    finals: Dict[int, Dict[str, Any]] = field(default_factory=dict)
    # the survivors' eviction reports after the kill: (group, victim, evicted)
    evictions: List[tuple] = field(default_factory=list)
    survivor_commits_after_kill: int = 0
    rejoiner_commits: int = 0
    # deadlines hit during the run, by group id (every incarnation): steps
    # that raised TimeoutError and were retried, and steps that voted False
    # on a latched error caused by a deadline (an op's, a heal's)
    timeout_retries: Dict[int, int] = field(default_factory=dict)
    deadline_aborts: Dict[int, int] = field(default_factory=dict)
    # the planes each group's epochs of more than one group ran on
    planes: Dict[int, List[str]] = field(default_factory=dict)
    log_paths: List[str] = field(default_factory=list)
    # the respawned group's first heal: mode, sources, bytes, per-source
    # rates and the stages (``HTTPTransport.last_heal_stats``), and its wall
    rejoin_heal: Optional[Dict[str, Any]] = None
    join_timeout_ms: int = 100  # the lighthouse's
    # the victim's first incarnation's exit code (-9: SIGKILL, the harness's
    # or its own fault schedule's)
    victim_rc: Optional[int] = None
    # the workers' trails, spans and the SIGUSR2 flight dump, read back
    # (see the module doc)
    observability: Dict[str, Any] = field(default_factory=dict)

    def as_dict(self) -> Dict[str, object]:
        return {
            "survivor_blackout_s": round(self.survivor_blackout_s, 3),
            "rejoin_to_commit_s": round(self.rejoin_to_commit_s, 3),
            "rejoin_parts_s": {k: round(v, 3) for k, v in self.rejoin_parts_s.items()},
            "steady_step_s": round(self.steady_step_s, 4),
            "blackout_steps": round(
                self.survivor_blackout_s / max(self.steady_step_s, 1e-9), 1
            ),
            "survivor_steps_lost": self.survivor_steps_lost,
            "timeout_retries": dict(self.timeout_retries),
            "deadline_aborts": dict(self.deadline_aborts),
            "rejoin_heal": self.rejoin_heal,
            "observability": self.observability,
        }


def _read_events(path: str) -> List[Dict[str, Any]]:
    """Parse a JSONL event log, skipping the torn last line a SIGKILLed
    writer may leave."""
    records: List[Dict[str, Any]] = []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except ValueError:
                    continue
    except FileNotFoundError:
        pass
    return records


def _signal_flight_dump(proc: subprocess.Popen, flight_dir: str,
                        timeout_s: float = 20.0) -> Optional[Dict[str, Any]]:
    """SIGUSR2 ``proc`` and wait for the flight dump it writes under
    ``flight_dir``; returns the dump (None if none came)."""
    import glob

    before = set(glob.glob(os.path.join(flight_dir, "tft_flight_*.json")))
    proc.send_signal(signal.SIGUSR2)
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        for path in sorted(set(glob.glob(os.path.join(flight_dir, "tft_flight_*.json"))) - before):
            try:
                with open(path, encoding="utf-8") as f:
                    dump = json.load(f)
            except (OSError, ValueError):
                continue  # still being written
            if dump.get("reason") == "signal":
                dump["path"] = path
                return dump
        time.sleep(0.05)
    return None


def _observability(logs: List[str], victim_gid: int, t_kill: float, t_respawn: float,
                   flight: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Read the workers' trails and spans back (see the module doc)."""
    from torchft_tpu_torch.telemetry import read_trail
    from torchft_tpu_torch.telemetry.tracing import read_spans

    survivors = [g for g in range(len(logs)) if g != victim_gid]
    victim_prefix = f"group{victim_gid}_"
    evictions, quorums = [], []
    for g in survivors:
        for r in read_trail(logs[g] + ".trail"):
            if r["ts"] <= t_kill:
                continue
            if r["event"] == "eviction":
                evictions.append({"group": g, "victim": r["victim"], "evicted": r["evicted"]})
            elif r["event"] == "quorum_ready":
                quorums.append({"group": g, "quorum_id": r["quorum_id"], "step": r["step"],
                                "num_participants": r["num_participants"],
                                "victim_in": any(p.startswith(victim_prefix)
                                                 for p in r["participants"])})
    heals = [s for s in read_spans(logs[victim_gid] + ".spans")
             if s["name"] == "heal_recv" and s["ts"] > t_respawn]
    trace_id = heals[0]["trace_id"] if heals else None
    served = {g: [s for s in read_spans(logs[g] + ".spans")
                  if s["name"] == "checkpoint_serve" and s["trace_id"] == trace_id]
              for g in survivors}
    out: Dict[str, Any] = {
        "survivor_evictions": evictions,
        # the first quorums after the kill: the shrunken one, then the rejoin
        "survivor_quorums_after_kill": quorums[:4],
        "rejoiner_heal_trace_id": trace_id,
        "serve_spans_in_that_trace": {g: len(v) for g, v in served.items()},
        "serve_spans_parented": all(s.get("parent_id") == heals[0]["span_id"]
                                    for v in served.values() for s in v) if heals else False,
        "flight_dump": None,
    }
    if flight is not None:
        entries = flight.get("entries", [])
        allreduces = [e for e in entries if e["op"] == "allreduce"]
        out["flight_dump"] = {
            "path": flight["path"], "reason": flight["reason"], "entries": len(entries),
            "allreduces": len(allreduces),
            "completed_allreduces": sum(e["status"] == "completed" for e in allreduces),
            "last_completed": flight.get("last_completed"),
            "anatomy_rows": len((flight.get("anatomy") or {}).get("rows", [])),
            "threads": len(flight.get("py_stacks") or []),
        }
    return out


def _spawn(gid: int, env_extra: Dict[str, str], num_groups: int) -> subprocess.Popen:
    from torchft_tpu_torch.store import StoreServer

    store = StoreServer()
    env = dict(os.environ)
    env.update(env_extra)
    # a checkout need not be installed: make the package importable in the
    # child whatever the parent's working directory
    pkg_parent = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (pkg_parent, env.get("PYTHONPATH")) if p)
    log = env["TORCHFT_EVENT_LOG"]
    os.makedirs(log + ".flight", exist_ok=True)
    env.update(
        # the worker's own telemetry, beside its event log
        TORCHFT_EVENT_TRAIL=log + ".trail",
        TORCHFT_TRACE_PATH=log + ".spans",
        TORCHFT_FLIGHT_DIR=log + ".flight",
        TORCHFT_STORE_ADDR=store.address(),
        REPLICA_GROUP_ID=str(gid),
        NUM_REPLICA_GROUPS=str(num_groups),
        RANK="0",
        WORLD_SIZE="1",
    )
    with open(env["TORCHFT_EVENT_LOG"] + ".stderr", "ab") as stderr_f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torchft_tpu_torch.benchmarks.recovery"],
            env=env, stdout=subprocess.DEVNULL, stderr=stderr_f,
        )
    proc._torchft_store = store  # the store lives as long as the process
    return proc


def _stderr_tail(log: str, n: int = 3000) -> str:
    try:
        with open(log + ".stderr", errors="replace") as f:
            return f.read()[-n:]
    except FileNotFoundError:
        return ""


def _wait_for(logs: List[str], gid: int, pred, timeout_s: float, procs) -> Dict:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        for e in _read_events(logs[gid]):
            if pred(e):
                return e
        for g, p in enumerate(procs):
            if p is not None and p.poll() not in (None, 0):
                raise RuntimeError(
                    f"group {g} died early (rc={p.poll()}):\n{_stderr_tail(logs[g])}"
                )
        time.sleep(0.02)
    raise TimeoutError("recovery bench: an expected event never arrived")


def measure_recovery(
    total_steps: int = 20,
    kill_at_step: int = 6,
    step_sleep: float = 0.0,
    op_timeout: float = 30.0,
    heartbeat_timeout_ms: int = 5000,
    timeout_s: float = 300.0,
    num_groups: int = 2,
    env_extra: Optional[Dict[str, str]] = None,
    victim_env: Optional[Dict[str, str]] = None,
) -> RecoveryResult:
    """Kill group ``num_groups - 1`` of ``num_groups`` once every group has
    committed a step and it has committed ``kill_at_step``, respawn it, and
    measure the envelope. Every group
    must exit 0. The defaults are the card's: the lighthouse's own 5 s
    lease, and an op timeout far above a joint step of the headline over
    TCP, so that the timeout never paces a slow step (detection by FIN does
    not depend on it). ``env_extra`` goes into every worker's environment
    (the data plane: ``TORCHFT_NATIVE_PLANE``, ``TORCHFT_DP_CMA``).

    ``victim_env`` goes into the victim's first incarnation alone, and
    holds a fault schedule that kills it (``TORCHFT_FAULT_SCHEDULE``). Its
    death, not ``kill_at_step``, is then the kill: the harness waits for
    it (the kill's time is when the harness sees the process gone), and
    the respawn runs without it. The lighthouse then forms no quorum
    without every group (``min_replicas=num_groups``): no group steps
    alone at the start, so the schedule's hits count joint steps from the
    first, and a survivor waits at its quorum for the respawn."""
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.utils.platform import resolve_device

    device = resolve_device(os.environ.get("DEVICE", "cuda"))
    if device.type == "cuda":
        from torchft_tpu_torch.ops import flash_attention as fa

        fa.build()  # once, here: no worker's timings include a build
    join_timeout_ms = 100 if num_groups < 3 else JOIN_TIMEOUT_MANY_MS
    victim_gid = num_groups - 1
    tmp = tempfile.mkdtemp(prefix="tft_torch_recovery_")
    logs = [os.path.join(tmp, f"g{g}.jsonl") for g in range(num_groups)]
    # the lighthouse loads (or builds) the native core before any spawn
    lighthouse = LighthouseServer(bind="[::]:0",
                                  min_replicas=1 if victim_env is None else num_groups,
                                  join_timeout_ms=join_timeout_ms,
                                  heartbeat_timeout_ms=heartbeat_timeout_ms)
    common = {
        **(env_extra or {}),
        "TORCHFT_LIGHTHOUSE": lighthouse.address().split("//", 1)[-1],
        "TORCHFT_BENCH_STEPS": str(total_steps),
        "TORCHFT_BENCH_STEP_SLEEP": str(step_sleep),
        "TORCHFT_BENCH_OP_TIMEOUT": str(op_timeout),
    }
    procs: List[Optional[subprocess.Popen]] = [None] * num_groups
    try:
        for g in range(num_groups):
            env = {**common, **((victim_env or {}) if g == victim_gid else {}),
                   "TORCHFT_EVENT_LOG": logs[g]}
            procs[g] = _spawn(g, env, num_groups)
        # every group has joined: a kill while a group makes its first join
        # can give a quorum that counts the victim in an epoch whose plane
        # it never joins, and the survivors then wait out the op timeout
        # (an open fault, ROADMAP queue 3)
        for g in range(num_groups):
            _wait_for(logs, g, lambda e: e["event"] == "commit", timeout_s, procs)
        if victim_env is None:
            _wait_for(logs, victim_gid,
                      lambda e: e["event"] == "commit" and e["step"] >= kill_at_step,
                      timeout_s, procs)
            t_kill = time.time()
            procs[victim_gid].send_signal(signal.SIGKILL)
            procs[victim_gid].wait()
        else:
            try:
                procs[victim_gid].wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                raise TimeoutError(f"the victim's schedule never killed it:\n"
                                   f"{_stderr_tail(logs[victim_gid])}")
            t_kill = time.time()
        victim_rc = procs[victim_gid].returncode
        procs[victim_gid]._torchft_store.shutdown()
        t_respawn = time.time()
        procs[victim_gid] = _spawn(victim_gid, {**common, "TORCHFT_EVENT_LOG": logs[victim_gid]},
                                   num_groups)
        post = _wait_for(logs, 0, lambda e: e["event"] == "commit" and e["t"] > t_kill,
                         timeout_s, procs)
        # the survivor cannot finish before the rejoiner has joined it:
        # it is alive for the signal
        flight = _signal_flight_dump(procs[0], logs[0] + ".flight")
        rejoin = _wait_for(logs, victim_gid,
                           lambda e: e["event"] == "commit" and e["t"] > t_respawn,
                           timeout_s, procs)
        deadline = time.monotonic() + timeout_s
        for g, p in enumerate(procs):
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise TimeoutError(f"group {g} did not finish:\n{_stderr_tail(logs[g])}")
            if rc != 0:
                # a crash after the measured commits would otherwise pass
                raise RuntimeError(f"group {g} exited rc={rc}:\n{_stderr_tail(logs[g])}")

        events = [_read_events(path) for path in logs]
        g0 = [e for e in events[0] if e["event"] == "commit"]
        pre = [e for e in g0 if e["t"] <= t_kill]
        steady = sorted(b["t"] - a["t"] for a, b in zip(pre, pre[1:]))
        steady_step = steady[len(steady) // 2] if steady else step_sleep
        last_pre = pre[-1] if pre else {"t": t_kill, "step": kill_at_step}
        blackout = post["t"] - last_pre["t"]
        # committed steps the survivor would have made in the blackout, less
        # the ones it made: the envelope in steps
        lost = max(0, int(blackout / max(steady_step, 1e-9)) - (post["step"] - last_pre["step"]))
        # the respawned incarnation's events follow its respawn
        mine = [e for e in events[victim_gid] if e["t"] > t_respawn]
        first = {}
        for e in mine:
            first.setdefault(e["event"], e["t"])
        marks = [("start", "process start and import torch"),
                 ("ready", "CUDA, kernels and model"), ("manager", "Manager up"),
                 ("trainer", "optimizer and trainer"), ("configured", "first quorum"),
                 ("heal_end", "heal")]
        parts, prev = {}, t_respawn
        for name, label in marks:
            if name in first:
                parts[label] = first[name] - prev
                prev = first[name]
        parts["rest of the first step"] = rejoin["t"] - prev
        healed = [e for e in mine if e["event"] == "heal_end"]
        rejoin_heal = None
        if healed:
            stats = healed[0].get("stats") or {}
            rejoin_heal = {
                "mode": stats.get("mode", "single"), "nsources": stats.get("nsources", 1),
                "bytes": healed[0]["bytes"], "seconds": healed[0]["seconds"],
                "per_source": {src: {k: v[k] for k in ("bytes", "ranges", "gb_per_sec", "route")
                                     if k in v}
                               for src, v in (stats.get("sources") or {}).items()},
                "stages": stats.get("stages"), "failures": stats.get("failures"),
            }
        finals = {}
        for g in range(num_groups):
            last = [e for e in events[g] if e["event"] == "final"]
            if last:
                finals[g] = last[-1]
        evictions = [(g, e["victim"], e["evicted"]) for g in range(num_groups)
                     if g != victim_gid for e in events[g]
                     if e["event"] == "eviction" and t_kill < e["t"] <= post["t"] + 10]
        return RecoveryResult(
            survivor_blackout_s=blackout,
            rejoin_to_commit_s=rejoin["t"] - t_respawn,
            steady_step_s=steady_step,
            survivor_steps_lost=lost,
            total_steps=total_steps,
            rejoin_parts_s=parts,
            finals=finals,
            evictions=evictions,
            survivor_commits_after_kill=len([e for e in g0 if e["t"] > t_kill]),
            rejoiner_commits=len([e for e in mine if e["event"] == "commit"]),
            timeout_retries={g: sum(e["event"] == "timeout_retry" for e in events[g])
                             for g in range(num_groups)},
            deadline_aborts={g: sum(e["event"] == "abort" and bool(e.get("deadline"))
                                    for e in events[g]) for g in range(num_groups)},
            planes={g: sorted({e["plane"] for e in events[g]
                               if e["event"] == "configured" and e["world_size"] > 1})
                    for g in range(num_groups)},
            log_paths=logs,
            rejoin_heal=rejoin_heal,
            join_timeout_ms=join_timeout_ms,
            victim_rc=victim_rc,
            observability=_observability(logs, victim_gid, t_kill, t_respawn, flight),
        )
    finally:
        # every worker dies before any server shuts down, so no server
        # outlives a client it serves
        for p in procs:
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
        stuck = _shutdown_bounded([p._torchft_store for p in procs if p is not None]
                                  + [lighthouse])
        if stuck:
            print(f"recovery bench: {stuck} server shutdown(s) still blocked after 10 s; "
                  "left to the process's exit", file=sys.stderr, flush=True)


def _get(url: str, timeout: float = 10.0) -> Any:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        body = resp.read().decode()
    return body if url.endswith("/metrics") else json.loads(body)


def run_fleet(
    num_groups: int = 3,
    total_steps: int = 40,
    slow_group: Optional[int] = None,
    slow_from: int = 10,
    slow_steps: float = 3.0,
    step_sleep: float = 0.0,
    op_timeout: float = 30.0,
    timeout_s: float = 300.0,
    env_extra: Optional[Dict[str, str]] = None,
    group_env: Optional[Dict[int, Dict[str, str]]] = None,
) -> Dict[str, Any]:
    """``num_groups`` workers against one lighthouse, no kill, until every
    group has committed ``total_steps`` together. ``slow_group`` sleeps, from
    its step ``slow_from`` on, ``slow_steps`` of its own steady steps in its
    local time each step. ``env_extra`` goes to every worker, ``group_env[g]``
    to group g alone (the fleet monitors, their poll periods). Once every
    worker has written its ``final`` event it lingers, and the fleet plane
    is read: the lighthouse's ``cluster``, ``fleet``, ``timeseries``,
    ``trace`` and ``diagnosis``, and each worker's ``metrics`` and
    ``critical_path``. Every
    worker must then exit 0. Returns those reads, each group's ``final``
    event (``finals``), its ``slowed`` event, its replica id and
    ``log_paths``.

    The lighthouse's time-series store is process-wide in the native core
    and outlives a lighthouse: it is cleared first, so that rings of
    earlier lighthouses in this process are not served (and attributed)
    beside the fleet's."""
    from torchft_tpu_torch import _native
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.utils.platform import resolve_device

    device = resolve_device(os.environ.get("DEVICE", "cuda"))
    if device.type == "cuda":
        from torchft_tpu_torch.ops import flash_attention as fa

        fa.build()
    join_timeout_ms = 100 if num_groups < 3 else JOIN_TIMEOUT_MANY_MS
    tmp = tempfile.mkdtemp(prefix="tft_torch_fleet_")
    logs = [os.path.join(tmp, f"g{g}.jsonl") for g in range(num_groups)]
    release = os.path.join(tmp, "release")
    _native.tsdb_reset()
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=1, join_timeout_ms=join_timeout_ms)
    addr = lighthouse.address()
    common = {
        **(env_extra or {}),
        "TORCHFT_LIGHTHOUSE": addr.split("//", 1)[-1],
        "TORCHFT_BENCH_STEPS": str(total_steps),
        "TORCHFT_BENCH_STEP_SLEEP": str(step_sleep),
        "TORCHFT_BENCH_OP_TIMEOUT": str(op_timeout),
        "TORCHFT_BENCH_LINGER": release,
    }
    procs: List[Optional[subprocess.Popen]] = [None] * num_groups
    try:
        for g in range(num_groups):
            env = {**common, **(group_env or {}).get(g, {}), "TORCHFT_EVENT_LOG": logs[g]}
            if g == slow_group:
                env.update(TORCHFT_BENCH_SLOW_FROM=str(slow_from),
                           TORCHFT_BENCH_SLOW_STEPS=str(slow_steps))
            procs[g] = _spawn(g, env, num_groups)
        finals = {g: _wait_for(logs, g, lambda e: e["event"] == "final", timeout_s, procs)
                  for g in range(num_groups)}
        events = [_read_events(path) for path in logs]
        http = {g: next(e["http"] for e in events[g] if e["event"] == "manager")
                for g in range(num_groups)}
        out: Dict[str, Any] = {
            "finals": finals, "log_paths": logs, "lighthouse": addr,
            "replica_ids": {g: next(e["replica_id"] for e in events[g]
                                    if e["event"] == "manager") for g in range(num_groups)},
            "slowed": {g: e for g in range(num_groups) for e in events[g]
                       if e["event"] == "slowed"},
            "commits": {g: [e for e in events[g] if e["event"] == "commit"]
                        for g in range(num_groups)},
            "cluster": _get(addr + "/cluster.json"),
            "fleet": _get(addr + "/fleet.json"),
            "timeseries": _get(addr + "/timeseries.json"),
            "trace": _get(addr + "/trace"),
            "diagnosis": _get(addr + "/diagnosis.json"),
            "metrics": {g: _get(http[g] + "/metrics") for g in range(num_groups)},
            "critical_path": {g: _get(http[g] + "/critical_path.json")
                              for g in range(num_groups)},
        }
        with open(release, "w"):
            pass
        deadline = time.monotonic() + timeout_s
        for g, p in enumerate(procs):
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise TimeoutError(f"group {g} did not finish:\n{_stderr_tail(logs[g])}")
            if rc != 0:
                raise RuntimeError(f"group {g} exited rc={rc}:\n{_stderr_tail(logs[g])}")
        return out
    finally:
        for p in procs:
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
        stuck = _shutdown_bounded([p._torchft_store for p in procs if p is not None]
                                  + [lighthouse])
        if stuck:
            print(f"fleet run: {stuck} server shutdown(s) still blocked after 10 s; left to the "
                  "process's exit", file=sys.stderr, flush=True)


def _series_value(metrics: str, family: str) -> Dict[str, float]:
    """``{labels: value}`` of one family's nonzero series in a Prometheus page."""
    out = {}
    for line in metrics.splitlines():
        if line.startswith(family + "{"):
            key, _, value = line.rpartition(" ")
            if float(value):
                out[key[len(family):]] = float(value)
    return out


def fleet_checks(r: Dict[str, Any], slow_group: int, slow_from: int,
                 total_steps: int, regression_alone: bool = True
                 ) -> List[Tuple[str, bool, str]]:
    """What a :func:`run_fleet` result must show, as ``(name, held,
    detail)``: one state in every worker; every replica in ``/cluster.json``
    at the last step with its summary and anatomy; the lighthouse's delta
    chains applied with one full blob each and no resync; ``/fleet.json``
    over every group with wall p50/p99; each replica's wall series in
    ``/timeseries.json``; the straggler and regression latches of group 0's
    monitors (its ``/metrics``) on the slowed group alone; its
    ``/critical_path.json`` blaming the fleet's replicas only, the slowed
    group for most of it, and the attribution of each step's series
    naming the slowed group the gating replica of most steps after the
    onset; the slowed group's SLO breach in ``/cluster.json``; and a lane
    per replica in the merged ``/trace`` with its ``quorum_rpc`` spans.
    ``regression_alone=False`` asks only that the regression sentinel
    latch the slowed group's ``local_s``: on a host that other jobs load,
    another worker's own phases may shift too, which the sentinel is
    there to see."""
    from torchft_tpu_torch.telemetry.critical_path import attribute_step

    ids = r["replica_ids"]
    n = len(ids)
    slow = ids[slow_group]
    out: List[Tuple[str, bool, str]] = []
    digests = {g: f["digest"] for g, f in r["finals"].items()}
    out.append(("one state", len(set(digests.values())) == 1, f"{digests}"))
    reps = r["cluster"].get("replicas", {})
    rows = {g: reps.get(rid, {}) for g, rid in ids.items()}
    out.append(("cluster.json", all(
        row.get("step", -1) >= total_steps - 1 and row.get("summary") and row.get("anatomy")
        for row in rows.values()), f"steps {[row.get('step') for row in rows.values()]}"))
    tel = r["fleet"].get("telemetry", {})
    out.append(("delta chains", tel.get("delta_blobs_total", 0) >= n * total_steps
                and tel.get("delta_fulls_total") == n and tel.get("delta_resyncs_total") == 0,
                f"{tel}"))
    wall = r["fleet"].get("hist", {}).get("wall", {})
    out.append(("fleet.json", r["fleet"].get("groups") == n and wall.get("p50_s", 0) > 0
                and wall.get("p99_s", 0) >= wall.get("p50_s", 0),
                f"groups {r['fleet'].get('groups')}, wall {wall}"))
    series = r["timeseries"].get("replicas", {})
    walls = {g: [s[1] for s in series.get(rid, {}).get("wall_s", {}).get("samples", [])]
             for g, rid in ids.items()}
    out.append(("timeseries.json", all(len(v) >= total_steps - 2 for v in walls.values()),
                f"wall_s samples {[len(v) for v in walls.values()]}"))
    m0 = r["metrics"][0]
    stragglers = _series_value(m0, "tft_straggler_detected_total")
    out.append(("straggler latch", list(stragglers) == [f'{{group="{slow}"}}'], f"{stragglers}"))
    regressions = _series_value(m0, "tft_perf_regression_total")
    mine = f'{{replica="{slow}",series="local_s"}}' in regressions
    alone = all(k.startswith(f'{{replica="{slow}"') for k in regressions)
    out.append(("regression latch", mine and (alone or not regression_alone),
                f"{regressions}"))
    cp = r["critical_path"][0]
    share = sum(b["share"] for b in cp.get("blame", []) if b["replica"] == slow)
    blamed = {b["replica"] for b in cp.get("blame", [])}
    out.append(("critical_path.json", cp.get("status") == "ok" and share >= 0.8
                and blamed <= set(ids.values()),
                f"steps {cp.get('steps')}, {slow_group}'s share {share:.4f}, replicas blamed "
                f"{sorted(blamed)}, last {cp.get('last')}"))
    # each step's rows from the series, attributed here too
    per_step: Dict[int, Dict[str, Dict[str, Any]]] = {}
    for rid in ids.values():
        for name, body in series.get(rid, {}).items():
            if name not in ("wall_s", "local_s") and not name.startswith("phase."):
                continue
            for _epoch, step, value in body.get("samples", []):
                row = per_step.setdefault(int(step), {}).setdefault(rid, {"phases": {}})
                if name.startswith("phase."):
                    row["phases"][name[len("phase."):]] = value
                else:
                    row[name] = value
    after = [attribute_step(rows) for step, rows in sorted(per_step.items())
             if step >= slow_from + 2 and len(rows) == n]
    gated = sum(1 for a in after if a and a["gating"] == slow)
    out.append(("gating after the onset", after and gated >= 0.8 * len(after),
                f"{gated} of {len(after)} steps"))
    breach = {g: row.get("slo_breach") for g, row in rows.items()}
    out.append(("slo breach", breach.get(slow_group) is True, f"{breach}"))
    events = r["trace"].get("traceEvents", []) if isinstance(r["trace"], dict) else r["trace"]
    lanes = {e["pid"]: e["args"]["name"] for e in events if e.get("name") == "process_name"}
    rpc = {lanes.get(e["pid"]) for e in events if e.get("name") == "quorum_rpc"}
    out.append(("merged trace", set(ids.values()) <= rpc and set(ids.values()) <= set(
        lanes.values()), f"lanes {sorted(lanes.values())}, with quorum_rpc {sorted(rpc - {None})}"))
    return out


if __name__ == "__main__":
    if "TORCHFT_EVENT_LOG" in os.environ:
        _worker()
    else:
        print(json.dumps(measure_recovery().as_dict()))
