"""Pipelined-vs-sync commit where the vote RPC costs something — the port's
copy of ``torchft_tpu/benchmarks/commit_pipeline.py``.

The protocol of ``quorum_overlap``: two replica groups as threads over
``CollectivesTcp``, a ``time.sleep(work_ms)`` forward pass, with a
synthetic round trip (``--rtt-ms``, default 10) injected into every
``ManagerClient.should_commit`` in the process. Sync mode pays ``work +
rtt`` a step; the pipelined commit (``Manager(commit_pipeline=True)``)
issues the vote asynchronously and the next step's forward covers it. No
fault is injected, so a rollback here would be a bug: the row counts them.

Run: ``python -m torchft_tpu_torch.benchmarks.commit_pipeline``; prints one
JSON line.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta
from typing import Any, Dict, List

from torchft_tpu_torch.benchmarks.quorum_overlap import summarize

__all__ = ["main", "measure"]


def _install_vote_rtt(rtt_s: float) -> None:
    """The synthetic RTT on every ``ManagerClient.should_commit`` in this
    process (class-level, so the pipelined variant's own vote client takes
    the same delayed path as the sync variant's shared one). The quorum RPC
    is untouched: async quorum hides it already."""
    from torchft_tpu_torch.coordination import ManagerClient

    if getattr(ManagerClient, "_cp_bench_patched", False):
        return
    real = ManagerClient.should_commit

    def slow(self, *args, **kwargs):
        time.sleep(rtt_s)
        return real(self, *args, **kwargs)

    ManagerClient.should_commit = slow
    ManagerClient._cp_bench_patched = True


class _Rollbacks:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.count = 0

    def watch(self, manager) -> None:
        """Count ``manager``'s rollbacks (a vetoed or lost pipelined vote)."""
        rollback = manager._rollback

        def counted(*args, **kwargs):
            with self._lock:
                self.count += 1
            return rollback(*args, **kwargs)

        manager._rollback = counted


def _train_group(replica_id: int, lighthouse_addr: str, pipelined: bool, steps: int,
                 work_ms: float, rollbacks: _Rollbacks) -> float:
    """One replica group (thread); returns steps/s over the timed window."""
    import numpy as np

    from torchft_tpu_torch.collectives import CollectivesTcp
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.store import StoreServer

    store = StoreServer()
    manager = Manager(
        collectives=CollectivesTcp(timeout=timedelta(seconds=20)),
        load_state_dict=lambda s: None,
        state_dict=lambda: {},
        min_replica_size=2,
        replica_id=f"cp_{replica_id}",
        store_addr=store.address(),
        rank=0,
        world_size=1,
        lighthouse_addr=lighthouse_addr,
        use_async_quorum=True,
        commit_pipeline=pipelined,
        timeout=timedelta(seconds=20),
    )
    rollbacks.watch(manager)
    grad = np.ones(1 << 16, dtype=np.float32)
    try:
        def step() -> None:
            manager.start_quorum()
            # the forward pass; pipelined, the previous step's vote RTT
            # hides here
            time.sleep(work_ms / 1e3)
            if pipelined:
                manager.resolve_pending_commit()
            manager.allreduce_many([grad.copy()]).wait()
            if pipelined and manager.speculation_allowed():
                # the trainers' gate: a healing or doomed step votes in sync
                manager.should_commit_async()
            else:
                manager.should_commit()

        for _ in range(3):
            step()  # warm-up: the first quorum forms the group
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        if pipelined:
            # the trailing vote belongs to the timed work: both variants
            # count `steps` full votes
            manager.resolve_pending_commit()
        return steps / (time.perf_counter() - t0)
    finally:
        manager.shutdown(wait=False)
        store.shutdown()


def _one_run(lighthouse_addr: str, pipelined: bool, steps: int, work_ms: float,
             rollbacks: _Rollbacks) -> float:
    with ThreadPoolExecutor(max_workers=2) as ex:
        futs = [ex.submit(_train_group, g, lighthouse_addr, pipelined, steps, work_ms,
                          rollbacks) for g in range(2)]
        rates = [f.result() for f in futs]
    return min(rates)  # the group rate is gated by the slower member


def measure(rtt_ms: float = 10.0, runs: int = 7, steps: int = 25,
            work_ms: float = 30.0) -> Dict[str, Any]:
    from torchft_tpu_torch.coordination import LighthouseServer

    _install_vote_rtt(rtt_ms / 1e3)
    rollbacks = _Rollbacks()
    piped_runs: List[float] = []
    sync_runs: List[float] = []
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=2)
    try:
        for _ in range(runs):  # interleaved: both see the same drift
            piped_runs.append(_one_run(lighthouse.address(), True, steps, work_ms, rollbacks))
            sync_runs.append(_one_run(lighthouse.address(), False, steps, work_ms, rollbacks))
    finally:
        lighthouse.shutdown()
    out = summarize(piped_runs, sync_runs, "pipelined", "sync")
    out["rollbacks"] = rollbacks.count  # no faults injected: any would be a bug
    out["config"] = (f"2 groups, host TCP plane, synthetic +{rtt_ms} ms RTT on the "
                     f"should_commit RPC, {work_ms} ms forward, interleaved median of {runs}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rtt-ms", type=float, default=10.0)
    ap.add_argument("--runs", type=int, default=7)
    # 25 steps a leg: shorter legs let setup jitter dominate the medians
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--work-ms", type=float, default=30.0)
    args = ap.parse_args()
    print(json.dumps(measure(args.rtt_ms, args.runs, args.steps, args.work_ms)), flush=True)


if __name__ == "__main__":
    main()
