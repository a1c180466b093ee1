"""Async-vs-sync quorum where the quorum RPC costs something — the port's
copy of ``torchft_tpu/benchmarks/quorum_overlap.py``.

Two replica groups as threads, each with a real Manager over
``CollectivesTcp`` (``min_replica_size=2``), with a synthetic round trip
(``--rtt-ms``, default 10) injected into the quorum RPC on the Manager's
client (the lighthouse is the component expected off-host). The forward
pass is a ``time.sleep(work_ms)``: the host thread is idle while the
device works, and two groups share the host. Async quorum overlaps the RPC
with the forward; sync pays it every step. A host-only harness: no model,
no device.

Protocol: interleaved pairs (async, sync, async, ...), ``--runs`` of them
(default 7), each variant's median and spread.

Run: ``python -m torchft_tpu_torch.benchmarks.quorum_overlap``; prints one
JSON line.
"""

from __future__ import annotations

import argparse
import json
import time
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta
from typing import Any, Dict, List

__all__ = ["main", "measure", "summarize"]


def _train_group(replica_id: int, lighthouse_addr: str, use_async: bool, rtt_s: float,
                 steps: int, work_ms: float) -> float:
    """One replica group (thread): real Manager and TCP collectives, a
    fixed-duration forward pass and the per-step quorum and commit. Returns
    steps/s over the timed window."""
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
        replica_id=f"qo_{replica_id}",
        store_addr=store.address(),
        rank=0,
        world_size=1,
        lighthouse_addr=lighthouse_addr,
        use_async_quorum=use_async,
        timeout=timedelta(seconds=20),
    )
    # the synthetic RTT on the quorum RPC only, at the client: async and
    # sync take the identical delayed path; the commit vote rides the
    # group's own manager server on localhost
    real_quorum = manager._client._quorum

    def slow_quorum(*args, **kwargs):
        time.sleep(rtt_s)
        return real_quorum(*args, **kwargs)

    manager._client._quorum = slow_quorum
    grad = np.ones(1 << 16, dtype=np.float32)
    try:
        def step() -> None:
            manager.start_quorum()
            time.sleep(work_ms / 1e3)  # the forward pass (see the module doc)
            manager.allreduce_many([grad.copy()]).wait()
            manager.should_commit()

        for _ in range(3):
            step()  # warm-up: the first quorum forms the group
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        return steps / (time.perf_counter() - t0)
    finally:
        manager.shutdown(wait=False)
        store.shutdown()


def _one_run(lighthouse_addr: str, use_async: bool, rtt_s: float, steps: int,
             work_ms: float) -> float:
    with ThreadPoolExecutor(max_workers=2) as ex:
        futs = [ex.submit(_train_group, g, lighthouse_addr, use_async, rtt_s, steps, work_ms)
                for g in range(2)]
        rates = [f.result() for f in futs]
    return min(rates)  # the group rate is gated by the slower member


def summarize(a_runs: List[float], b_runs: List[float], a: str, b: str) -> Dict[str, Any]:
    """Each variant's median, the first's gain over the second, the sorted
    runs and each variant's spread (max - min over its median)."""
    a_runs, b_runs = sorted(a_runs), sorted(b_runs)
    a_med, b_med = a_runs[len(a_runs) // 2], b_runs[len(b_runs) // 2]
    return {
        f"{a}_steps_per_sec": round(a_med, 3),
        f"{b}_steps_per_sec": round(b_med, 3),
        f"{a}_gain_pct": round((a_med / b_med - 1) * 100.0, 2),
        f"{a}_runs": [round(r, 3) for r in a_runs],
        f"{b}_runs": [round(r, 3) for r in b_runs],
        f"{a}_spread_pct": round((a_runs[-1] - a_runs[0]) / a_med * 100.0, 1),
        f"{b}_spread_pct": round((b_runs[-1] - b_runs[0]) / b_med * 100.0, 1),
    }


def measure(rtt_ms: float = 10.0, runs: int = 7, steps: int = 15,
            work_ms: float = 30.0) -> Dict[str, Any]:
    from torchft_tpu_torch.coordination import LighthouseServer

    async_runs: List[float] = []
    sync_runs: List[float] = []
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=2)
    try:
        for _ in range(runs):  # interleaved: both see the same drift
            async_runs.append(_one_run(lighthouse.address(), True, rtt_ms / 1e3, steps,
                                       work_ms))
            sync_runs.append(_one_run(lighthouse.address(), False, rtt_ms / 1e3, steps,
                                      work_ms))
    finally:
        lighthouse.shutdown()
    out = summarize(async_runs, sync_runs, "async", "sync")
    out["config"] = (f"2 groups, host TCP plane, synthetic +{rtt_ms} ms RTT on the quorum "
                     f"RPC, {work_ms} ms forward, interleaved median of {runs}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rtt-ms", type=float, default=10.0)
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--steps", type=int, default=15)
    ap.add_argument("--work-ms", type=float, default=30.0)
    args = ap.parse_args()
    print(json.dumps(measure(args.rtt_ms, args.runs, args.steps, args.work_ms)), flush=True)


if __name__ == "__main__":
    main()
