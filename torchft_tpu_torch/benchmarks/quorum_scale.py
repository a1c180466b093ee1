"""Quorum fan-out latency against the group count, and the telemetry
piggyback's bytes — the port's copy of
``torchft_tpu/benchmarks/quorum_scale.py``.

N groups against one lighthouse, for N in ``--groups``: every group is a
real in-process ``ManagerServer`` (world size 1, heartbeat loop, the
``lh.quorum`` long-poll) with one thread driving ``mgr.quorum`` through a
``ManagerClient``, ``--rounds`` full quorum rounds. Everything shares this
process, so ``_native.lathist_snapshot`` holds every ``quorum.fanout``
observation: p50/p99 per N, control-plane cost alone (no training, no
data plane).

Each N then runs two telemetry legs: the same synthetic per-round report
shipped as the full-JSON payload and as the delta encoding
(``telemetry/fleetdelta.py``), with the wire bytes per step per replica of
both (the delta leg's first, full, round apart from its steady rounds),
and ``/fleet.json`` scrape p50/p99 beside the ``/cluster.json`` sweep it
replaces.

All N servers share the host's cores, so a large N measures scheduling
pressure as well as protocol cost: the shape over N is the signal.

Run: ``python -m torchft_tpu_torch.benchmarks.quorum_scale [--groups
8,32,64]``; prints one JSON line, ``{"quorum_scale": {...}}``.
"""

import argparse
import json
import threading
import time
import urllib.request
from datetime import timedelta
from typing import Dict, List, Optional


def _quorum_round(
    client,
    rank: int,
    step: int,
    timeout_s: float,
    telemetry_payload: Optional[Dict] = None,
):
    return client._quorum(
        rank=rank,
        step=step,
        checkpoint_metadata="",
        shrink_only=False,
        timeout=timedelta(seconds=timeout_s),
        telemetry_payload=telemetry_payload,
    )


def _synthetic_report(i: int, step: int) -> Dict:
    """Per-group report with realistic churn: the health scalars move
    every step, ONE histogram bucket increments, the counters digest
    bumps a couple of counters. Deterministic (no RNG) so full-JSON and
    delta legs encode byte-identical logical content."""
    bucket = 10 + (i % 5)
    return {
        "step": step,
        "epoch": 1,
        "stuck": False,
        "slo_breach": False,
        "local_step_p50_s": 0.1 + (i % 17) * 1e-3,
        "last_heal_ts": 0.0,
        "summary": {
            "quorums": step,
            "commits": step,
            "heals_recv": 0,
            "participants": 1,
        },
        "anatomy": {
            "steps": step,
            "wall_p50_s": 0.2,
            "wall_p99_s": 0.3,
            "local_p50_s": 0.1,
            "phases": {
                "compute": {"p50_s": 0.08, "p99_s": 0.1, "total_s": 0.1 * step},
                "quorum_wait": {
                    "p50_s": 0.02,
                    "p99_s": 0.05,
                    "total_s": 0.02 * step,
                },
            },
        },
        "hist": {
            "wall": {str(bucket): step, str(bucket + 1): 1},
            "local": {str(bucket - 1): step},
        },
        "series": {"step_wall_s": 0.2, "step_local_s": 0.1},
    }


def _telemetry_legs(
    n: int,
    clients: List,
    base_step: int,
    timeout_s: float,
    lighthouse_addr: str,
) -> Dict:
    """The same synthetic per-round report shipped as the full-JSON
    payload and as the delta encoding, bytes measured with the wire codec
    on both legs, plus /fleet.json scrape percentiles and the full
    /cluster.json sweep they replace."""
    from torchft_tpu_torch.telemetry.fleetdelta import DeltaEncoder
    from torchft_tpu_torch.utils.wire import encode as wire_encode

    out: Dict = {}
    lock = threading.Lock()

    def drive(payload_fn, rounds: int) -> List[int]:
        """Run `rounds` telemetry-carrying quorum rounds; returns
        per-round total wire bytes across all n groups."""
        per_round: List[int] = []
        for rnd in range(rounds):
            step = base_step + rnd
            total = [0]
            threads = []

            def go(i, c, step=step, total=total):
                payload = payload_fn(i, step)
                nbytes = len(wire_encode(payload))
                try:
                    r = _quorum_round(c, 0, step, timeout_s, payload)
                except Exception:  # noqa: BLE001 — counted upstream
                    return
                with lock:
                    total[0] += nbytes
                ack_fn = getattr(payload_fn, "on_ack", None)
                if ack_fn is not None and r.telemetry_ack:
                    ack_fn(i, r.telemetry_ack)

            for i, c in enumerate(clients):
                th = threading.Thread(target=lambda i=i, c=c: go(i, c))
                th.start()
                threads.append(th)
            for th in threads:
                th.join()
            per_round.append(total[0])
        return per_round

    # --- full-JSON leg (TORCHFT_TELEMETRY_DELTA=0 shape): the whole
    # report re-serialized and re-sent every round
    def full_payload(i: int, step: int) -> Dict:
        rep = _synthetic_report(i, step)
        return {
            "summary": json.dumps(rep["summary"], separators=(",", ":")),
            "anatomy": json.dumps(rep["anatomy"], separators=(",", ":")),
            "local_step_p50_s": rep["local_step_p50_s"],
            "slo_breach": rep["slo_breach"],
            "step": rep["step"],
            "epoch": rep["epoch"],
            "stuck": rep["stuck"],
            "last_heal_ts": rep["last_heal_ts"],
            "series": rep["series"],
        }

    full_rounds = drive(full_payload, 2)
    out["full_bytes_per_step_per_replica"] = round(
        sum(full_rounds) / (len(full_rounds) * n), 1
    )

    # --- delta leg: one encoder per group, acks fed back from the
    # quorum reply; round 0 is the FULL bootstrap, later rounds are the
    # steady state, which must stay flat as N grows
    encoders = [DeltaEncoder() for _ in range(n)]

    def delta_payload(i: int, step: int) -> Dict:
        return {"tdelta": encoders[i].encode(_synthetic_report(i, step))}

    delta_payload.on_ack = lambda i, ack: encoders[i].on_ack(ack)
    delta_rounds = drive(delta_payload, 3)
    out["delta_first_full_bytes_per_replica"] = round(delta_rounds[0] / n, 1)
    steady = delta_rounds[1:]
    out["delta_bytes_per_step_per_replica"] = round(
        sum(steady) / (len(steady) * n), 1
    )

    # --- scrape latencies: the O(#hists) rollup vs the O(fleet) sweep
    def scrape(path: str):
        t0 = time.perf_counter()
        with urllib.request.urlopen(
            f"{lighthouse_addr}{path}", timeout=timeout_s
        ) as resp:
            body = resp.read()
        return time.perf_counter() - t0, len(body)

    fleet_lats: List[float] = []
    fleet_bytes = 0
    for _ in range(15):
        dt, fleet_bytes = scrape("/fleet.json")
        fleet_lats.append(dt)
    fleet_lats.sort()
    out["fleet_scrape_p50_s"] = round(
        fleet_lats[len(fleet_lats) // 2], 6
    )
    out["fleet_scrape_p99_s"] = round(fleet_lats[-1], 6)
    out["fleet_json_bytes"] = fleet_bytes
    sweep_s, sweep_bytes = scrape("/cluster.json")
    out["cluster_sweep_s"] = round(sweep_s, 6)
    out["cluster_json_bytes"] = sweep_bytes
    return out


def measure_groups(n: int, rounds: int, timeout_s: float) -> Dict:
    """One lighthouse, ``n`` manager servers + clients, ``rounds`` full
    quorum rounds; returns the ``quorum.fanout`` digest for exactly this
    configuration (the histogram is reset on entry)."""
    from torchft_tpu_torch import _native
    from torchft_tpu_torch.coordination import (
        LighthouseServer,
        ManagerClient,
        ManagerServer,
    )
    from torchft_tpu_torch.telemetry.anatomy import lathist_quantile

    _native.lathist_reset()
    lighthouse = LighthouseServer(
        bind="[::]:0",
        min_replicas=n,
        # long join window: N servers booting on a small box must not
        # split the first quorum round
        join_timeout_ms=60000,
    )
    managers: List[ManagerServer] = []
    clients: List[ManagerClient] = []
    errors: List[str] = []
    t_setup = time.perf_counter()
    try:
        for i in range(n):
            managers.append(
                ManagerServer(
                    replica_id=f"qs_{i}",
                    lighthouse_addr=lighthouse.address(),
                    hostname="localhost",
                    bind="[::]:0",
                    store_addr="unused:0",
                    world_size=1,
                    # modest heartbeat so N groups don't saturate the
                    # box with heartbeat traffic between rounds
                    heartbeat_interval=timedelta(milliseconds=500),
                    connect_timeout=timedelta(seconds=timeout_s),
                )
            )
        clients = [
            ManagerClient(
                m.address(), connect_timeout=timedelta(seconds=timeout_s)
            )
            for m in managers
        ]
        setup_s = time.perf_counter() - t_setup

        t0 = time.perf_counter()
        for rnd in range(rounds):
            threads = []
            for i, c in enumerate(clients):
                th = threading.Thread(
                    target=lambda c=c, i=i: (
                        errors.append(f"g{i}: fail")
                        if _try(_quorum_round, c, 0, rnd, timeout_s)
                        else None
                    ),
                    name=f"qs_client_{i}",
                )
                th.start()
                threads.append(th)
            for th in threads:
                th.join()
        wall_s = time.perf_counter() - t0

        # snapshot BEFORE the telemetry legs so fanout_p50/p99 keep
        # their original meaning (bare-quorum fan-in cost)
        snap = _native.lathist_snapshot().get("quorum.fanout", {})
        count = int(snap.get("count", 0))
        out = {
            "groups": n,
            "rounds": rounds,
            "fanout_count": count,
            "fanout_p50_s": round(lathist_quantile(snap, 0.5), 6)
            if count
            else None,
            "fanout_p99_s": round(lathist_quantile(snap, 0.99), 6)
            if count
            else None,
            "setup_s": round(setup_s, 3),
            "wall_s": round(wall_s, 3),
            "errors": len(errors),
        }
        if count < n * rounds:
            out["note"] = (
                f"only {count}/{n * rounds} fan-outs recorded "
                "(client errors or joins folded into one round)"
            )
        try:
            out["telemetry"] = _telemetry_legs(
                n, clients, rounds, timeout_s, lighthouse.address()
            )
        except Exception as e:  # noqa: BLE001 — fanout row still lands
            out["telemetry"] = {"error": str(e)}
        return out
    finally:
        for c in clients:
            try:
                c.close()
            except Exception:  # noqa: BLE001
                pass
        for m in managers:
            try:
                m.shutdown()
            except Exception:  # noqa: BLE001
                pass
        lighthouse.shutdown()


def _try(fn, *args) -> bool:
    """Returns True on FAILURE (reads nicer at the call site above)."""
    try:
        fn(*args)
        return False
    except Exception:  # noqa: BLE001 — counted, not raised
        return True


def _raise_fd_limit(n: int) -> None:
    """256 manager servers need ~8 fds each (listener + lighthouse
    quorum/digest/heartbeat clients + accepted conns on the lighthouse
    side); the default 1024 soft limit dies around N=128. Raise the soft
    limit toward the hard limit, best-effort."""
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    want = min(hard, max(soft, n))
    if want > soft:
        try:
            resource.setrlimit(resource.RLIMIT_NOFILE, (want, hard))
        except (ValueError, OSError):
            pass


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", default="8,32,64,128,256,512,1024",
                    help="comma-separated group counts")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--timeout", type=float, default=120.0)
    args = ap.parse_args()
    _raise_fd_limit(
        16 * max(
            [int(x) for x in args.groups.split(",") if x] or [1]
        )
    )

    rows: Dict[str, Dict] = {}
    for n in [int(x) for x in args.groups.split(",") if x]:
        try:
            rows[f"groups_{n}"] = measure_groups(
                n, args.rounds, args.timeout
            )
        except Exception as e:  # noqa: BLE001 — partial results still land
            rows[f"groups_{n}"] = {"error": str(e)}
    print(json.dumps({
        "quorum_scale": {
            "_gate_presence": True,
            **rows,
            "note": "quorum.fanout p50/p99 per group count (N in-process "
            "manager servers against one lighthouse, the native lathist); "
            "shape-over-N is the signal, absolutes are box-bound",
        }
    }))


if __name__ == "__main__":
    main()
