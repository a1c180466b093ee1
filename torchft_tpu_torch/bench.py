"""Headline benchmark of the port — the counterpart of the root ``bench.py``.

Runs the full fault-tolerant loop (an in-process C++ lighthouse, a store
and a Manager over ``CollectivesDevice``; a quorum and a commit vote every
step) around the port's ``TrainStep``, replayed from CUDA graphs on the
card. The headline is a single replica group on one card, the median of
three interleaved pairs of runs with and without the cross-group average
(the average is the identity at world 1, so their difference is the FT
control path's cost), with the spread beside it and MFU against the card's
dense bf16 peak. Then the measurement rows of ``torchft_tpu_torch/benchmarks/``
that one card holds, each in a process of its own as ``bench.py`` runs
them, and the recovery rows in this process.

The headline runs through the instrumented Manager in this process, so the
step-anatomy ledger holds a phase decomposition of exactly those steps:
the ``step_anatomy`` row (per-phase p50/p99, the p50 composition against
the wall p50, ``ft_control_overhead_pct`` from the ledger and the native
planes' latency quantiles, as ``bench.py:429-490`` computes it) and the
``telemetry`` row (``telemetry.summary()``, ``bench.py:690-701``).

Run::

    python -m torchft_tpu_torch.bench             # on the card
    DEVICE=cpu python -m torchft_tpu_torch.bench  # on the CPU (headline at b4 s128)

The last two lines of standard output are ``{"extra": {...}}`` (every row)
and ``{"metric": "ft_transformer_train_steps_per_sec_per_chip", ...}``. A
row that raises is recorded as ``{"error": ...}`` and the run then exits 1
after printing.
"""

from __future__ import annotations

import gc
import json
import logging
import os
import signal
import subprocess
import sys
import time
import traceback
from contextlib import contextmanager
from datetime import timedelta
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

__all__ = ["train_bench", "main", "mfu_pct", "has_error", "step_anatomy_row"]

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# dense bf16 peak FLOP/s per card, by words that must all appear in
# torch.cuda.get_device_name() (NVIDIA's data sheet: the SXM part, whose
# memory is HBM3, at its 700 W limit)
_PEAK_BF16 = {("H100", "HBM3"): 989e12}


def _peak_flops(device_name: str) -> float:
    for words, val in _PEAK_BF16.items():
        if all(w in device_name for w in words):
            return val
    return 0.0  # unknown card: MFU omitted


def _model_flops_per_step(cfg, n_params: int, batch: int, seq: int) -> float:
    # fwd+bwd matmul FLOPs: 6*N per token, + attention 12*L*S*d per token
    # (QK^T and AV each 2*S*d MACs per token per layer, x3 for fwd+bwd)
    per_token = 6.0 * n_params + 12.0 * cfg.n_layers * seq * cfg.d_model
    return per_token * batch * seq


def mfu_pct(steps_per_sec: float, flops_per_step: float, peak: float) -> Optional[float]:
    """Model FLOP utilization in percent, or None on a card without a peak."""
    return round(steps_per_sec * flops_per_step / peak * 100.0, 2) if peak else None


def _device():
    from torchft_tpu_torch.utils.platform import resolve_device

    return resolve_device(os.environ.get("DEVICE", "cuda"))


def _device_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def card_info() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


@contextmanager
def _single_group_ft_runtime(replica_id: str, device) -> Iterator[Any]:
    """Full FT control plane for a one-group bench: C++ lighthouse, store
    and Manager (async quorum) over the device data plane. Frees what the previous row
    left first (its CUDA graphs' pools among it): rows do not share shapes."""
    import torch

    from torchft_tpu_torch.collectives_device import CollectivesDevice
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.store import StoreServer

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=1)
    store = StoreServer()
    manager = Manager(
        collectives=CollectivesDevice(timeout=timedelta(seconds=30), device=device),
        load_state_dict=lambda s: None,
        state_dict=lambda: {},
        min_replica_size=1,
        replica_id=replica_id,
        store_addr=store.address(),
        rank=0,
        world_size=1,
        lighthouse_addr=lighthouse.address(),
        use_async_quorum=True,
    )
    try:
        yield manager
    finally:
        manager.shutdown(wait=False)
        store.shutdown()
        lighthouse.shutdown()


def train_bench(cfg, batch: int, seq: int, steps: int, warmup: int, averaging: bool,
                record: Optional[Dict[str, Any]] = None):
    """Measured FT train loop; returns (steps/s, n_params).

    ``record``, when given, receives what the run saw: the Manager's
    committed steps against the steps taken, the flash launches (in all,
    and each step's, distinct), the graphs captured, the last loss and the
    peak device memory."""
    import torch

    from torchft_tpu_torch.ddp import allreduce_gradients
    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.parallel.train_step import TrainStep, synchronize
    from torchft_tpu_torch.utils.tree import tree_leaves

    device = _device()
    with _single_group_ft_runtime("bench", device) as manager:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        ts = TrainStep(cfg, device=device)  # graphed on the card
        params = ts.init_params(seed=0)
        opt = ts.init_opt(params)
        rng = np.random.default_rng(0)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq))).to(device)
        launches: List[Dict[str, int]] = []

        def ft_step():
            # reference-faithful ordering (bench.py:128-140): quorum, grads,
            # cross-group average, then the commit vote gates the update
            before = dict(fa.LAUNCHES)
            manager.start_quorum()
            loss, grads = ts.grads(params, tokens)
            if averaging:
                grads = allreduce_gradients(manager, grads)
            if manager.should_commit():
                ts.apply(params, opt, grads)
            launches.append({k: fa.LAUNCHES[k] - before[k] for k in before})
            return loss

        for _ in range(warmup):  # the graphs are captured here
            loss = ft_step()
        synchronize(device)  # fence the warm-up out of the timed window
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = ft_step()
        # one fence at the end: the last step depends on the whole chain
        synchronize(device)
        elapsed = time.perf_counter() - t0
        n_params = sum(p.numel() for p in tree_leaves(params))
        if record is not None:
            record.update(
                steps=warmup + steps, committed=manager.current_step(),
                launches={k: sum(x[k] for x in launches) for k in fa.LAUNCHES},
                # the distinct per-step counts: one entry when every step
                # ran the same kernels
                launches_per_step=[x for i, x in enumerate(launches) if x not in launches[:i]],
                captures=dict(ts.graphs.captures) if ts.graphs is not None else None,
                loss=float(loss),
                peak_memory_gb=(torch.cuda.max_memory_allocated(device) / 1e9
                                if device.type == "cuda" else None),
            )
    return steps / elapsed, n_params


def step_anatomy_row() -> Dict[str, Any]:
    """The ``step_anatomy`` row from this process's ledger, as
    ``bench.py:429-490`` computes it: per-phase p50/p99 over the retained
    step rows, their p50 sum against the wall p50 (``idle`` is each row's
    residual, so a row sums to its wall exactly and the p50 composition
    lands within a few percent), ``ft_control_overhead_pct`` (the
    quorum_wait and commit_barrier p50s' share of the wall p50) and the
    native planes' latency quantiles."""
    from torchft_tpu_torch import telemetry
    from torchft_tpu_torch.telemetry.anatomy import lathist_quantile
    from torchft_tpu_torch.telemetry.native import native_latency_snapshot

    anatomy = telemetry.LEDGER.summary()
    wall_p50 = float(anatomy.get("wall_p50_s") or 0.0)
    phases = anatomy.get("phases", {})
    phase_sum_p50 = sum(p["p50_s"] for p in phases.values())
    ctl_p50 = sum(phases.get(p, {}).get("p50_s", 0.0) for p in ("quorum_wait", "commit_barrier"))
    row: Dict[str, Any] = {
        "_gate_presence": True,
        "steps": anatomy.get("steps"),
        "phases": {k: {"p50_s": v["p50_s"], "p99_s": v["p99_s"]} for k, v in phases.items()},
        "wall_p50_s": round(wall_p50, 6),
        "wall_p99_s": anatomy.get("wall_p99_s"),
        "local_p50_s": anatomy.get("local_p50_s"),
        "phase_sum_p50_s": round(phase_sum_p50, 6),
        "reconciliation_pct": (round((phase_sum_p50 / wall_p50 - 1.0) * 100.0, 2)
                               if wall_p50 else None),
        "ft_control_overhead_pct": round(ctl_p50 / wall_p50 * 100.0, 2) if wall_p50 else None,
        "note": "per-phase p50/p99 over the in-process headline steps (both variants); idle "
        "is the residual so per-step phase sums equal wall exactly; reconciliation_pct is "
        "the p50-composition error; ft_control_overhead_pct = (quorum_wait+commit_barrier) "
        "p50 share of wall p50",
    }
    native = native_latency_snapshot()
    if native:
        row["native_latency"] = {
            op: {"count": int(h["count"]), "p50_s": round(lathist_quantile(h, 0.5), 6),
                 "p99_s": round(lathist_quantile(h, 0.99), 6)}
            for op, h in sorted(native.items()) if int(h["count"])
        }
    return row


def _run_json_subprocess(cmd: List[str], timeout_s: float,
                         env_extra: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """Run a bench worker; parse the last stdout line as JSON.

    The worker runs in its own session and a timeout kills the whole
    process group: a wedged grandchild holding the inherited stdout pipe
    must fail the row, not hang the bench in communicate()."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_REPO, env.get("PYTHONPATH")) if p)
    if env_extra:
        env.update(env_extra)
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        start_new_session=True,
        # `python -m torchft_tpu_torch...` resolves the package from here
        cwd=_REPO,
    )
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except OSError:
            pass
        proc.wait()
        raise
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd[2:])} failed rc={proc.returncode}: "
                           f"{err.decode(errors='replace')[-1500:]}")
    return json.loads(out.decode().strip().splitlines()[-1])


def has_error(row: Any) -> bool:
    """Whether a row, or a row inside it, holds ``error``."""
    if isinstance(row, dict):
        return "error" in row or any(has_error(v) for v in row.values())
    return False


def _module(name: str, *args: str) -> List[str]:
    return [sys.executable, "-m", f"torchft_tpu_torch.benchmarks.{name}", *args]


def recovery_row(num_groups: int) -> Dict[str, Any]:
    """``measure_recovery`` of ``num_groups`` worker processes (the last
    one SIGKILLed and respawned; the lighthouse's join timeout is the
    harness's, 1 s with three groups or more) as a bench row, with whether
    the groups ended with one state and whether a survivor's eviction
    report held."""
    from torchft_tpu_torch.benchmarks.recovery import measure_recovery

    r = measure_recovery(num_groups=num_groups)
    row = r.as_dict()
    row.update(num_groups=num_groups, join_timeout_ms=r.join_timeout_ms,
               one_digest=len({f["digest"] for f in r.finals.values()}) == 1,
               eviction_accepted=any(ok for _, _, ok in r.evictions))
    return row


def main() -> None:
    import torch

    from torchft_tpu_torch.benchmarks.long_context import ROW_KEYS
    from torchft_tpu_torch.models.transformer import headline_config

    logging.basicConfig(level=logging.WARNING)
    started = time.perf_counter()
    device = _device()
    on_card = device.type == "cuda"
    if on_card:
        from torchft_tpu_torch.ops import flash_attention as fa

        fa.build()  # once, before any timed window or worker
    cfg = headline_config()
    batch, seq = (8, 1024) if on_card else (4, 128)
    steps, warmup = (20, 3) if on_card else (5, 1)
    n_runs = 3 if on_card else 1

    from torchft_tpu_torch import telemetry

    # the ledger and the counters then hold the headline's steps alone
    telemetry.reset()
    runs: List[float] = []
    noavg_runs: List[float] = []
    n_params = 0
    records: List[Dict[str, Any]] = []
    for _ in range(n_runs):  # interleaved: both variants see the same drift
        rec: Dict[str, Any] = {}
        r, n_params = train_bench(cfg, batch, seq, steps, warmup, averaging=True, record=rec)
        runs.append(r)
        records.append(rec)
        rec = {}
        noavg_runs.append(
            train_bench(cfg, batch, seq, steps, warmup, averaging=False, record=rec)[0])
        records.append(rec)
    runs.sort()
    noavg_runs.sort()
    sps = runs[len(runs) // 2]
    sps_noavg = noavg_runs[len(noavg_runs) // 2]
    tokens_per_sec = sps * batch * seq
    overhead_pct = (sps_noavg - sps) / sps_noavg * 100.0 if sps_noavg else 0.0
    name = _device_name(device)
    flops = _model_flops_per_step(cfg, n_params, batch, seq)
    mfu = mfu_pct(sps, flops, _peak_flops(name))

    extra: Dict[str, Any] = {
        "data_plane": "device plane (CollectivesDevice); a single replica group on one "
        "card, so the cross-group average is the identity at world 1. Measured per "
        "step: the real quorum RPC, the commit vote and the managed-op machinery",
        "headline_runs_steps_per_sec": [round(r, 4) for r in runs],
        "headline_spread_pct": round((max(runs) - min(runs)) / sps * 100.0, 2),
        "steps_per_sec_no_ft_control": round(sps_noavg, 4),
        "noavg_runs_steps_per_sec": [round(r, 4) for r in noavg_runs],
        "ft_control_overhead_pct": round(overhead_pct, 2),
        "n_params": n_params,
        "mfu_pct": mfu,
        "headline_steps": [{k: rec[k] for k in ("steps", "committed", "launches_per_step",
                                                  "captures")} for rec in records],
        "config": {
            "model": "d512 L8 h8 ff1408 vocab32k bf16, attention_impl flash",
            "remat": cfg.remat,
            "batch": batch,
            "seq": seq,
            "steps": steps,
            "warmup": warmup,
            "optimizer": "AdamW(3e-4), capturable; both halves of the step replayed "
            "from CUDA graphs on the card",
            "torch": torch.__version__,
            "device": name,
            "card": card_info() if on_card else None,
        },
    }

    try:
        extra["step_anatomy"] = step_anatomy_row()
    except Exception as e:  # noqa: BLE001 — recorded; the run exits 1 below
        extra["step_anatomy"] = {"error": str(e)}

    # the measurement rows, each in a process of its own (bench.py:497-688);
    # the card-only rows as bench.py runs its TPU-only rows
    # (key, command, timeout, the rows a worker that prints several owes)
    rows = []
    if on_card:
        rows.append(("resnet18_cifar", _module("resnet_ft"), 900, None))
        # one row per length, and scale_647M
        rows.append(("long_context", _module("long_context"), 1500, ROW_KEYS))
    rows += [
        ("quorum_overlap", _module("quorum_overlap"), 900, None),
        # quorum fan-out and the telemetry legs against the group count, N
        # in-process manager servers (bench.py:547-563); its own process,
        # so its N-group latency histograms stay out of the anatomy row
        ("quorum_scale", _module("quorum_scale"), 1200, ("quorum_scale",)),
        ("commit_pipeline", _module("commit_pipeline"), 900, None),
        ("diloco_4group", _module("diloco"), 600, None),
        ("crossgroup_host_plane", _module("crossgroup", "--total-mb", "128", "--rounds", "2",
                                          "--device", device.type), 900, None),
        ("crossgroup_compressed", _module("crossgroup", "--compressed", "--total-mb", "128",
                                          "--rounds", "2", "--device", device.type), 900, None),
    ]
    for key, cmd, timeout_s, owed in rows:
        try:
            out = _run_json_subprocess(cmd, timeout_s)
        except Exception as e:  # noqa: BLE001 — recorded; the run exits 1 below
            out = {"error": str(e)}
            if owed:  # mark every row the worker owes
                out = {k: out for k in owed}
        if owed:
            extra.update(out)
        else:
            extra[key] = out

    # the recovery envelope (SIGKILL 1 of N groups, respawn), in this
    # process as bench.py:682-688 runs it; its workers train on DEVICE
    for key, num_groups in (("recovery", 2), ("recovery_1of4", 4)):
        try:
            extra[key] = recovery_row(num_groups)
        except Exception:  # noqa: BLE001 — recorded; the run exits 1 below
            extra[key] = {"error": traceback.format_exc()[-1500:]}
    # what FT control traffic and step-time distribution produced these
    # numbers: the counters of this process, the headline's Managers'
    try:
        extra["telemetry"] = telemetry.summary()
    except Exception as e:  # noqa: BLE001 — recorded; the run exits 1 below
        extra["telemetry"] = {"error": str(e)}
    extra["bench_wall_s"] = round(time.perf_counter() - started, 1)

    print(json.dumps({"extra": extra}))
    print(json.dumps({
        "metric": "ft_transformer_train_steps_per_sec_per_chip",
        "value": round(sps, 4),
        "unit": f"steps/s (bf16 d512 L8 b{batch} s{seq}; {tokens_per_sec:.0f} tok/s; single "
        f"replica group, full quorum+commit FT control per step; median of {len(runs)} "
        f"runs; {name}; extras on the previous line)",
        "vs_baseline": 1.0,
        "extra_keys": sorted(extra),
    }), flush=True)
    failed = sorted(k for k, v in extra.items() if has_error(v))
    if failed:
        print(f"rows that raised: {failed}", file=sys.stderr, flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
