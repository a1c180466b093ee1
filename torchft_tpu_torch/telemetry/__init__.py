"""Telemetry of the port's fault-tolerance runtime — the port's copy of
``torchft_tpu/telemetry/__init__.py``, its per-process plane: metrics,
the FT event trail, spans, the step-anatomy ledger, the collective
flight recorder with its step watchdog, and the forensics: the
crash-durable black box they mirror into (:mod:`.blackbox`), the stack
samplers (:mod:`.profiler`), the latch-triggered diagnosis bundles
(:mod:`.diagnosis`) and the postmortem (:mod:`.postmortem`).

One process-wide :class:`~torchft_tpu_torch.telemetry.registry.MetricsRegistry`
(``REGISTRY``) and one process-wide FT event trail (``EVENTS``), fed by the
Manager, the coordination client, the collectives (host and device
planes), the checkpoint transports and the futures' deadlines. Every
catalog family is registered at import under the JAX catalog's names, help
texts and label sets, so the two packages' ``/metrics`` pages list the same
families; closed label sets (role, outcome, kind, result) are pre-seeded so
those series exist zero-valued from process start, open-ended ones (plane,
transport, event) appear on first observation. Read three ways:

* ``GET /metrics`` on every checkpoint HTTP server
  (:class:`~torchft_tpu_torch.checkpointing.http_transport.HTTPTransport`),
  Prometheus text format;
* the native lighthouse's own ``/metrics`` (its C++ counters;
  :mod:`torchft_tpu_torch.telemetry.native` polls them);
* :func:`dump` / :func:`summary` snapshots for benches and tests.

The fleet plane writes its families from its own modules: the delta
piggyback (:mod:`.fleetdelta`, ``tft_telemetry_bytes_total``), the time
series (:mod:`.timeseries`), the SLO and straggler detectors (:mod:`.slo`,
``tft_slo_breach_total``, ``tft_straggler_detected_total``,
``tft_stragglers``), the regression sentinel (:mod:`.regression`,
``tft_perf_regression_total``) and the critical path
(:mod:`.critical_path`, ``tft_critical_path_*``); the forensics theirs
(``tft_prof_samples_total`` from the samplers, ``tft_diagnosis_bundles_total``
from the diagnosis engine) and the fault plane
(``torchft_tpu_torch.faultinject``) ``tft_faults_injected_total``; the
Manager's divergence sentinel ``tft_divergence_total`` (once a process, on
the vote reply that first carries the lighthouse's latch).

Stdlib-only, like the JAX package's, and exception-free on the hot path:
observability must never fail a step. No call here reads a tensor's value.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from torchft_tpu_torch.telemetry.anatomy import (
    LEDGER,
    LOG2_BUCKETS,
    PHASES,
    StepLedger,
    merge_lathist,
)
from torchft_tpu_torch.telemetry.blackbox import (
    BLACKBOX,
    BlackBox,
    read_blackbox,
    read_native_blackbox,
)
from torchft_tpu_torch.telemetry.events import (
    CANONICAL_EVENTS,
    ENV_TRAIL_PATH,
    EventTrail,
    read_trail,
)
from torchft_tpu_torch.telemetry.flight import (
    FLIGHT,
    FlightRecorder,
    StepWatchdog,
    install_sigusr2,
)
from torchft_tpu_torch.telemetry.registry import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from torchft_tpu_torch.telemetry.tracing import TRACER, Span, Tracer, chrome_trace

__all__ = [
    "REGISTRY",
    "EVENTS",
    "TRACER",
    "FLIGHT",
    "BLACKBOX",
    "BlackBox",
    "read_blackbox",
    "read_native_blackbox",
    "LEDGER",
    "LOG2_BUCKETS",
    "PHASES",
    "StepLedger",
    "merge_lathist",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "EventTrail",
    "read_trail",
    "CANONICAL_EVENTS",
    "ENV_TRAIL_PATH",
    "Span",
    "Tracer",
    "chrome_trace",
    "FlightRecorder",
    "StepWatchdog",
    "install_sigusr2",
    "counter",
    "gauge",
    "histogram",
    "emit",
    "record_collective",
    "record_checkpoint",
    "render_prometheus",
    "dump",
    "summary",
    "reset",
]

REGISTRY = MetricsRegistry()
EVENTS = EventTrail()

# Byte-count buckets (allreduce payloads span 4-byte scalars to GB-scale
# checkpoint buffers).
BYTE_BUCKETS = tuple(float(1 << s) for s in range(10, 34, 2))  # 1KiB..8GiB

# ---------------------------------------------------------------------------
# Metric catalog — pre-registered so /metrics always exposes the full
# schema (zero-valued series beat absent ones: dashboards and the
# acceptance scrape can rely on the names before the first observation).
# ---------------------------------------------------------------------------

# quorum / membership
QUORUM_LATENCY = REGISTRY.histogram(
    "tft_quorum_latency_seconds",
    "Latency of the mgr.quorum RPC (start_quorum to quorum delivery)",
)
QUORUMS_TOTAL = REGISTRY.counter(
    "tft_quorums_total", "Completed quorum RPCs"
)
QUORUM_RECONFIGURES = REGISTRY.counter(
    "tft_quorum_reconfigures_total",
    "Quorum-id changes (data-plane re-rendezvous events)",
)
MEMBERSHIP_CHANGES = REGISTRY.counter(
    "tft_membership_changes_total",
    "Quorums whose participant set differed from the previous one",
)
PARTICIPANTS = REGISTRY.gauge(
    "tft_participants", "Replica groups participating in the current step"
)

# step / commit
STEP_DURATION = REGISTRY.histogram(
    "tft_step_duration_seconds",
    "Committed-step wall-clock by kind (steady, quorum-reconfigure, heal)",
    labelnames=("kind",),
)
COMMITS_TOTAL = REGISTRY.counter(
    "tft_commits_total",
    "should_commit outcomes by result",
    labelnames=("outcome",),
)
COMMIT_BARRIER = REGISTRY.histogram(
    "tft_commit_barrier_seconds",
    "should_commit wall-clock (pending-work drain + vote RPC)",
)
CURRENT_STEP = REGISTRY.gauge(
    "tft_current_step", "Committed step counter of this replica group"
)
COMMIT_PIPELINE_ROLLBACKS = REGISTRY.counter(
    "tft_commit_pipeline_rollbacks_total",
    "Speculative optimizer updates rolled back because a pipelined "
    "commit vote resolved to veto (commit_pipeline mode only)",
)

# heal / recovery
HEALS_TOTAL = REGISTRY.counter(
    "tft_heals_total",
    "Live checkpoint recoveries by role (recv = this group healed, "
    "send = this group served a healing peer)",
    labelnames=("role",),
)
HEAL_DURATION = REGISTRY.histogram(
    "tft_heal_duration_seconds",
    "Wall-clock of a full heal (metadata fetch + checkpoint transfer + "
    "staging) on the healing side",
)
HEAL_STAGE_SECONDS = REGISTRY.counter(
    "tft_heal_stage_seconds_total",
    "Cumulative wall-clock inside the heal data path, by sub-stage "
    "(meta / recv / decode / device_put — docs/heal_plane.md)",
    labelnames=("stage",),
)
PEER_DEATHS = REGISTRY.counter(
    "tft_peer_deaths_total",
    "Dead-peer detections: death-watch socket EOF or a failed op naming "
    "the peer (deduplicated per victim per epoch)",
)
EVICTIONS_REPORTED = REGISTRY.counter(
    "tft_evictions_reported_total",
    "Eviction reports filed with the lighthouse, by result",
    labelnames=("result",),
)

# collectives / data plane
ALLREDUCE_BYTES = REGISTRY.counter(
    "tft_allreduce_bytes_total",
    "Payload bytes entering cross-group allreduce, by data plane",
    labelnames=("plane",),
)
ALLREDUCE_LATENCY = REGISTRY.histogram(
    "tft_allreduce_latency_seconds",
    "Cross-group allreduce op latency, by data plane",
    labelnames=("plane",),
)
COLLECTIVE_OPS = REGISTRY.counter(
    "tft_collective_ops_total",
    "Cross-group collective ops issued, by op and data plane",
    labelnames=("op", "plane"),
)
WIRE_STAGE_SECONDS = REGISTRY.counter(
    "tft_wire_stage_seconds_total",
    "Cumulative wall-clock inside the cross-group wire plane, by stage "
    "(host_copy / quantize / wire / dequant_reduce — docs/wire_plane.md)",
    labelnames=("stage",),
)

# checkpoint transfers
CHECKPOINT_BYTES = REGISTRY.counter(
    "tft_checkpoint_bytes_total",
    "Checkpoint payload bytes moved, by direction and transport",
    labelnames=("direction", "transport"),
)
CHECKPOINT_SECONDS = REGISTRY.histogram(
    "tft_checkpoint_transfer_seconds",
    "Checkpoint stage/transfer wall-clock, by phase and transport",
    labelnames=("phase", "transport"),
)

# futures / deadlines
FUTURE_TIMEOUTS = REGISTRY.counter(
    "tft_future_timeouts_total",
    "Futures failed by the deadline manager",
)
FUTURE_CANCELS = REGISTRY.counter(
    "tft_future_cancels_total",
    "Collective ops cancelled by reconfigure before running",
)

# event trail mirror
FT_EVENTS_TOTAL = REGISTRY.counter(
    "tft_ft_events_total",
    "FT event-trail records emitted, by event kind",
    labelnames=("event",),
)

# tracing / flight recorder / watchdog
TRACE_SPANS = REGISTRY.counter(
    "tft_trace_spans_total",
    "Distributed trace spans recorded, by span name",
    labelnames=("span",),
)
WATCHDOG_STALLS = REGISTRY.counter(
    "tft_watchdog_stalls_total",
    "Step-watchdog firings (a step exceeded the p99-derived threshold)",
)
FLIGHT_DUMPS = REGISTRY.counter(
    "tft_flight_dumps_total",
    "Collective flight-recorder dumps written, by trigger reason",
    labelnames=("reason",),
)

# fault-injection plane (torchft_tpu/faultinject/): every fired scheduled
# injection is counted here AND emitted as a fault_injected trail event,
# so a chaos run's evidence is collected without extra wiring
FAULTS_INJECTED = REGISTRY.counter(
    "tft_faults_injected_total",
    "Scheduled fault injections fired, by site and action",
    labelnames=("site", "action"),
)

# step-anatomy ledger (telemetry/anatomy.py): per-step wall clock
# decomposed into named phases on the fixed log2 bucket grid shared with
# the native plane's latency histograms (native/lathist.h), so cross-
# plane/process merges are exact
STEP_PHASE_SECONDS = REGISTRY.histogram(
    "tft_step_phase_seconds",
    "Per-step seconds spent in each anatomy phase (compute / host_copy / "
    "quantize / wire / dequant_reduce / quorum_wait / commit_barrier / "
    "heal / telemetry / idle — docs/observability.md 'Step anatomy')",
    labelnames=("phase",),
    buckets=LOG2_BUCKETS,
)
STEP_WALL_SECONDS = REGISTRY.histogram(
    "tft_step_wall_seconds",
    "Per-step wall clock as the anatomy ledger measures it (tick to tick)",
    buckets=LOG2_BUCKETS,
)
STEP_LOCAL_SECONDS = REGISTRY.histogram(
    "tft_step_local_seconds",
    "Per-step LOCAL time: wall minus the peer-wait phases (wire, "
    "quorum_wait, commit_barrier, heal) — the straggler-discriminating "
    "signal piggybacked to the lighthouse",
    buckets=LOG2_BUCKETS,
)

# self-metering: bytes the telemetry plane itself moves, per
# channel. `piggyback` = delta/JSON blobs attached to quorum RPCs,
# `spans` = chrome-trace fragments riding the same RPC; the lighthouse
# meters its own `scrape` channel (HTTP bodies served) as the native
# torchft_telemetry_bytes_total counterpart. The budget gate
# (benchmarks/telemetry_overhead.py) keys off the step-rate delta, but
# this counter is what tells you WHERE an overhead regression lives.
TELEMETRY_BYTES = REGISTRY.counter(
    "tft_telemetry_bytes_total",
    "Bytes moved by the telemetry plane itself, by channel "
    "(piggyback / spans)",
    labelnames=("channel",),
)

# divergence sentinel: cross-group post-reduce digest
# mismatches latched by the lighthouse's (epoch, step) cohort compare,
# observed replica-side on the should_commit reply — the corrupt-commit
# failure mode surfaced at the commit boundary instead of at the nan
DIVERGENCE_TOTAL = REGISTRY.counter(
    "tft_divergence_total",
    "Commit-time state-digest divergence latches observed by this "
    "replica (the lighthouse's cohort compare disagreed — see "
    "docs/observability.md 'Divergence sentinel')",
)

# fleet time machine: per-commit critical-path attribution
# (telemetry/critical_path.py) and the perf-regression sentinel
# (telemetry/regression.py) over the retained time series
CRITICAL_PATH_SECONDS = REGISTRY.counter(
    "tft_critical_path_seconds_total",
    "Blamed seconds per (replica, phase): for each committed step, the "
    "excess local time of the step's gating replica over the fleet "
    "median, split across its non-barrier anatomy phases — see "
    "docs/observability.md 'Critical path'",
    labelnames=("replica", "phase"),
)
CRITICAL_PATH_WHATIF = REGISTRY.gauge(
    "tft_critical_path_whatif_steps_per_sec",
    "What-if fleet throughput: steps/s if every step's gating replica "
    "had run at the fleet median local time (Coz-style causal estimate)",
)
PERF_REGRESSION_TOTAL = REGISTRY.counter(
    "tft_perf_regression_total",
    "Page-Hinkley level-shift latches over the retained time series, by "
    "(replica, series) — the threshold-free whole-fleet-drift detector "
    "(docs/observability.md 'Perf regression')",
    labelnames=("replica", "series"),
)

# diagnosis plane: always-on profiler samples (both planes)
# and latch-triggered deep-capture bundles (telemetry/diagnosis.py)
PROF_SAMPLES = REGISTRY.counter(
    "tft_prof_samples_total",
    "Always-on profiler samples aggregated, by plane (py = the "
    "sys._current_frames thread sampler, native = the SIGPROF sampler "
    "over the GIL-free planes; native counts fold in on poll — see "
    "docs/observability.md 'Profiling & diagnosis bundles')",
    labelnames=("plane",),
)
DIAGNOSIS_BUNDLES = REGISTRY.counter(
    "tft_diagnosis_bundles_total",
    "Latch-triggered diagnosis bundles written to TORCHFT_DIAG_DIR, by "
    "trigger event",
    labelnames=("trigger",),
)

# SLO / straggler plane (telemetry/slo.py)
SLO_BREACH_TOTAL = REGISTRY.counter(
    "tft_slo_breach_total",
    "Burn-rate SLO breaches latched, by SLO (step_time / rejoin_commit)",
    labelnames=("slo",),
)
STRAGGLER_DETECTED = REGISTRY.counter(
    "tft_straggler_detected_total",
    "Straggler latches by the fleet detector, by replica group",
    labelnames=("group",),
)
STRAGGLERS = REGISTRY.gauge(
    "tft_stragglers", "Replica groups currently latched as stragglers"
)

# Pre-create the CLOSED label sets so their series exist (zero-valued)
# from process start: dashboards and absent-series alerts can then tell
# "healthy, zero heals" from "trainer not scraped". Open-ended label sets
# (plane, transport, event) appear on first observation.
for _role in ("recv", "send"):
    HEALS_TOTAL.labels(role=_role)
for _outcome in ("committed", "aborted"):
    COMMITS_TOTAL.labels(outcome=_outcome)
for _kind in ("steady", "quorum", "heal"):
    STEP_DURATION.labels(kind=_kind)
for _result in ("evicted", "rejected", "failed"):
    EVICTIONS_REPORTED.labels(result=_result)
for _reason in ("signal", "deadline", "watchdog", "manual"):
    FLIGHT_DUMPS.labels(reason=_reason)
for _stage in ("host_copy", "quantize", "wire", "dequant_reduce"):
    WIRE_STAGE_SECONDS.labels(stage=_stage)
for _stage in ("meta", "recv", "decode", "device_put"):
    HEAL_STAGE_SECONDS.labels(stage=_stage)
for _phase in PHASES:
    STEP_PHASE_SECONDS.labels(phase=_phase)
for _slo in ("step_time", "rejoin_commit"):
    SLO_BREACH_TOTAL.labels(slo=_slo)
for _plane in ("py", "native"):
    PROF_SAMPLES.labels(plane=_plane)
for _channel in ("piggyback", "spans"):
    TELEMETRY_BYTES.labels(channel=_channel)
del (
    _role,
    _outcome,
    _kind,
    _result,
    _reason,
    _stage,
    _phase,
    _slo,
    _plane,
    _channel,
)


# ---------------------------------------------------------------------------
# convenience API
# ---------------------------------------------------------------------------


def counter(name: str, help: str = "", labelnames=()) -> Counter:
    """Get-or-create a counter on the process registry."""
    return REGISTRY.counter(name, help, labelnames)


def gauge(name: str, help: str = "", labelnames=()) -> Gauge:
    """Get-or-create a gauge on the process registry."""
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name: str, help: str = "", labelnames=(), buckets=DEFAULT_BUCKETS):
    """Get-or-create a histogram on the process registry."""
    return REGISTRY.histogram(name, help, labelnames, buckets)


def emit(event: str, **fields: Any) -> Dict[str, Any]:
    """Append one record to the process FT event trail."""
    return EVENTS.emit(event, **fields)


def record_collective(
    op: str, nbytes: int, seconds: float, plane: str = "", count_op: bool = True
) -> None:
    """Account one collective op: count it, and for allreduce also record
    bytes + latency (the hot-path series the perf PRs gate on). Pass
    ``count_op=False`` when the op was already counted at submission —
    ops are counted when ISSUED (uniform across kinds, cancellations
    included) while bytes/latency are recorded at completion."""
    if count_op:
        COLLECTIVE_OPS.labels(op=op, plane=plane).inc()
    if op == "allreduce":
        ALLREDUCE_BYTES.labels(plane=plane).inc(nbytes)
        ALLREDUCE_LATENCY.labels(plane=plane).observe(seconds)


def record_checkpoint(
    phase: str, nbytes: int, seconds: float, transport: str
) -> None:
    """Account one checkpoint stage/transfer (phase: stage | send | recv)."""
    CHECKPOINT_BYTES.labels(direction=phase, transport=transport).inc(nbytes)
    CHECKPOINT_SECONDS.labels(phase=phase, transport=transport).observe(seconds)


def render_prometheus(lighthouse_addr: Optional[str] = None) -> str:
    """Prometheus text exposition of the process registry; with
    ``lighthouse_addr``, the native lighthouse's ``torchft_*`` exposition
    is appended so one scrape carries both layers."""
    text = REGISTRY.render()
    if lighthouse_addr:
        from torchft_tpu_torch.telemetry.native import scrape_lighthouse_metrics

        native_text = scrape_lighthouse_metrics(lighthouse_addr)
        if native_text:
            text = text + native_text
    return text


def dump(lighthouse_addr: Optional[str] = None) -> Dict[str, Any]:
    """JSON-serializable snapshot: every metric family, the recent event
    ring, and (optionally) the native lighthouse's /status.json counters."""
    out: Dict[str, Any] = {
        "metrics": REGISTRY.dump(),
        "events": EVENTS.recent(),
    }
    if lighthouse_addr:
        from torchft_tpu_torch.telemetry.native import poll_lighthouse

        out["lighthouse"] = poll_lighthouse(lighthouse_addr)
    return out


def summary() -> Dict[str, Any]:
    """Compact FT/perf digest for bench rows: one flat dict instead of the
    full exposition (quorum count, heal count, allreduce traffic, and a
    step-duration histogram summary by kind)."""
    step: Dict[str, Any] = {}
    for (kind,), child in STEP_DURATION._snapshot_children():
        if not child.count:
            continue
        step[kind] = {
            "count": child.count,
            "sum_s": round(child.sum, 4),
            "p50_s": round(child.quantile(0.5) or 0.0, 4),
            "p99_s": round(child.quantile(0.99) or 0.0, 4),
        }
    allreduce_bytes = sum(
        child.value for _v, child in ALLREDUCE_BYTES._snapshot_children()
    )
    allreduce_ops = sum(
        child.count for _v, child in ALLREDUCE_LATENCY._snapshot_children()
    )
    commits: Dict[str, float] = {
        values[0]: child.value
        for values, child in COMMITS_TOTAL._snapshot_children()
    }
    return {
        "quorums": int(QUORUMS_TOTAL.value),
        "quorum_reconfigures": int(QUORUM_RECONFIGURES.value),
        "quorum_latency_p50_s": round(QUORUM_LATENCY.quantile(0.5) or 0.0, 4),
        "heals_recv": int(HEALS_TOTAL.labels(role="recv").value),
        "heals_send": int(HEALS_TOTAL.labels(role="send").value),
        "peer_deaths": int(PEER_DEATHS.value),
        "allreduce_bytes": int(allreduce_bytes),
        "allreduce_ops": int(allreduce_ops),
        "commits": {k: int(v) for k, v in commits.items()},
        "future_timeouts": int(FUTURE_TIMEOUTS.value),
        "step_duration": step,
    }


def reset() -> None:
    """Zero every metric in place and empty the event/span/flight rings
    and the step-anatomy ledger (tests)."""
    REGISTRY.reset_values()
    EVENTS.clear()
    TRACER.clear()
    FLIGHT.clear()
    LEDGER.reset()
