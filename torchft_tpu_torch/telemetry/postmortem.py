"""Fleet postmortem reconstruction — the port's copy of
``torchft_tpu/telemetry/postmortem.py``:
``python -m torchft_tpu_torch.telemetry.postmortem <dir>``.

Merges every replica's crash-durable black boxes (Python rings and native
breadcrumb rings, :mod:`torchft_tpu_torch.telemetry.blackbox`), FT event
trails (``*.jsonl``) and fault-injection evidence (``tft_fault_*``) found
under one directory into a single causal timeline, ordered by the
clock-sync-free ``(quorum_epoch, step, seq)`` coordinates every record
carries (wall clock is only the tiebreak within a coordinate). The rings'
format is shared with the JAX package, so either package's postmortem
reads the other's directories and reports alike.

The incident report answers:

* **first anomaly**: the earliest abort, heal failure, peer death,
  watchdog stall or divergence latch on the merged timeline;
* **victim**: the replica the survivors' ``peer_death`` records accuse
  (else the box that ends with an op in flight or a torn tail);
* **in-flight ops**: per replica, the last collective issued and never
  completed (the flight recorder's mirror survives SIGKILL in the box);
* **classification**: ``injected`` (fault-plane evidence exists),
  ``environmental`` (the documented corruption signatures,
  ``faultinject.core.ENV_CORRUPTION_SIGNATURES``), ``divergence`` (the
  commit-time sentinel latched), or ``new-bug`` (anomalies nothing
  explains).

``--perf`` rebuilds each replica's step series from the boxes' anatomy
ticks and runs the regression sentinel over them offline; ``--bundles``
folds diagnosis bundles into the timeline. Left out: the JAX CLI's
``--conformance`` (its protocol checker lives in the JAX package's
``analysis/``, which the port does not import; the tests run that checker
over the port's directories). Stdlib-only and safe against a live
directory (readers never write the rings).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

from torchft_tpu_torch.telemetry.blackbox import (
    read_blackbox,
    read_native_blackbox,
)

__all__ = [
    "collect_boxes", "analyze", "classify", "render_text",
    "perf_windows", "render_perf_text", "main",
]

# record kinds that mark "something went wrong here" on the timeline
ANOMALY_KINDS = (
    "abort",
    "heal_failed",
    "peer_death",
    "eviction",
    "watchdog_stall",
    "flight_dump",
    "fault_injected",
    "divergence_detected",
    "slo_breach",
)


def _read_trail_file(path: str) -> List[Dict[str, Any]]:
    records: List[Dict[str, Any]] = []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn tail of a SIGKILLed writer
                if isinstance(rec, dict) and "event" in rec:
                    records.append(rec)
    except OSError:
        pass
    return records


def collect_boxes(root: str) -> List[Dict[str, Any]]:
    """Every black box under ``root`` (recursive), each as
    ``{"path", "pid", "replica", "native", "torn", "records"}``."""
    out: List[Dict[str, Any]] = []
    for base, _dirs, files in os.walk(root):
        for fn in sorted(files):
            if not fn.endswith(".bb"):
                continue
            path = os.path.join(base, fn)
            try:
                if fn.endswith("_native.bb"):
                    records, meta = read_native_blackbox(path)
                else:
                    records, meta = read_blackbox(path)
            except OSError:
                continue
            out.append(
                {
                    "path": path,
                    "pid": meta.get("pid"),
                    "replica": meta.get("replica") or "",
                    "native": bool(meta.get("native")),
                    "torn": int(meta.get("torn", 0)),
                    "records": records,
                }
            )
    return out


def _inflight_op(records: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """The last op issued but never completed in one box's records —
    "what was this process doing when it died"."""
    completed = {
        r.get("fseq") for r in records if r.get("k") == "op_complete"
    }
    last = None
    for r in records:
        if r.get("k") == "op_issue" and r.get("fseq") not in completed:
            last = r
    return last


def _sort_key(rec: Dict[str, Any]) -> Tuple:
    # (epoch, step) are the causal coordinates; seq orders within one
    # process; ts is only the cross-process tiebreak inside a coordinate
    ep = rec.get("ep", -1)
    st = rec.get("st", -1)
    return (
        ep if isinstance(ep, int) else -1,
        st if isinstance(st, int) else -1,
        float(rec.get("ts", 0.0) or 0.0),
        int(rec.get("q", 0) or 0),
    )


def classify(
    report: Dict[str, Any], log_text: Optional[str] = None
) -> str:
    """Attribution verdict for the incident (see module docstring)."""
    if report.get("injected_evidence"):
        return "injected"
    from torchft_tpu_torch.faultinject.core import ENV_CORRUPTION_SIGNATURES

    texts: List[str] = []
    if log_text:
        texts.append(log_text)
    for rec in report.get("timeline", []):
        err = rec.get("error") or rec.get("errored")
        if err:
            texts.append(str(err))
    for text in texts:
        for sig in ENV_CORRUPTION_SIGNATURES:
            if sig in text:
                return "environmental"
    if any(
        r.get("k") == "divergence_detected" or r.get("k") == "divergence"
        for r in report.get("timeline", [])
    ):
        return "divergence"
    if report.get("first_anomaly") or report.get("victim"):
        return "new-bug"
    return "clean"


def collect_bundles(paths: List[Optional[str]]) -> List[Dict[str, Any]]:
    """Every diagnosis bundle (``bundle.json``) under the given roots,
    deduplicated and ordered by capture time — the ``--bundles`` input.
    Torn/malformed bundles are skipped, same contract as the
    black-box reader."""
    from torchft_tpu_torch.telemetry.diagnosis import load_bundle_meta

    metas: List[Dict[str, Any]] = []
    seen: set = set()
    for p in paths:
        if not p or not os.path.isdir(p):
            continue
        for base, _dirs, files in os.walk(p):
            if "bundle.json" not in files:
                continue
            real = os.path.realpath(base)
            if real in seen:
                continue
            seen.add(real)
            meta = load_bundle_meta(base)
            if meta is not None:
                metas.append(meta)
    metas.sort(key=lambda m: m.get("ts", 0.0))
    return metas


def analyze(
    root: str,
    log_text: Optional[str] = None,
    timeline_cap: int = 2000,
    bundles_dir: Optional[str] = None,
) -> Dict[str, Any]:
    """Reconstruct the incident under ``root``; returns the report dict
    (JSON-safe). ``log_text`` optionally feeds worker-log text into the
    environmental-signature classification. ``bundles_dir`` (the
    ``--bundles`` flag; ``""`` = discover under ``root``) folds captured
    diagnosis bundles into the causal timeline, so the report reads
    latch → capture → evidence even after every process died."""
    boxes = collect_boxes(root)
    evidence: List[Dict[str, Any]] = []
    trails: List[Dict[str, Any]] = []
    for base, _dirs, files in os.walk(root):
        for fn in sorted(files):
            path = os.path.join(base, fn)
            if fn.startswith("tft_fault_"):
                from torchft_tpu_torch.faultinject.core import read_evidence

                evidence.extend(read_evidence(base))
                break  # read_evidence consumed the whole directory
        for fn in sorted(files):
            if fn.endswith(".jsonl"):
                trails.extend(_read_trail_file(os.path.join(base, fn)))

    # normalize everything onto one record shape and merge
    timeline: List[Dict[str, Any]] = []
    replicas: Dict[str, Dict[str, Any]] = {}
    for box in boxes:
        src = box["replica"] or f"pid:{box['pid']}"
        info = replicas.setdefault(
            src,
            {"replica": box["replica"], "pids": [], "records": 0,
             "torn": 0, "inflight": None, "last_epoch": -1,
             "last_step": -1},
        )
        info["pids"].append(box["pid"])
        info["records"] += len(box["records"])
        info["torn"] += box["torn"]
        inflight = _inflight_op(box["records"])
        if inflight is not None:
            info["inflight"] = inflight
        for rec in box["records"]:
            info["last_epoch"] = max(
                info["last_epoch"], int(rec.get("ep", -1) or -1)
            )
            info["last_step"] = max(
                info["last_step"], int(rec.get("st", -1) or -1)
            )
            timeline.append({**rec, "src": src})
    # The black box MIRRORS every event-trail emit (events.py), so when
    # boxes were recovered the trail files are duplicates: merging both
    # would double every peer_death/abort on the timeline and double the
    # victim-accusation counts. Trails only fill in when no box spoke
    # (pre-arm workers, or a directory with trails alone).
    trails_mirrored = any(box["records"] for box in boxes)
    if not trails_mirrored:
        for rec in trails:
            timeline.append(
                {
                    "k": rec.get("event"),
                    "ep": rec.get("quorum_id", -1),
                    "st": rec.get("step", -1),
                    "ts": rec.get("ts", 0.0),
                    "src": "trail",
                    **{
                        k: v
                        for k, v in rec.items()
                        if k not in ("event", "ts", "step")
                    },
                }
            )
    # diagnosis bundles fold in as first-class timeline records at their
    # stamped (epoch, step, seq) coordinates: the latch event (mirrored
    # by the trigger replica's box) is followed by its capture, and the
    # record carries the on-disk evidence paths
    bundles: List[Dict[str, Any]] = []
    if bundles_dir is not None:
        bundles = collect_bundles([root, bundles_dir or None])
        for meta in bundles:
            trig = meta.get("trigger") or {}
            timeline.append(
                {
                    "k": "diagnosis_captured",
                    "ep": meta.get("epoch", -1),
                    "st": meta.get("step", -1),
                    "q": meta.get("seq", 0),
                    "ts": meta.get("ts", 0.0),
                    "src": meta.get("replica_id") or "diagnosis",
                    "bundle": meta.get("bundle"),
                    "trigger": trig.get("event"),
                    "path": meta.get("_dir"),
                }
            )
    timeline.sort(key=_sort_key)

    # victim attribution: the replica the survivors' peer_death records
    # accuse — readable from black boxes alone (the event-trail mirror
    # rides the box), corroborated by that replica's own torn/in-flight
    # tail
    accusations: Dict[str, int] = {}
    for rec in timeline:
        if rec.get("k") == "peer_death" and rec.get("replica"):
            accusations[str(rec["replica"])] = (
                accusations.get(str(rec["replica"]), 0) + 1
            )
    victim = max(accusations, key=accusations.get) if accusations else None
    victim_info = replicas.get(victim) if victim else None
    if victim is None:
        # no accuser survived (or a single-replica incident): fall back
        # to the box that ends torn / with an op still in flight
        for src, info in replicas.items():
            if info["torn"] or info["inflight"] is not None:
                victim = src
                victim_info = info
                break

    first_anomaly = next(
        (r for r in timeline if r.get("k") in ANOMALY_KINDS), None
    )
    injected = [
        r
        for r in evidence
        if r.get("action") in ("kill", "torn", "drop", "corrupt")
    ]

    report: Dict[str, Any] = {
        "root": root,
        "boxes": [
            {k: v for k, v in b.items() if k != "records"} for b in boxes
        ],
        "replicas": replicas,
        "victim": victim,
        "victim_inflight_op": (
            victim_info.get("inflight") if victim_info else None
        ),
        "victim_epoch": (
            victim_info.get("last_epoch") if victim_info else None
        ),
        "survivor_inflight": {
            src: info["inflight"]
            for src, info in replicas.items()
            if src != victim and info["inflight"] is not None
        },
        "first_anomaly": first_anomaly,
        "injected_evidence": injected,
        "bundles": [
            {k: v for k, v in m.items() if k not in ("lathist",)}
            for m in bundles
        ],
        "trails_mirrored_by_boxes": trails_mirrored,
        "timeline": timeline[:timeline_cap],
        "timeline_truncated": max(0, len(timeline) - timeline_cap),
    }
    report["classification"] = classify(report, log_text=log_text)

    # recovery accounting: reading a crashed process's box IS the event
    # the live plane could never emit — record it on THIS process's
    # trail so forensic tooling use shows up in telemetry too
    try:
        from torchft_tpu_torch import telemetry

        telemetry.emit(
            "blackbox_recovered",
            boxes=len(boxes),
            records=sum(len(b["records"]) for b in boxes),
            torn=sum(b["torn"] for b in boxes),
            classification=report["classification"],
        )
    except Exception:  # noqa: BLE001 — reporting must not fail the report
        pass
    return report


def perf_windows(
    root: str,
    window: int = 0,
    delta: Optional[float] = None,
    lam: Optional[float] = None,
    min_n: Optional[int] = None,
) -> Dict[str, Any]:
    """``--perf`` window mode: reconstruct each replica's
    per-step wall/local series from the crash-durable ``anatomy_tick``
    black-box records — the SAME series the lighthouse time-series store
    retains live, read post-hoc from disk — and run the perf-regression
    sentinel (:mod:`torchft_tpu_torch.telemetry.regression` Page-Hinkley)
    offline over them. Answers "when did this fleet get slow" from the
    boxes ALONE, after every live surface died with its processes.

    ``window`` keeps only the last N steps per replica (0 = all).
    Returns per-replica: the step range, first/last-window means, and
    every latched shift with its onset step."""
    from torchft_tpu_torch.telemetry.regression import RegressionDetector

    boxes = collect_boxes(root)
    # replica -> [(step, wall_s, local_s)] in recorded order
    series: Dict[str, List[Tuple[int, float, float]]] = {}
    for box in boxes:
        src = box["replica"] or f"pid:{box['pid']}"
        for rec in box["records"]:
            if rec.get("k") != "anatomy_tick":
                continue
            try:
                step = int(rec.get("step", rec.get("st", -1)))
                wall = float(rec.get("wall_s", 0.0))
                local = float(rec.get("local_s", 0.0))
            except (TypeError, ValueError):
                continue
            if step >= 0 and wall > 0:
                series.setdefault(src, []).append((step, wall, local))
    kwargs: Dict[str, Any] = {}
    if delta is not None:
        kwargs["delta"] = delta
    if lam is not None:
        kwargs["lam"] = lam
    if min_n is not None:
        kwargs["min_n"] = min_n
    # unlike the live monitor (which excludes wall_s — the straggler/
    # critical-path planes already own cross-replica wall analysis),
    # this offline window feeds BOTH reconstructed series, so watch both:
    # a barrier-dominated degradation shows in wall while local stays
    # flat, and 'no level shift latched' would be a lie
    detector = RegressionDetector(
        prefixes=("local_s", "wall_s", "phase."), **kwargs
    )
    out: Dict[str, Any] = {"root": root, "replicas": {}}
    for src, samples in sorted(series.items()):
        samples.sort(key=lambda t: t[0])
        if window > 0:
            samples = samples[-window:]
        shifts: List[Dict[str, Any]] = []
        for step, wall, local in samples:
            for name, value in (("wall_s", wall), ("local_s", local)):
                ev = detector.observe(src, name, step, value)
                if ev is not None:
                    shifts.append(ev)
        locals_ = [s[2] for s in samples]
        head = locals_[: max(1, len(locals_) // 4)]
        tail = locals_[-max(1, len(locals_) // 4):]
        out["replicas"][src] = {
            "steps": len(samples),
            "step_range": [samples[0][0], samples[-1][0]] if samples else [],
            "local_head_mean_s": (
                round(sum(head) / len(head), 6) if head else None
            ),
            "local_tail_mean_s": (
                round(sum(tail) / len(tail), 6) if tail else None
            ),
            "shifts": shifts,
        }
    out["regressed"] = [
        {"replica": r, "series": s} for r, s in detector.regressed()
    ]
    return out


def render_perf_text(report: Dict[str, Any]) -> str:
    lines = [f"perf window of {report['root']}"]
    for src, info in sorted(report.get("replicas", {}).items()):
        lines.append(
            f"  {src}: {info['steps']} steps {info['step_range']} "
            f"local mean {info['local_head_mean_s']}s -> "
            f"{info['local_tail_mean_s']}s"
        )
        for ev in info.get("shifts", []):
            lines.append(
                f"    {ev['event']}: {ev['series']} at step {ev['step']}"
                + (
                    f" (baseline {ev['baseline_s']}s -> {ev['value_s']}s)"
                    if "baseline_s" in ev
                    else ""
                )
            )
    if not report.get("regressed"):
        lines.append("  no level shift latched")
    return "\n".join(lines)


def render_text(report: Dict[str, Any]) -> str:
    """Human-readable incident summary (the JSON report is the machine
    surface; this is the triage page)."""
    lines = [f"postmortem of {report['root']}"]
    lines.append(
        f"  boxes: {len(report['boxes'])} "
        f"({sum(b['torn'] for b in report['boxes'])} torn region(s) "
        "skipped — CRC-invalid tails, never trusted)"
    )
    lines.append(f"  classification: {report['classification']}")
    if report.get("victim"):
        lines.append(f"  victim: {report['victim']}")
        op = report.get("victim_inflight_op")
        if op:
            lines.append(
                f"    in-flight at death: {op.get('op', op.get('k'))} "
                f"(plane={op.get('plane', '?')}, step={op.get('st')}, "
                f"epoch={op.get('ep')})"
            )
        if report.get("victim_epoch") is not None:
            lines.append(f"    quorum epoch: {report['victim_epoch']}")
    fa = report.get("first_anomaly")
    if fa:
        lines.append(
            f"  first anomaly: {fa.get('k')} at epoch={fa.get('ep')} "
            f"step={fa.get('st')} (src={fa.get('src')})"
        )
    for src, op in sorted(report.get("survivor_inflight", {}).items()):
        lines.append(
            f"  survivor {src}: in-flight {op.get('op', op.get('k'))} "
            f"at step={op.get('st')}"
        )
    if report.get("injected_evidence"):
        sites = sorted(
            {r.get("site", "?") for r in report["injected_evidence"]}
        )
        lines.append(
            f"  injection evidence: {len(report['injected_evidence'])} "
            f"record(s) at {sites}"
        )
    for m in report.get("bundles") or []:
        trig = (m.get("trigger") or {}).get("event", "?")
        lines.append(
            f"  diagnosis bundle: {m.get('bundle')} (trigger={trig}, "
            f"replica={m.get('replica_id')}, step={m.get('step')}, "
            f"epoch={m.get('epoch')}) -> {m.get('_dir')}"
        )
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m torchft_tpu_torch.telemetry.postmortem",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("dir", help="directory holding black boxes / trails / "
                    "fault evidence (searched recursively)")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="also write the full report JSON here")
    ap.add_argument("--timeline", type=int, default=0,
                    help="print the last N merged timeline records")
    ap.add_argument("--perf", action="store_true",
                    help="perf window mode: reconstruct per-replica "
                    "wall/local step series from the boxes' anatomy "
                    "ticks and run the perf-regression sentinel offline")
    ap.add_argument("--window", type=int, default=0,
                    help="--perf: analyze only the last N steps per "
                    "replica (0 = all)")
    ap.add_argument("--bundles", nargs="?", const="", default=None,
                    metavar="DIR",
                    help="fold diagnosis bundles (bundle.json dirs) into "
                    "the causal timeline; with no DIR, discover them "
                    "under the evidence dir itself")
    args = ap.parse_args(argv)

    if args.perf:
        perf = perf_windows(args.dir, window=args.window)
        print(render_perf_text(perf))
        if args.json_out:
            with open(args.json_out, "w", encoding="utf-8") as f:
                json.dump(perf, f, indent=1, default=str)
            print(f"report: {args.json_out}")
        return 0

    report = analyze(args.dir, bundles_dir=args.bundles)
    print(render_text(report))
    if args.timeline:
        for rec in report["timeline"][-args.timeline:]:
            print(
                f"  [ep={rec.get('ep')} st={rec.get('st')} "
                f"q={rec.get('q', '-')}] {rec.get('src')}: {rec.get('k')}"
            )
    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=1, default=str)
        print(f"report: {args.json_out}")
    return 0 if report["classification"] in ("clean", "injected") else 2


if __name__ == "__main__":
    sys.exit(main())
