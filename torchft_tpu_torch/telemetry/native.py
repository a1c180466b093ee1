"""Bridge to the C++ coordination core's own counters — the port's copy of
``torchft_tpu/telemetry/native.py``.

The native lighthouse (``native/coord.cc``) serves ``/status.json`` and a
Prometheus ``/metrics`` page on its dashboard port: quorum_id, participant
steps, evictions_total, flush_requests_total, heartbeat ages. Those
counters live in the C++ process (possibly another host), so the Python
registry cannot own them; this module polls them over that HTTP surface,
as a dict (:func:`poll_lighthouse`) or as raw exposition text spliced into
this process's scrape (:func:`scrape_lighthouse_metrics`). The native
planes' latency histograms of THIS process come from the loaded core
(:func:`native_latency_snapshot`). The fleet's view, which the replicas'
telemetry piggyback feeds, is read with :func:`poll_cluster`
(``/cluster.json``) and :func:`fetch_merged_trace` (``/trace``).
"""

from __future__ import annotations

import json
import urllib.request
from typing import Any, Dict, Optional

__all__ = [
    "poll_lighthouse",
    "scrape_lighthouse_metrics",
    "native_latency_snapshot",
    "poll_cluster",
    "fetch_merged_trace",
]


def native_latency_snapshot() -> Optional[Dict[str, Any]]:
    """THIS process's native latency histograms (dp.hop / dp.stripe /
    rpc.serve / quorum.fanout) from ``_native.lathist_snapshot``: raw
    per-bucket counts on the fixed log2 grid shared with
    ``telemetry.anatomy.LOG2_BUCKETS``. Merge snapshots from several
    processes with ``telemetry.merge_lathist`` (exact: same bounds
    everywhere). None when the native core cannot be loaded."""
    try:
        from torchft_tpu_torch import _native

        return _native.lathist_snapshot()
    except Exception:  # noqa: BLE001 — degrade, don't raise
        return None


def _base_url(addr: str) -> str:
    # LighthouseServer.address() returns "http://host:port"; accept a bare
    # host:port too (the TORCHFT_LIGHTHOUSE convention)
    if "://" not in addr:
        addr = "http://" + addr
    return addr.rstrip("/")


def poll_lighthouse(addr: str, timeout: float = 2.0) -> Optional[Dict[str, Any]]:
    """Fetch the lighthouse's ``/status.json`` native counters
    (quorum_id, members with their step and plane, evictions_total,
    flush_requests_total, recent evictions). None when the lighthouse is
    unreachable: observability degrades, it does not raise."""
    try:
        with urllib.request.urlopen(f"{_base_url(addr)}/status.json", timeout=timeout) as resp:
            return json.loads(resp.read().decode())
    except Exception:  # noqa: BLE001 — any failure means "no native stats"
        return None


def scrape_lighthouse_metrics(addr: str, timeout: float = 2.0) -> str:
    """Fetch the lighthouse's raw Prometheus ``/metrics`` text (the
    ``torchft_*`` families). Empty when unreachable."""
    try:
        with urllib.request.urlopen(f"{_base_url(addr)}/metrics", timeout=timeout) as resp:
            return resp.read().decode()
    except Exception:  # noqa: BLE001
        return ""


def poll_cluster(addr: str, timeout: float = 2.0) -> Optional[Dict[str, Any]]:
    """The lighthouse's ``/cluster.json``: per replica the last report's
    age, step, stuck and SLO flags, heal recency, counters digest and
    anatomy (each replica's telemetry piggyback). None when unreachable."""
    try:
        with urllib.request.urlopen(f"{_base_url(addr)}/cluster.json", timeout=timeout) as resp:
            return json.loads(resp.read().decode())
    except Exception:  # noqa: BLE001 — degrade, don't raise
        return None


def fetch_merged_trace(
    addr: str, path: Optional[str] = None, timeout: float = 5.0
) -> Optional[Dict[str, Any]]:
    """The lighthouse's merged Chrome trace (``GET /trace``): every
    replica's recent spans on one timeline, a lane per replica. With
    ``path``, the raw JSON is also written there (Perfetto opens it). None
    when unreachable."""
    try:
        with urllib.request.urlopen(f"{_base_url(addr)}/trace", timeout=timeout) as resp:
            raw = resp.read()
    except Exception:  # noqa: BLE001
        return None
    if path:
        try:
            with open(path, "wb") as f:
                f.write(raw)
        except OSError:
            pass
    try:
        return json.loads(raw.decode())
    except ValueError:
        return None
