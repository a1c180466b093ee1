"""The time-series plane: the replica's series and the range-query
client — the port's copy of ``torchft_tpu/telemetry/timeseries.py``.

The lighthouse keeps a fixed-retention ring of samples per ``(replica,
series)`` (``native/tsdb.h``), keyed by ``(epoch, step)`` (no clock
sync), and fed by the quorum piggyback that already carries the summary
and anatomy. This module is both ends of that pipe:

* :func:`build_series` — the replica side: the ``{name: float}`` map the
  Manager attaches to its report each step: the last ledger row's wall,
  local and per-phase seconds (raw per-step values: percentiles would
  smooth away the level shifts the regression sentinel looks for), the
  rolling local p50, the native planes' p50/p99 and the SLO, stuck and
  divergence flags as 0/1 series. The lighthouse is schema-blind.
* :func:`poll_timeseries` — one ``GET /timeseries.json`` range query
  (``since`` step cursor, ``max_points`` downsampling, replica and series
  substring filters), read by the critical-path attributor and the
  regression sentinel; :func:`iter_new_samples` walks a reply's samples
  past each consumer's per-(replica, series) cursor.

Series vocabulary (seconds unless a flag): ``wall_s``, ``local_s``,
``local_p50_s``, ``phase.<name>``, ``lat.<op>.p50_s`` / ``.p99_s``,
``flag.slo_breach`` / ``flag.stuck`` / ``flag.divergence``.

:data:`SERIES_ENABLED` and :data:`MAX_SERIES` (the per-replica fan-out
cap; the lighthouse refuses, and counts, series past its own) are module
constants that tests patch.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "DEFAULT_RETAIN",
    "DEFAULT_MAX_SERIES",
    "series_enabled",
    "build_series",
    "poll_timeseries",
    "iter_new_samples",
]

DEFAULT_RETAIN = 512
DEFAULT_MAX_SERIES = 64


# the per-step series piggyback; tests turn it off
SERIES_ENABLED = True
# build_series trims its map to this many series, by priority
MAX_SERIES = DEFAULT_MAX_SERIES


def series_enabled() -> bool:
    return SERIES_ENABLED


def build_series(
    slo_breach: bool = False,
    stuck: bool = False,
    divergence: bool = False,
) -> Optional[Dict[str, float]]:
    """The replica's sample map for this step's piggyback (see module
    docstring for the vocabulary); None when disabled or before the
    first step row. Never raises — observability must not fail quorum."""
    if not series_enabled():
        return None
    try:
        from torchft_tpu_torch import telemetry
        from torchft_tpu_torch.telemetry.anatomy import lathist_quantile

        row = telemetry.LEDGER.last_row()
        if row is None:
            return None
        out: Dict[str, float] = {
            "wall_s": float(row["wall_s"]),
            "local_s": float(row["local_s"]),
        }
        p50 = telemetry.LEDGER.local_p50()
        if p50 is not None:
            out["local_p50_s"] = float(p50)
        for phase, seconds in row["phases"].items():
            out[f"phase.{phase}"] = float(seconds)
        try:
            from torchft_tpu_torch.telemetry.native import native_latency_snapshot

            native = native_latency_snapshot()
            for op, hist in (native or {}).items():
                if int(hist.get("count", 0)):
                    out[f"lat.{op}.p50_s"] = float(
                        lathist_quantile(hist, 0.5)
                    )
                    out[f"lat.{op}.p99_s"] = float(
                        lathist_quantile(hist, 0.99)
                    )
        except Exception:  # noqa: BLE001 — native plane optional
            pass
        out["flag.slo_breach"] = 1.0 if slo_breach else 0.0
        out["flag.stuck"] = 1.0 if stuck else 0.0
        out["flag.divergence"] = 1.0 if divergence else 0.0
        cap = MAX_SERIES
        if len(out) > cap:
            # deterministic PRIORITY trim — the lighthouse would refuse
            # the overflow anyway; trimming here controls WHICH series
            # survive. Ordered by consumer criticality, not
            # alphabetically: wall/local and the phase decomposition
            # feed the critical-path and regression planes and must
            # outlive diagnostics like lat.* quantiles and the 0/1 flags
            # (a lexicographic trim would cut wall_s FIRST and keep
            # flag.* — exactly backwards).
            def rank(name: str) -> int:
                if name in ("wall_s", "local_s", "local_p50_s"):
                    return 0
                if name.startswith("phase."):
                    return 1
                if name.startswith("flag."):
                    return 2
                return 3  # lat.* and anything future

            out = dict(
                sorted(out.items(), key=lambda kv: (rank(kv[0]), kv[0]))
                [:cap]
            )
        return out
    except Exception:  # noqa: BLE001
        return None


def _base_url(addr: str) -> str:
    if "://" not in addr:
        addr = "http://" + addr
    return addr.rstrip("/")


def poll_timeseries(
    addr: str,
    replica: str = "",
    series: str = "",
    since: Optional[int] = None,
    max_points: Optional[int] = None,
    timeout: float = 3.0,
) -> Optional[Dict[str, Any]]:
    """One range query against the lighthouse's ``GET /timeseries.json``.
    Filters are substring matches; ``since`` is an exclusive step cursor
    (the reply's ``cursor.max_step`` is the next value); ``max_points``
    stride-downsamples each series (the newest sample always survives).
    Returns the parsed reply or None when unreachable — observability
    degrades, never raises."""
    params: List[str] = []
    if replica:
        params.append(f"replica={replica}")
    if series:
        params.append(f"series={series}")
    if since is not None:
        params.append(f"since={int(since)}")
    if max_points is not None:
        params.append(f"max_points={int(max_points)}")
    url = f"{_base_url(addr)}/timeseries.json"
    if params:
        url += "?" + "&".join(params)
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return json.loads(resp.read().decode())
    except Exception:  # noqa: BLE001
        return None


def iter_new_samples(
    reply: Dict[str, Any],
    cursor: Dict[Tuple[str, str], int],
) -> Iterable[Tuple[str, str, int, int, float]]:
    """Yield ``(replica, series, epoch, step, value)`` for every sample in
    ``reply`` newer than the per-(replica, series) ``cursor`` (mutated in
    place), in step order per series. The shared consumption idiom of the
    regression sentinel and the critical-path monitor: both poll the full
    ring and dedup here, so a replica lagging the fleet-wide max step
    (or a respawn restarting at step 0) never loses samples to a global
    since-cursor."""
    for rid, all_series in (reply.get("replicas") or {}).items():
        for name, body in (all_series or {}).items():
            key = (rid, name)
            last = cursor.get(key)
            for sample in body.get("samples") or []:
                try:
                    epoch, step, value = (
                        int(sample[0]), int(sample[1]), float(sample[2]),
                    )
                except (TypeError, ValueError, IndexError):
                    continue
                if last is not None and step <= last:
                    continue
                cursor[key] = step
                last = step
                yield rid, name, epoch, step, value
