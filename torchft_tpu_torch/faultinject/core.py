"""Deterministic fault-injection plane — the port's copy of
``torchft_tpu/faultinject/core.py``: the site registry and the seeded
schedule engine.

Kill and restart soaks rely on wall-clock races, so the interesting
windows — a peer dying mid-collective, a CMA pull torn halfway, a commit
vote delayed past the pipeline's speculation fence — fire rarely and can
not be bisected. Every layer where such faults land has a **named
injection site**, and a **seeded schedule** decides, deterministically,
which occurrences of which sites fire which fault.

Sites (call sites pass a free-form ``match`` label a rule can
substring-filter on):

========================  ====================================================
site                      where it fires in the port
========================  ====================================================
``rpc.send``              wire-level frame send (``CollectivesTcp._send_to``)
``rpc.recv``              wire-level frame receive (``_recv_from``)
``collective.issue``      a collective op is issued (host and device planes)
``collective.complete``   a collective op finished on the op thread
``cma.pull``              a process_vm_readv pull of a peer's buffer
``ckpt.serve``            the checkpoint HTTP server is about to stream
``ckpt.recv``             a healing replica starts fetching a checkpoint
``quorum.reply``          the quorum RPC reply reached this replica
``commit.vote``           the should_commit vote (``match="prepare"`` at the
                          barrier's drain, ``match="rpc"`` at the vote RPC)
``future.deadline``       a future is registered with the deadline manager
========================  ====================================================

Actions: ``delay(ms)``, ``drop``, ``error(exc)``, ``torn(frac)`` (partial
write or torn read: a peer dying mid-op), ``kill(sig)`` and
``corrupt(frac)`` (a silent perturbation of ``frac`` of one replica's
finished op output: no error is raised). ``delay`` / ``error`` / ``kill``
are applied inline by :func:`fault_point`; ``drop`` / ``torn`` /
``corrupt`` are returned to wire-capable call sites (those passing
``wire=True``), which implement them; at any other site they degrade to
``error``, so a schedule never silently does nothing.

Schedules are JSON (inline or ``@/path/to/file``) in
``TORCHFT_FAULT_SCHEDULE``, or passed to :func:`configure`::

    {"seed": 7,
     "rules": [
       {"site": "rpc.recv",  "nth": 3, "action": "error",
        "exc": "ConnectionError"},
       {"site": "collective.issue", "match": "allreduce",
        "nth": 5, "action": "kill", "sig": 9},
       {"site": "commit.vote", "match": "rpc",
        "every": 2, "action": "delay", "ms": 150},
       {"site": "cma.pull", "p": 0.1, "action": "torn", "frac": 0.5}
     ]}

Each rule keeps its own hit counter over the occurrences its ``match``
accepts: ``nth`` fires on the nth (once), ``every`` on every k-th, ``p``
per occurrence from an RNG seeded by ``(seed, rule index, site, match)``
through crc32 (so a fixed seed replays the identical sequence, in this
package and in the JAX one alike), and ``after`` on every occurrence
from the after-th on (a mid-run onset). ``limit`` caps the fires
(default 1 for ``nth``, unlimited otherwise).

Every fired injection emits a ``fault_injected`` trail event, counts in
``tft_faults_injected_total{site,action}``, lands in the flight recorder
and, when ``TORCHFT_FAULT_EVIDENCE_DIR`` is set, appends a JSONL evidence
record (written before a ``kill`` runs) in the shape the native plane's
records share (``native/faultinject.h``), so a postmortem tells an
injected death from an environmental one. The native plane's own sites
(``TORCHFT_FI_*``, ``NATIVE_SITES``) are armed by their environment
variables in the C++ core.

Stdlib-only; :func:`fault_point` costs one global read when no schedule
is loaded. Left out: the JAX package's scenario runner
(``faultinject/runner.py``) and its sanitizer worker.
"""

from __future__ import annotations

import json
import logging
import os
import random
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

__all__ = [
    "SITES",
    "NATIVE_SITES",
    "ACTIONS",
    "ENV_CORRUPTION_SIGNATURES",
    "CORRUPTION_SIGNAL_RCS",
    "ENV_SCHEDULE",
    "ENV_EVIDENCE_DIR",
    "Injection",
    "FaultPlane",
    "configure",
    "active",
    "fault_point",
    "read_evidence",
]

ENV_SCHEDULE = "TORCHFT_FAULT_SCHEDULE"
ENV_EVIDENCE_DIR = "TORCHFT_FAULT_EVIDENCE_DIR"

SITES = (
    "rpc.send",
    "rpc.recv",
    "collective.issue",
    "collective.complete",
    "cma.pull",
    "ckpt.serve",
    "ckpt.recv",
    "quorum.reply",
    "commit.vote",
    "future.deadline",
)

# Site labels the native plane's evidence records may carry (the
# `fi::write_evidence` / `fi::kill_self` call sites in native/*.cc|h): a
# death is attributed to a scheduled injection at these as at SITES.
NATIVE_SITES = (
    "blob.serve",
    "cma.desc",
    "cma.pull",
    "commit.vote",
    "dp.hop",
    "rpc.send",
)

ACTIONS = ("delay", "drop", "error", "torn", "kill", "corrupt")

# Environmental-corruption catalog, the JAX package's: a worker can die
# of heap corruption (glibc aborts), its pytree-level symptom ("Too few
# elements for TreeDef node"), or a bare signal-class exit during
# multi-process churn. The postmortem classifies such deaths
# `environmental`; both packages keep the same tuple.
ENV_CORRUPTION_SIGNATURES = (
    "Too few elements for TreeDef node",
    "malloc(): ",
    "malloc_consolidate",
    "double free or corruption",
    "free(): invalid",
    "corrupted size vs. prev_size",
    "corrupted double-linked list",
    "Segmentation fault",
)

# signal-class deaths that glibc/the kernel may leave without any log
# output: SIGSEGV, SIGABRT, SIGBUS
CORRUPTION_SIGNAL_RCS = (-11, -6, -7)

# exception classes a rule may name; PeerGoneError is resolved lazily to
# avoid importing the collectives layer at schedule-parse time
_EXC_NAMES = ("ConnectionError", "TimeoutError", "OSError", "RuntimeError",
              "EOFError", "PeerGoneError")


def _resolve_exc(name: str):
    if name == "PeerGoneError":
        from torchft_tpu_torch.collectives import PeerGoneError

        return PeerGoneError
    return {
        "ConnectionError": ConnectionError,
        "TimeoutError": TimeoutError,
        "OSError": OSError,
        "RuntimeError": RuntimeError,
        "EOFError": EOFError,
    }[name]


class Injection:
    """One fired rule, handed to the call site."""

    __slots__ = ("site", "match", "action", "ms", "frac", "sig", "exc",
                 "msg", "hit", "rule")

    def __init__(self, site: str, match: str, action: str, ms: float,
                 frac: float, sig: int, exc: str, msg: str, hit: int,
                 rule: int) -> None:
        self.site = site
        self.match = match
        self.action = action
        self.ms = ms
        self.frac = frac
        self.sig = sig
        self.exc = exc
        self.msg = msg
        self.hit = hit  # which occurrence of (site, rule-match) fired
        self.rule = rule

    def make_exception(self) -> BaseException:
        text = (
            f"fault injection: {self.site}[{self.match or '*'}] "
            f"hit {self.hit} action={self.action}"
            + (f" ({self.msg})" if self.msg else "")
        )
        cls = _resolve_exc(self.exc or "ConnectionError")
        try:
            from torchft_tpu_torch.collectives import PeerGoneError

            if cls is PeerGoneError:
                return cls(0, text)
        except Exception:  # noqa: BLE001 — fall through to plain construct
            pass
        return cls(text)


class _Rule:
    def __init__(self, spec: Dict[str, Any], idx: int, seed: int) -> None:
        self.site = spec["site"]
        if self.site not in SITES:
            raise ValueError(
                f"unknown injection site {self.site!r}; known: {SITES}"
            )
        self.action = spec.get("action", "error")
        if self.action not in ACTIONS:
            raise ValueError(
                f"unknown action {self.action!r}; known: {ACTIONS}"
            )
        self.match = str(spec.get("match", ""))
        self.nth = spec.get("nth")
        self.every = spec.get("every")
        self.p = spec.get("p")
        # onset semantics: fire on EVERY matching occurrence from the
        # after-th onward — a mid-run level shift needs a clean onset
        # step, which nth (one-shot) and every (periodic from the start)
        # cannot express
        self.after = spec.get("after")
        if sum(
            x is not None
            for x in (self.nth, self.every, self.p, self.after)
        ) > 1:
            raise ValueError(
                "rule may set at most one of nth/every/p/after"
            )
        # nth rules are one-shot by default; every/p unlimited (limit=0)
        default_limit = 1 if self.nth is not None else 0
        self.limit = int(spec.get("limit", default_limit))
        self.ms = float(spec.get("ms", 0.0))
        self.frac = float(spec.get("frac", 0.5))
        self.sig = int(spec.get("sig", 9))
        self.exc = spec.get("exc", "ConnectionError")
        if self.exc not in _EXC_NAMES:
            raise ValueError(
                f"unknown exc {self.exc!r}; known: {_EXC_NAMES}"
            )
        self.msg = str(spec.get("msg", ""))
        self.idx = idx
        # stable per-rule stream: crc32 keying (hash() is salted per
        # process, which would break cross-process replay)
        key = f"{seed}:{idx}:{self.site}:{self.match}".encode()
        self._rng = random.Random(zlib.crc32(key))
        self.hits = 0
        self.fires = 0

    def consider(self, match: str) -> bool:
        """Count a matching occurrence; True when this one fires.
        Called under the plane lock."""
        if self.match and self.match not in match:
            return False
        self.hits += 1
        if self.limit and self.fires >= self.limit:
            return False
        if self.nth is not None:
            fire = self.hits == int(self.nth)
        elif self.every is not None:
            fire = self.hits % int(self.every) == 0
        elif self.p is not None:
            fire = self._rng.random() < float(self.p)
        elif self.after is not None:
            fire = self.hits >= int(self.after)
        else:
            fire = True
        if fire:
            self.fires += 1
        return fire


class FaultPlane:
    """A parsed schedule plus its per-rule occurrence state."""

    def __init__(self, schedule: Dict[str, Any]) -> None:
        self.seed = int(schedule.get("seed", 0))
        self.rules = [
            _Rule(spec, i, self.seed)
            for i, spec in enumerate(schedule.get("rules", []))
        ]
        self._lock = threading.Lock()
        self.fired: List[Dict[str, Any]] = []
        self._evidence_dir = os.environ.get(ENV_EVIDENCE_DIR)

    def hit(self, site: str, match: str,
            ctx: Dict[str, Any]) -> Optional[Injection]:
        """Consult the schedule for one occurrence of ``site``; returns
        the fired Injection (first matching rule wins) or None."""
        inj: Optional[Injection] = None
        record: Optional[Dict[str, Any]] = None
        with self._lock:
            for rule in self.rules:
                if rule.site != site:
                    continue
                if rule.consider(match):
                    inj = Injection(
                        site, match, rule.action, rule.ms, rule.frac,
                        rule.sig, rule.exc, rule.msg, rule.hits, rule.idx,
                    )
                    record = {
                        "ts": time.time(),
                        "pid": os.getpid(),
                        "site": site,
                        "match": match,
                        "action": rule.action,
                        "hit": rule.hits,
                        "rule": rule.idx,
                    }
                    self.fired.append(record)
                    break
        if inj is None:
            return None
        self._write_evidence(record)
        self._account(inj, ctx)
        return inj

    def fired_sequence(self) -> List[Tuple[str, str, str, int]]:
        """The deterministic replay key: (site, match, action, hit) per
        fired injection, in firing order."""
        with self._lock:
            return [
                (r["site"], r["match"], r["action"], r["hit"])
                for r in self.fired
            ]

    # -- evidence + accounting -------------------------------------------

    def _write_evidence(self, record: Optional[Dict[str, Any]]) -> None:
        """Append the fired record to the per-pid evidence file. Written
        BEFORE the action executes so a kill's evidence survives it —
        this file is what lets a postmortem tell a scheduled death from
        the documented environmental corruption."""
        if not self._evidence_dir or record is None:
            return
        try:
            os.makedirs(self._evidence_dir, exist_ok=True)
            path = os.path.join(
                self._evidence_dir, f"tft_fault_{os.getpid()}.json"
            )
            with open(path, "a", encoding="utf-8") as f:
                f.write(json.dumps(record) + "\n")
                f.flush()
                os.fsync(f.fileno())
        except OSError:
            logger.warning("fault evidence write failed", exc_info=True)

    def _account(self, inj: Injection, ctx: Dict[str, Any]) -> None:
        """Telemetry: event + counter + a flight-recorder ring entry, so
        evidence collection is automatic on every fire."""
        try:
            from torchft_tpu_torch import telemetry

            telemetry.FAULTS_INJECTED.labels(
                site=inj.site, action=inj.action
            ).inc()
            telemetry.emit(
                "fault_injected",
                site=inj.site,
                action=inj.action,
                match=inj.match,
                hit=inj.hit,
            )
            fid = telemetry.FLIGHT.record_issue(
                f"fault.{inj.action}", inj.site,
                int(ctx.get("nbytes", 0) or 0),
                tag=int(ctx.get("tag", 0) or 0),
                rank=int(ctx.get("rank", -1) or -1),
            )
            telemetry.FLIGHT.record_complete(fid)
        except Exception:  # noqa: BLE001 — accounting must not mask the fault
            logger.exception("fault-injection accounting failed")


# process-global plane; _UNSET means "env not consulted yet"
_UNSET = object()
_PLANE: Any = _UNSET
_PLANE_LOCK = threading.Lock()


def _parse_schedule(raw: str) -> Dict[str, Any]:
    raw = raw.strip()
    if raw.startswith("@"):
        with open(raw[1:], encoding="utf-8") as f:
            raw = f.read()
    doc = json.loads(raw)
    if not isinstance(doc, dict):
        raise ValueError("fault schedule must be a JSON object")
    return doc


def configure(schedule: Any = None) -> Optional[FaultPlane]:
    """Install a schedule process-wide (dict, JSON string, ``@path``, or
    None to disable). Returns the installed plane (None when disabled).
    Replaces any previous plane and resets all occurrence counters — a
    reconfigure with the same schedule replays the same sequence."""
    global _PLANE
    with _PLANE_LOCK:
        if schedule is None:
            _PLANE = None
        else:
            if isinstance(schedule, str):
                schedule = _parse_schedule(schedule)
            _PLANE = FaultPlane(schedule)
        return _PLANE


def active() -> Optional[FaultPlane]:
    """The live plane, loading ``TORCHFT_FAULT_SCHEDULE`` on first use."""
    global _PLANE
    if _PLANE is _UNSET:
        with _PLANE_LOCK:
            if _PLANE is _UNSET:
                raw = os.environ.get(ENV_SCHEDULE)
                if not raw:
                    _PLANE = None
                else:
                    try:
                        _PLANE = FaultPlane(_parse_schedule(raw))
                        logger.info(
                            "fault-injection plane armed: %d rules, seed %d",
                            len(_PLANE.rules), _PLANE.seed,
                        )
                    except Exception:  # noqa: BLE001 — bad schedule: disable
                        logger.exception(
                            "ignoring malformed %s", ENV_SCHEDULE
                        )
                        _PLANE = None
    return _PLANE


def fault_point(site: str, match: str = "", wire: bool = False,
                **ctx: Any) -> Optional[Injection]:
    """The instrumentation hook. Near-zero cost when no schedule is
    loaded (one global read). Applies ``delay``/``error``/``kill``
    inline; returns ``drop``/``torn`` injections to wire-capable call
    sites (``wire=True``) and degrades them to ``error`` elsewhere."""
    plane = _PLANE if _PLANE is not _UNSET else active()
    if plane is None:
        return None
    inj = plane.hit(site, match, ctx)
    if inj is None:
        return None
    if inj.action == "delay":
        time.sleep(inj.ms / 1000.0)
        return inj
    if inj.action == "kill":
        logger.warning(
            "fault injection: killing pid %d with signal %d at %s[%s]",
            os.getpid(), inj.sig, site, match,
        )
        os.kill(os.getpid(), inj.sig)
        return inj  # non-fatal signals (incl. sig=0 probes) return
    if inj.action == "error" or not wire:
        raise inj.make_exception()
    return inj  # drop / torn / corrupt: the call site implements them


def read_evidence(evidence_dir: Optional[str] = None) -> List[Dict[str, Any]]:
    """Parse every evidence file under ``evidence_dir`` (default: the
    ``TORCHFT_FAULT_EVIDENCE_DIR`` env) back into fired records — both
    this engine's JSONL and the native plane's single-line records."""
    import glob as _glob

    d = evidence_dir or os.environ.get(ENV_EVIDENCE_DIR)
    out: List[Dict[str, Any]] = []
    if not d:
        return out
    for path in sorted(_glob.glob(os.path.join(d, "tft_fault_*"))):
        try:
            with open(path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        continue
        except OSError:
            continue
    return out
