"""Fault-injection scenario runner — the port's copy of
``torchft_tpu/faultinject/runner.py``. It drives two (or three) replica
groups of the port's ``train_bytes`` example through a seeded failure
matrix and holds the safety invariant after every injection:

    **no committed step carries a corrupt average**: the survivors'
    parameter checksums stay finite and bit-identical across groups, or the
    step aborts, is vetoed or heals instead of committing.

Each scenario is one run of worker processes with a seeded schedule
(``TORCHFT_FAULT_SCHEDULE``) and/or native knobs (``TORCHFT_FI_*``) on a
designated victim: kills mid-allreduce on each data plane (CMA, striped TCP,
the Python ring), torn TCP hops and CMA pulls, a torn int8 frame, a serve
cut mid-heal, a striped heal losing a source, delayed votes under the
pipelined commit, and the custom runners of the fleet and forensics
planes: the straggler detector, the diagnosis bundle, the perf-regression
sentinel with the critical path, the postmortem from the black boxes alone,
and the divergence sentinel and its fence (``corrupt_divergence``).

A worker that dies with injection evidence (``TORCHFT_FAULT_EVIDENCE_DIR``)
is the scenario and is respawned with the injections scrubbed. A death with
the documented environmental-corruption signature and no evidence marks the
scenario ``environmental`` (recorded, not a failure). Anything else fails.

The workers run on the card unless ``--device cpu`` (the runner passes
``DEVICE`` on). ``--sanitize[=asan|tsan]`` builds the native core under the
sanitizer into the port's build directory, loads it into every worker
(``TORCHFT_NATIVE_LIB``, the runtime in ``LD_PRELOAD``; the runner itself
stays uninstrumented) and runs the jax-free numpy worker
(``faultinject._san_worker``) on the CPU; any sanitizer report fails the
run. A passed scenario is also replayed through a ``conformance`` checker
(a function from the workdir to findings, None when clean) when the caller
gives one; without one the report says ``"conformance": "not run"``.

Usage::

    python -m torchft_tpu_torch.faultinject.runner --quick
    python -m torchft_tpu_torch.faultinject.runner --quick --device cpu
    python -m torchft_tpu_torch.faultinject.runner --scenario torn_cma_pull
    python -m torchft_tpu_torch.faultinject.runner --sanitize --quick
    python -m torchft_tpu_torch.faultinject.runner --compiled --device cpu
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from torchft_tpu_torch.faultinject.core import (
    CORRUPTION_SIGNAL_RCS,
    ENV_CORRUPTION_SIGNATURES,
    read_evidence,
)

REPO = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
EXAMPLE_ARGV = [sys.executable, "-m", "torchft_tpu_torch.examples.train_bytes"]
SAN_WORKER_ARGV = [sys.executable, "-m", "torchft_tpu_torch.faultinject._san_worker"]
# the descriptors compiled from the protocol model checker's traces; the
# bare ``--compiled`` flag replays this set
COMPILED_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "compiled")

Conformance = Callable[[str], Optional[str]]


@dataclass
class Scenario:
    name: str
    description: str
    victim_env: Dict[str, str] = field(default_factory=dict)
    survivor_env: Dict[str, str] = field(default_factory=dict)
    common_env: Dict[str, str] = field(default_factory=dict)
    victim_schedule: Optional[dict] = None
    survivor_schedule: Optional[dict] = None
    expect_victim_death: bool = False
    quick: bool = True  # in the --quick / --sanitize subset


def _kill_issue(seed: int, nth: int = 6) -> dict:
    return {"seed": seed, "rules": [{"site": "collective.issue", "match": "allreduce",
                                     "nth": nth, "action": "kill", "sig": 9}]}


def _delay_issue(seed: int, ms: int, **when) -> dict:
    return {"seed": seed, "rules": [{"site": "collective.issue", "match": "allreduce",
                                     **when, "action": "delay", "ms": ms}]}


SCENARIOS: List[Scenario] = [
    Scenario(
        name="kill_allreduce_cma",
        description="victim SIGKILLed after publishing a CMA pull descriptor (the peer "
        "holds a descriptor into dying memory)",
        victim_env={"TORCHFT_FI_CMA_KILL": "3"},
        expect_victim_death=True,
    ),
    Scenario(
        name="kill_allreduce_tcp",
        description="victim SIGKILLed entering a striped-TCP hop mid-allreduce",
        common_env={"TORCHFT_DP_CMA": "0"},
        victim_env={"TORCHFT_FI_DP_KILL": "3"},
        expect_victim_death=True,
        quick=False,
    ),
    Scenario(
        name="kill_allreduce_python",
        description="victim SIGKILLed mid-frame-send on the Python-ring plane",
        common_env={"TORCHFT_NATIVE_PLANE": "0"},
        victim_schedule={"seed": 1, "rules": [
            {"site": "rpc.send", "nth": 4, "action": "kill", "sig": 9}]},
        expect_victim_death=True,
        quick=False,
    ),
    Scenario(
        name="torn_stripe_tcp",
        description="a striped-TCP hop is cut after half its payload (torn write); the "
        "step must latch and flush, the victim survives",
        common_env={"TORCHFT_DP_CMA": "0"},
        victim_env={"TORCHFT_FI_DP_CUT": "3:0.5"},
    ),
    Scenario(
        name="kill_streamed_bucket",
        description="victim SIGKILLed entering a striped hop while int8 streamed buckets "
        "are in flight: the survivor's step latches and flushes, and the error-feedback "
        "residuals staged for the doomed step roll back with it (a leaked residual would "
        "diverge the next committed average, so the final checksums tell)",
        common_env={"TORCHFT_DP_CMA": "0", "TORCHFT_WIRE_CODEC": "int8"},
        victim_env={"TORCHFT_FI_DP_KILL": "3"},
        expect_victim_death=True,
        quick=False,
    ),
    Scenario(
        name="torn_compressed_frame",
        description="a striped hop carrying an int8 frame is cut after half its payload: "
        "the receiver sees a mid-frame EOF (a partial scale and payload never dequantize "
        "into a committed average) and the aborted step's residuals do not leak",
        common_env={"TORCHFT_DP_CMA": "0", "TORCHFT_WIRE_CODEC": "int8"},
        victim_env={"TORCHFT_FI_DP_CUT": "3:0.5"},
    ),
    Scenario(
        name="torn_cma_pull",
        description="a CMA pull stops halfway (torn read); partial bytes must never "
        "average into a committed step",
        victim_env={"TORCHFT_FI_CMA_TORN": "3:0.5"},
        # the divergence sentinel rides along: abstaining must hold through
        # torn-op aborts (no false latch), and the sanitizer matrix drives
        # the lighthouse's digest compare
        common_env={"TORCHFT_DIVERGENCE_SENTINEL": "1"},
    ),
    Scenario(
        name="postmortem_kill_allreduce",
        description="victim SIGKILLed mid-allreduce (the CMA kill site); the postmortem, "
        "from the crash-durable black boxes alone, must name the victim, its in-flight "
        "allreduce and the quorum epoch, with checksums bit-identical after the heal "
        "(custom runner: run_postmortem_scenario)",
        victim_env={"TORCHFT_FI_CMA_KILL": "3"},
        expect_victim_death=True,
    ),
    Scenario(
        name="corrupt_divergence",
        description="corrupt(frac) perturbs one replica's finished allreduce output "
        "(collective.complete): silent, finite, no error raised. Three legs (custom "
        "runner: run_divergence_scenario): the sentinel alone latches divergence within "
        "one commit of the injection; under TORCHFT_DIVERGENCE_FENCE=1 the commit aborts "
        "instead (checksums stay bit-identical); an equal-length control soak latches "
        "nothing",
        common_env={"TORCHFT_DIVERGENCE_SENTINEL": "1"},
        victim_schedule={"seed": 6, "rules": [
            {"site": "collective.complete", "match": "allreduce", "nth": 5,
             "action": "corrupt", "frac": 0.05}]},
    ),
    Scenario(
        name="commit_vote_delay_pipeline",
        description="every 3rd commit vote delayed 150 ms under the pipelined commit",
        common_env={"TORCHFT_COMMIT_PIPELINE": "1"},
        victim_schedule={"seed": 2, "rules": [
            {"site": "commit.vote", "match": "rpc", "every": 3, "action": "delay",
             "ms": 150}]},
        quick=False,
    ),
    Scenario(
        name="straggler_group",
        description="+200 ms skew on group 1's collective submissions (collective.issue "
        "delay): the fleet straggler detector latches exactly that group once, an "
        "equal-length control soak latches nothing, and checksums stay bit-identical "
        "(custom runner: run_straggler_scenario)",
        victim_schedule=_delay_issue(4, 200, every=1),
        quick=False,
    ),
    Scenario(
        name="diagnose_straggler",
        description="+200 ms collective.issue delay and a 60 ms native stripe-hop delay on "
        "group 1: the victim's own straggler latch captures exactly one diagnosis bundle "
        "whose native stacks show the delay frame dominant in its dp.pump hot stack; the "
        "survivor captures nothing; a control soak captures nothing; checksums "
        "bit-identical; the bundle round-trips through `postmortem --bundles` (custom "
        "runner: run_diagnose_scenario)",
        victim_schedule=_delay_issue(8, 200, every=1),
        # the native delay lands in the stripe pump threads, where the
        # native sampler must find it
        victim_env={"TORCHFT_FI_DP_DELAY_MS": "60"},
        common_env={"TORCHFT_DP_CMA": "0"},
        quick=False,
    ),
    Scenario(
        name="perf_regression",
        description="+150 ms collective.issue delay on group 1 from mid-run (the `after` "
        "onset): the perf-regression sentinel latches each shifted series once, naming "
        "that group, within K commits of the onset; the critical path blames it for >=80% "
        "of the gating seconds after the onset with a what-if rate within 25% of the "
        "pre-onset rate; /timeseries.json serves the whole history across a kill and "
        "respawn; a control soak latches nothing (custom runner: "
        "run_perf_regression_scenario)",
        victim_schedule=_delay_issue(7, 150, after=13),
        quick=False,
    ),
    Scenario(
        name="stripe_heal_peer_death",
        description="3 groups (custom runner): the victim g2 is SIGKILLed mid-run and "
        "respawns into a striped heal from the two survivors; survivor g1 is SIGKILLed by "
        "the native blob plane on its first stripe serve (TORCHFT_FI_BLOB_KILL), so the "
        "healer re-stripes g1's ranges over g0; g1 respawns and heals striped; all three "
        "final checksums finite and bit-identical",
        victim_schedule=_kill_issue(5),
        # striped TCP on every group: a death on the CMA plane latches broken
        # CMA on some survivors only, and the mixed planes' state trees would
        # then differ, leaving the heal one source
        common_env={"TORCHFT_DP_CMA": "0"},
        # g1 serves its first blob range during g2's re-heal (the bootstrap
        # heals come from g0 alone)
        survivor_env={"TORCHFT_FI_BLOB_KILL": "1"},
        expect_victim_death=True,
    ),
    Scenario(
        name="ckpt_serve_death",
        description="victim killed mid-run; the survivor's first checkpoint serve to the "
        "healer is cut mid-stream: the heal retries and never stages torn state",
        victim_schedule=_kill_issue(3),
        survivor_schedule={"seed": 3, "rules": [
            {"site": "ckpt.serve", "nth": 1, "action": "drop"}]},
        expect_victim_death=True,
    ),
]


@dataclass
class Result:
    scenario: str
    status: str  # passed | environmental | failed
    detail: str = ""
    fired: int = 0
    respawns: int = 0
    checksums: Optional[List[str]] = None


def load_compiled_scenarios(compiled_dir: str) -> List[Scenario]:
    """Compiled-schedule descriptors as scenarios. A descriptor that is not
    runnable (unlowered coordinates of the HA lighthouse) is skipped out
    loud: dropping it quietly would read as coverage."""
    out: List[Scenario] = []
    for path in sorted(glob.glob(os.path.join(compiled_dir, "*.json"))):
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        if not doc.get("runnable"):
            print(f"--- {doc.get('name', path)}: SKIPPED (not runnable: "
                  f"{len(doc.get('unlowered', []))} unlowered HA action(s))")
            continue
        out.append(Scenario(
            name=doc["name"],
            description=doc.get("description", ""),
            common_env=dict(doc.get("common_env", {})),
            victim_schedule=doc.get("victim_schedule"),
            survivor_schedule=doc.get("survivor_schedule"),
            expect_victim_death=bool(doc.get("expect_victim_death")),
            quick=False,
        ))
    return out


# ---------------------------------------------------------------------------
# workers
# ---------------------------------------------------------------------------


def _env_signature(text: str) -> Optional[str]:
    for sig in ENV_CORRUPTION_SIGNATURES:
        if sig in text:
            return sig
    return None


def _prepare(workdir: str) -> str:
    """The workdir with its evidence directory and the toy corpus (a
    repeatable byte pattern); returns the evidence directory."""
    evidence_dir = os.path.join(workdir, "evidence")
    os.makedirs(evidence_dir, exist_ok=True)
    with open(os.path.join(workdir, "corpus.bin"), "wb") as f:
        f.write(bytes(range(256)) * 24)
    return evidence_dir


def _spawn(gid: int, lighthouse_addr: str, workdir: str, steps: int,
           env_extra: Dict[str, str], argv: Optional[List[str]] = None,
           num_groups: int = 2, device: str = "cuda") -> subprocess.Popen:
    env = dict(os.environ)
    env.update(
        REPLICA_GROUP_ID=str(gid),
        NUM_REPLICA_GROUPS=str(num_groups),
        STEPS=str(steps),
        BATCH="4",
        DATA_PATH=os.path.join(workdir, "corpus.bin"),
        TRACE_PATH=os.path.join(workdir, f"trace{gid}.jsonl"),
        TORCHFT_LIGHTHOUSE=lighthouse_addr,
        DEVICE=device,
        PYTHONPATH=os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p),
        TORCHFT_FAULT_EVIDENCE_DIR=os.path.join(workdir, "evidence"),
        TORCHFT_EVENT_TRAIL=os.path.join(workdir, f"trail{gid}.jsonl"),
        # every worker keeps a crash-durable black box: a failed scenario
        # collects them into a postmortem, and postmortem_kill_allreduce
        # reads them directly
        TORCHFT_BLACKBOX_DIR=os.path.join(workdir, "blackbox"),
    )
    env.update(env_extra)
    log = open(os.path.join(workdir, f"g{gid}.log"), "ab", buffering=0)
    try:
        return subprocess.Popen(argv or EXAMPLE_ARGV, env=env, stdout=log,
                                stderr=subprocess.STDOUT, cwd=REPO)
    finally:
        log.close()  # the child holds its own descriptor


def _read_log(workdir: str, gid: int) -> str:
    try:
        with open(os.path.join(workdir, f"g{gid}.log"), "rb") as f:
            return f.read().decode(errors="replace")
    except OSError:
        return ""


def _scrub(env: Dict[str, str]) -> Dict[str, str]:
    """A respawned worker's environment: injections fire in the first
    incarnation only (occurrence counters are per process, so a respawn would
    re-arm the same coordinates and die at the same point forever). The plane
    selection (``TORCHFT_DP_CMA`` and the like) stays."""
    return {k: v for k, v in env.items()
            if k != "TORCHFT_FAULT_SCHEDULE" and not k.startswith("TORCHFT_FI_")}


def _worker_env(scn: Scenario, gid: int, respawn: bool = False) -> Dict[str, str]:
    """Group 0 is the survivor, group 1 the victim."""
    env = dict(scn.common_env)
    schedule = scn.survivor_schedule if gid == 0 else scn.victim_schedule
    env.update(scn.survivor_env if gid == 0 else scn.victim_env)
    if schedule is not None:
        env["TORCHFT_FAULT_SCHEDULE"] = json.dumps(schedule)
    return _scrub(env) if respawn else env


def _lighthouse(min_replicas: int = 2):
    """A fresh lighthouse and its ``host:port``."""
    from torchft_tpu_torch.coordination import LighthouseServer

    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=min_replicas)
    return lighthouse, lighthouse.address().split("//", 1)[-1]


def _stop(procs: Dict[int, subprocess.Popen], lighthouse) -> None:
    for p in procs.values():
        if p.poll() is None:
            p.kill()
    for p in procs.values():
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass
    lighthouse.shutdown()


def _supervise(procs: Dict[int, subprocess.Popen], respawn: Callable[[int], subprocess.Popen],
               workdir: str, timeout_s: float, max_respawns: int = 4
               ) -> Tuple[str, str, int]:
    """Poll the workers to the end, respawning one that died with kill
    evidence written by its own pid. Returns ``(status, detail, respawns)``:
    ``ok`` (every worker exited 0), ``environmental``, ``failed`` or
    ``timeout``. Finished workers are classified before the all-done check:
    a victim whose kill lands in the poll window the survivor exits in is
    still respawned."""
    evidence_dir = os.path.join(workdir, "evidence")
    respawns = 0
    consumed: set = set()  # pids whose kill evidence a respawn honored
    deadline = time.monotonic() + timeout_s
    while True:
        for gid, p in list(procs.items()):
            if p.poll() is None or p.returncode == 0:
                continue
            kills = [r for r in read_evidence(evidence_dir)
                     if r.get("action") == "kill" and r.get("pid") == p.pid
                     and p.pid not in consumed]
            text = _read_log(workdir, gid)
            if kills and respawns < max_respawns:
                consumed.add(p.pid)
                respawns += 1
                procs[gid] = respawn(gid)
            elif _env_signature(text) or p.returncode in CORRUPTION_SIGNAL_RCS:
                return ("environmental",
                        f"g{gid} rc={p.returncode} sig={_env_signature(text)!r} (the documented "
                        "environmental corruption, no injection evidence)", respawns)
            else:
                return ("failed", f"g{gid} rc={p.returncode} not explained by new injection "
                        f"evidence; log tail: {text[-1500:]}", respawns)
        if all(p.poll() is not None for p in procs.values()):
            return "ok", "", respawns
        if time.monotonic() > deadline:
            alive = sorted(g for g, p in procs.items() if p.poll() is None)
            return "timeout", f"timeout after {timeout_s}s (alive: {alive})", respawns
        time.sleep(0.5)


def _wait_leg(name: str, procs: Dict[int, subprocess.Popen], workdir: str, timeout_s: float,
              poll_s: float = 0.25, on_poll: Optional[Callable[[], None]] = None
              ) -> Optional[str]:
    """Poll a leg's workers to the end (no respawns: any non-zero exit fails
    the leg), calling ``on_poll`` each round; returns an error or None."""
    deadline = time.monotonic() + timeout_s
    while True:
        if on_poll is not None:
            try:
                on_poll()
            except Exception:  # noqa: BLE001 — a scrape racing the workers is fine
                pass
        done = {g: p.poll() for g, p in procs.items()}
        for gid, rc in done.items():
            if rc is not None and rc != 0:
                return f"{name}: g{gid} rc={rc}; log tail: {_read_log(workdir, gid)[-1000:]}"
        if all(rc is not None for rc in done.values()):
            return None
        if time.monotonic() > deadline:
            return f"{name}: timeout after {timeout_s}s"
        time.sleep(poll_s)


_CHECKSUM = re.compile(r"param_checksum=(-?[\d.]+|nan|inf)")


def _checksums(workdir: str, gids=(0, 1)) -> Tuple[Optional[str], List[str]]:
    """Each group's last ``param_checksum``; returns (error, sums): the error
    names a missing, non-finite or differing checksum, else None."""
    sums: List[str] = []
    for gid in gids:
        text = _read_log(workdir, gid)
        m = _CHECKSUM.findall(text)
        if not m:
            return f"g{gid} printed no param_checksum; log tail: {text[-800:]}", sums
        sums.append(m[-1])
    if any(s in ("nan", "inf") for s in sums):
        return (f"non-finite committed checksums {sums}: corrupt averages committed (the "
                "divergence mode)"), sums
    if len(set(sums)) != 1:
        return f"checksum divergence across {len(gids)} groups: {sums}", sums
    return None, sums


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------


def run_scenario(scn: Scenario, workdir: str, steps: int = 16, timeout_s: float = 600.0,
                 extra_env: Optional[Dict[str, str]] = None,
                 worker_argv: Optional[List[str]] = None, device: str = "cuda") -> Result:
    """One 2-group run under the scenario's schedule; the victim is group 1.

    ``extra_env`` / ``worker_argv`` are the sanitizer's: its environment
    reaches the workers only (the runner stays uninstrumented) and the
    workers are the numpy worker."""
    os.makedirs(workdir, exist_ok=True)
    evidence_dir = _prepare(workdir)

    def env_of(gid: int, respawn: bool = False) -> Dict[str, str]:
        env = dict(extra_env or {})
        env.update(_worker_env(scn, gid, respawn=respawn))
        return env

    lighthouse, addr = _lighthouse()
    procs = {g: _spawn(g, addr, workdir, steps, env_of(g), worker_argv, device=device)
             for g in (0, 1)}
    try:
        status, detail, respawns = _supervise(
            procs, lambda g: _spawn(g, addr, workdir, steps, env_of(g, respawn=True),
                                    worker_argv, device=device), workdir, timeout_s)
    finally:
        _stop(procs, lighthouse)
    fired = read_evidence(evidence_dir)
    if status != "ok":
        return Result(scn.name, "environmental" if status == "environmental" else "failed",
                      detail, fired=len(fired), respawns=respawns)
    err, sums = _checksums(workdir)
    if err:
        return Result(scn.name, "failed", err, fired=len(fired), respawns=respawns,
                      checksums=sums or None)
    if (scn.victim_schedule or scn.survivor_schedule or scn.victim_env) and not fired:
        return Result(scn.name, "failed", "scenario completed but no injection fired (the "
                      "schedule's coordinates were never hit)", respawns=respawns,
                      checksums=sums)
    if scn.expect_victim_death and respawns == 0:
        return Result(scn.name, "failed", "expected an injected victim death and a respawn; "
                      "none happened", fired=len(fired), checksums=sums)
    return Result(scn.name, "passed", f"checksums {sums[0]} == {sums[1]}", fired=len(fired),
                  respawns=respawns, checksums=sums)


def run_stripe_heal_scenario(scn: Scenario, workdir: str, steps: int = 16,
                             timeout_s: float = 600.0,
                             extra_env: Optional[Dict[str, str]] = None,
                             worker_argv: Optional[List[str]] = None,
                             device: str = "cuda") -> Result:
    """``stripe_heal_peer_death``: three groups, so a striped heal has two
    sources to lose one of. g0 runs clean; g2 (the victim) is killed by its
    schedule and respawns into a striped heal from {g0, g1}; g1 carries
    ``TORCHFT_FI_BLOB_KILL=1`` and dies on its first blob range serve (a
    stripe of g2's re-heal), so the healer re-stripes over g0; g1 respawns
    and heals striped itself. Passes when both deaths carry evidence, both
    respawned, and all three groups exit 0 with one finite checksum.

    The lighthouse takes ``min_replicas=3``: with 2, the survivors would
    finish the run and exit while a respawn still starts, leaving it alone
    with a quorum that cannot form."""
    os.makedirs(workdir, exist_ok=True)
    evidence_dir = _prepare(workdir)

    def env_of(gid: int, respawn: bool = False) -> Dict[str, str]:
        env = dict(extra_env or {})
        env.update(scn.common_env)
        if gid == 1:
            env.update(scn.survivor_env)
            if scn.survivor_schedule is not None:
                env["TORCHFT_FAULT_SCHEDULE"] = json.dumps(scn.survivor_schedule)
        elif gid == 2:
            env.update(scn.victim_env)
            if scn.victim_schedule is not None:
                env["TORCHFT_FAULT_SCHEDULE"] = json.dumps(scn.victim_schedule)
        return _scrub(env) if respawn else env

    lighthouse, addr = _lighthouse(min_replicas=3)
    procs = {g: _spawn(g, addr, workdir, steps, env_of(g), worker_argv, num_groups=3,
                       device=device) for g in (0, 1, 2)}
    try:
        status, detail, respawns = _supervise(
            procs, lambda g: _spawn(g, addr, workdir, steps, env_of(g, respawn=True),
                                    worker_argv, num_groups=3, device=device),
            workdir, timeout_s)
    finally:
        _stop(procs, lighthouse)
    fired = read_evidence(evidence_dir)
    if status != "ok":
        return Result(scn.name, "environmental" if status == "environmental" else "failed",
                      detail, fired=len(fired), respawns=respawns)
    err, sums = _checksums(workdir, gids=(0, 1, 2))
    if err:
        return Result(scn.name, "failed", err, fired=len(fired), respawns=respawns,
                      checksums=sums or None)
    if not any(r.get("action") == "kill" and r.get("site") == "blob.serve" for r in fired):
        return Result(scn.name, "failed", "no blob.serve kill evidence: the stripe-serving "
                      "survivor was never killed mid-serve", fired=len(fired),
                      respawns=respawns, checksums=sums)
    if respawns < 2:
        return Result(scn.name, "failed", f"expected both the victim and the stripe-serving "
                      f"survivor to die and respawn; respawns={respawns}", fired=len(fired),
                      respawns=respawns, checksums=sums)
    return Result(scn.name, "passed", f"3-way checksums identical ({sums[0]}); the blob-serve "
                  "kill and the re-stripe survived", fired=len(fired), respawns=respawns,
                  checksums=sums)


def _leg_env(scn: Scenario, gid: int, inject: bool, delay_ms: Optional[int] = None
             ) -> Dict[str, str]:
    """A leg worker's environment: the scenario's, with the victim's schedule
    dropped in a control leg, or its delay resized to ``delay_ms``."""
    env = _worker_env(scn, gid)
    if gid == 1 and not inject:
        env.pop("TORCHFT_FAULT_SCHEDULE", None)
    elif gid == 1 and delay_ms is not None:
        sched = json.loads(env["TORCHFT_FAULT_SCHEDULE"])
        sched["rules"][0]["ms"] = int(delay_ms)
        env["TORCHFT_FAULT_SCHEDULE"] = json.dumps(sched)
    return env


def _straggler_skew_ms(ctl_p50s: Dict[str, float]) -> int:
    """The injected skew of the straggler scenarios, from a control leg's
    local-step p50s: four times the steady p50, at least 400 ms. The
    detector latches at twice the fleet median; a loaded host can double a
    step between the control leg and the injected one, and a skew of twice
    the control p50 then leaves the victim at about twice the survivor,
    where the latch is a coin toss. Four times keeps the victim near three
    times the survivor even then."""
    steady = sorted(v for v in ctl_p50s.values() if v > 0)
    return max(400, int(4000 * steady[len(steady) // 2])) if steady else 400


def run_straggler_scenario(scn: Scenario, workdir: str, steps: int = 16,
                           timeout_s: float = 600.0, device: str = "cuda") -> Result:
    """``straggler_group``: two legs, the runner hosting the fleet detector
    (a ``FleetMonitor`` polling the lighthouse's ``/cluster.json``, factor
    2.0, K 3).

    The control leg (no injection) runs first: it must emit no event, and
    its final local-step p50s size the injected leg's skew (the factor is a
    ratio to the fleet median, so the skew follows whatever step time the
    host gives that run). In the injected leg group 1 issues every
    allreduce ``_straggler_skew_ms`` late; the detector must latch
    ``train_bytes_1`` with exactly one ``straggler_detected``, and the
    checksums stay bit-identical."""
    from torchft_tpu_torch.telemetry.native import poll_cluster
    from torchft_tpu_torch.telemetry.slo import FleetMonitor, StragglerDetector

    victim_id = "train_bytes_1"

    def leg(name: str, inject: bool, delay_ms: Optional[int] = None):
        wd = os.path.join(workdir, name)
        os.makedirs(wd, exist_ok=True)
        evidence_dir = _prepare(wd)
        lighthouse, addr = _lighthouse()
        monitor = FleetMonitor(lighthouse.address(),
                               detector=StragglerDetector(factor=2.0, k=3), poll_s=0.25)
        events: List[Dict] = []
        p50s: Dict[str, float] = {}
        procs = {g: _spawn(g, addr, wd, steps, _leg_env(scn, g, inject, delay_ms),
                           device=device) for g in (0, 1)}
        try:
            # the runner is the fleet monitor: polling here keeps each leg's
            # detection sequence deterministic
            err = _wait_leg(name, procs, wd, timeout_s,
                            on_poll=lambda: events.extend(monitor.poll_once()))
            try:
                cluster = poll_cluster(lighthouse.address()) or {}
                for rid, rec in (cluster.get("replicas") or {}).items():
                    p50s[rid] = float(rec.get("local_step_p50_s") or 0.0)
            except Exception:  # noqa: BLE001 — best effort
                pass
        finally:
            _stop(procs, lighthouse)
        if err is None:
            cs_err, _sums = _checksums(wd)
            err = f"{name}: {cs_err}" if cs_err else None
        return err, events, len(read_evidence(evidence_dir)), p50s

    ctl_err, ctl_events, _fired, ctl_p50s = leg("control", inject=False)
    if ctl_err:
        return Result(scn.name, "failed", ctl_err)
    if ctl_events:
        return Result(scn.name, "failed", f"the control soak emitted detector events (false "
                      f"positives): {ctl_events}")
    delay_ms = _straggler_skew_ms(ctl_p50s)

    err, events, fired, _p50s = leg("injected", inject=True, delay_ms=delay_ms)
    if err:
        return Result(scn.name, "failed", err, fired=fired)
    detected = [e for e in events if e["event"] == "straggler_detected"]
    if len(detected) != 1:
        return Result(scn.name, "failed", f"expected exactly one latched straggler_detected, "
                      f"got {len(detected)}: {detected}", fired=fired)
    # the Manager appends a uuid4 to every replica_id: match the prefix
    if not detected[0]["group"].startswith(victim_id):
        return Result(scn.name, "failed", f"the detector named {detected[0]['group']!r}, not "
                      f"the skewed group {victim_id!r}* ({detected[0]})", fired=fired)
    if fired == 0:
        return Result(scn.name, "failed", "no injection evidence: the delay never fired")
    return Result(scn.name, "passed", f"latched {victim_id} once (p50 {detected[0]['p50_s']}s "
                  f"vs baseline {detected[0]['baseline_s']}s, {delay_ms} ms skew); the "
                  "control soak stayed clean", fired=fired)


def pump_dominance(folded: str) -> Tuple[int, int, str]:
    """(delayed, active, top stack) over the hot ``dp.pump`` stacks of a
    bundle's ``native.folded``: those doing stripe work (``run_stripe``; a
    wall-clock sampler also sees the pump threads parked in their job wait
    while the issue delay holds the step back, which is not the hot stack).
    ``delayed`` counts the samples in the injected delay's frame."""
    pump = [(line.rpartition(" ")[0], int(line.rpartition(" ")[2]))
            for line in folded.splitlines()
            if line.startswith("dp.pump") and line.rpartition(" ")[2].isdigit()]
    active = [(s, c) for s, c in pump if "run_stripe" in s]
    delayed = sum(c for s, c in active if "sleep_ms" in s or "nanosleep" in s)
    top = max(active, key=lambda sc: sc[1])[0] if active else ""
    return delayed, sum(c for _s, c in active), top


def run_diagnose_scenario(scn: Scenario, workdir: str, steps: int = 24,
                          timeout_s: float = 600.0,
                          extra_env: Optional[Dict[str, str]] = None,
                          worker_argv: Optional[List[str]] = None,
                          device: str = "cuda") -> Result:
    """``diagnose_straggler``: detection to diagnosis in the victim's own
    process.

    Injected leg: group 1 issues every allreduce late (``_straggler_skew_ms``
    of the control leg's step p50s) and sleeps 60 ms in every native stripe
    hop. Both workers host a ``FleetMonitor``
    (``TORCHFT_STRAGGLER_MONITOR=1``, factor 2.0, K 3) and a
    ``DiagnosisEngine`` on one fleet directory. The victim's monitor
    latches ``straggler_detected`` naming itself and its engine captures;
    the survivor's latches the same event and its remote-subject filter
    drops it. Held: one bundle fleet-wide, the victim's, whose
    ``native.folded`` has the delay frame on top of the hot ``dp.pump``
    stacks and in half their samples or more; the bundle folds into
    ``postmortem --bundles``; checksums bit-identical. Control leg: no
    injection, no bundle.

    Under ``--sanitize`` the numpy worker runs with the native sampler at
    97 Hz. Its allreduce wait is no ledger barrier, so the delay inflates
    both groups' local time and the straggler compare cannot tell them
    apart: the legs trigger through the victim's step-time SLO
    (``TORCHFT_SLO_STEP_S``) instead, the same latch-to-capture path; the
    dominance is held only when the bundle has native stacks (sanitizer
    scheduling skews the sampling)."""
    from torchft_tpu_torch.telemetry import postmortem
    from torchft_tpu_torch.telemetry.diagnosis import read_bundles
    from torchft_tpu_torch.telemetry.native import poll_cluster

    sanitized = worker_argv is not None
    if sanitized:
        # the SLO's min-events floor (8) sets the earliest latch: leave the
        # capture window room to finish before the worker exits
        steps = max(steps, 20)
    victim_id = "san_worker_1" if sanitized else "train_bytes_1"

    def leg(name: str, inject: bool, delay_ms: Optional[int] = None):
        wd = os.path.join(workdir, name)
        os.makedirs(wd, exist_ok=True)
        evidence_dir = _prepare(wd)
        leg_diag = os.path.join(wd, "diag")
        os.makedirs(leg_diag, exist_ok=True)
        lighthouse, addr = _lighthouse()
        p50s: Dict[str, float] = {}

        def env_of(gid: int) -> Dict[str, str]:
            env = dict(extra_env or {})
            env.update(_leg_env(scn, gid, True, delay_ms))
            env.update(
                # one fleet directory: "exactly one bundle" is a fleet claim
                TORCHFT_DIAG_DIR=leg_diag,
                TORCHFT_DIAG_WINDOW_S="1.5",
                TORCHFT_PROF_BURST_HZ="97",
                # every group hosts the detector: the victim must latch itself
                TORCHFT_STRAGGLER_MONITOR="1",
                TORCHFT_STRAGGLER_FACTOR="2.0",
                TORCHFT_STRAGGLER_K="3",
                TORCHFT_STRAGGLER_POLL_S="0.25",
            )
            if sanitized:
                env["TORCHFT_PROF_HZ"] = "97"
                env["TORCHFT_DIAG_WINDOW_S"] = "0.75"
                env.pop("TORCHFT_STRAGGLER_MONITOR", None)
                if gid == 1 and inject:
                    env["TORCHFT_SLO_STEP_S"] = "0.01"
            return env if inject else _scrub(env)

        procs = {g: _spawn(g, addr, wd, steps, env_of(g), worker_argv, device=device)
                 for g in (0, 1)}
        try:
            err = _wait_leg(name, procs, wd, timeout_s)
            try:
                cluster = poll_cluster(lighthouse.address()) or {}
                for rid, rec in (cluster.get("replicas") or {}).items():
                    p50s[rid] = float(rec.get("local_step_p50_s") or 0.0)
            except Exception:  # noqa: BLE001 — best effort
                pass
        finally:
            _stop(procs, lighthouse)
        if err is None:
            cs_err, _sums = _checksums(wd)
            err = f"{name}: {cs_err}" if cs_err else None
        return err, leg_diag, len(read_evidence(evidence_dir)), p50s

    # the control leg first: no bundle may appear, and its step p50s size
    # the injected leg's issue delay (the straggler compare is a ratio, so
    # the skew follows whatever step time the host gives this run; the
    # SLO-triggered sanitizer legs keep the scenario's 200 ms)
    ctl_err, diag_ctl, _, ctl_p50s = leg("control", inject=False)
    if ctl_err:
        return Result(scn.name, "failed", ctl_err)
    ctl_bundles = read_bundles(diag_ctl)
    if ctl_bundles:
        return Result(scn.name, "failed", f"the control soak captured {len(ctl_bundles)} "
                      f"bundle(s): {[x.get('bundle') for x in ctl_bundles]}")
    delay_ms = None if sanitized else _straggler_skew_ms(ctl_p50s)
    err, diag_inj, fired, _ = leg("injected", inject=True, delay_ms=delay_ms)
    if err:
        return Result(scn.name, "failed", err, fired=fired)
    if fired == 0:
        return Result(scn.name, "failed", "no injection evidence: the delay never fired")
    bundles = read_bundles(diag_inj)
    if (len(bundles) < 1) if sanitized else (len(bundles) != 1):
        return Result(scn.name, "failed", f"expected exactly one diagnosis bundle fleet-wide, "
                      f"got {len(bundles)}: {[b.get('bundle') for b in bundles]}", fired=fired)
    b = bundles[0]
    expect_trigger = "slo_breach" if sanitized else "straggler_detected"
    trigger = (b.get("trigger") or {}).get("event")
    if trigger != expect_trigger:
        return Result(scn.name, "failed", f"the bundle's trigger is {trigger!r}, not "
                      f"{expect_trigger} ({b})", fired=fired)
    replica = str(b.get("replica_id") or "")
    if not replica.startswith(victim_id):
        return Result(scn.name, "failed", f"bundle written by {replica!r}, not the victim "
                      f"{victim_id!r}*: the remote-subject filter failed", fired=fired)
    try:
        with open(os.path.join(b["_dir"], "native.folded"), encoding="utf-8") as f:
            folded = f.read()
    except OSError:
        folded = ""
    delayed, total, top = pump_dominance(folded)
    if total:
        if not ("sleep_ms" in top or "nanosleep" in top) or delayed * 2 < total:
            return Result(scn.name, "failed", f"the delay frame is not dominant in the "
                          f"victim's native hot stack: {delayed}/{total} active pump samples, "
                          f"top stack {top[:200]!r}", fired=fired)
        dominance = f"{delayed}/{total} active pump samples in the delay frame"
    elif not sanitized:
        return Result(scn.name, "failed", "the bundle holds no active dp.pump native stacks "
                      f"(folded: {folded[:300]!r})", fired=fired)
    else:
        dominance = "no active native stacks (sanitizer skew: ok)"
    # the postmortem folds the bundle into the causal timeline from disk alone
    report = postmortem.analyze(workdir, bundles_dir=diag_inj)
    caps = [r for r in report["timeline"] if r.get("k") == "diagnosis_captured"]
    if not report.get("bundles") or not caps:
        return Result(scn.name, "failed", "postmortem --bundles did not fold the bundle into "
                      f"the timeline (bundles={report.get('bundles')})", fired=fired)

    return Result(scn.name, "passed", f"one bundle by {replica} ({dominance}, "
                  f"{delay_ms or 200} ms issue delay); the postmortem round trip held; the "
                  "control soak captured none", fired=fired)


def run_perf_regression_scenario(scn: Scenario, workdir: str, steps: int = 16,
                                 timeout_s: float = 600.0, device: str = "cuda") -> Result:
    """``perf_regression``: three legs, the runner hosting the regression
    sentinel (``RegressionMonitor``) and the critical-path attributor
    (``CriticalPathMonitor``) over the live lighthouse's
    ``/timeseries.json``.

    Control leg: no injection; no regression may latch. Injected leg: group
    1 issues every allreduce late from the onset occurrence on (a level
    shift, twice the control leg's median step wall, at least 300 ms).
    Held: every latch names the victim and each (replica, series) latches
    once; the first latch within K=10 commits of the onset step; >=80% of
    the post-onset blame on the victim; the post-onset what-if rate within
    25% of the same leg's pre-onset rate (a reference that shares the
    host's load); checksums bit-identical. Persistence leg: group 1 is
    killed mid-run and respawned; ``/timeseries.json`` must still serve the
    dead incarnation's ring beside the respawn's."""
    from torchft_tpu_torch import _native
    from torchft_tpu_torch.telemetry.critical_path import CriticalPathMonitor
    from torchft_tpu_torch.telemetry.events import read_trail
    from torchft_tpu_torch.telemetry.regression import RegressionDetector, RegressionMonitor
    from torchft_tpu_torch.telemetry.timeseries import poll_timeseries

    victim_id = "train_bytes_1"
    leg_steps = max(steps, 28)  # the detector's warm-up, the onset, the margin
    k_commits = 10
    # a little wider than the defaults: two workers on few cores jitter
    det_cfg = dict(delta=0.1, lam=4.0, min_n=8, k=4)

    def leg(name: str, inject: bool, delay_ms: Optional[int] = None):
        wd = os.path.join(workdir, name)
        os.makedirs(wd, exist_ok=True)
        evidence_dir = _prepare(wd)
        # the time-series store is process-wide: this process hosts many
        # lighthouses, and an earlier leg's rings (same steps, other
        # replicas) would mix into this leg's rows
        _native.tsdb_reset()
        lighthouse, addr = _lighthouse()
        monitor = RegressionMonitor(lighthouse.address(),
                                    detector=RegressionDetector(**det_cfg), poll_s=0.25)
        cpm = CriticalPathMonitor(lighthouse.address())
        events: List[Dict] = []
        atts: List[Dict] = []

        def poll() -> None:
            # one fetch feeds both consumers
            reply = poll_timeseries(lighthouse.address())
            if reply:
                events.extend(monitor.poll_once(reply=reply))
                atts.extend(cpm.poll_once(reply=reply))

        procs = {g: _spawn(g, addr, wd, leg_steps, _leg_env(scn, g, inject, delay_ms),
                           device=device) for g in (0, 1)}
        try:
            err = _wait_leg(name, procs, wd, timeout_s, on_poll=poll)
            # the last steps' samples land with the final quorum RPCs
            try:
                events.extend(monitor.poll_once())
                atts.extend(cpm.poll_once())
                atts.extend(cpm.drain())
            except Exception:  # noqa: BLE001
                pass
        finally:
            _stop(procs, lighthouse)
        if err is None:
            cs_err, _sums = _checksums(wd)
            err = f"{name}: {cs_err}" if cs_err else None
        evidence = read_evidence(evidence_dir)
        onset_ts = min((r["ts"] for r in evidence if r.get("action") == "delay"), default=None)
        return err, events, atts, len(evidence), onset_ts, wd

    def onset_step(wd: str, onset_ts: Optional[float]) -> int:
        """The first step the victim committed after the first delay fired
        (evidence carries wall time; the trail carries each commit's)."""
        if onset_ts is None:
            return -1
        try:
            trail = read_trail(os.path.join(wd, "trail1.jsonl"))
        except OSError:
            return -1
        commits = sorted((r["ts"], r.get("step", -1)) for r in trail
                         if r.get("event") == "commit")
        return next((int(step) for ts, step in commits if ts >= onset_ts), -1)

    err, ctl_events, ctl_atts, _f, _o, _wd = leg("control", inject=False)
    if err:
        return Result(scn.name, "failed", err)
    ctl_regressions = [e for e in ctl_events if e["event"] == "perf_regression"]
    if ctl_regressions:
        return Result(scn.name, "failed", f"the control soak latched regressions (false "
                      f"positives): {ctl_regressions}")
    if not ctl_atts:
        return Result(scn.name, "failed", "the control leg produced no critical-path "
                      "attributions (no per-step series reached the lighthouse?)")
    # twice the control leg's median steady wall (past the first 8 steps)
    # triples the step: once would double it, which a host whose load
    # doubles the step between the legs brings down to a third more, and
    # the relative Page-Hinkley then latches past K commits or not at all
    ctl_walls = sorted(a["wall_s"] for a in ctl_atts
                       if a.get("wall_s") and a.get("step") is not None and a["step"] >= 8)
    delay_ms = max(300, int(2000 * ctl_walls[len(ctl_walls) // 2])) if ctl_walls else 300

    err, events, atts, fired, onset_ts, wd = leg("injected", inject=True, delay_ms=delay_ms)
    if err:
        return Result(scn.name, "failed", err, fired=fired)
    if fired == 0:
        return Result(scn.name, "failed", "no injection evidence: the delay never fired")
    regressions = [e for e in events if e["event"] == "perf_regression"]
    if not regressions:
        return Result(scn.name, "failed", f"the sentinel latched nothing across {len(atts)} "
                      f"attributed steps (events: {events})", fired=fired)
    wrong = [e for e in regressions if not e["replica"].startswith(victim_id)]
    if wrong:
        return Result(scn.name, "failed", f"the sentinel named non-injected replicas: {wrong}",
                      fired=fired)
    seen = [e["series"] for e in regressions]
    if len(seen) != len(set(seen)):
        return Result(scn.name, "failed", f"a series latched twice in one episode: "
                      f"{regressions}", fired=fired)
    onset = onset_step(wd, onset_ts)
    first_latch = min(e["step"] for e in regressions)
    if onset >= 0 and first_latch > onset + k_commits:
        return Result(scn.name, "failed", f"first latch at step {first_latch}, more than "
                      f"{k_commits} commits after the onset step {onset}", fired=fired)
    post = [a for a in atts if a.get("step") is not None
            and (onset < 0 or a["step"] >= onset) and a.get("blame_s", 0) > 0]
    blame_by: Dict[str, float] = {}
    for a in post:
        blame_by[a["gating"]] = blame_by.get(a["gating"], 0.0) + a["blame_s"]
    total_blame = sum(blame_by.values())
    victim_blame = sum(s for r, s in blame_by.items() if r.startswith(victim_id))
    if total_blame <= 0 or victim_blame < 0.8 * total_blame:
        return Result(scn.name, "failed", f"post-onset blame not >=80% on {victim_id}: "
                      f"{blame_by} (onset step {onset})", fired=fired)
    # the what-if: removing the gater's excess should give back the rate the
    # same leg ran at before the onset (past the warm-up steps)
    pre_walls = [a["wall_s"] for a in atts
                 if a.get("wall_s") and a.get("step") is not None
                 and 8 <= a["step"] < (onset if onset >= 0 else 10 ** 9)]
    post_whatif = [a["whatif_wall_s"] for a in post if a.get("whatif_wall_s")]
    whatif_sps = len(post_whatif) / sum(post_whatif) if post_whatif else 0.0
    pre_sps = len(pre_walls) / sum(pre_walls) if pre_walls else 0.0
    if not whatif_sps or not pre_sps or abs(whatif_sps / pre_sps - 1.0) > 0.25:
        return Result(scn.name, "failed", f"what-if estimate {whatif_sps:.3f} steps/s not "
                      f"within 25% of the pre-onset rate {pre_sps:.3f} steps/s", fired=fired)

    p_err = _persistence_leg(workdir, leg_steps, timeout_s, device)
    if p_err:
        return Result(scn.name, "failed", p_err, fired=fired)
    return Result(scn.name, "passed", f"latched {sorted(set(seen))} on {victim_id}* at step "
                  f"{first_latch} (onset {onset}); post-onset blame "
                  f"{victim_blame / total_blame:.0%}; what-if {whatif_sps:.2f} vs pre-onset "
                  f"{pre_sps:.2f} steps/s ({len(ctl_atts)}-step control soak: no latch); the "
                  "kill/respawn history served", fired=fired)


def _persistence_leg(workdir: str, steps: int, timeout_s: float, device: str) -> Optional[str]:
    """Kill group 1 mid-run, respawn it, and hold that ``/timeseries.json``
    still serves both incarnations' rings (the dead one's history up to the
    kill beside the respawn's). Returns an error or None."""
    from torchft_tpu_torch import _native
    from torchft_tpu_torch.telemetry.timeseries import poll_timeseries

    wd = os.path.join(workdir, "persistence")
    os.makedirs(wd, exist_ok=True)
    evidence_dir = _prepare(wd)
    kill = {"TORCHFT_FAULT_SCHEDULE": json.dumps(_kill_issue(8))}
    _native.tsdb_reset()  # the earlier legs' rings (see the legs)
    lighthouse, addr = _lighthouse()
    procs = {0: _spawn(0, addr, wd, steps, {}, device=device),
             1: _spawn(1, addr, wd, steps, kill, device=device)}
    err: Optional[str] = None
    try:
        status, detail, respawns = _supervise(
            procs, lambda g: _spawn(g, addr, wd, steps, {}, device=device), wd, timeout_s,
            max_respawns=1)
        if status != "ok":
            err = f"persistence: {detail}"
        elif not respawns or not read_evidence(evidence_dir):
            err = "persistence: the scheduled kill never fired"
        else:
            # before the lighthouse goes: the dead incarnation's ring must
            # still be there, beside the respawn's
            reply = poll_timeseries(lighthouse.address())
            if not reply:
                err = "persistence: /timeseries.json unreachable"
            else:
                rings = {rid: body for rid, body in reply["replicas"].items()
                         if "local_s" in body}
                g1 = [r for r in rings if r.startswith("train_bytes_1")]
                if len(g1) < 2:
                    err = (f"persistence: expected both g1 incarnations' rings (dead and "
                           f"respawned), got {sorted(rings)}")
                else:
                    counts = {r: len(rings[r]["local_s"]["samples"]) for r in g1}
                    max_step = max(s[1] for body in rings.values()
                                   for s in body["local_s"]["samples"])
                    if min(counts.values()) < 1:
                        err = f"persistence: an incarnation's ring is empty: {counts}"
                    elif max_step < steps - 4:
                        err = f"persistence: the history stops at step {max_step} of {steps}"
    finally:
        _stop(procs, lighthouse)
    if err is None:
        cs_err, _sums = _checksums(wd)
        err = f"persistence: {cs_err}" if cs_err else None
    return err


def run_postmortem_scenario(scn: Scenario, workdir: str, steps: int = 16,
                            timeout_s: float = 600.0,
                            extra_env: Optional[Dict[str, str]] = None,
                            worker_argv: Optional[List[str]] = None,
                            device: str = "cuda") -> Result:
    """``postmortem_kill_allreduce``: the mid-allreduce kill run, then the
    postmortem over the crash-durable black boxes alone (not the logs, not
    the evidence) must name the victim replica, its in-flight op and the
    quorum epoch it died in."""
    from torchft_tpu_torch.telemetry import postmortem

    res = run_scenario(scn, workdir, steps=steps, timeout_s=timeout_s, extra_env=extra_env,
                       worker_argv=worker_argv, device=device)
    if res.status != "passed":
        return res

    def failed(detail: str) -> Result:
        return Result(scn.name, "failed", detail, fired=res.fired, respawns=res.respawns,
                      checksums=res.checksums)

    report = postmortem.analyze(os.path.join(workdir, "blackbox"))
    victim = report.get("victim") or ""
    # group 1's replica_id is the worker's prefix and a uuid4; a bare "pid:N"
    # means the boxes never carried the replica
    if not victim.startswith(("train_bytes_1", "san_worker_1")):
        return failed(f"the postmortem (black boxes alone) named victim {victim!r}, not group "
                      f"1's replica; report: {postmortem.render_text(report)}")
    op = report.get("victim_inflight_op") or {}
    if op.get("op") != "allreduce":
        return failed(f"the postmortem named in-flight op {op!r}, not an allreduce")
    epoch = report.get("victim_epoch")
    if not isinstance(epoch, int) or epoch < 0:
        return failed(f"the postmortem recovered no quorum epoch for the victim ({epoch!r})")
    with open(os.path.join(workdir, "evidence", "postmortem.json"), "w",
              encoding="utf-8") as f:
        json.dump(report, f, indent=1, default=str)
    return Result(scn.name, "passed", f"the black boxes alone named victim={victim} inflight="
                  f"{op.get('op')} epoch={epoch}; checksums {res.checksums[0]} == "
                  f"{res.checksums[1]}", fired=res.fired, respawns=res.respawns,
                  checksums=res.checksums)


def run_divergence_scenario(scn: Scenario, workdir: str, steps: int = 16,
                            timeout_s: float = 600.0,
                            extra_env: Optional[Dict[str, str]] = None,
                            worker_argv: Optional[List[str]] = None,
                            device: str = "cuda") -> Result:
    """``corrupt_divergence``: three legs.

    Sentinel leg: ``corrupt(frac)`` perturbs group 1's finished allreduce
    output once. Nothing errors and the corrupt average commits, so the
    final checksums may differ; held: the lighthouse's commit-time digest
    compare latched (``divergence_total >= 1``) and a worker's trail records
    ``divergence_detected`` within one commit of the corrupted step (read
    from the black box, whose mirror of ``fault_injected`` carries the
    Manager's step).

    Fence leg: the same injection under ``TORCHFT_DIVERGENCE_FENCE=1``; the
    lighthouse decides before the decision is published, the corrupt commit
    is vetoed on every group (an ``abort``), and the final checksums are
    finite and bit-identical.

    Control leg: sentinel and fence armed, no injection:
    ``divergence_total`` must be 0 (committed state is bit-identical by
    construction, so any latch is a false positive)."""
    import urllib.request

    from torchft_tpu_torch.telemetry.events import read_trail
    from torchft_tpu_torch.telemetry.postmortem import collect_boxes

    def leg(name: str, inject: bool, fence: bool):
        wd = os.path.join(workdir, name)
        os.makedirs(wd, exist_ok=True)
        evidence_dir = _prepare(wd)
        lighthouse, addr = _lighthouse()
        status: Dict = {}
        procs: Dict[int, subprocess.Popen] = {}
        try:
            for gid in (0, 1):
                env = dict(extra_env or {})
                env.update(_worker_env(scn, gid))
                if not inject:
                    env.pop("TORCHFT_FAULT_SCHEDULE", None)
                if fence:
                    env["TORCHFT_DIVERGENCE_FENCE"] = "1"
                procs[gid] = _spawn(gid, addr, wd, steps, env, worker_argv, device=device)
            err = _wait_leg(name, procs, wd, timeout_s, poll_s=0.5)
            # the latch lives in the lighthouse: scrape it before it goes
            try:
                with urllib.request.urlopen(f"http://{addr}/status.json", timeout=5) as resp:
                    status = json.loads(resp.read().decode())
            except Exception as e:  # noqa: BLE001
                err = err or f"{name}: lighthouse scrape failed: {e}"
        finally:
            _stop(procs, lighthouse)
        trails = {gid: read_trail(os.path.join(wd, f"trail{gid}.jsonl")) for gid in (0, 1)}
        sums = []
        for gid in (0, 1):
            m = _CHECKSUM.findall(_read_log(wd, gid))
            sums.append(m[-1] if m else "")
        fired[name] = len(read_evidence(evidence_dir))
        return err, status, trails, sums

    fired: Dict[str, int] = {}
    err, status, trails, sums = leg("sentinel", inject=True, fence=False)
    if err:
        return Result(scn.name, "failed", err)
    if not fired["sentinel"]:
        return Result(scn.name, "failed", "sentinel leg: the corrupt injection never fired")
    if int(status.get("divergence_total", 0)) < 1:
        return Result(scn.name, "failed", f"a corrupt output committed but the sentinel never "
                      f"latched (divergence_total={status.get('divergence_total')})")
    corrupt_steps = [r.get("st")
                     for b in collect_boxes(os.path.join(workdir, "sentinel", "blackbox"))
                     for r in b["records"]
                     if r.get("k") == "fault_injected" and r.get("action") == "corrupt"]
    injected = [s for s in corrupt_steps if isinstance(s, int) and s >= 0]
    detected = sorted(r.get("step", 10 ** 9) for t in trails.values() for r in t
                      if r.get("event") == "divergence_detected")
    if not detected:
        return Result(scn.name, "failed", "the lighthouse latched but no worker trail holds "
                      "divergence_detected (the reply's flag never surfaced)")
    corrupt_step = min(injected) if injected else None
    if corrupt_step is not None and detected[0] > corrupt_step + 1:
        return Result(scn.name, "failed", f"the sentinel latched at step {detected[0]}, more "
                      f"than one commit after the injection at step {corrupt_step}")
    if any(s in ("nan", "inf", "") for s in sums):
        return Result(scn.name, "failed", f"the sentinel leg ended with non-finite or missing "
                      f"checksums {sums}")

    err, status, trails, sums = leg("fence", inject=True, fence=True)
    if err:
        return Result(scn.name, "failed", err)
    if not fired["fence"]:
        return Result(scn.name, "failed", "fence leg: the corrupt injection never fired")
    if int(status.get("divergence_total", 0)) < 1:
        return Result(scn.name, "failed", f"fence leg: the sentinel never latched "
                      f"(divergence_total={status.get('divergence_total')})")
    if not any(r.get("event") == "abort" for t in trails.values() for r in t):
        return Result(scn.name, "failed", "fence leg: divergence latched but no abort "
                      "recorded: the fence did not veto the corrupt commit")
    if any(s in ("nan", "inf", "") for s in sums) or sums[0] != sums[1]:
        return Result(scn.name, "failed", f"fence leg: checksums {sums}: the vetoed "
                      "corruption reached committed state")

    err, status, _trails, ctl_sums = leg("control", inject=False, fence=True)
    if err:
        return Result(scn.name, "failed", err)
    if int(status.get("divergence_total", 0)) != 0:
        return Result(scn.name, "failed", f"control soak false positive: divergence_total="
                      f"{status.get('divergence_total')} with no injection")
    if any(s in ("nan", "inf", "") for s in ctl_sums) or ctl_sums[0] != ctl_sums[1]:
        return Result(scn.name, "failed", f"control leg checksums {ctl_sums}")
    return Result(scn.name, "passed", f"sentinel latched at step {detected[0]} (corrupt at "
                  f"{corrupt_step}); the fence aborted with identical checksums {sums[0]}; "
                  "the control soak stayed clean", fired=fired["sentinel"] + fired["fence"],
                  checksums=sums)


def collect_postmortem(workdir: str, detail: str = "") -> Optional[str]:
    """Forensics after a failed or environmental scenario: the run's black
    boxes, trails, evidence and log tails merged into one postmortem report
    under the evidence directory. Returns its path (None when nothing could
    be written): a broken postmortem never masks the scenario's failure."""
    try:
        from torchft_tpu_torch.telemetry import postmortem

        evidence_dir = os.path.join(workdir, "evidence")
        os.makedirs(evidence_dir, exist_ok=True)
        logs = []
        for path in sorted(glob.glob(os.path.join(workdir, "g*.log"))):
            try:
                with open(path, errors="replace") as f:
                    logs.append(f.read()[-20000:])
            except OSError:
                pass
        report = postmortem.analyze(workdir, log_text="\n".join(logs))
        report["scenario_detail"] = detail
        out = os.path.join(evidence_dir, "postmortem.json")
        with open(out, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=1, default=str)
        print(f"    postmortem ({report['classification']}): {out}")
        return out
    except Exception as e:  # noqa: BLE001 — forensics must not mask failures
        print(f"    postmortem collection failed: {e}")
        return None


# ---------------------------------------------------------------------------
# sanitizer mode
# ---------------------------------------------------------------------------


def _libsan_path(runtime: str) -> str:
    name = f"lib{runtime}.so"
    out = subprocess.run(["g++", "-print-file-name=" + name], capture_output=True, text=True,
                         check=True).stdout.strip()
    if not out or out == name:
        raise RuntimeError(f"{name} not found (is gcc installed?)")
    return out


def build_sanitized(kind: str) -> str:
    """``make -C native CXX=g++ OUTDIR=<the port's build directory> <kind>``;
    returns the sanitized library's path. ``CXX=g++`` for the reason
    ``_native.build`` gives (one libstdc++ in the process)."""
    from torchft_tpu_torch import _native
    from torchft_tpu_torch.utils.platform import build_dir, run_locked_build

    out_dir = os.path.join(build_dir("torch_native"), _native._sources_digest())
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"libtftcore_{kind}.so")
    return run_locked_build(lib, ["make", "-s", "-C", _native._NATIVE_SRC, "CXX=g++",
                                  f"OUTDIR={out_dir}", kind])


def sanitize_env(outdir: str, kind: str) -> Dict[str, str]:
    """The workers' environment under the sanitizer ``kind``."""
    env = {"TORCHFT_NATIVE_LIB": build_sanitized(kind), "LD_PRELOAD": _libsan_path(kind)}
    if kind == "asan":
        # the interpreter leaks by design; the hunt is for corruption
        env["ASAN_OPTIONS"] = ("detect_leaks=0:abort_on_error=1:handle_abort=1:"
                               f"log_path={os.path.join(outdir, 'asan')}")
    else:
        # exitcode=0: a report must not kill the worker mid-scenario (the
        # checksums still have to be checked); the gate is the log scan.
        # Only the native library is instrumented, but the interpreter's
        # pthread use is intercepted, so happens-before through the GIL and
        # ctypes is tracked.
        env["TSAN_OPTIONS"] = ("exitcode=0:report_thread_leaks=0:second_deadlock_stack=1:"
                               f"log_path={os.path.join(outdir, 'tsan')}")
    return env


_SAN_REPORT_MARKERS = (
    "ERROR: AddressSanitizer",
    "WARNING: ThreadSanitizer",
    "ERROR: ThreadSanitizer",
    "runtime error:",
)


def scan_san_reports(outdir: str, kind: str) -> List[str]:
    hits = []
    for path in sorted(glob.glob(os.path.join(outdir, f"{kind}.*"))):
        try:
            with open(path, errors="replace") as f:
                text = f.read()
        except OSError:
            continue
        if any(m in text for m in _SAN_REPORT_MARKERS):
            hits.append(path)
    return hits


# ---------------------------------------------------------------------------
# the matrix
# ---------------------------------------------------------------------------

# the scenarios with a custom runner, and whether it takes the sanitizer's
# worker (those that need the model's anatomy piggyback do not)
_CUSTOM = {
    "straggler_group": (run_straggler_scenario, False),
    "diagnose_straggler": (run_diagnose_scenario, True),
    "perf_regression": (run_perf_regression_scenario, False),
    "stripe_heal_peer_death": (run_stripe_heal_scenario, True),
    "postmortem_kill_allreduce": (run_postmortem_scenario, True),
    "corrupt_divergence": (run_divergence_scenario, True),
}


def run_one(scn: Scenario, workdir: str, steps: int, timeout_s: float, device: str = "cuda",
            extra_env: Optional[Dict[str, str]] = None,
            worker_argv: Optional[List[str]] = None,
            conformance: Optional[Conformance] = None) -> Tuple[Result, str]:
    """One scenario through its runner, then through ``conformance`` when
    it passed. Returns the result and the conformance verdict: ``clean``,
    ``not run`` (no checker, or the scenario did not pass) or the
    findings."""
    fn, sanitizable = _CUSTOM.get(scn.name, (run_scenario, True))
    kwargs = dict(steps=steps, timeout_s=timeout_s, device=device)
    if sanitizable:
        kwargs.update(extra_env=extra_env, worker_argv=worker_argv)
    elif worker_argv is not None:
        raise ValueError(f"{scn.name} is not wired for --sanitize (it needs the model's "
                         "anatomy piggyback); run it unsanitized")
    res = fn(scn, workdir, **kwargs)
    verdict = "not run"
    if res.status == "passed" and conformance is not None:
        try:
            findings = conformance(workdir)
        except Exception as e:  # noqa: BLE001 — a broken checker must be loud
            findings = f"the conformance replay itself failed: {e}"
        verdict = "clean" if findings is None else findings
        if findings is not None:
            res = Result(res.scenario, "failed", f"spec-conformance violation: {findings}",
                         fired=res.fired, respawns=res.respawns, checksums=res.checksums)
    return res, verdict


def main(argv: Optional[List[str]] = None,
         conformance: Optional[Conformance] = None) -> int:
    """The CLI. ``conformance`` (a function from a workdir to findings,
    None when clean) replays each passed scenario; with none given the
    report says the check was not run."""
    ap = argparse.ArgumentParser(prog="faultinject-runner", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scenario", action="append", default=None,
                    help="run only these scenarios (repeatable)")
    ap.add_argument("--quick", action="store_true",
                    help="the quick subset, fewer steps")
    ap.add_argument("--sanitize", nargs="?", const="asan", default=None,
                    choices=("asan", "tsan"), metavar="{asan,tsan}",
                    help="build the native core under the sanitizer (default asan), run the "
                    "numpy worker on the CPU, and fail on any report")
    ap.add_argument("--compiled", nargs="?", const=COMPILED_DIR, default=None, metavar="DIR",
                    help="also run the compiled-schedule descriptors under DIR (default: the "
                    "shipped set); with no --scenario/--quick, only those")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="wall-clock cap per scenario (seconds)")
    ap.add_argument("--outdir", default=None, help="working directory (default: a new temp dir)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the workers train (default: the card)")
    ap.add_argument("--list", action="store_true", help="list the scenarios")
    args = ap.parse_args(argv)

    if args.list:
        for s in SCENARIOS:
            print(f"{s.name:28s} {'[quick] ' if s.quick else '':8s}{s.description}")
        return 0

    compiled = load_compiled_scenarios(args.compiled) if args.compiled else []
    selected = SCENARIOS
    if args.scenario:
        by_name = {s.name: s for s in SCENARIOS + compiled}
        unknown = [n for n in args.scenario if n not in by_name]
        if unknown:
            ap.error(f"unknown scenario(s) {unknown}; see --list")
        selected = [by_name[n] for n in args.scenario]
    elif args.quick or args.sanitize:
        selected = [s for s in SCENARIOS if s.quick] + compiled
    elif args.compiled:
        selected = compiled
    if args.sanitize:
        refused = [s.name for s in selected if not _CUSTOM.get(s.name, (None, True))[1]]
        if refused:
            ap.error(f"{refused} are not wired for --sanitize (they need the model's anatomy "
                     "piggyback); run them unsanitized")
    elif args.device == "cuda":
        from torchft_tpu_torch.utils.platform import resolve_device

        resolve_device("cuda")  # no quiet fallback: --device cpu asks for the CPU

    outdir = args.outdir or tempfile.mkdtemp(prefix="tft_torch_faultmatrix_")
    os.makedirs(outdir, exist_ok=True)
    steps = args.steps or (10 if (args.quick or args.sanitize) else 16)
    extra_env: Optional[Dict[str, str]] = None
    worker_argv: Optional[List[str]] = None
    if args.sanitize:
        # the workers only: the runner's own lighthouse must not load the
        # sanitized core without its preloaded runtime
        extra_env = sanitize_env(outdir, args.sanitize)
        worker_argv = SAN_WORKER_ARGV
        print(f"sanitizer armed ({args.sanitize}): {extra_env['TORCHFT_NATIVE_LIB']} (numpy "
              "worker on the CPU)")
    device = "cpu" if args.sanitize else args.device

    results: List[Result] = []
    verdicts: Dict[str, str] = {}
    for scn in selected:
        wd = os.path.join(outdir, scn.name)
        shutil.rmtree(wd, ignore_errors=True)
        print(f"--- {scn.name}: {scn.description}")
        t0 = time.monotonic()
        res, verdict = run_one(scn, wd, steps, args.timeout, device, extra_env, worker_argv,
                               conformance)
        verdicts[scn.name] = verdict if res.status == "passed" else "not run"
        print(f"    {res.status.upper()} in {time.monotonic() - t0:.1f}s (fired={res.fired} "
              f"respawns={res.respawns}; conformance {verdicts[scn.name]}) {res.detail}")
        if res.status != "passed":
            # a failed or environmental run leaves a merged postmortem beside
            # its evidence, so triage starts from a timeline
            collect_postmortem(wd, detail=res.detail)
        results.append(res)

    report = {
        "steps": steps,
        "device": device,
        "sanitize": args.sanitize or False,
        "conformance": "checked" if conformance is not None else "not run",
        "results": [dict(r.__dict__, conformance=verdicts[r.scenario]) for r in results],
    }
    failed = [r for r in results if r.status == "failed"]
    if args.sanitize:
        hits = scan_san_reports(outdir, args.sanitize)
        report["sanitizer_reports"] = hits
        if hits:
            print(f"{args.sanitize.upper()} REPORTS ({len(hits)}):")
            for h in hits:
                print(f"  {h}")
                with open(h, errors="replace") as f:
                    head = f.read(2000)
                print("    " + "\n    ".join(head.splitlines()[:25]))
            failed.append(Result("sanitizer", "failed", f"{len(hits)} {args.sanitize} report(s)"))
        else:
            print("sanitizer: no reports")
    with open(os.path.join(outdir, "faultmatrix.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(f"report: {os.path.join(outdir, 'faultmatrix.json')}")
    env_skips = [r.scenario for r in results if r.status == "environmental"]
    if env_skips:
        print(f"environmental (documented corruption, recorded): {env_skips}")
    if failed:
        print(f"FAILED: {[r.scenario for r in failed]}")
        return 1
    print("fault matrix clean" + ("" if conformance is not None else " (conformance not run)"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
