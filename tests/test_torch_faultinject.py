"""The port's fault-injection plane against the JAX package's.

Every case of ``tests/test_faultinject.py``'s ``TestScheduleEngine`` and
``TestWireTorn`` and its two-replica integration run (one ``commit.vote``
delay and one ``rpc.recv`` error), and ``tests/test_timeseries.py``'s
``TestAfterRule``, on the port. Then the two engines side by side: the
same schedules, seeds and numpy-seeded hit sequences fire the same
injections in the same order; the evidence records have the same JSON
shape, and the native plane's records (``native/faultinject.h``) share
it. ``tests/test_faultinject_compiled.py`` replays the checker-compiled
schedules through the JAX scenario runner, which the port does not have
yet: here each compiled victim schedule (its kill made a signal-0 probe)
runs under two threaded groups of each package, and fires at the same
site, label and hit in both.
"""

import json
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta

import numpy as np
import pytest

from torchft_tpu.faultinject import core as jfi
from torchft_tpu_torch import telemetry
from torchft_tpu_torch.collectives import CollectivesTcp, PeerGoneError
from torchft_tpu_torch.faultinject import core as fi
from torchft_tpu_torch.store import StoreServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPILED = os.path.join(REPO, "torchft_tpu", "faultinject", "compiled")


@pytest.fixture(autouse=True)
def _clean_plane():
    """Every test starts and ends with no schedule in either package."""
    fi.configure(None)
    jfi.configure(None)
    yield
    fi.configure(None)
    jfi.configure(None)


@pytest.fixture()
def store():
    s = StoreServer()
    yield s
    s.shutdown()


def _drive(engine, schedule, script):
    """Install ``schedule`` fresh in ``engine`` and replay ``script`` (a
    list of (site, match) occurrences), swallowing injected errors;
    returns the plane's fired sequence."""
    plane = engine.configure(schedule)
    for site, match in script:
        try:
            engine.fault_point(site, match=match)
        except Exception:  # noqa: BLE001 — injected errors are the point
            pass
    return plane.fired_sequence()


class TestScheduleEngine:
    SCHEDULE = {
        "seed": 7,
        "rules": [
            {"site": "rpc.recv", "nth": 3, "action": "error", "exc": "ConnectionError"},
            {"site": "collective.issue", "match": "allreduce", "every": 4, "action": "delay",
             "ms": 0},
            {"site": "cma.pull", "p": 0.25, "action": "error", "exc": "OSError", "limit": 0},
        ],
    }

    def _script(self):
        script = []
        for i in range(200):
            script.append(("rpc.recv", f"peer{i % 2}"))
            script.append(("collective.issue", "allreduce" if i % 3 else "broadcast"))
            script.append(("cma.pull", f"pid{1000 + i}"))
        return script

    def test_same_seed_replays_identical_sequence(self):
        first = _drive(fi, self.SCHEDULE, self._script())
        second = _drive(fi, self.SCHEDULE, self._script())
        assert first, "schedule never fired — the test proves nothing"
        assert first == second
        assert any(site == "cma.pull" for site, *_ in first)

    def test_different_seed_changes_probabilistic_fires(self):
        a = _drive(fi, self.SCHEDULE, self._script())
        b = _drive(fi, dict(self.SCHEDULE, seed=8), self._script())
        assert [r for r in a if r[0] == "cma.pull"] != [r for r in b if r[0] == "cma.pull"]

    def test_nth_fires_exactly_once_on_nth_occurrence(self):
        plane = fi.configure(
            {"rules": [{"site": "rpc.send", "nth": 3, "action": "delay", "ms": 0}]})
        fires = [fi.fault_point("rpc.send", match="x", wire=True) is not None for _ in range(10)]
        assert [i for i, fired in enumerate(fires) if fired] == [2]
        assert len(plane.fired_sequence()) == 1

    def test_every_and_limit(self):
        fi.configure({"rules": [{"site": "rpc.send", "every": 2, "limit": 2, "action": "delay",
                                 "ms": 0}]})
        fired = [fi.fault_point("rpc.send", wire=True) is not None for _ in range(10)]
        assert fired == [False, True, False, True] + [False] * 6

    def test_match_is_substring_filter(self):
        fi.configure({"rules": [{"site": "collective.issue", "match": "allreduce", "nth": 1,
                                 "action": "delay", "ms": 0}]})
        assert fi.fault_point("collective.issue", match="broadcast") is None
        assert fi.fault_point("collective.issue", match="device.allreduce") is not None

    def test_unknown_site_and_action_rejected(self):
        with pytest.raises(ValueError, match="unknown injection site"):
            fi.configure({"rules": [{"site": "nope", "action": "drop"}]})
        with pytest.raises(ValueError, match="unknown action"):
            fi.configure({"rules": [{"site": "rpc.send", "action": "zap"}]})

    def test_error_action_raises_configured_class(self):
        fi.configure({"rules": [{"site": "quorum.reply", "nth": 1, "action": "error",
                                 "exc": "TimeoutError", "msg": "synthetic"}]})
        with pytest.raises(TimeoutError, match="fault injection: quorum"):
            fi.fault_point("quorum.reply")

    def test_peer_gone_error_resolves_to_the_ports_class(self):
        fi.configure({"rules": [{"site": "rpc.recv", "nth": 1, "action": "error",
                                 "exc": "PeerGoneError"}]})
        with pytest.raises(PeerGoneError, match="fault injection: rpc.recv"):
            fi.fault_point("rpc.recv", match="peer1")

    def test_drop_degrades_to_error_at_non_wire_site(self):
        fi.configure({"rules": [{"site": "commit.vote", "nth": 1, "action": "drop"}]})
        with pytest.raises(ConnectionError):
            fi.fault_point("commit.vote", match="rpc")

    def test_delay_action_sleeps(self):
        fi.configure({"rules": [{"site": "ckpt.recv", "nth": 1, "action": "delay", "ms": 80}]})
        t0 = time.perf_counter()
        fi.fault_point("ckpt.recv")
        assert time.perf_counter() - t0 >= 0.07

    def test_env_schedule_inline_and_file(self, tmp_path, monkeypatch):
        doc = {"rules": [{"site": "rpc.send", "nth": 1, "action": "drop"}]}
        monkeypatch.setenv(fi.ENV_SCHEDULE, json.dumps(doc))
        fi._PLANE = fi._UNSET  # force the lazy env load
        plane = fi.active()
        assert plane is not None and len(plane.rules) == 1
        p = tmp_path / "sched.json"
        p.write_text(json.dumps(doc))
        monkeypatch.setenv(fi.ENV_SCHEDULE, f"@{p}")
        fi._PLANE = fi._UNSET
        plane = fi.active()
        assert plane is not None and plane.rules[0].site == "rpc.send"

    def test_malformed_env_schedule_disables_not_crashes(self, monkeypatch):
        monkeypatch.setenv(fi.ENV_SCHEDULE, "{not json")
        fi._PLANE = fi._UNSET
        assert fi.active() is None

    def test_kill_writes_evidence_before_signal(self, tmp_path, monkeypatch):
        """sig=0 is a liveness probe: the kill path runs end to end
        (evidence written, os.kill called) without dying."""
        monkeypatch.setenv(fi.ENV_EVIDENCE_DIR, str(tmp_path))
        fi.configure({"rules": [{"site": "collective.issue", "nth": 1, "action": "kill",
                                 "sig": 0}]})
        inj = fi.fault_point("collective.issue", match="allreduce")
        assert inj is not None and inj.action == "kill"
        recs = fi.read_evidence(str(tmp_path))
        assert len(recs) == 1
        assert recs[0]["site"] == "collective.issue" and recs[0]["action"] == "kill"
        assert recs[0]["pid"] == os.getpid()
        from conftest import injected_kill_evidence

        assert injected_kill_evidence(str(tmp_path))

    def test_fired_injection_lands_in_telemetry(self):
        telemetry.EVENTS.clear()
        before = telemetry.FAULTS_INJECTED.labels(site="rpc.recv", action="delay").value
        fi.configure({"rules": [{"site": "rpc.recv", "nth": 1, "action": "delay", "ms": 0}]})
        fi.fault_point("rpc.recv", match="peer1")
        assert telemetry.FAULTS_INJECTED.labels(site="rpc.recv", action="delay").value \
            == before + 1
        events = telemetry.EVENTS.recent("fault_injected")
        assert events and events[-1]["site"] == "rpc.recv" and events[-1]["hit"] == 1
        assert "fault.delay" in [r["op"] for r in telemetry.FLIGHT.snapshot()]


class TestWireTorn:
    """Torn writes at the port's wire layer: the receiver surfaces a
    mid-frame EOF (never half-filled data reported as success) and the
    sender fails as a send to a dead peer does."""

    def test_torn_send_fails_both_ends(self, store):
        fi.configure({"rules": [{"site": "rpc.send", "match": "peer1", "nth": 1,
                                 "action": "torn", "frac": 0.5}]})
        colls = [CollectivesTcp(hostname="localhost", timeout=timedelta(seconds=5),
                                native_plane=False) for _ in range(2)]
        payload = np.arange(4096, dtype=np.float32)
        sentinel = np.full(4096, -7.0, dtype=np.float32)
        errs = {}

        def run(rank):
            colls[rank].configure(f"{store.address()}/torn", rank, 2)
            try:
                if rank == 0:
                    colls[rank].send(payload, dst=1, tag=5).wait()
                else:
                    buf = sentinel.copy()
                    try:
                        colls[rank].recv(buf, src=0, tag=5).wait()
                    finally:
                        errs["recv_buf"] = buf.copy()
            except Exception as e:  # noqa: BLE001
                errs[rank] = e
            finally:
                colls[rank].shutdown()

        threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert isinstance(errs.get(0), PeerGoneError), errs
        assert "torn send" in str(errs[0])
        assert isinstance(errs.get(1), (ConnectionError, TimeoutError, OSError)), errs
        assert not np.array_equal(errs["recv_buf"], payload)

    def test_torn_cma_pull_fills_prefix_then_raises(self):
        import ctypes

        from torchft_tpu_torch.collectives import _cma_pull

        src = (ctypes.c_char * 64).from_buffer_copy(bytes(range(64)))
        dst = bytearray(64)
        fi.configure({"rules": [{"site": "cma.pull", "nth": 1, "action": "torn",
                                 "frac": 0.25}]})
        with pytest.raises(ConnectionError, match="torn CMA pull"):
            _cma_pull(os.getpid(), ctypes.addressof(src), memoryview(dst))
        assert bytes(dst[:16]) == bytes(range(16))
        assert bytes(dst[16:]) == b"\x00" * 48


def _train_group(pkg, gid, lighthouse_addr, steps, barrier, max_aborts=8):
    """One replica group of ``pkg`` ("port" or "jax") on the Python ring
    (the ``rpc.recv`` site lives on the Python wire path): start_quorum,
    one allreduce, the vote, until ``steps`` commits."""
    if pkg == "port":
        from torchft_tpu_torch.collectives import CollectivesTcp as Coll
        from torchft_tpu_torch.manager import Manager
        from torchft_tpu_torch.store import StoreServer as Store
    else:
        from torchft_tpu.collectives import CollectivesTcp as Coll
        from torchft_tpu.manager import Manager
        from torchft_tpu.store import StoreServer as Store

    store = Store()
    manager = Manager(
        collectives=Coll(timeout=timedelta(seconds=15), native_plane=False),
        load_state_dict=lambda s: None,
        state_dict=lambda: {"w": np.zeros(4, np.float32)},
        min_replica_size=2,
        replica_id=f"faultinject_{pkg}_g{gid}_",
        store_addr=store.address(),
        rank=0,
        world_size=1,
        lighthouse_addr=lighthouse_addr,
        timeout=timedelta(seconds=15),
        quorum_timeout=timedelta(seconds=30),
    )
    committed = aborted = 0
    grad = None
    try:
        barrier.wait(timeout=30)
        while committed < steps and aborted < max_aborts:
            manager.start_quorum()
            grad = np.full(8, float(gid + 1), np.float32)
            manager.allreduce(grad).wait()
            if manager.should_commit():
                committed += 1
            else:
                aborted += 1
        return {"gid": gid, "committed": committed, "aborted": aborted, "grad": grad}
    finally:
        manager.shutdown(wait=False)
        store.shutdown()


def _two_groups(pkg, steps):
    if pkg == "port":
        from torchft_tpu_torch.coordination import LighthouseServer
    else:
        from torchft_tpu.coordination import LighthouseServer
    lh = LighthouseServer(bind="[::]:0", min_replicas=2)
    barrier = threading.Barrier(2)
    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            futs = [pool.submit(_train_group, pkg, g, lh.address(), steps, barrier)
                    for g in range(2)]
            return [f.result(timeout=120) for f in futs]
    finally:
        lh.shutdown()


def test_2replica_commit_vote_delay_and_recv_error():
    """One ``commit.vote`` delay and one ``rpc.recv`` error in a two-replica
    run of the port: the errored step aborts (no corrupt average commits)
    and both groups still reach the target committed steps."""
    telemetry.EVENTS.clear()
    fi.configure({
        "seed": 5,
        "rules": [
            {"site": "commit.vote", "match": "rpc", "nth": 2, "action": "delay", "ms": 100},
            {"site": "rpc.recv", "nth": 3, "action": "error", "exc": "ConnectionError",
             "msg": "injected wire error"},
        ],
    })
    steps = 3
    results = _two_groups("port", steps)
    fired = fi.active().fired_sequence()
    assert ("commit.vote", "rpc", "delay", 2) in fired, fired
    assert any(site == "rpc.recv" and action == "error" for site, _m, action, _h in fired), fired
    assert all(r["committed"] == steps for r in results), results
    assert any(r["aborted"] >= 1 for r in results), results
    kinds = [e["event"] for e in telemetry.EVENTS.recent()]
    assert "abort" in kinds and "fault_injected" in kinds
    for r in results:
        np.testing.assert_allclose(r["grad"], 1.5)


class TestAfterRule:
    def test_after_fires_from_onset_onward(self):
        plane = fi.FaultPlane({"seed": 1, "rules": [{
            "site": "collective.issue", "match": "allreduce", "after": 4, "action": "delay",
            "ms": 1}]})
        fired = [plane.hit("collective.issue", "allreduce", {}) is not None for _ in range(8)]
        assert fired == [False] * 3 + [True] * 5

    def test_after_exclusive_with_nth(self):
        with pytest.raises(ValueError, match="at most one"):
            fi.FaultPlane({"rules": [{"site": "rpc.send", "nth": 2, "after": 3,
                                      "action": "delay", "ms": 1}]})


# ---------------------------------------------------------------------------
# the two engines side by side
# ---------------------------------------------------------------------------


def _random_schedule(rng):
    """A schedule of 1-4 rules over every site, trigger kind and action
    but kill (delays of 0 ms: the replay is what is compared)."""
    rules = []
    for _ in range(int(rng.integers(1, 5))):
        site = fi.SITES[int(rng.integers(len(fi.SITES)))]
        rule = {"site": site, "action": ["delay", "error", "drop", "torn", "corrupt"][
            int(rng.integers(5))], "ms": 0}
        if rng.random() < 0.5:
            rule["match"] = ["peer", "allreduce", "1", "rpc", ""][int(rng.integers(5))]
        kind = int(rng.integers(5))
        if kind == 0:
            rule["nth"] = int(rng.integers(1, 20))
        elif kind == 1:
            rule["every"] = int(rng.integers(1, 6))
        elif kind == 2:
            rule["p"] = float(rng.random())
        elif kind == 3:
            rule["after"] = int(rng.integers(1, 30))
        if rng.random() < 0.3:
            rule["limit"] = int(rng.integers(0, 4))
        rules.append(rule)
    return {"seed": int(rng.integers(1 << 30)), "rules": rules}


def _random_script(rng, n=300):
    labels = ["peer0", "peer1", "allreduce", "device.allreduce", "broadcast", "rpc", "prepare",
              "12", "pid4242", ""]
    return [(fi.SITES[int(rng.integers(len(fi.SITES)))], labels[int(rng.integers(len(labels)))])
            for _ in range(n)]


@pytest.mark.parametrize("seed", range(12))
def test_same_schedule_and_hits_fire_the_same_injections(seed):
    """Random schedules (seed, rules, nth/every/p/after, limits) over a
    numpy-seeded hit sequence: both engines fire the same (site, match,
    action, hit) in the same order, and hand the call site the same
    injection (its action, delay, fraction, signal, rule)."""
    rng = np.random.default_rng(seed)
    schedule = _random_schedule(rng)
    script = _random_script(rng)
    fired = []
    for engine in (fi, jfi):
        plane = engine.FaultPlane(schedule)
        out = []
        for site, match in script:
            inj = plane.hit(site, match, {})
            if inj is not None:
                out.append((inj.site, inj.match, inj.action, inj.ms, inj.frac, inj.sig,
                            inj.exc, inj.hit, inj.rule))
        fired.append((out, plane.fired_sequence()))
    assert fired[0] == fired[1]


def test_fault_point_raises_and_returns_alike():
    """At a wire site drop/torn/corrupt come back to the caller, at any
    other site they raise; error raises the named class; delay and kill
    (sig 0) return. The same on both packages."""
    rules = [
        {"site": "rpc.send", "nth": 1, "action": "torn", "frac": 0.3},
        # a rule counts only the hits it is asked about: the first rule
        # fired the first send, so this one sees the second as its first
        {"site": "rpc.send", "nth": 1, "action": "drop"},
        {"site": "collective.complete", "nth": 1, "action": "corrupt", "frac": 0.1},
        {"site": "ckpt.recv", "nth": 1, "action": "torn"},
        {"site": "quorum.reply", "nth": 1, "action": "error", "exc": "EOFError"},
        {"site": "future.deadline", "nth": 1, "action": "delay", "ms": 1},
        {"site": "commit.vote", "nth": 1, "action": "kill", "sig": 0},
    ]
    calls = [("rpc.send", True), ("rpc.send", True), ("collective.complete", True),
             ("ckpt.recv", False), ("quorum.reply", False), ("future.deadline", False),
             ("commit.vote", False)]
    seen = []
    for engine in (fi, jfi):
        engine.configure({"seed": 3, "rules": rules})
        out = []
        for site, wire in calls:
            try:
                inj = engine.fault_point(site, match="x", wire=wire)
                out.append(("returned", inj.action, inj.frac))
            except Exception as e:  # noqa: BLE001 — the class is compared
                out.append(("raised", type(e).__name__, str(e)))
        seen.append(out)
    assert seen[0] == seen[1]
    assert [k for k, *_ in seen[0]] == ["returned", "returned", "returned", "raised", "raised",
                                        "returned", "returned"]


def test_evidence_lines_have_the_same_shape(tmp_path, monkeypatch):
    """Both engines' evidence records: the same keys and value types, in
    per-pid files ``read_evidence`` of either package reads."""
    recs = {}
    for name, engine in (("port", fi), ("jax", jfi)):
        d = tmp_path / name
        monkeypatch.setenv(engine.ENV_EVIDENCE_DIR, str(d))
        engine.configure({"seed": 2, "rules": [
            {"site": "collective.issue", "match": "allreduce", "nth": 2, "action": "kill",
             "sig": 0},
            {"site": "rpc.recv", "every": 3, "action": "delay", "ms": 0}]})
        for i in range(7):
            engine.fault_point("collective.issue", match="allreduce")
            engine.fault_point("rpc.recv", match=f"peer{i % 2}")
        recs[name] = engine.read_evidence(str(d))
        assert os.listdir(d) == [f"tft_fault_{os.getpid()}.json"]
    assert len(recs["port"]) == len(recs["jax"]) == 3
    for a, b in zip(recs["port"], recs["jax"]):
        assert {k: type(v) for k, v in a.items()} == {k: type(v) for k, v in b.items()}
        assert {k: v for k, v in a.items() if k != "ts"} == {k: v for k, v in b.items()
                                                              if k != "ts"}
    # each package's reader reads the other's directory
    assert fi.read_evidence(str(tmp_path / "jax")) == recs["jax"]
    assert jfi.read_evidence(str(tmp_path / "port")) == recs["port"]


_NATIVE_CUT = r"""
import os, sys, threading
import numpy as np
from torchft_tpu_torch import _native

a = _native.NativeDataPlane(0, 2, nstripes=1)
b = _native.NativeDataPlane(1, 2, nstripes=1)
b.connect(0, "127.0.0.1", a.port, 5000)
a.wait_ready(5000)
b.wait_ready(5000)
bufs = [np.ones(1 << 12, dtype=np.float32) for _ in range(2)]
errs = []

def run(dp, buf):
    try:
        dp.allreduce(buf.ctypes.data, buf.size, "sum", tag=1, timeout_ms=5000)
    except Exception as e:
        errs.append(type(e).__name__)

ts = [threading.Thread(target=run, args=(dp, buf)) for dp, buf in ((a, bufs[0]), (b, bufs[1]))]
for t in ts:
    t.start()
for t in ts:
    t.join()
a.close()
b.close()
print(len(errs))
"""


def test_native_evidence_shares_the_records_shape(tmp_path):
    """A torn native stripe hop (``TORCHFT_FI_DP_CUT=1``, read once per
    process: a subprocess) writes its evidence beside the Python engine's:
    a ``tft_fault_<pid>_native.json`` record with the site, action, hit and
    pid the Python records carry, which both packages' readers return."""
    env = dict(os.environ, TORCHFT_FI_DP_CUT="1", TORCHFT_FAULT_EVIDENCE_DIR=str(tmp_path),
               PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _NATIVE_CUT], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    native = fi.read_evidence(str(tmp_path))
    assert native and native == jfi.read_evidence(str(tmp_path))
    rec = native[0]
    assert rec["native"] is True and rec["site"] in fi.NATIVE_SITES and rec["action"] == "torn"
    fi.configure(None)
    os.environ[fi.ENV_EVIDENCE_DIR] = str(tmp_path / "py")
    try:
        fi.configure({"rules": [{"site": "rpc.send", "nth": 1, "action": "drop"}]})
        fi.fault_point("rpc.send", wire=True)
    finally:
        del os.environ[fi.ENV_EVIDENCE_DIR]
    py = fi.read_evidence(str(tmp_path / "py"))[0]
    shared = {"site", "action", "hit", "pid"}
    assert shared <= set(rec) and shared <= set(py)
    assert {k: type(rec[k]) for k in shared} == {k: type(py[k]) for k in shared}


def _compiled_schedules():
    out = []
    for name in sorted(os.listdir(COMPILED)):
        if name.endswith(".json"):
            with open(os.path.join(COMPILED, name), encoding="utf-8") as f:
                out.append(json.load(f))
    return out


@pytest.mark.parametrize("desc", _compiled_schedules(), ids=lambda d: d["name"])
def test_compiled_schedule_fires_at_the_same_site_and_hit(desc):
    """A checker-compiled victim schedule (``torchft_tpu/faultinject/
    compiled/``), its kill made a signal-0 probe, under two threaded
    groups of each package (the loop of the two-replica test, four
    commits): the port's sites fire the same (site, match, action, hit)
    as the JAX package's, once each."""
    schedule = json.loads(json.dumps(desc["victim_schedule"]))
    for rule in schedule["rules"]:
        if rule.get("action") == "kill":
            rule["sig"] = 0
    fired = {}
    for pkg, engine in (("port", fi), ("jax", jfi)):
        engine.configure(schedule)
        results = _two_groups(pkg, 4)
        assert all(r["committed"] == 4 for r in results), (pkg, results)
        fired[pkg] = engine.active().fired_sequence()
        engine.configure(None)
    assert fired["port"] == fired["jax"]
    assert len(fired["port"]) == len(schedule["rules"]), fired


# ---------------------------------------------------------------------------
# the data planes' completion and issue sites
# ---------------------------------------------------------------------------


def _host_world(pkg, store, fn, world=2):
    if pkg == "port":
        from torchft_tpu_torch.collectives import CollectivesTcp as Coll
    else:
        from torchft_tpu.collectives import CollectivesTcp as Coll
    prefix = f"{store.address()}/{pkg}{time.monotonic_ns()}"
    colls = [Coll(hostname="localhost", timeout=timedelta(seconds=10), native_plane=False)
             for _ in range(world)]

    def run(rank):
        colls[rank].configure(prefix, rank, world)
        try:
            return fn(colls[rank], rank)
        finally:
            colls[rank].shutdown()

    with ThreadPoolExecutor(max_workers=world) as ex:
        return list(ex.map(run, range(world)))


def test_corrupt_at_completion_perturbs_one_replica_alike(store):
    """``corrupt`` at ``collective.complete`` on the host plane: one
    replica's finished average gets +1 on its leading ``frac``, silently,
    the other's stays exact; the same outputs (in either rank order) on
    both packages."""
    schedule = {"seed": 3, "rules": [{"site": "collective.complete", "match": "allreduce",
                                      "nth": 1, "action": "corrupt", "frac": 0.25}]}

    def fn(coll, rank):
        x = np.arange(8, dtype=np.float32) + rank
        return coll.allreduce([x]).wait(timedelta(seconds=10))[0].tolist()

    outs = {}
    for pkg, engine in (("port", fi), ("jax", jfi)):
        engine.configure(schedule)
        outs[pkg] = sorted(_host_world(pkg, store, fn))
        assert engine.active().fired_sequence() == [("collective.complete", "allreduce",
                                                     "corrupt", 1)]
        engine.configure(None)
    exact = (2 * np.arange(8) + 1).astype(np.float32)
    bumped = exact.copy()
    bumped[:2] += 1
    assert outs["port"] == outs["jax"] == sorted([exact.tolist(), bumped.tolist()])


def test_device_plane_corrupt_and_issue_error():
    """The device plane's sites: ``corrupt`` perturbs one group's result as
    a copy on its device (the inputs and the other group's result
    untouched); an ``error`` at ``collective.issue`` raises before the op
    takes its slot, so the group's next op meets the others' in that slot."""
    import torch

    from torchft_tpu_torch.collectives_device import CollectivesDevice

    prefix = f"store:0/torchft/fi{time.monotonic_ns()}"
    colls = [CollectivesDevice(timeout=timedelta(seconds=10), device="cpu") for _ in range(2)]
    fi.configure({"rules": [
        {"site": "collective.complete", "match": "device.allreduce", "nth": 1,
         "action": "corrupt", "frac": 0.5},
        {"site": "collective.issue", "match": "device.allgather", "nth": 1, "action": "error",
         "exc": "RuntimeError"}]})
    inputs = [torch.arange(4, dtype=torch.float32) + r for r in range(2)]
    barrier = threading.Barrier(2)

    def run(rank):
        colls[rank].configure(f"{prefix}/{rank}", rank, 2)
        try:
            out = colls[rank].allreduce([inputs[rank]]).wait(timedelta(seconds=10))[0]
            barrier.wait(10)
            mine = torch.tensor([float(rank)])
            try:
                raised, gathered = None, colls[rank].allgather(mine).wait(timedelta(seconds=10))
            except RuntimeError as e:
                # the op never took its slot: the retry meets the other group's there
                raised, gathered = str(e), colls[rank].allgather(mine).wait(timedelta(seconds=10))
            return out.tolist(), raised, [g.tolist() for g in gathered]
        finally:
            colls[rank].shutdown()

    with ThreadPoolExecutor(max_workers=2) as ex:
        results = list(ex.map(run, range(2)))
    outs = sorted(r[0] for r in results)
    assert outs == [[1.0, 3.0, 5.0, 7.0], [2.0, 4.0, 5.0, 7.0]]
    assert [t.tolist() for t in inputs] == [[0.0, 1.0, 2.0, 3.0], [1.0, 2.0, 3.0, 4.0]]
    raised = [r[1] for r in results if r[1] is not None]
    assert len(raised) == 1 and "fault injection: collective.issue" in raised[0]
    assert [r[2] for r in results] == [[[0.0], [1.0]]] * 2


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_torn_checkpoint_serve_fails_the_heal_then_recovers(pkg):
    """``torn`` at ``ckpt.serve``: the source promises the whole body,
    streams a prefix and cuts the connection; the healer's receive fails
    (never a torn state) and the next receive, with no fire left, returns
    the state. ``ckpt.recv`` fires once per receive. Both packages alike."""
    if pkg == "port":
        import torch

        from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport
        engine = fi
        state = {"w": torch.arange(4096, dtype=torch.float32)}
    else:
        from torchft_tpu.checkpointing.http_transport import HTTPTransport
        engine = jfi
        state = {"w": np.arange(4096, dtype=np.float32)}
    engine.configure({"rules": [
        {"site": "ckpt.serve", "match": "full", "nth": 1, "action": "torn", "frac": 0.5},
        {"site": "ckpt.recv", "every": 1, "action": "delay", "ms": 0}]})
    src = HTTPTransport(timeout=timedelta(seconds=10), hostname="localhost")
    dst = HTTPTransport(timeout=timedelta(seconds=10), hostname="localhost")
    try:
        src.send_checkpoint([1], 3, state, timedelta(seconds=10))
        with pytest.raises(Exception):
            dst.recv_checkpoint(0, src.metadata(), 3, timedelta(seconds=10))
        got = dst.recv_checkpoint(0, src.metadata(), 3, timedelta(seconds=10))
        np.testing.assert_array_equal(np.asarray(got["w"]), np.arange(4096, dtype=np.float32))
        fired = engine.active().fired_sequence()
        assert fired == [("ckpt.recv", "3", "delay", 1), ("ckpt.serve", "full", "torn", 1),
                         ("ckpt.recv", "3", "delay", 2)], fired
    finally:
        src.shutdown()
        dst.shutdown()
