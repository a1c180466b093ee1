"""The port's telemetry against the JAX package's: the registry and its
catalog, the FT event trail, the flight recorder, the step watchdog,
``/metrics`` and the instrumented runtime.

Each case feeds the same calls into ``torchft_tpu.telemetry`` and the
port's ``torchft_tpu_torch.telemetry``: the Prometheus text is compared
byte for byte (the whole catalog in a fresh process, where no earlier
test has created children of the open label sets), trail records equal
but for ``ts``, flight records equal but for their wall timestamps. Then
the port's runtime: the collectives' counters and flight records against
the JAX collectives' on the same ops, the futures' deadline, SIGUSR2, a
Manager that ``shutdown()`` leaves held by no thread, and a SIGKILL of
one of two worker processes whose trails, spans and flight dump are read
back.
"""

import gc
import glob
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
import weakref
from datetime import timedelta

import numpy as np
import pytest

from torchft_tpu import telemetry as J
from torchft_tpu_torch import telemetry as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    J.reset()
    P.reset()
    yield
    J.reset()
    P.reset()


def _registry_calls(reg):
    c = reg.counter("tft_t_ops_total", "ops \\ with a backslash\nand a newline")
    c.inc()
    c.inc(2.5)
    lc = reg.counter("tft_t_bytes_total", "bytes by plane", labelnames=("plane", "op"))
    lc.labels(plane="tcp", op="allreduce").inc(1024)
    lc.labels(plane='we"ird\\', op="x\ny").inc(7)
    g = reg.gauge("tft_t_participants", "participants")
    g.set(4)
    g.dec()
    g.inc(0.5)
    h = reg.histogram("tft_t_latency_seconds", "latency", labelnames=("phase",),
                      buckets=(0.001, 0.01, 0.1, 1.0))
    for v in (0.0005, 0.003, 0.003, 0.05, 0.2, 3.0, float("inf")):
        h.labels(phase="wire").observe(v)
    h.labels(phase="idle")
    h2 = reg.histogram("tft_t_wall_seconds", "wall", buckets=J.LOG2_BUCKETS)
    for v in np.random.default_rng(0).exponential(0.03, 50):
        h2.observe(float(v))
    with h2.time():
        pass
    return reg


def test_registry_renders_the_same_bytes():
    from torchft_tpu.telemetry.registry import MetricsRegistry as JReg
    from torchft_tpu_torch.telemetry.registry import MetricsRegistry as PReg

    jr, pr = _registry_calls(JReg()), _registry_calls(PReg())
    # the timer's observation differs in value: drop that family's sum
    jt, pt = jr.render(), pr.render()
    strip = lambda t: [ln for ln in t.splitlines() if not ln.startswith("tft_t_wall_seconds")]  # noqa: E731
    assert strip(pt) == strip(jt)
    assert pt.count("\n") == jt.count("\n")
    jd, pd = jr.dump(), pr.dump()
    jd.pop("tft_t_wall_seconds")
    pd.pop("tft_t_wall_seconds")
    assert pd == jd
    assert pr.get("tft_t_latency_seconds").labels(phase="wire").quantile(0.5) == \
        jr.get("tft_t_latency_seconds").labels(phase="wire").quantile(0.5)


# the same telemetry calls in a fresh process on both packages: the whole
# catalog's exposition byte for byte, the summaries and the dumps' metrics
_CATALOG = r"""
import json, sys
import torchft_tpu.telemetry as J
import torchft_tpu_torch.telemetry as P
assert "jax" not in sys.modules
for t in (J, P):
    t.QUORUM_LATENCY.observe(0.004)
    t.QUORUMS_TOTAL.inc()
    t.QUORUM_RECONFIGURES.inc()
    t.PARTICIPANTS.set(2)
    t.STEP_DURATION.labels(kind="steady").observe(0.03)
    t.STEP_DURATION.labels(kind="heal").observe(2.5)
    t.COMMITS_TOTAL.labels(outcome="committed").inc()
    t.COMMIT_BARRIER.observe(0.0007)
    t.HEALS_TOTAL.labels(role="recv").inc()
    t.HEAL_DURATION.observe(1.25)
    t.record_collective("allreduce", 4096, 0.002, "tcp-striped")
    t.record_collective("allgather", 64, 0.001, "python-ring")
    t.record_collective("allreduce", 128, 0.0, "device", count_op=False)
    t.record_checkpoint("stage", 1 << 20, 0.01, "http")
    t.record_checkpoint("recv", 1 << 20, 0.2, "http")
    t.FUTURE_TIMEOUTS.inc()
    t.emit("commit", step=3, participants=2)
    t.emit("quorum_ready", quorum_id=4, step=3, participants=["a", "b"])
    t.LEDGER.record_heal_stage("recv", 0.5)
    t.LEDGER.record("wire", 0.25, wire_total=True)
out = {
    "render": [J.render_prometheus(), P.render_prometheus()],
    "summary": [J.summary(), P.summary()],
    "families": [sorted(J.REGISTRY.dump()), sorted(P.REGISTRY.dump())],
    "metrics": [J.dump()["metrics"], P.dump()["metrics"]],
    "events": [[{k: v for k, v in r.items() if k != "ts"} for r in t.EVENTS.recent()]
               for t in (J, P)],
}
print(json.dumps(out, default=str))
"""


def test_catalog_renders_the_same_prometheus_text():
    proc = subprocess.run([sys.executable, "-c", _CATALOG], capture_output=True, text=True,
                          timeout=120, cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    jt, pt = out["render"]
    assert pt == jt
    assert out["families"][0] == out["families"][1] and len(out["families"][1]) == 41
    assert out["summary"][0] == out["summary"][1]
    assert out["metrics"][0] == out["metrics"][1]
    assert out["events"][0] == out["events"][1]
    assert 'tft_allreduce_bytes_total{plane="tcp-striped"} 4096' in pt
    assert "tft_ft_events_total" in pt


def test_trail_records_match_jax(tmp_path):
    from torchft_tpu.telemetry.events import LIFECYCLE_EVENTS as JL
    from torchft_tpu_torch.telemetry.events import LIFECYCLE_EVENTS as PL

    assert P.CANONICAL_EVENTS == J.CANONICAL_EVENTS and PL == JL
    recs = []
    for name, pkg in (("jax", J), ("port", P)):
        trail = pkg.EventTrail(path=str(tmp_path / name / "trail.jsonl"), max_bytes=600)
        got = []
        trail.subscribe(got.append)
        for i in range(12):
            trail.emit("commit", step=i, participants=2)
            trail.emit("heal_end", step=i, bytes=1 << i, heal_stats={"mode": "striped"},
                       obj=object)
        trail.close()
        path = str(tmp_path / name / "trail.jsonl")
        on_disk = pkg.read_trail(path + ".1") + pkg.read_trail(path)
        recs.append((
            [{k: v for k, v in r.items() if k != "ts"} for r in on_disk],
            [{k: v for k, v in r.items() if k != "ts"} for r in trail.recent("heal_end", 3)],
            len(got),
        ))
        # a torn last line (a SIGKILLed writer) is skipped
        whole = pkg.read_trail(path)
        with open(path, "a") as f:
            f.write('{"ts": 1, "event": "comm')
        assert pkg.read_trail(path) == whole
    assert recs[1] == recs[0]
    assert recs[1][2] == 24
    assert os.path.exists(tmp_path / "port" / "trail.jsonl.1")


def _flight_script(rec):
    """The same issue/complete sequence (a wraparound of the 16-entry ring
    included); returns the records without their wall timestamps."""
    seqs = [rec.record_issue("allreduce", "tcp-striped", 4096 * i, tag=i, rank=0)
            for i in range(20)]
    for s in seqs[:-3]:
        rec.record_complete(s)
    rec.record_complete(seqs[-3], error=RuntimeError("peer 1 gone"))
    rec.record_complete(seqs[0])  # overwritten by the wraparound: ignored
    snap = [{k: v for k, v in r.items() if not k.endswith("_ts")} for r in rec.snapshot()]
    digest = rec.analyze(rec.snapshot())
    return snap, {k: v["seq"] for k, v in digest.items()}


def test_flight_recorder_matches_jax(tmp_path, monkeypatch):
    from torchft_tpu.telemetry.flight import FlightRecorder as JF
    from torchft_tpu_torch.telemetry.flight import FlightRecorder as PF

    jr, pr = JF(size=16), PF(size=16)
    assert _flight_script(pr) == _flight_script(jr)
    snap, digest = _flight_script(PF(size=16))
    assert len(snap) == 16 and digest == {"last_completed": 17, "first_stuck": 19}
    monkeypatch.setenv("TORCHFT_FLIGHT_DIR", str(tmp_path))
    paths = [rec.dump("manual") for rec in (jr, pr)]
    assert all(paths)
    dumps = []
    for p in paths:
        with open(p) as f:
            dumps.append(json.load(f))
    assert set(dumps[1]) == set(dumps[0])
    assert dumps[1]["entries"][-1]["status"] == "issued"
    assert pr.dump("manual") is None  # rate-limited per reason
    assert pr.dump("manual", force=True) is not None
    assert [r["event"] for r in P.EVENTS.recent()] == ["flight_dump", "flight_dump"]
    assert P.FLIGHT_DUMPS.labels(reason="manual").value == 2


def _watchdog_run(pkg):
    fired = []
    done = threading.Event()

    def on_stall(step, elapsed, thr):
        fired.append((step, round(thr, 3)))
        done.set()

    wd = pkg.StepWatchdog(mult=10.0, min_s=0.2, on_stall=on_stall)
    wd.arm(7)
    assert done.wait(10.0), "the watchdog never fired"
    stalled = wd.stalled
    wd.disarm()
    after = wd.stalled
    wd.stop()
    ev = [{k: v for k, v in r.items() if k not in ("ts", "elapsed_s", "path")}
          for r in pkg.EVENTS.recent() if r["event"] in ("watchdog_stall", "flight_dump")]
    return fired, stalled, after, ev, pkg.WATCHDOG_STALLS.value


def test_watchdog_fires_dumps_and_disarms_as_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCHFT_FLIGHT_DIR", str(tmp_path))
    for pkg in (J, P):
        pkg.FLIGHT.min_dump_interval_s = 0.0
    try:
        got, ref = _watchdog_run(P), _watchdog_run(J)
    finally:
        for pkg in (J, P):
            pkg.FLIGHT.min_dump_interval_s = 5.0
    assert got == ref
    assert got[0] == [(7, 0.2)] and got[1] is True and got[2] is False
    assert [e["event"] for e in got[3]] == ["watchdog_stall", "flight_dump"]


def test_watchdog_knobs_come_from_the_environment(monkeypatch):
    monkeypatch.setenv("TORCHFT_WATCHDOG_MULT", "3")
    monkeypatch.setenv("TORCHFT_WATCHDOG_MIN_S", "0.75")
    wd = P.StepWatchdog()
    assert (wd.mult, wd.min_s, wd.threshold_s()) == (3.0, 0.75, 0.75)
    monkeypatch.setenv("TORCHFT_WATCHDOG_MULT", "0")
    assert not P.StepWatchdog().enabled


def test_watchdog_thread_lets_its_owner_go():
    """The watchdog holds a bound ``on_stall`` weakly: its thread keeps no
    owner (a Manager, and its CUDA graphs) alive, and exits once the owner
    is collected."""

    class Owner:
        def __init__(self):
            self.wd = P.StepWatchdog(mult=10.0, min_s=60.0, on_stall=self.on_stall)

        def on_stall(self, step, elapsed, thr):
            pass

    owner = Owner()
    owner.wd.arm(1)
    thread = owner.wd._thread
    assert thread is not None and thread.is_alive()
    ref = weakref.ref(owner)
    owner.wd.disarm()
    del owner
    gc.collect()
    assert ref() is None
    thread.join(5.0)
    assert not thread.is_alive()


def test_install_sigusr2_off_the_main_thread_and_a_signalled_dump(tmp_path):
    code = r"""
import json, os, signal, sys, threading, time
import torchft_tpu_torch.telemetry as t
res = {}
th = threading.Thread(target=lambda: res.setdefault("thread", t.install_sigusr2()))
th.start(); th.join()
res["main"] = t.install_sigusr2()
seq = t.FLIGHT.record_issue("allreduce", "python-ring", 64, tag=1, rank=0)
t.FLIGHT.record_complete(seq)
t.FLIGHT.record_issue("allgather", "python-ring", 8, tag=2, rank=0)
os.kill(os.getpid(), signal.SIGUSR2)
deadline = time.monotonic() + 10
while time.monotonic() < deadline and not os.listdir(sys.argv[1]):
    time.sleep(0.02)
time.sleep(0.2)
path = os.path.join(sys.argv[1], os.listdir(sys.argv[1])[0])
with open(path) as f:
    dump = json.load(f)
res["dump"] = {k: dump[k] for k in ("reason", "last_completed", "first_stuck")}
res["keys"] = sorted(dump)
print(json.dumps(res))
"""
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                          text=True, timeout=120, cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO, TORCHFT_FLIGHT_DIR=str(tmp_path)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["thread"] is False and res["main"] is True
    assert res["dump"]["reason"] == "signal"
    assert res["dump"]["last_completed"]["op"] == "allreduce"
    assert res["dump"]["first_stuck"]["op"] == "allgather"
    assert {"entries", "anatomy", "py_stacks", "pid", "host"} <= set(res["keys"])


def test_deadline_counts_and_dumps(tmp_path, monkeypatch):
    from torchft_tpu_torch.futures import Future, future_timeout

    monkeypatch.setenv("TORCHFT_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setattr(P.FLIGHT, "min_dump_interval_s", 0.0)
    fut = future_timeout(Future(), timedelta(milliseconds=50))
    with pytest.raises(TimeoutError):
        fut.wait(timedelta(seconds=10))
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and not glob.glob(str(tmp_path / "tft_flight_*.json")):
        time.sleep(0.02)
    assert P.FUTURE_TIMEOUTS.value == 1
    dumps = glob.glob(str(tmp_path / "tft_flight_*.json"))
    assert dumps
    with open(dumps[0]) as f:
        assert json.load(f)["reason"] == "deadline"


def test_step_timer_matches_jax(monkeypatch):
    from torchft_tpu.profiling import StepTimer as JT
    from torchft_tpu_torch.profiling import StepTimer as PT

    out = []
    for timer_cls, pkg in ((JT, J), (PT, P)):
        t = [10.0]
        monkeypatch.setattr("time.perf_counter", lambda: t[0])
        timer = timer_cls(window=4)
        durs = []
        for i, d in enumerate((0.1, 0.2, 0.15, 0.3, 0.12, 0.5, 0.11)):
            if i == 1:
                timer.mark_heal()  # before the first boundary: held
            if i == 4:
                timer.mark_quorum()
            durs.append(timer.tick(quorum=(i == 5)))
            t[0] += d
        out.append((durs, timer.steps_per_sec(), timer.steps_per_sec_all(), timer.outliers(),
                    timer.outlier_digest(),
                    {k: pkg.STEP_DURATION.labels(kind=k).count
                     for k in ("steady", "quorum", "heal")}))
    assert out[1] == out[0]


def test_profile_writes_a_chrome_trace(tmp_path):
    import torch

    from torchft_tpu_torch.profiling import profile

    with profile(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with profile(None):
        pass
    (path,) = glob.glob(str(tmp_path / "trace_*.json"))
    with open(path) as f:
        trace = json.load(f)
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


# ---------------------------------------------------------------------------
# the runtime's counters and flight records
# ---------------------------------------------------------------------------


def _pair(pkg_coll, pkg_store, **kwargs):
    server = pkg_store.StoreServer()
    colls = [pkg_coll.CollectivesTcp(timeout=timedelta(seconds=20), hostname="localhost",
                                     **kwargs) for _ in range(2)]
    threads = [threading.Thread(target=c.configure, args=(f"{server.address()}/tm", r, 2))
               for r, c in enumerate(colls)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return server, colls


def _ops(pkg_coll, pkg_store, pkg_tel):
    """The same ops on a pair over the Python ring; rank 0's flight
    records (op, plane, bytes, status) and the op counters."""
    pkg_tel.reset()
    server, colls = _pair(pkg_coll, pkg_store, native_plane=False)
    try:
        def rank(r):
            c = colls[r]
            c.allreduce([np.full(1000, r + 1, np.float32)]).wait()
            c.allgather(np.arange(4, dtype=np.int64)).wait()
            c.broadcast(np.zeros(8, np.float32), root=0).wait()
            c.barrier().wait()
            if r == 0:
                c.send(np.ones(16, np.uint8), dst=1, tag=3).wait()
            else:
                c.recv(np.zeros(16, np.uint8), src=0, tag=3).wait()

        threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        recs = sorted((r["op"], r["plane"], r["bytes"], r["status"])
                      for r in pkg_tel.FLIGHT.snapshot())
        # nonzero children only: reset() zeroes the children earlier tests
        # in this process created, it does not drop them
        ops = sorted((values, child.value)
                     for values, child in pkg_tel.COLLECTIVE_OPS._snapshot_children()
                     if child.value)
        return recs, ops, pkg_tel.summary()["allreduce_bytes"], pkg_tel.summary()["allreduce_ops"]
    finally:
        for c in colls:
            c.shutdown()
        server.shutdown()


def test_collectives_count_and_record_as_jax():
    import torchft_tpu.collectives as jc
    import torchft_tpu.store as js
    import torchft_tpu_torch.collectives as pc
    import torchft_tpu_torch.store as ps

    got, ref = _ops(pc, ps, P), _ops(jc, js, J)
    assert got == ref
    recs = got[0]
    assert len(recs) == 10 and all(r[3] == "completed" for r in recs)
    assert got[2] == 8000 and got[3] == 2


def test_device_plane_counts_without_reading_a_tensor():
    import torch

    from torchft_tpu_torch.collectives_device import CollectivesDevice
    from torchft_tpu_torch.store import StoreServer

    server = StoreServer()
    solo = CollectivesDevice(timeout=timedelta(seconds=20), device="cpu")
    solo.configure(f"{server.address()}/solo/0", 0, 1)
    pair = [CollectivesDevice(timeout=timedelta(seconds=20), device="cpu") for _ in range(2)]
    threads = [threading.Thread(target=c.configure, args=(f"{server.address()}/dev/{r}", r, 2))
               for r, c in enumerate(pair)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    try:
        solo.allreduce([torch.ones(10)]).wait()  # world 1: bytes, no latency
        futs = [c.allreduce([torch.full((256,), float(r))]) for r, c in enumerate(pair)]
        futs += [c.allgather(torch.ones(3)) for c in pair]
        for f in futs:
            f.wait(timedelta(seconds=20))
    finally:
        for c in pair + [solo]:
            c.shutdown()
        server.shutdown()
    s = P.summary()
    assert s["allreduce_bytes"] == 40 + 2 * 1024 and s["allreduce_ops"] == 2
    assert P.COLLECTIVE_OPS.labels(op="allreduce", plane="device").value == 3
    recs = P.FLIGHT.snapshot()
    assert sorted((r["op"], r["bytes"], r["status"]) for r in recs) == [
        ("allgather", 12, "completed")] * 2 + [("allreduce", 1024, "completed")] * 2


def test_metrics_endpoint_lists_the_jax_families():
    from torchft_tpu.checkpointing.http_transport import HTTPTransport as JH
    from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport as PH

    pages = []
    for cls in (JH, PH):
        tr = cls(timeout=timedelta(seconds=10), hostname="localhost")
        try:
            with urllib.request.urlopen(tr.metadata() + "/metrics", timeout=10) as resp:
                assert resp.headers["Content-Type"] == "text/plain; version=0.0.4"
                pages.append(resp.read().decode())
        finally:
            tr.shutdown()
    fams = [sorted(ln.split()[2] for ln in p.splitlines() if ln.startswith("# TYPE ")) for p in pages]
    assert fams[1] == fams[0] and len(fams[1]) == 41


# ---------------------------------------------------------------------------
# lifetimes
# ---------------------------------------------------------------------------


def _manager_lifetime(shutdown):
    from torchft_tpu_torch.collectives import CollectivesTcp
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.store import StoreServer

    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=1)
    store = StoreServer()
    timeout = timedelta(seconds=20)
    manager = Manager(collectives=CollectivesTcp(timeout=timeout, native_plane=True),
                      load_state_dict=lambda s: None, state_dict=lambda: {},
                      min_replica_size=1, replica_id="lifetime", store_addr=store.address(),
                      rank=0, world_size=1, lighthouse_addr=lighthouse.address(),
                      timeout=timeout)
    try:
        for _ in range(3):
            manager.start_quorum()
            manager.allreduce_many([np.ones(100, np.float32)]).wait()
            assert manager.should_commit()
        watchdog = manager._watchdog._thread
        assert watchdog is not None and watchdog.is_alive()
        ref = weakref.ref(manager)
        if shutdown:
            manager.shutdown(wait=True)
        del manager
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            gc.collect()
            if ref() is None:
                break
            time.sleep(0.05)
        holders = [t.name for t in threading.enumerate()
                   if ref() is not None and _refers(t, ref())]
        watchdog.join(5.0)
        return ref() is None, holders, watchdog.is_alive()
    finally:
        store.shutdown()
        lighthouse.shutdown()


def _refers(thread, obj):
    seen, todo = set(), [thread]
    for _ in range(4):  # a few levels of referents: target, bound self, closures
        nxt = []
        for o in todo:
            for r in gc.get_referents(o):
                if r is obj:
                    return True
                if id(r) not in seen and not isinstance(r, (str, bytes, int, float)):
                    seen.add(id(r))
                    nxt.append(r)
        todo = nxt
    return False


def test_shutdown_leaves_no_thread_holding_the_manager():
    """After ``Manager.shutdown()`` no live thread refers to the Manager:
    its step watchdog's thread has stopped, and the Manager (with whatever
    it holds, CUDA graphs on the card) is collected. Built like
    ``test_torch_death_path.py::test_teardown_wakes_the_acceptor_and_frees_the_watcher``."""
    freed, holders, watchdog_alive = _manager_lifetime(shutdown=True)
    assert freed and not holders and not watchdog_alive, (freed, holders, watchdog_alive)


# ---------------------------------------------------------------------------
# a kill of one of two worker processes, read back from their telemetry
# ---------------------------------------------------------------------------


def test_kill_trails_spans_and_flight_dump(monkeypatch):
    """``measure_recovery`` on the CPU: the survivor's trail holds the
    accepted eviction of the victim and the quorum without it; the
    rejoiner's heal_recv span and the survivor's checkpoint_serve span
    share one trace id, the serve span parented on the heal's (the
    ``X-TFT-Trace`` header); a SIGUSR2 to the survivor dumps its flight
    recorder with its completed allreduces and its step-anatomy rows, each
    summing to its wall clock (worker processes, one group each: the rows
    hold that group's steps alone)."""
    from torchft_tpu_torch.benchmarks.recovery import measure_recovery

    monkeypatch.setenv("DEVICE", "cpu")
    r = measure_recovery(total_steps=16, kill_at_step=5, step_sleep=0.05, op_timeout=5.0,
                         heartbeat_timeout_ms=5000, timeout_s=120.0)
    obs = r.observability
    assert any(e["evicted"] and e["victim"].startswith("group1_")
               for e in obs["survivor_evictions"]), obs
    assert any(not q["victim_in"] and q["num_participants"] == 1
               for q in obs["survivor_quorums_after_kill"]), obs
    assert obs["rejoiner_heal_trace_id"] and obs["rejoiner_heal_trace_id"].startswith("group1_")
    assert obs["serve_spans_in_that_trace"] == {0: 1} and obs["serve_spans_parented"], obs
    fd = obs["flight_dump"]
    assert fd["reason"] == "signal" and fd["completed_allreduces"] >= 1, fd
    assert fd["last_completed"]["op"] == "allreduce"
    with open(fd["path"]) as f:
        rows = json.load(f)["anatomy"]["rows"]
    assert rows
    for row in rows:
        assert sum(row["phases"].values()) == pytest.approx(row["wall_s"], abs=2e-5), row
    # every worker's trail: one commit event per committed step of its own
    trail = P.read_trail(r.log_paths[0] + ".trail")
    commits = [e["step"] for e in trail if e["event"] == "commit"]
    assert len(commits) == len(set(commits)) and commits == sorted(commits)
