"""The port's diagnosis plane against the JAX package's.

The cases of ``tests/test_diagnosis.py`` on the port: the collapsed-stack
helpers, the Python sampler, the native sampler through the port's
``_native`` (``tft_prof_*``), the trigger engine (five latches debounced
once an episode, one capture a process, distinct SLO streams, pids in
bundle names, the remote-subject filter, no directory no engine, the
bundle's schema and files, its round trip through ``postmortem
--bundles``, the burst boost restored), the flight dump's thread stacks,
and the empty-surface hints (the critical path's status, the lighthouse's
``/diagnosis.json`` fed by a heartbeat's ``diag_*`` keys). Then the
packages side by side: the folded helpers give equal output on
numpy-seeded stacks, and the same latch events give the same episodes and
``bundle.json`` keys (the JAX ``jax_trace`` is the port's ``torch_trace``).
Last, the lifetimes and the card's hazards, on the CPU: a Manager with
the engine and the sampler armed is collected after ``shutdown()`` and
its engine leaves the trail; the torch trace waits for a CUDA-graph
capture in progress (a thread holding the train step's capture lock
stands in for one), and the engine's bundle then carries it.
"""

from __future__ import annotations

import gc
import json
import os
import threading
import time
import weakref
from datetime import timedelta
from typing import Dict

import numpy as np
import pytest

from torchft_tpu.telemetry import diagnosis as jdiag
from torchft_tpu.telemetry import profiler as jprof
from torchft_tpu_torch import telemetry
from torchft_tpu_torch.telemetry import diagnosis as pdiag
from torchft_tpu_torch.telemetry import profiler as prof
from torchft_tpu_torch.telemetry.diagnosis import TRIGGER_EVENTS, DiagnosisEngine, read_bundles


@pytest.fixture(autouse=True)
def _clean_telemetry():
    """Both packages' process-wide planes zeroed, and the black boxes'
    coordinates (a bundle's fallback step) as no Manager has set them."""
    from torchft_tpu import telemetry as jtelemetry

    telemetry.reset()
    jtelemetry.reset()
    for box in (telemetry.BLACKBOX, jtelemetry.BLACKBOX):
        box.set_context(step=-1, quorum_epoch=-1)
    yield
    telemetry.reset()
    jtelemetry.reset()


# ---------------------------------------------------------------------------
# collapsed-stack (folded) utilities
# ---------------------------------------------------------------------------


class TestFolded:
    def test_parse_render_roundtrip(self):
        text = "a;b;c 3\nx;y 1\n"
        assert prof.render_folded(prof.parse_folded(text)) == text

    def test_merge_exact_across_processes(self):
        a = "dp.pump;run;hop 10\ndp.pump;run;idle 4\nrpc.serve;loop 2\n"
        b = "dp.pump;run;hop 7\nblob.serve;conn 1\n"
        merged = prof.parse_folded(prof.merge_folded(a, b))
        pa, pb = prof.parse_folded(a), prof.parse_folded(b)
        for key in set(pa) | set(pb):
            assert merged[key] == pa.get(key, 0) + pb.get(key, 0)
        assert merged["dp.pump;run;hop"] == 17

    def test_subtract_is_window(self):
        window = prof.parse_folded(prof.subtract_folded("a;b 9\nc;d 2\ne;f 3\n",
                                                        "a;b 5\nc;d 2\n"))
        assert window == {"a;b": 4, "e;f": 3}

    def test_subtract_tolerates_reset(self):
        assert prof.parse_folded(prof.subtract_folded("a;b 1\n", "a;b 5\n")) == {}

    def test_malformed_lines_skipped(self):
        assert prof.parse_folded("garbage\na;b notanum\nx;y 2\n") == {"x;y": 2}


def _random_folded(rng, n=60):
    frames = ["dp.pump", "run_stripe", "hop", "sleep_ms", "nanosleep", "poll", "rpc.serve",
              "loop", "a b", "x;y", "blob.serve"]
    lines = []
    for _ in range(n):
        depth = int(rng.integers(1, 6))
        stack = ";".join(frames[int(rng.integers(len(frames)))] for _ in range(depth))
        count = int(rng.integers(-2, 40))
        lines.append(f"{stack} {count}" if rng.random() > 0.05 else stack)
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("seed", range(6))
def test_folded_helpers_equal_in_both_packages(seed):
    rng = np.random.default_rng(seed)
    a, b, c = (_random_folded(rng) for _ in range(3))
    assert prof.parse_folded(a) == jprof.parse_folded(a)
    assert prof.render_folded(prof.parse_folded(a)) == jprof.render_folded(jprof.parse_folded(a))
    assert prof.merge_folded(a, b, c) == jprof.merge_folded(a, b, c)
    assert prof.subtract_folded(a, b) == jprof.subtract_folded(a, b)


# ---------------------------------------------------------------------------
# the samplers
# ---------------------------------------------------------------------------


class TestPySampler:
    def test_sample_once_names_thread_and_function(self):
        stop = threading.Event()

        def parked_in_named_function():
            stop.wait(5.0)

        t = threading.Thread(target=parked_in_named_function, name="tft_test_parked",
                             daemon=True)
        t.start()
        try:
            s = prof.PyStackSampler(hz=0)  # manual ticks only
            n = s.sample_once()
            assert n >= 1
            mine = [line for line in s.folded().splitlines()
                    if line.startswith("tft_test_parked;")]
            assert mine and "parked_in_named_function" in mine[0]
            assert s.samples_total() == n
            s.reset()
            assert s.folded() == "" and s.samples_total() == 0
        finally:
            stop.set()
            t.join()

    def test_metric_counts_py_plane(self):
        before = telemetry.PROF_SAMPLES.labels(plane="py").value
        n = prof.PyStackSampler(hz=0).sample_once()
        assert telemetry.PROF_SAMPLES.labels(plane="py").value - before == n

    def test_disarmed_starts_no_thread(self):
        s = prof.PyStackSampler(hz=0)
        assert s.ensure_started()._thread is None
        s.set_hz(50)
        try:
            assert s._thread is not None
            deadline = time.monotonic() + 2.0
            while s.samples_total() == 0 and time.monotonic() < deadline:
                time.sleep(0.02)
            assert s.samples_total() > 0
        finally:
            s.stop()


def _dp_pair():
    from torchft_tpu_torch import _native

    a = _native.NativeDataPlane(0, 2, nstripes=2)
    b = _native.NativeDataPlane(1, 2, nstripes=2)
    b.connect(0, "127.0.0.1", a.port, 5000)
    a.wait_ready(5000)
    b.wait_ready(5000)
    return a, b


def _dp_traffic(a, b, rounds: int = 30, tag0: int = 1):
    bufs = [np.ones(1 << 16, dtype=np.float32) for _ in range(2)]

    def run(dp, buf):
        for t in range(rounds):
            dp.allreduce(buf.ctypes.data, buf.size, "avg", tag=tag0 + t, timeout_ms=20000)

    threads = [threading.Thread(target=run, args=(dp, buf), daemon=True)
               for dp, buf in ((a, bufs[0]), (b, bufs[1]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert bufs[0][0] == 1.0


class TestNativeProfiler:
    def test_armed_samples_dp_pump(self):
        from torchft_tpu_torch import _native

        _native.prof_reset()
        _native.prof_set_hz(199.0)
        try:
            a, b = _dp_pair()
            try:
                _dp_traffic(a, b, rounds=60)
                time.sleep(0.2)
            finally:
                a.close()
                b.close()
            folded = _native.prof_snapshot()
            assert any(line.startswith("dp.pump;") for line in folded.splitlines()), folded[:500]
            assert _native.prof_samples_total() > 0
            before = telemetry.PROF_SAMPLES.labels(plane="native").value
            prof.poll_native_samples()
            assert telemetry.PROF_SAMPLES.labels(plane="native").value > before
            _native.prof_reset()
            assert _native.prof_snapshot() == "" and _native.prof_samples_total() == 0
        finally:
            _native.prof_set_hz(prof.env_hz())

    def test_disarmed_profiler_zero_cost_on_dp_hop(self):
        from torchft_tpu_torch import _native

        _native.prof_set_hz(0.0)
        _native.prof_reset()
        try:
            a, b = _dp_pair()
            try:
                _dp_traffic(a, b, rounds=40)
            finally:
                a.close()
                b.close()
            assert _native.prof_snapshot() == ""
            assert _native.prof_samples_total() == 0
        finally:
            _native.prof_set_hz(prof.env_hz())

    def test_rate_round_trips_through_the_bindings(self):
        assert prof.native_set_hz(23.0)
        try:
            assert prof.native_hz() == 23.0
        finally:
            prof.native_set_hz(prof.env_hz())
        assert prof.native_hz() == prof.env_hz()


# ---------------------------------------------------------------------------
# trigger engine
# ---------------------------------------------------------------------------


def _mk_engine(tmp_path, **kw) -> DiagnosisEngine:
    kw.setdefault("directory", str(tmp_path / "diag"))
    kw.setdefault("replica_id", "g1")
    kw.setdefault("window_s", 0.01)
    kw.setdefault("burst_hz", 0.0)
    kw.setdefault("synchronous", True)
    os.makedirs(kw["directory"], exist_ok=True)
    return DiagnosisEngine(**kw)


_TRIGGER_FIXTURE: Dict[str, Dict] = {
    "straggler_detected": {"group": "g1", "p50_s": 0.4},
    "perf_regression": {"replica": "g1", "series": "local_s", "step": 7},
    "slo_breach": {"slo": "step_time", "threshold_s": 0.5},
    "watchdog_stall": {"step": 9, "elapsed_s": 120.0},
    "divergence_detected": {"step": 11, "fence": False},
}


class TestTriggerEngine:
    def test_debounce_once_per_episode_all_five(self, tmp_path):
        now = [0.0]
        eng = _mk_engine(tmp_path, rearm_s=600.0, clock=lambda: now[0]).install()
        try:
            for kind, fields in _TRIGGER_FIXTURE.items():
                telemetry.emit(kind, **fields)
                telemetry.emit(kind, **fields)  # same episode: debounced
            assert eng.bundle_count == len(TRIGGER_EVENTS)
            telemetry.emit("straggler_cleared", group="g1")
            telemetry.emit("perf_regression_cleared", replica="g1", series="local_s")
            telemetry.emit("slo_recovered", slo="step_time")
            for kind in ("straggler_detected", "perf_regression", "slo_breach"):
                telemetry.emit(kind, **_TRIGGER_FIXTURE[kind])
            assert eng.bundle_count == len(TRIGGER_EVENTS) + 3
            telemetry.emit("watchdog_stall", **_TRIGGER_FIXTURE["watchdog_stall"])
            telemetry.emit("divergence_detected", **_TRIGGER_FIXTURE["divergence_detected"])
            assert eng.bundle_count == len(TRIGGER_EVENTS) + 3
            now[0] += 601.0
            telemetry.emit("watchdog_stall", **_TRIGGER_FIXTURE["watchdog_stall"])
            telemetry.emit("divergence_detected", **_TRIGGER_FIXTURE["divergence_detected"])
            assert eng.bundle_count == len(TRIGGER_EVENTS) + 5
        finally:
            eng.remove()

    def test_default_rearm_is_the_module_constant(self, tmp_path, monkeypatch):
        from torchft_tpu_torch.telemetry import diagnosis

        monkeypatch.setattr(diagnosis, "DEFAULT_REARM_S", 5.0)
        assert _mk_engine(tmp_path).rearm_s == 5.0

    def test_one_capture_per_process_across_engines(self, tmp_path):
        pre_hz = prof.PROFILER.hz
        a = _mk_engine(tmp_path, synchronous=False, window_s=0.05).install()
        b = _mk_engine(tmp_path, synchronous=False, window_s=0.05).install()
        try:
            telemetry.emit("divergence_detected", step=3, fence=False)
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline and a.bundle_count + b.bundle_count < 1:
                time.sleep(0.01)
            time.sleep(0.2)  # slack for a (buggy) second capture to land
            assert a.bundle_count + b.bundle_count == 1
            assert prof.PROFILER.hz == pre_hz
            assert a.wait_idle(5.0) and b.wait_idle(5.0)
        finally:
            a.remove()
            b.remove()

    def test_distinct_slos_are_distinct_episodes(self, tmp_path):
        eng = _mk_engine(tmp_path).install()
        try:
            telemetry.emit("slo_breach", slo="step_time")
            telemetry.emit("slo_breach", slo="rejoin_commit")
            assert eng.bundle_count == 2
            telemetry.emit("slo_recovered", slo="rejoin_commit")
            telemetry.emit("slo_breach", slo="step_time")  # still latched
            assert eng.bundle_count == 2
            telemetry.emit("slo_breach", slo="rejoin_commit")  # re-armed
            assert eng.bundle_count == 3
        finally:
            eng.remove()

    def test_bundle_names_carry_pid(self, tmp_path):
        eng = _mk_engine(tmp_path).install()
        try:
            telemetry.emit("watchdog_stall", step=1)
        finally:
            eng.remove()
        assert f"_{os.getpid()}_" in eng.bundles[0]

    def test_remote_subject_filtered(self, tmp_path):
        eng = _mk_engine(tmp_path).install()
        try:
            telemetry.emit("straggler_detected", group="SOME_OTHER_GROUP")
            telemetry.emit("perf_regression", replica="not_me", series="local_s")
            assert eng.bundle_count == 0
            telemetry.emit("straggler_detected", group="g1-uuid-suffix")
            assert eng.bundle_count == 1
        finally:
            eng.remove()

    def test_disabled_without_dir(self, monkeypatch):
        monkeypatch.delenv("TORCHFT_DIAG_DIR", raising=False)
        eng = DiagnosisEngine(directory=None, replica_id="g1", synchronous=True)
        eng.install()  # no-op: disabled
        telemetry.emit("watchdog_stall", step=1)
        assert eng.bundle_count == 0

    def test_bundle_schema_and_capture_contents(self, tmp_path):
        eng = _mk_engine(tmp_path, window_s=0.05).install()
        try:
            telemetry.emit("slo_breach", slo="step_time", step=3)
        finally:
            eng.remove()
        bundles = read_bundles(eng.directory)
        assert len(bundles) == 1
        b = bundles[0]
        assert b["schema"] == 1 and b["trigger"]["event"] == "slo_breach"
        assert b["replica_id"] == "g1"
        assert set(b["files"]) >= {"native_folded", "python_folded", "flight", "torch_trace"}
        for fname in ("bundle.json", "native.folded", "python.folded", "flight.json"):
            assert os.path.isfile(os.path.join(b["_dir"], fname)), fname
        assert isinstance(b["lathist"], dict) and b["torch_trace"] is False
        with open(os.path.join(b["_dir"], "flight.json"), encoding="utf-8") as f:
            flight = json.load(f)
        assert "entries" in flight and "first_stuck" in flight
        assert "diagnosis_captured" in [e["event"] for e in telemetry.EVENTS.recent()]
        assert telemetry.DIAGNOSIS_BUNDLES.labels(trigger="slo_breach").value == 1

    def test_bundle_roundtrips_through_postmortem_bundles(self, tmp_path):
        eng = _mk_engine(tmp_path).install()
        try:
            telemetry.emit("watchdog_stall", step=41, elapsed_s=99.0)
        finally:
            eng.remove()
        from torchft_tpu_torch.telemetry import postmortem

        report = postmortem.analyze(str(tmp_path), bundles_dir=eng.directory)
        assert len(report["bundles"]) == 1
        assert report["bundles"][0]["trigger"]["event"] == "watchdog_stall"
        caps = [r for r in report["timeline"] if r.get("k") == "diagnosis_captured"]
        assert len(caps) == 1 and caps[0]["st"] == 41
        assert caps[0]["path"] == report["bundles"][0]["_dir"]
        assert postmortem.analyze(str(tmp_path))["bundles"] == []
        assert postmortem.main([str(tmp_path), "--bundles", eng.directory]) == 0
        # the JAX postmortem folds the port's bundle alike
        from torchft_tpu.telemetry import postmortem as jpm

        ref = jpm.analyze(str(tmp_path), bundles_dir=eng.directory)
        assert [r["bundle"] for r in ref["timeline"] if r.get("k") == "diagnosis_captured"] \
            == [caps[0]["bundle"]]

    def test_burst_boost_restores_rate(self, tmp_path):
        before = prof.PROFILER.hz
        eng = _mk_engine(tmp_path, burst_hz=123.0, window_s=0.05).install()
        try:
            telemetry.emit("slo_breach", slo="step_time")
        finally:
            eng.remove()
        assert prof.PROFILER.hz == before
        assert eng.bundle_count == 1


def _latch_script(rng, n=40):
    """A numpy-seeded sequence of (event, fields, clock advance): latches,
    clears and the remote subjects the engine must drop."""
    kinds = list(_TRIGGER_FIXTURE) + ["straggler_cleared", "perf_regression_cleared",
                                      "slo_recovered", "commit"]
    out = []
    for _ in range(n):
        kind = kinds[int(rng.integers(len(kinds)))]
        fields = dict(_TRIGGER_FIXTURE.get(kind, {}))
        if kind in ("straggler_detected", "straggler_cleared"):
            fields["group"] = ["g1", "g1-x", "g2"][int(rng.integers(3))]
        if kind in ("perf_regression", "perf_regression_cleared"):
            fields.update(replica=["g1", "g0"][int(rng.integers(2))],
                          series=["local_s", "wall_s"][int(rng.integers(2))])
        if kind in ("slo_breach", "slo_recovered"):
            fields["slo"] = ["step_time", "rejoin_commit"][int(rng.integers(2))]
        out.append((kind, fields, float(rng.choice([0.0, 10.0, 400.0]))))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_same_latches_give_the_same_episodes_and_bundle_keys(tmp_path, seed):
    """Both packages' engines (synchronous, one injected clock) fed the
    same latch sequence: a bundle after the same events, and bundle.json
    carrying the same keys (the JAX ``jax_trace`` is ``torch_trace``)."""
    from torchft_tpu import telemetry as jtelemetry

    script = _latch_script(np.random.default_rng(seed))
    runs = {}
    for name, mod, tel in (("port", __import__("torchft_tpu_torch.telemetry.diagnosis",
                                                fromlist=["x"]), telemetry),
                           ("jax", jdiag, jtelemetry)):
        now = [0.0]
        d = tmp_path / name
        d.mkdir()
        eng = mod.DiagnosisEngine(directory=str(d), replica_id="g1", window_s=0.0, burst_hz=0.0,
                                  rearm_s=600.0, synchronous=True, clock=lambda: now[0]).install()
        counts = []
        try:
            for kind, fields, advance in script:
                now[0] += advance
                tel.emit(kind, **fields)
                counts.append(eng.bundle_count)
        finally:
            eng.remove()
        # in capture order (read_bundles orders by a millisecond stamp)
        by_name = {m["bundle"]: m for m in mod.read_bundles(str(d))}
        metas = [by_name[b] for b in eng.bundles]
        runs[name] = (counts, [(m["trigger"]["event"], m["step"]) for m in metas],
                      [sorted(k.replace("jax_trace", "torch_trace") for k in m)
                       for m in metas],
                      [sorted(k.replace("jax_trace", "torch_trace") for k in m["files"])
                       for m in metas])
    assert runs["port"] == runs["jax"]
    assert runs["port"][0][-1] > 0


# ---------------------------------------------------------------------------
# satellites: crash-time evidence and the empty-surface hints
# ---------------------------------------------------------------------------


class TestFlightDumpStacks:
    def test_dump_carries_live_python_thread_stacks(self, tmp_path):
        stop = threading.Event()

        def wedged_in_named_place():
            stop.wait(5.0)

        t = threading.Thread(target=wedged_in_named_place, name="tft_test_wedged", daemon=True)
        t.start()
        try:
            rec = telemetry.FlightRecorder(size=16)
            rec.record_issue("allreduce", "test", 128)
            os.environ["TORCHFT_FLIGHT_DIR"] = str(tmp_path)
            try:
                path = rec.dump("manual", force=True)
            finally:
                os.environ.pop("TORCHFT_FLIGHT_DIR", None)
            with open(path, encoding="utf-8") as f:
                payload = json.load(f)
            mine = [s for s in payload["py_stacks"] if s["thread"] == "tft_test_wedged"]
            assert mine and any("wedged_in_named_place" in fr for fr in mine[0]["frames"])
        finally:
            stop.set()
            t.join()


class TestStatusHints:
    def test_critical_path_no_monitor_vs_empty_vs_ok(self):
        from torchft_tpu_torch.telemetry import critical_path as cp

        cp.set_reporter(None)
        assert json.loads(cp.report_json())["status"] == "no-monitor"
        att = cp.CriticalPathAttributor()
        cp.set_reporter(att)
        try:
            assert json.loads(cp.report_json())["status"] == "empty"
            att.observe_step(5, {"a": {"wall_s": 1.0, "local_s": 0.9, "phases": {"compute": 0.9}},
                                 "b": {"wall_s": 1.0, "local_s": 0.5,
                                       "phases": {"compute": 0.5}}})
            assert json.loads(cp.report_json())["status"] == "ok"
        finally:
            cp.set_reporter(None)

    def test_lighthouse_diagnosis_json_empty_then_ok(self):
        import urllib.request

        from torchft_tpu_torch.coordination import LighthouseClient, LighthouseServer

        def get(base):
            with urllib.request.urlopen(base + "/diagnosis.json", timeout=5) as resp:
                return json.loads(resp.read().decode())

        def beat(base, payload):
            client = LighthouseClient(base.split("//", 1)[-1],
                                      connect_timeout=timedelta(seconds=5))
            try:
                client.heartbeat("repl_a", timeout=timedelta(seconds=5),
                                 telemetry_payload=payload)
            finally:
                client.close()

        lh = LighthouseServer(bind="[::]:0", min_replicas=1)
        try:
            base = lh.address()
            doc = get(base)
            assert doc["status"] == "empty" and doc["bundles_total"] == 0
            beat(base, {"step": 12, "diag_bundles": 2, "diag_last": "diag_17_straggler_detected_2",
                        "diag_dir": "/tmp/diag"})
            doc = get(base)
            assert doc["status"] == "ok" and doc["bundles_total"] == 2
            assert doc["replicas"]["repl_a"]["bundles"] == 2
            assert doc["replicas"]["repl_a"]["last"] == "diag_17_straggler_detected_2"
            beat(base, {"step": 13, "diag_bundles": 3, "diag_last": "x" * 300,
                        "diag_dir": "/d/" + "y" * 600})
            doc = get(base)
            assert doc["replicas"]["repl_a"]["last"] == "(oversized)"
            assert doc["replicas"]["repl_a"]["dir"] == "(oversized)"
        finally:
            lh.shutdown()


# ---------------------------------------------------------------------------
# the Manager's wiring, lifetimes and the capture hazard
# ---------------------------------------------------------------------------


def _diag_manager(monkeypatch, tmp_path, lighthouse_addr, store, replica_id):
    from torchft_tpu_torch.collectives import CollectivesTcp
    from torchft_tpu_torch.manager import Manager

    monkeypatch.setenv("TORCHFT_DIAG_DIR", str(tmp_path / "diag"))
    timeout = timedelta(seconds=20)
    return Manager(collectives=CollectivesTcp(timeout=timeout, native_plane=False),
                   load_state_dict=lambda s: None, state_dict=lambda: {}, min_replica_size=1,
                   replica_id=replica_id, store_addr=store.address(), rank=0, world_size=1,
                   lighthouse_addr=lighthouse_addr, timeout=timeout)


def _steps(manager, n=3):
    for _ in range(n):
        manager.start_quorum()
        manager.allreduce_many([np.ones(100, np.float32)]).wait()
        assert manager.should_commit()


def test_manager_announces_its_bundles(monkeypatch, tmp_path):
    """With ``TORCHFT_DIAG_DIR`` the Manager hosts an engine: a latch naming
    it writes a bundle, its report and payload then carry ``diag_bundles``
    / ``diag_last`` / ``diag_dir``, and the lighthouse's
    ``/diagnosis.json`` lists the bundle after the next quorum."""
    import urllib.request

    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.store import StoreServer

    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=1)
    store = StoreServer()
    manager = _diag_manager(monkeypatch, tmp_path, lighthouse.address(), store, "diagwire")
    try:
        engine = manager._diagnosis
        assert engine is not None and engine.directory == str(tmp_path / "diag")
        assert prof.PROFILER._thread is not None or prof.PROFILER.hz <= 0
        _steps(manager, 2)
        engine.window_s = 0.01
        telemetry.emit("watchdog_stall", step=manager.current_step())
        assert engine.wait_idle(10.0) and engine.bundle_count == 1
        report = manager._telemetry_report()
        assert report["diag_bundles"] == 1 and report["diag_last"] == engine.last_bundle
        assert manager._telemetry_payload_json()["diag_dir"] == engine.directory
        _steps(manager, 1)
        with urllib.request.urlopen(lighthouse.address() + "/diagnosis.json", timeout=5) as r:
            doc = json.loads(r.read().decode())
        assert doc["bundles_total"] == 1
        assert [v["last"] for v in doc["replicas"].values()] == [engine.last_bundle]
    finally:
        manager.shutdown(wait=True)
        store.shutdown()
        lighthouse.shutdown()


def test_manager_with_the_engine_armed_is_collected_after_shutdown(monkeypatch, tmp_path):
    """The engine subscribes to the process-wide trail and the sampler is
    a process-wide thread: after ``shutdown()`` the engine has left the
    trail, no thread refers to the Manager, and it is collected."""
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.store import StoreServer
    from torchft_tpu_torch.telemetry import EVENTS

    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=1)
    store = StoreServer()
    try:
        manager = _diag_manager(monkeypatch, tmp_path, lighthouse.address(), store, "diaglife")
        engine = manager._diagnosis
        assert engine.on_event in EVENTS._subscribers
        _steps(manager)
        prof.PROFILER.sample_once()  # the sampler has seen the Manager's frames
        ref = weakref.ref(manager)
        manager.shutdown(wait=True)
        del manager
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and ref() is not None:
            gc.collect()
            time.sleep(0.05)
        assert ref() is None
        assert engine.on_event not in EVENTS._subscribers
    finally:
        store.shutdown()
        lighthouse.shutdown()


def test_torch_trace_waits_for_a_capture(monkeypatch, tmp_path):
    """A thread holding the train step's capture lock (what a CUDA-graph
    capture holds) keeps the trace from starting: the profiler's start
    runs only once the lock is released. The trace then records the
    window and lands as ``trace.json``."""
    import torch.profiler

    from torchft_tpu_torch.parallel import train_step

    monkeypatch.setenv("TORCHFT_DIAG_TORCH", "1")
    started = []
    real = torch.profiler.profile

    class Recording(real):
        def start(self):
            started.append(time.monotonic())
            return super().start()

    monkeypatch.setattr(torch.profiler, "profile", Recording)
    captured = threading.Event()
    release = threading.Event()

    def capture():
        with train_step.capture_quiesced():
            captured.set()
            release.wait(10.0)
            return

    holder = threading.Thread(target=capture, name="tft_test_capture", daemon=True)
    holder.start()
    assert captured.wait(5.0)
    out = {}
    tracer = threading.Thread(
        target=lambda: out.setdefault("dir", prof.capture_torch_trace(str(tmp_path / "t"), 0.05)),
        name="tft_test_trace", daemon=True)
    tracer.start()
    time.sleep(0.3)
    assert not started, "the trace started while a capture held the lock"
    released_at = time.monotonic()
    release.set()
    tracer.join(30.0)
    holder.join(5.0)
    assert started and started[0] >= released_at
    assert out["dir"] == str(tmp_path / "t")
    assert os.path.isfile(os.path.join(out["dir"], prof.TRACE_FILE))


def test_engine_bundle_carries_the_torch_trace(monkeypatch, tmp_path):
    """With ``TORCHFT_DIAG_TORCH=1`` the capture window is the torch trace:
    ``torch_trace/trace.json`` in the bundle, named in ``bundle.json``."""
    monkeypatch.setenv("TORCHFT_DIAG_TORCH", "1")
    eng = _mk_engine(tmp_path, window_s=0.05).install()
    try:
        telemetry.emit("watchdog_stall", step=2)
    finally:
        eng.remove()
    (b,) = read_bundles(eng.directory)
    assert b["torch_trace"] is True and b["files"]["torch_trace"] == "torch_trace"
    with open(os.path.join(b["_dir"], "torch_trace", prof.TRACE_FILE), encoding="utf-8") as f:
        assert "traceEvents" in json.load(f)


def test_engine_trace_spans_a_steady_step(monkeypatch, tmp_path):
    """A step runs its compute phase once: when the window is shorter than
    ``TRACE_STEPS`` of the ledger's steady steps, the trace stays open that
    long (and the samplers' window stays ``window_s``)."""
    monkeypatch.setenv("TORCHFT_DIAG_TORCH", "1")
    monkeypatch.setattr(pdiag, "_step_wall_p50", lambda: 0.4)
    spans = []
    start, stop = prof.start_torch_trace, prof.stop_torch_trace

    def timed_start(log_dir):
        spans.append(time.monotonic())
        return start(log_dir)

    def timed_stop(session, log_dir):
        spans.append(time.monotonic())
        return stop(session, log_dir)

    monkeypatch.setattr(prof, "start_torch_trace", timed_start)
    monkeypatch.setattr(prof, "stop_torch_trace", timed_stop)
    eng = _mk_engine(tmp_path, window_s=0.05).install()
    try:
        telemetry.emit("watchdog_stall", step=2)
    finally:
        eng.remove()
    (b,) = read_bundles(eng.directory)
    assert b["torch_trace"] is True and b["window_s"] == 0.05
    assert spans[1] - spans[0] >= pdiag.TRACE_STEPS * 0.4


def test_torch_trace_disabled_is_not_slept():
    """Without ``TORCHFT_DIAG_TORCH`` the trace returns at once (the caller
    sleeps the window itself)."""
    os.environ.pop("TORCHFT_DIAG_TORCH", None)
    t0 = time.monotonic()
    assert prof.capture_torch_trace("/nonexistent/never", 5.0) is None
    assert time.monotonic() - t0 < 1.0


# ---------------------------------------------------------------------------
# the samplers' overhead row
# ---------------------------------------------------------------------------


def _jax_profiler_overhead_keys():
    """The keys of the dict ``torchft_tpu/benchmarks/profiler_overhead.py``'s
    ``measure`` returns, from its source."""
    import ast

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "torchft_tpu", "benchmarks", "profiler_overhead.py")
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "measure")
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return))
    return {k.value for k in ret.value.keys}


def test_profiler_overhead_row_carries_the_jax_keys(monkeypatch):
    """The row at a tiny model on the CPU, two pairs: the JAX row's keys,
    both legs timed, the samplers left armed at the default rate, and
    samples taken in the armed legs."""
    import torch

    from torchft_tpu_torch.benchmarks import profiler_overhead
    from torchft_tpu_torch.models.transformer import TransformerConfig

    monkeypatch.setenv("DEVICE", "cpu")
    cfg = TransformerConfig(vocab_size=64, d_model=32, n_layers=1, n_heads=2, head_dim=16,
                            d_ff=64, dtype=torch.float32, attention_impl="flash")
    try:
        row = profiler_overhead.measure(runs=2, steps=2, warmup=1, batch=2, seq=16, cfg=cfg)
    finally:
        prof.native_set_hz(prof.env_hz())
    assert set(row) == _jax_profiler_overhead_keys()
    assert len(row["runs_armed"]) == len(row["runs_disarmed"]) == 2
    assert row["steps_per_sec"] > 0 and row["steps_per_sec_disarmed"] > 0
    assert row["hz"] == prof.DEFAULT_HZ == jprof.DEFAULT_HZ
    assert row["gate_pct"] == profiler_overhead.GATE_PCT == 2.0
    assert row["within_gate"] == (row["overhead_pct"] <= row["gate_pct"])
    assert prof.PROFILER.hz == prof.DEFAULT_HZ and prof.native_hz() == prof.DEFAULT_HZ
    assert row["py_samples"] >= 0 and row["native_samples"] >= 0
