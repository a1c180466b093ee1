"""The port's crash-durable black box and postmortem against the JAX
package's.

The cases of ``tests/test_blackbox.py`` on the port: the mmap'd ring
(round trip, wraparound, a torn tail skipped, SIGKILL mid-write), the
native breadcrumb ring of the port's core, the postmortem merge (causal
order, victim, in-flight op, the classifications, trails only without
boxes, the ``blackbox_recovered`` event, the CLI) and the mirrors of the
trail and the flight recorder. Then the contract between the packages:
each package's reader reads the other's Python and native rings to the
same records, and ``analyze`` of one directory gives the same victim,
in-flight ops, first anomaly and classification in both.
``tests/test_timeseries.py``'s ``TestPostmortemPerf`` runs on the port
(both packages' ``perf_windows`` over the same boxes). Last, a two-process
kill on the CPU under a ``kill`` schedule (the recovery harness with the
victim's first incarnation killing itself at its eighth gradient
allreduce): both postmortems read the directory alike, and the JAX
package's protocol checker (``torchft_tpu.analysis.protocol.check_tree``)
finds every recorded transition legal.
"""

import json
import os
import signal
import struct
import subprocess
import sys
import time

import numpy as np
import pytest

from tests.conftest import scaled_timeout
from torchft_tpu.telemetry import blackbox as jbb
from torchft_tpu.telemetry import postmortem as jpm
from torchft_tpu_torch import telemetry
from torchft_tpu_torch.telemetry import postmortem
from torchft_tpu_torch.telemetry.blackbox import (
    _FRAME,
    _FRAME_MAGIC,
    _HEADER_SIZE,
    _NATIVE_REC,
    BlackBox,
    read_blackbox,
    read_native_blackbox,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestBlackBoxRing:
    def test_round_trip_and_order(self, tmp_path):
        path = str(tmp_path / "a.bb")
        bb = BlackBox(path)
        bb.set_context(replica_id="rep_a", step=0, quorum_epoch=1)
        bb.record("quorum_start", step=0)
        bb.record("op_issue", op="allreduce", fseq=1, plane="tcp")
        bb.set_context(step=1, quorum_epoch=2)
        bb.record("op_complete", fseq=1, status="completed")
        bb.close()
        records, meta = read_blackbox(path)
        assert meta["replica"] == "rep_a" and meta["torn"] == 0
        assert [r["k"] for r in records] == ["ctx", "quorum_start", "op_issue", "op_complete"]
        assert [r["q"] for r in records] == sorted(r["q"] for r in records)
        assert records[1]["ep"] == 1 and records[1]["st"] == 0
        assert records[3]["ep"] == 2 and records[3]["st"] == 1

    def test_wraparound_keeps_latest(self, tmp_path, monkeypatch):
        monkeypatch.setenv("TORCHFT_BLACKBOX_SIZE", "4096")
        path = str(tmp_path / "w.bb")
        bb = BlackBox(path)
        for i in range(500):  # far more than a 4 KiB ring holds
            bb.record("tick", i=i)
        bb.close()
        records, _meta = read_blackbox(path)
        ticks = [r["i"] for r in records if r["k"] == "tick"]
        assert ticks[-1] == 499
        assert all(b > a for a, b in zip(ticks, ticks[1:]))
        assert len(ticks) > 10

    def test_torn_tail_skipped_never_corrupt(self, tmp_path):
        path = str(tmp_path / "t.bb")
        bb = BlackBox(path)
        bb.record("good", n=1)
        bb.record("victim", n=2)
        bb.close()
        with open(path, "r+b") as f:
            raw = bytearray(f.read())
        off, frames = _HEADER_SIZE, []
        while off + _FRAME.size <= len(raw):
            magic, plen, _crc = _FRAME.unpack_from(raw, off)
            if magic != _FRAME_MAGIC:
                break
            frames.append((off, plen))
            off += _FRAME.size + plen + ((-plen) % 4)
        assert len(frames) == 2
        raw[frames[-1][0] + _FRAME.size + 5] ^= 0xFF  # one payload byte: the CRC fails
        with open(path, "wb") as f:
            f.write(raw)
        records, meta = read_blackbox(path)
        assert [r["k"] for r in records] == ["good"]
        assert meta["torn"] >= 1

    def test_sigkill_durability(self, tmp_path):
        """A writer SIGKILLed mid-stream leaves a CRC-valid box."""
        box_dir, marker = str(tmp_path), str(tmp_path / "marker")
        code = f"""
import os
os.environ["TORCHFT_BLACKBOX_DIR"] = {box_dir!r}
from torchft_tpu_torch.telemetry.blackbox import BLACKBOX
BLACKBOX.set_context(replica_id="kill_me", step=0, quorum_epoch=7)
i = 0
while True:
    BLACKBOX.record("spin", i=i)
    i += 1
    if i == 200:
        open({marker!r}, "w").close()
"""
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        try:
            deadline = time.monotonic() + scaled_timeout(60)
            while not os.path.exists(marker):
                assert proc.poll() is None, "writer died early"
                assert time.monotonic() < deadline, "writer never reached marker"
                time.sleep(0.01)
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=scaled_timeout(30))
        finally:
            if proc.poll() is None:
                proc.kill()
        boxes = [f for f in os.listdir(box_dir) if f.endswith(".bb")
                 and not f.endswith("_native.bb")]
        assert len(boxes) == 1
        records, meta = read_blackbox(os.path.join(box_dir, boxes[0]))
        assert meta["replica"] == "kill_me"
        spins = [r for r in records if r["k"] == "spin"]
        assert len(spins) >= 100
        for r in spins:
            assert r["ep"] == 7 and isinstance(r["i"], int)
        assert all(b["q"] > a["q"] for a, b in zip(records, records[1:]))


# a lighthouse and a heartbeat in a fresh process of one package: the
# native core reads TORCHFT_BLACKBOX_DIR once
_NATIVE = """
import os, sys
os.environ["TORCHFT_BLACKBOX_DIR"] = sys.argv[2]
from datetime import timedelta
if sys.argv[1] == "port":
    from torchft_tpu_torch.coordination import LighthouseClient, LighthouseServer
else:
    from torchft_tpu.coordination import LighthouseClient, LighthouseServer
lh = LighthouseServer(bind="[::]:0", min_replicas=1)
c = LighthouseClient(lh.address(), connect_timeout=timedelta(seconds=5))
c.heartbeat("bbtest")
c.close()
lh.shutdown()
"""


def _native_ring(pkg, d):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-c", _NATIVE, pkg, str(d)], cwd=REPO, env=env, check=True,
                   timeout=scaled_timeout(120), capture_output=True)
    boxes = [f for f in os.listdir(d) if f.endswith("_native.bb")]
    assert len(boxes) == 1
    return os.path.join(d, boxes[0])


class TestNativeBlackBox:
    def test_native_ring_recovers(self, tmp_path):
        """The port's core with the box armed: its breadcrumbs parse back
        CRC-valid and ordered (rpc.serve of the heartbeat)."""
        records, meta = read_native_blackbox(_native_ring("port", tmp_path))
        assert meta["torn"] == 0
        assert "rpc.serve" in {r["k"] for r in records}
        assert all(b["q"] > a["q"] for a, b in zip(records, records[1:]))
        assert abs(records[-1]["ts"] - time.time()) < 3600

    def test_native_record_struct_is_64_bytes(self):
        assert _NATIVE_REC.size == 64
        assert struct.calcsize("<IHHQQqqqqII") == 64
        assert _NATIVE_REC.format == jbb._NATIVE_REC.format


def _two_boxes(tmp_path, box=BlackBox):
    a = box(str(tmp_path / "tft_bb_1.bb"))
    a.set_context(replica_id="rep_a", step=0, quorum_epoch=1)
    a.record("quorum_start", step=0)
    a.record("op_issue", op="allreduce", plane="tcp", fseq=1)
    a.set_context(step=1, quorum_epoch=2)
    a.record("op_issue", op="allreduce", plane="tcp", fseq=2)
    a.close()  # "dies" with fseq=2 in flight at epoch 2
    b = box(str(tmp_path / "tft_bb_2.bb"))
    b.set_context(replica_id="rep_b", step=0, quorum_epoch=1)
    b.record("quorum_start", step=0)
    b.set_context(step=1, quorum_epoch=2)
    b.record("peer_death", ring_rank=0, replica="rep_a", step=1)
    b.record("abort", step=1)
    b.close()


class TestPostmortemMerge:
    def test_merge_ordering_and_victim(self, tmp_path):
        _two_boxes(tmp_path)
        report = postmortem.analyze(str(tmp_path))
        eps = [r["ep"] for r in report["timeline"] if r.get("ep", -1) >= 0]
        assert eps == sorted(eps)
        assert report["victim"] == "rep_a"
        assert report["victim_inflight_op"]["op"] == "allreduce"
        assert report["victim_inflight_op"]["fseq"] == 2
        assert report["victim_epoch"] == 2
        assert report["first_anomaly"]["k"] == "peer_death"
        assert report["classification"] == "new-bug"

    def test_injected_classification_wins(self, tmp_path):
        _two_boxes(tmp_path)
        with open(tmp_path / "tft_fault_1.json", "w") as f:
            f.write(json.dumps({"site": "cma.pull", "action": "kill", "pid": 1, "hit": 3}) + "\n")
        assert postmortem.analyze(str(tmp_path))["classification"] == "injected"

    def test_environmental_classification(self, tmp_path):
        _two_boxes(tmp_path)
        report = postmortem.analyze(str(tmp_path),
                                    log_text="worker: malloc(): invalid size (unsorted)")
        assert report["classification"] == "environmental"

    def test_trail_records_merge_only_without_boxes(self, tmp_path):
        with open(tmp_path / "trail0.jsonl", "w") as f:
            f.write(json.dumps({"ts": time.time(), "event": "commit", "step": 0}) + "\n")
            f.write('{"torn tail')  # skipped, not fatal
        report = postmortem.analyze(str(tmp_path))
        assert any(r["k"] == "commit" and r["src"] == "trail" for r in report["timeline"])
        assert report["trails_mirrored_by_boxes"] is False
        _two_boxes(tmp_path)
        report = postmortem.analyze(str(tmp_path))
        assert report["trails_mirrored_by_boxes"] is True
        assert not any(r["src"] == "trail" for r in report["timeline"])
        assert len([r for r in report["timeline"] if r["k"] == "peer_death"]) == 1

    def test_recovery_emits_event(self, tmp_path):
        _two_boxes(tmp_path)
        telemetry.EVENTS.clear()
        postmortem.analyze(str(tmp_path))
        recs = telemetry.EVENTS.recent(event="blackbox_recovered")
        assert recs and recs[-1]["boxes"] == 2

    def test_cli(self, tmp_path, capsys):
        _two_boxes(tmp_path)
        out_json = str(tmp_path / "report.json")
        assert postmortem.main([str(tmp_path), "--json", out_json]) == 2  # new-bug: loud
        text = capsys.readouterr().out
        assert "victim: rep_a" in text and "in-flight at death: allreduce" in text
        with open(out_json) as f:
            assert json.load(f)["victim"] == "rep_a"

    def test_cli_module_runs(self, tmp_path):
        """``python -m torchft_tpu_torch.telemetry.postmortem <dir>``."""
        _two_boxes(tmp_path)
        with open(tmp_path / "tft_fault_1.json", "w") as f:
            f.write(json.dumps({"site": "rpc.send", "action": "kill", "pid": 1, "hit": 1}) + "\n")
        proc = subprocess.run([sys.executable, "-m", "torchft_tpu_torch.telemetry.postmortem",
                               str(tmp_path), "--timeline", "3"], cwd=REPO,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "classification: injected" in proc.stdout


class TestEventTrailMirror:
    def test_emit_mirrors_into_blackbox(self, tmp_path):
        path = str(tmp_path / "m.bb")
        telemetry.BLACKBOX.configure(path)
        try:
            telemetry.emit("commit", step=42, participants=2)
        finally:
            telemetry.BLACKBOX.configure(None)
        records, _meta = read_blackbox(path)
        commits = [r for r in records if r["k"] == "commit"]
        assert commits and commits[0]["step"] == 42

    def test_flight_mirrors_into_blackbox(self, tmp_path):
        path = str(tmp_path / "f.bb")
        telemetry.BLACKBOX.configure(path)
        try:
            fid = telemetry.FLIGHT.record_issue("allreduce", "tcp", 128, tag=9, rank=0)
            telemetry.FLIGHT.record_complete(fid)
        finally:
            telemetry.BLACKBOX.configure(None)
        records, _meta = read_blackbox(path)
        kinds = [r["k"] for r in records]
        assert "op_issue" in kinds and "op_complete" in kinds
        issue = [r for r in records if r["k"] == "op_issue"][0]
        assert issue["op"] == "allreduce" and issue["fseq"] == fid

    def test_ledger_tick_mirrors_into_blackbox(self, tmp_path):
        """The ledger's mirror: one ``anatomy_tick`` a step row."""
        from torchft_tpu_torch.telemetry.anatomy import StepLedger

        path = str(tmp_path / "l.bb")
        ledger = StepLedger()
        telemetry.BLACKBOX.configure(path)
        try:
            ledger.tick(step=0)
            ledger.record("compute", 0.001)
            ledger.tick(step=1)
        finally:
            telemetry.BLACKBOX.configure(None)
        ticks = [r for r in read_blackbox(path)[0] if r["k"] == "anatomy_tick"]
        assert [t["step"] for t in ticks] == [1] and ticks[0]["wall_s"] >= 0.0

    def test_disarmed_record_is_noop(self, monkeypatch):
        monkeypatch.delenv("TORCHFT_BLACKBOX_DIR", raising=False)
        bb = BlackBox()
        bb.record("anything", x=1)
        assert bb.path is None


# ---------------------------------------------------------------------------
# the two packages over each other's rings
# ---------------------------------------------------------------------------


def _fill(box, rng, n=300):
    """A numpy-seeded mixed record stream (contexts, ops, events) into
    ``box``; small rings wrap."""
    for i in range(n):
        if rng.random() < 0.1:
            box.set_context(step=int(rng.integers(0, 50)), quorum_epoch=int(rng.integers(0, 9)))
        kind = ["op_issue", "op_complete", "commit", "quorum_ready", "anatomy_tick"][
            int(rng.integers(5))]
        box.record(kind, fseq=int(rng.integers(1, 100)), x=float(rng.random()),
                   name=f"r{int(rng.integers(1000))}", i=i)


@pytest.mark.parametrize("size", [4096, 1 << 20])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_python_rings_read_alike_by_both_packages(tmp_path, monkeypatch, writer, size):
    monkeypatch.setenv("TORCHFT_BLACKBOX_SIZE", str(size))
    cls = BlackBox if writer == "port" else jbb.BlackBox
    path = str(tmp_path / "tft_bb_7.bb")
    box = cls(path)
    box.set_context(replica_id=f"{writer}_group", step=0, quorum_epoch=0)
    _fill(box, np.random.default_rng(size))
    box.close()
    port_read, jax_read = read_blackbox(path), jbb.read_blackbox(path)
    assert port_read == jax_read and port_read[0]
    # a 4 KiB ring wraps past its ctx record: the replica is then unknown
    assert port_read[1]["replica"] == (f"{writer}_group" if size > 4096 else "")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_native_rings_read_alike_by_both_packages(tmp_path, writer):
    """Each package's core writes a native ring (a fresh process each);
    both readers return the same records, CRC-valid."""
    path = _native_ring(writer, tmp_path)
    port_read, jax_read = read_native_blackbox(path), jbb.read_native_blackbox(path)
    assert port_read == jax_read
    assert port_read[0] and port_read[1]["torn"] == 0


def _analysis_keys(report):
    """What both postmortems must agree on (paths and wall clocks aside)."""
    first = dict(report["first_anomaly"] or {})
    return {"victim": report["victim"], "inflight": report["victim_inflight_op"],
            "survivor_inflight": report["survivor_inflight"], "first_anomaly": first,
            "classification": report["classification"], "victim_epoch": report["victim_epoch"],
            "timeline": [(r.get("k"), r.get("ep"), r.get("st"), r.get("q"), r.get("src"))
                         for r in report["timeline"]]}


@pytest.mark.parametrize("evidence", [False, True])
def test_both_postmortems_agree_on_one_directory(tmp_path, evidence):
    """Two boxes of each package under one directory (a death accused by
    a peer, an op in flight), with and without injection evidence: the
    same victim, in-flight ops, first anomaly, classification and
    timeline from both packages' ``analyze``."""
    _two_boxes(tmp_path / "port", BlackBox)
    _two_boxes(tmp_path / "jax", jbb.BlackBox)
    if evidence:
        with open(tmp_path / "tft_fault_9.json", "w") as f:
            f.write(json.dumps({"site": "collective.issue", "action": "kill", "pid": 9,
                                "hit": 4}) + "\n")
    port, jax_ = postmortem.analyze(str(tmp_path)), jpm.analyze(str(tmp_path))
    assert _analysis_keys(port) == _analysis_keys(jax_)
    assert port["classification"] == ("injected" if evidence else "new-bug")
    assert port["victim"] == "rep_a" and port["victim_inflight_op"]["fseq"] == 2


class TestPostmortemPerf:
    def test_perf_windows_from_black_boxes(self, tmp_path):
        from torchft_tpu_torch.telemetry.postmortem import perf_windows, render_perf_text

        box = BlackBox(path=str(tmp_path / "tft_bb_91001.bb"))
        box.set_context(replica_id="gShift", step=0, quorum_epoch=1)
        for step in range(1, 30):
            local = 4.0 if step == 1 else (0.1 if step < 18 else 0.3)
            box.record("anatomy_tick", step=step, wall_s=local + 0.02, local_s=local)
        box.close()
        rep = perf_windows(str(tmp_path), min_n=6)
        info = rep["replicas"]["gShift"]
        assert info["steps"] == 29
        latched = [e for e in info["shifts"] if e["event"] == "perf_regression"]
        assert latched, rep
        assert all(e["replica"] == "gShift" for e in latched)
        assert info["local_tail_mean_s"] > info["local_head_mean_s"] or latched
        text = render_perf_text(rep)
        assert "gShift" in text and "perf_regression" in text
        # the JAX package's window over the same boxes
        ref = jpm.perf_windows(str(tmp_path), min_n=6)
        strip = lambda r: {src: {k: v for k, v in i.items() if k != "shifts"}  # noqa: E731
                           for src, i in r["replicas"].items()}
        assert strip(rep) == strip(ref) and rep["regressed"] == ref["regressed"]
        assert [(e["event"], e["series"], e["step"]) for e in info["shifts"]] == \
            [(e["event"], e["series"], e["step"]) for e in ref["replicas"]["gShift"]["shifts"]]

    def test_perf_cli(self, tmp_path):
        box = BlackBox(path=str(tmp_path / "tft_bb_91002.bb"))
        box.set_context(replica_id="gA", step=0, quorum_epoch=1)
        for step in range(1, 10):
            box.record("anatomy_tick", step=step, wall_s=0.1, local_s=0.09)
        box.close()
        assert postmortem.main([str(tmp_path), "--perf", "--window", "5"]) == 0


# ---------------------------------------------------------------------------
# a real kill under a schedule, two CPU worker processes
# ---------------------------------------------------------------------------


KILL_NTH = 8  # the tiny model's gradients are one bucket: one allreduce a step


def test_scheduled_kill_read_alike_by_both_postmortems(tmp_path, monkeypatch):
    """The recovery harness on the CPU: group 1's first incarnation carries
    ``{"seed": 7, "rules": [{"site": "collective.issue", "match":
    "allreduce", "nth": 8, "action": "kill", "sig": 9}]}`` and the box and
    evidence directories; it dies at its eighth gradient allreduce, is
    respawned and heals. Its box holds that allreduce issued and never
    completed; both packages' postmortems name it the victim with that op
    in flight and call the incident injected, alike; the protocol
    checker finds the boxes legal."""
    from torchft_tpu.analysis.protocol import check_tree
    from torchft_tpu_torch.benchmarks.recovery import measure_recovery

    monkeypatch.setenv("DEVICE", "cpu")
    forensics = tmp_path / "forensics"
    schedule = {"seed": 7, "rules": [{"site": "collective.issue", "match": "allreduce",
                                      "nth": KILL_NTH, "action": "kill", "sig": 9}]}
    r = measure_recovery(
        total_steps=14, step_sleep=0.05, op_timeout=5.0, heartbeat_timeout_ms=5000,
        timeout_s=120.0,
        env_extra={"TORCHFT_BLACKBOX_DIR": str(forensics / "bb"),
                   "TORCHFT_FAULT_EVIDENCE_DIR": str(forensics / "evidence")},
        victim_env={"TORCHFT_FAULT_SCHEDULE": json.dumps(schedule)})
    assert r.victim_rc == -signal.SIGKILL
    assert len({f["digest"] for f in r.finals.values()}) == 1
    assert r.finals[1]["heal"] and r.finals[1]["heal"]["bytes"] > 0
    from torchft_tpu_torch.faultinject.core import read_evidence

    kills = [e for e in read_evidence(str(forensics / "evidence")) if e["action"] == "kill"]
    assert len(kills) == 1 and kills[0]["site"] == "collective.issue" and \
        kills[0]["hit"] == KILL_NTH
    port, jax_ = postmortem.analyze(str(forensics)), jpm.analyze(str(forensics))
    assert _analysis_keys(port) == _analysis_keys(jax_)
    assert port["classification"] == "injected"
    victim = port["victim"]
    assert victim and victim.startswith("group1_"), port["victim"]
    op = port["victim_inflight_op"]
    assert op and op["k"] == "op_issue" and op["op"] == "allreduce", op
    # the victim's own box: that op issued, never completed, near its end
    box = next(b for b in postmortem.collect_boxes(str(forensics))
               if b["replica"] == victim and not b["native"])
    tail = box["records"][-8:]
    assert any(rec["k"] == "op_issue" and rec["fseq"] == op["fseq"] for rec in tail)
    assert not any(rec["k"] == "op_complete" and rec["fseq"] == op["fseq"]
                   for rec in box["records"])
    assert any(rec["k"] == "fault_injected" for rec in tail)
    assert any(b["native"] and b["pid"] == box["pid"]
               for b in postmortem.collect_boxes(str(forensics)))
    conf = check_tree(str(forensics))
    assert conf.lifecycle_records > 0 and conf.ok, conf.render()
    assert postmortem.main([str(forensics)]) == 0
