"""The port's time series, SLOs and fleet monitors against the JAX package's.

The cases of ``tests/test_timeseries.py`` (but its postmortem and fault
injection cases, whose modules the port has not yet) and the straggler,
SLO and piggyback cases of ``tests/test_anatomy.py`` run here on the
port's ``telemetry.{timeseries, slo, regression, critical_path}``, its
Manager, its HTTP transport and its bindings of the C++ lighthouse. The
environment variables the JAX tests set are module constants of the port
(``timeseries.SERIES_ENABLED``, ``MAX_SERIES``, ``regression.SERIES``).

Then both packages on the same numpy-seeded inputs: Page-Hinkley streams
with warm-ups, spikes and shifts; the regression bank; straggler rounds
with absences; burn-rate SLO event streams; per-step attributions and the
attributor's report; both monitors over one ``/timeseries.json`` reply and
the straggler monitor over one lighthouse. Latches, events, counters and
reports must be equal. Last, the Manager: its report's keys against the
JAX Manager's, a rank-0 Manager whose armed monitors name a slowed replica
fed to its lighthouse, and a Manager freed after ``shutdown()`` with both
monitors armed.
"""

from __future__ import annotations

import gc
import json
import threading
import time
import urllib.request
import weakref
from datetime import timedelta
from types import SimpleNamespace

import numpy as np
import pytest

from torchft_tpu import telemetry as J
from torchft_tpu.telemetry import critical_path as JCP
from torchft_tpu.telemetry import regression as JR
from torchft_tpu.telemetry import slo as JS
from torchft_tpu.telemetry import timeseries as JT
from torchft_tpu_torch import _native, telemetry
from torchft_tpu_torch.telemetry import critical_path as PCP
from torchft_tpu_torch.telemetry import regression as PREG
from torchft_tpu_torch.telemetry import slo as PS
from torchft_tpu_torch.telemetry import timeseries as PT
from torchft_tpu_torch.telemetry.anatomy import LOG2_BUCKETS, lathist_quantile, merge_lathist
from torchft_tpu_torch.telemetry.slo import BurnRateSlo, StragglerDetector


@pytest.fixture(autouse=True)
def _clean():
    J.reset()
    telemetry.reset()
    yield
    for cp in (JCP, PCP):
        cp.set_reporter(None)
    J.reset()
    telemetry.reset()


@pytest.fixture
def lighthouse():
    from torchft_tpu_torch.coordination import LighthouseClient, LighthouseServer

    _native.tsdb_reset()
    lh = LighthouseServer(bind="[::]:0", min_replicas=1)
    client = LighthouseClient(lh.address(), connect_timeout=timedelta(seconds=5))
    try:
        yield lh, client
    finally:
        client.close()
        lh.shutdown()
        _native.tsdb_reset()


def _feed(client, rid, step, series, epoch=1, **extra):
    client.heartbeat(rid, telemetry_payload={"step": step, "epoch": epoch, "series": series,
                                             **extra})


def _get_json(url):
    with urllib.request.urlopen(url, timeout=5) as resp:
        return json.loads(resp.read().decode())


def _nonzero(metric):
    """A family's series with a value other than 0 (the registries are
    process-wide: earlier tests leave zeroed children of open label sets)."""
    return [ln for ln in metric.render() if not ln.startswith("#") and not ln.endswith(" 0")]


def _events(pkg):
    return [{k: v for k, v in e.items() if k != "ts"} for e in pkg.EVENTS.recent()]


# ---------------------------------------------------------------------------
# the native store and /timeseries.json
# ---------------------------------------------------------------------------


class TestNativeTsdb:
    def test_ingest_snapshot_and_range_query(self, lighthouse):
        lh, client = lighthouse
        for step in range(6):
            _feed(client, "repA", step, {"local_s": 0.1 + step * 0.01})
        samples = _native.tsdb_snapshot()["repA"]["local_s"]["samples"]
        assert [s[1] for s in samples] == list(range(6))
        assert samples[0][0] == 1
        assert abs(samples[3][2] - 0.13) < 1e-9
        ts = _get_json(lh.address() + "/timeseries.json")
        body = ts["replicas"]["repA"]["local_s"]
        assert body["count"] == 6 and body["stride"] == 1
        assert ts["cursor"]["max_step"] == 5
        assert ts["retain"] >= 1

    def test_since_cursor_and_downsampling(self, lighthouse):
        lh, client = lighthouse
        for step in range(10):
            _feed(client, "repA", step, {"local_s": float(step)})
        ts = PT.poll_timeseries(lh.address(), since=3)
        assert [s[1] for s in ts["replicas"]["repA"]["local_s"]["samples"]] == [4, 5, 6, 7, 8, 9]
        body = PT.poll_timeseries(lh.address(), since=3, max_points=3)["replicas"]["repA"]["local_s"]
        steps = [s[1] for s in body["samples"]]
        assert body["stride"] == 2 and steps[-1] == 9 and len(steps) <= 4
        assert PT.poll_timeseries(lh.address(), since=9)["cursor"]["max_step"] == 9

    def test_replica_and_series_filters(self, lighthouse):
        lh, client = lighthouse
        _feed(client, "groupA", 1, {"local_s": 0.1, "wall_s": 0.2})
        _feed(client, "groupB", 1, {"local_s": 0.3})
        assert list(PT.poll_timeseries(lh.address(), replica="groupB")["replicas"]) == ["groupB"]
        ts = PT.poll_timeseries(lh.address(), series="wall")
        assert list(ts["replicas"]["groupA"]) == ["wall_s"]

    def test_same_step_report_overwrites_not_appends(self, lighthouse):
        lh, client = lighthouse
        _feed(client, "repA", 3, {"local_s": 0.1})
        _feed(client, "repA", 3, {"local_s": 0.5})
        samples = _native.tsdb_snapshot()["repA"]["local_s"]["samples"]
        assert len(samples) == 1 and abs(samples[0][2] - 0.5) < 1e-9

    def test_kill_respawn_full_history_served(self, lighthouse):
        lh, client = lighthouse
        for step in range(5):
            _feed(client, "g1-uuid-dead", step, {"local_s": 0.1})
        for step in range(3, 9):
            _feed(client, "g1-uuid-respawn", step, {"local_s": 0.2})
        rings = PT.poll_timeseries(lh.address(), replica="g1-uuid")["replicas"]
        assert set(rings) == {"g1-uuid-dead", "g1-uuid-respawn"}
        assert len(rings["g1-uuid-dead"]["local_s"]["samples"]) == 5
        assert rings["g1-uuid-respawn"]["local_s"]["samples"][-1][1] == 8

    def test_series_fanout_cap_degrades_loudly(self, lighthouse):
        lh, client = lighthouse
        _feed(client, "chatty", 1, {f"s{i:03d}": float(i) for i in range(80)})
        ts = PT.poll_timeseries(lh.address(), replica="chatty")
        assert len(ts["replicas"]["chatty"]) <= 64 and ts["dropped_series"] > 0
        metrics = urllib.request.urlopen(lh.address() + "/metrics", timeout=5).read().decode()
        assert "torchft_tsdb_dropped_series_total" in metrics

    def test_non_numeric_and_stepless_reports_ignored(self, lighthouse):
        lh, client = lighthouse
        _feed(client, "repA", -1, {"local_s": 0.1})
        client.heartbeat("repA", telemetry_payload={
            "step": 2, "epoch": 1, "series": {"ok": 1.0, "bad": "not-a-number"}})
        snap = _native.tsdb_snapshot()
        assert "bad" not in snap.get("repA", {})
        assert len(snap["repA"]["ok"]["samples"]) == 1

    def test_poll_timeseries_degrades_on_an_unreachable_lighthouse(self):
        assert PT.poll_timeseries("http://127.0.0.1:9", timeout=0.5) is None


# ---------------------------------------------------------------------------
# the 64 KiB anatomy cap
# ---------------------------------------------------------------------------


def _fake_manager(manager_cls, logger_method="warn", **fields):
    base = dict(_slo=SimpleNamespace(breached=lambda: False),
                _watchdog=SimpleNamespace(stalled=False), _step=3, _quorum_id=2,
                _last_heal_ts=0.0, _divergence_latched=False, _tdelta_encoder=None,
                _anatomy_oversize_warned=False)
    base.update(fields)
    warned = []
    fake = SimpleNamespace(**base, _logger=SimpleNamespace(
        **{logger_method: lambda *a, **k: warned.append(a)}), warned=warned)
    for name in ("_delta_encoder", "_telemetry_report", "_telemetry_payload_delta",
                 "_telemetry_payload", "_telemetry_payload_json"):
        setattr(fake, name, getattr(manager_cls, name).__get__(fake))
    return fake


class TestAnatomyOversizeCap:
    def test_lighthouse_drops_and_counts_oversized_digest(self, lighthouse):
        lh, client = lighthouse
        client.heartbeat("repA", telemetry_payload={"step": 1, "anatomy": json.dumps({"steps": 1})})
        client.heartbeat("repA", telemetry_payload={"step": 2,
                                                    "anatomy": "{" + "x" * (1 << 16) + "}"})
        rec = _get_json(lh.address() + "/cluster.json")["replicas"]["repA"]
        assert rec["anatomy"] == {} and rec["anatomy_oversized"] == 1
        metrics = urllib.request.urlopen(lh.address() + "/metrics", timeout=5).read().decode()
        assert "torchft_telemetry_oversized_total 1" in metrics

    def test_cluster_json_stays_parseable_after_drop(self, lighthouse):
        lh, client = lighthouse
        client.heartbeat("repA", telemetry_payload={"step": 1,
                                                    "anatomy": "{" + "y" * (1 << 16) + "}"})
        assert "repA" in _get_json(lh.address() + "/cluster.json")["replicas"]

    def test_manager_side_guard_replaces_oversized_digest(self, monkeypatch):
        """The JSON row sends an ``{"_oversized_bytes": n}`` marker, and
        warns once an episode."""
        from torchft_tpu_torch.manager import Manager

        monkeypatch.setenv("TORCHFT_TELEMETRY_DELTA", "0")
        monkeypatch.setattr(telemetry.LEDGER, "summary", lambda: {"rows": ["z" * 1024] * 100})
        fake = _fake_manager(Manager)
        for _ in range(2):
            payload = fake._telemetry_payload()
            anatomy = json.loads(payload["anatomy"])
            assert anatomy["_oversized_bytes"] > (1 << 16) and payload["epoch"] == 2
        assert len(fake.warned) == 1 and fake._anatomy_oversize_warned


# ---------------------------------------------------------------------------
# merge_lathist's overflow bucket
# ---------------------------------------------------------------------------


class TestLathistOverflow:
    N = len(LOG2_BUCKETS) + 1

    def _hist(self, finite=0, overflow=0):
        counts = [0] * self.N
        if finite:
            counts[10] = finite
        counts[-1] = overflow
        return {"counts": counts, "count": finite + overflow,
                "sum_ns": (finite + overflow) * 1000}

    def test_overflow_counts_merge_exactly(self):
        merged = merge_lathist({"op": self._hist(3, 2)}, {"op": self._hist(1, 5)})["op"]
        assert merged["counts"][-1] == 7 and merged["counts"][10] == 4
        assert merged["count"] == 11 and merged["sum_ns"] == 11000

    def test_overflow_only_quantile_clamps_to_last_bound(self):
        h = self._hist(overflow=10)
        assert lathist_quantile(h, 0.5) == LOG2_BUCKETS[-1]
        assert lathist_quantile(h, 0.99) == LOG2_BUCKETS[-1]

    def test_bucket_count_mismatch_is_loud(self):
        bad = self._hist(finite=1)
        bad["counts"] = bad["counts"][:-1]
        with pytest.raises(ValueError, match="bucket count mismatch"):
            merge_lathist({"op": self._hist(finite=1)}, {"op": bad})

    def test_one_sided_merge_preserves_overflow(self):
        assert merge_lathist({"op": self._hist(overflow=4)}, {})["op"]["counts"][-1] == 4


# ---------------------------------------------------------------------------
# the series builder
# ---------------------------------------------------------------------------


class TestBuildSeries:
    def test_series_from_last_row_with_flags(self):
        telemetry.LEDGER.tick(step=0)
        telemetry.LEDGER.record("compute", 0.08)
        telemetry.LEDGER.record("wire", 0.02)
        time.sleep(0.12)
        telemetry.LEDGER.tick(step=1)
        s = PT.build_series(slo_breach=True, divergence=False)
        assert s["phase.compute"] == pytest.approx(0.08)
        assert s["phase.wire"] == pytest.approx(0.02)
        assert s["wall_s"] >= 0.12 and s["local_s"] > 0
        assert s["local_s"] <= s["wall_s"] - 0.02 + 1e-6
        assert s["flag.slo_breach"] == 1.0 and s["flag.divergence"] == 0.0

    def test_none_before_first_row_and_when_disabled(self, monkeypatch):
        assert PT.build_series() is None
        telemetry.LEDGER.tick(step=0)
        telemetry.LEDGER.tick(step=1)
        assert PT.build_series() is not None
        monkeypatch.setattr(PT, "SERIES_ENABLED", False)
        assert PT.build_series() is None

    def test_fanout_cap_trims_by_priority(self, monkeypatch):
        telemetry.LEDGER.tick(step=0)
        telemetry.LEDGER.record("compute", 0.01)
        telemetry.LEDGER.tick(step=1)
        monkeypatch.setattr(PT, "MAX_SERIES", 4)
        s = PT.build_series(slo_breach=True)
        assert s is not None and len(s) == 4
        for essential in ("wall_s", "local_s", "local_p50_s", "phase.compute"):
            assert essential in s, s
        assert not any(k.startswith("flag.") for k in s)

    def test_same_rows_give_the_jax_series(self, monkeypatch):
        """One injected clock drives both ledgers: the series are equal
        (the native latency entries aside: each package's core counts its
        own RPCs)."""
        clock = iter(np.cumsum(np.random.default_rng(5).exponential(0.02, 64)).tolist())
        now = [0.0]

        def tick():
            now[0] = next(clock)
            return now[0]

        for pkg in (J, telemetry):
            pkg.LEDGER.tick(step=0)
        import torchft_tpu.telemetry.anatomy as JA
        import torchft_tpu_torch.telemetry.anatomy as PA

        for mod in (JA, PA):
            monkeypatch.setattr(mod.time, "perf_counter", lambda: now[0])
        for step in range(1, 12):
            tick()
            for pkg in (J, telemetry):
                pkg.LEDGER.record("compute", 0.001 * step)
                pkg.LEDGER.record("wire", 0.0005)
                pkg.LEDGER.tick(step=step)
        keep = lambda s: {k: v for k, v in s.items() if not k.startswith("lat.")}  # noqa: E731
        for flags in ({}, {"slo_breach": True, "stuck": True}):
            assert keep(PT.build_series(**flags)) == keep(JT.build_series(**flags))


def test_iter_new_samples_equal_jax():
    """One reply through both cursors, then a second reply with older and
    newer samples: the same samples come out."""
    rng = np.random.default_rng(9)

    def reply(lo, hi):
        return {"replicas": {f"g{r}": {name: {"samples": [
            [1, int(s), float(rng.random())] for s in range(lo + r, hi)]}
            for name in ("wall_s", "local_s", "phase.compute")} for r in range(3)}}

    first, second = reply(0, 10), reply(5, 16)
    second["replicas"]["g0"]["wall_s"]["samples"].append(["x", 1, 2])  # malformed: skipped
    pc, jc = {}, {}
    for r in (first, second):
        assert list(PT.iter_new_samples(r, pc)) == list(JT.iter_new_samples(r, jc))
    assert pc == jc


# ---------------------------------------------------------------------------
# Page-Hinkley and the regression bank
# ---------------------------------------------------------------------------


class TestPageHinkley:
    def _ph(self, **kw):
        for k, v in dict(delta=0.1, lam=4.0, min_n=8, k=4).items():
            kw.setdefault(k, v)
        return PREG.PageHinkley(**kw)

    def test_level_shift_latches_once_then_clears_on_recovery(self):
        ph = self._ph()
        evs = [r for x in [0.1] * 12 + [0.25] * 10 + [0.1] * 10 for r in [ph.observe(x)] if r]
        assert evs == ["latched", "cleared"]
        assert ph.latches == 1 and 0.09 < ph.baseline < 0.12

    def test_jit_warmup_does_not_poison_the_baseline(self):
        ph = self._ph()
        xs = [4.0, 0.8] + [0.09] * 10 + [0.25] * 8
        assert [r for x in xs for r in [ph.observe(x)] if r] == ["latched"]

    def test_single_spike_does_not_latch(self):
        ph = self._ph()
        assert [r for x in [0.1] * 20 + [3.0] + [0.1] * 20 for r in [ph.observe(x)] if r] == []

    def test_steady_jitter_does_not_latch(self):
        import random

        rng = random.Random(42)
        ph = self._ph()
        for _ in range(200):
            assert ph.observe(0.1 + rng.uniform(-0.02, 0.02)) is None

    def test_floor_disarms_micro_series(self):
        ph = self._ph(floor=0.02)
        assert [r for x in [0.001] * 12 + [0.006] * 20 for r in [ph.observe(x)] if r] == []

    def test_warmup_min_n_blocks_early_latch(self):
        ph = self._ph(min_n=8)
        for x in [0.1, 0.5, 0.1, 0.5, 0.1]:
            assert ph.observe(x) is None

    def test_defaults_are_the_module_constants(self, monkeypatch):
        ph = PREG.PageHinkley()
        assert (ph.delta, ph.lam, ph.min_n, ph.k, ph.floor) == (
            PREG.DELTA, PREG.LAMBDA, PREG.MIN_N, PREG.K, PREG.FLOOR_S)
        monkeypatch.setattr(PREG, "MIN_N", 3)
        assert PREG.PageHinkley().min_n == 3


class TestRegressionDetector:
    def test_latch_names_replica_and_phase_and_emits(self):
        det = PREG.RegressionDetector(min_n=6, k=3)
        events = [ev for step in range(30)
                  for ev in [det.observe("gB", "phase.compute", step, 0.1 if step < 15 else 0.3)]
                  if ev]
        assert len(events) == 1
        ev = events[0]
        assert ev["event"] == "perf_regression" and ev["replica"] == "gB"
        assert ev["phase"] == "compute"
        assert det.regressed() == [("gB", "phase.compute")]
        assert "perf_regression" in [e["event"] for e in telemetry.EVENTS.recent()]
        assert telemetry.PERF_REGRESSION_TOTAL.labels(replica="gB",
                                                      series="phase.compute").value == 1

    def test_barrier_phases_not_watched_by_default(self):
        det = PREG.RegressionDetector(min_n=4, k=2)
        for step in range(40):
            v = 0.05 if step < 20 else 0.5
            assert det.observe("g", "phase.commit_barrier", step, v) is None
            assert det.observe("g", "phase.wire", step, v) is None

    def test_explicit_listing_overrides_barrier_exclusion(self, monkeypatch):
        monkeypatch.setattr(PREG, "SERIES", ("phase.commit_barrier",))
        det = PREG.RegressionDetector(min_n=4, k=2)
        assert det.watched("phase.commit_barrier") and not det.watched("local_s")


# ---------------------------------------------------------------------------
# critical-path attribution
# ---------------------------------------------------------------------------


class TestCriticalPath:
    def test_attribute_step_names_gater_and_phase(self):
        att = PCP.attribute_step({
            "g0": {"wall_s": 0.5, "local_s": 0.2, "phases": {"compute": 0.15, "wire": 0.3}},
            "g1": {"wall_s": 0.5, "local_s": 0.45, "phases": {"compute": 0.4, "wire": 0.02}},
        })
        assert att["gating"] == "g1" and att["phase"] == "compute"
        assert att["blame_s"] == pytest.approx(0.25)
        assert att["whatif_wall_s"] == pytest.approx(0.25)

    def test_blame_never_lands_on_barrier_phases(self):
        att = PCP.attribute_step({
            "g0": {"wall_s": 0.3, "local_s": 0.1, "phases": {"compute": 0.1}},
            "g1": {"wall_s": 0.3, "local_s": 0.25, "phases": {"compute": 0.1, "wire": 0.15}},
        })
        assert att["gating"] == "g1" and "wire" not in att["phase_blame"]

    def test_single_replica_attributes_nothing(self):
        assert PCP.attribute_step({"g0": {"wall_s": 1.0, "local_s": 0.9, "phases": {}}}) is None

    def test_attributor_accumulates_and_reports_whatif(self):
        attr = PCP.CriticalPathAttributor()
        for step in range(10):
            attr.observe_step(step, {
                "g0": {"wall_s": 0.4, "local_s": 0.1, "phases": {"compute": 0.1}},
                "g1": {"wall_s": 0.4, "local_s": 0.3, "phases": {"compute": 0.3}},
            })
        rep = attr.report()
        assert rep["steps"] == 10
        assert rep["blame"][0]["replica"] == "g1" and rep["blame"][0]["phase"] == "compute"
        assert rep["blame"][0]["share"] == pytest.approx(1.0)
        assert rep["whatif_steps_per_sec"] == pytest.approx(2 * rep["measured_steps_per_sec"],
                                                            rel=1e-6)
        assert attr.blame_by_replica() == pytest.approx({"g1": 2.0})
        assert telemetry.CRITICAL_PATH_SECONDS.labels(replica="g1",
                                                      phase="compute").value == pytest.approx(2.0)

    def test_critical_path_json_route(self):
        from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport

        transport = HTTPTransport(timeout=timedelta(seconds=5))
        try:
            url = transport.metadata() + "/critical_path.json"
            body = _get_json(url)
            assert body["monitor"] is False and body["steps"] == 0
            assert body["status"] == "no-monitor"
            attr = PCP.CriticalPathAttributor()
            PCP.set_reporter(attr)
            assert _get_json(url)["status"] == "empty"
            attr.observe_step(1, {
                "g0": {"wall_s": 0.2, "local_s": 0.1, "phases": {}},
                "g1": {"wall_s": 0.2, "local_s": 0.15, "phases": {"compute": 0.15}},
            })
            body = _get_json(url)
            assert body["monitor"] is True and body["steps"] == 1 and body["status"] == "ok"
            assert body["blame"][0]["replica"] == "g1"
        finally:
            transport.shutdown()


# ---------------------------------------------------------------------------
# both history monitors against a live lighthouse
# ---------------------------------------------------------------------------


class TestMonitorsEndToEnd:
    def test_regression_and_critical_path_monitors(self, lighthouse):
        lh, client = lighthouse
        rm = PREG.RegressionMonitor(lh.address(), detector=PREG.RegressionDetector(min_n=6, k=3),
                                  poll_s=0.05)
        cpm = PCP.CriticalPathMonitor(lh.address())
        events = []
        for step in range(36):
            slow = step >= 18
            for rid in ("gA", "gB"):
                local = 0.1 + (0.15 if (slow and rid == "gB") else 0.0)
                _feed(client, rid, step, {"local_s": local, "wall_s": local + 0.05,
                                          "phase.compute": local})
            events.extend(rm.poll_once())
            cpm.poll_once()
        cpm.drain()
        latched = [e for e in events if e["event"] == "perf_regression"]
        assert latched and all(e["replica"] == "gB" for e in latched)
        assert min(e["step"] for e in latched) <= 28
        blame = cpm.attributor.blame_by_replica()
        assert blame.get("gB", 0) > 0.8 * sum(blame.values())
        rep = cpm.attributor.report()
        assert rep["whatif_steps_per_sec"] > rep["measured_steps_per_sec"]

    def test_monitor_survives_unreachable_lighthouse(self):
        assert PREG.RegressionMonitor("http://127.0.0.1:9", poll_s=0.05).poll_once() == []
        assert PS.FleetMonitor("http://127.0.0.1:9", poll_s=0.05).poll_once() == []


# ---------------------------------------------------------------------------
# tests/test_anatomy.py: the piggyback's scalars, burn-rate SLOs, stragglers
# ---------------------------------------------------------------------------


def test_anatomy_scalars_reach_cluster_json(lighthouse):
    from torchft_tpu_torch.telemetry.native import poll_cluster

    lh, client = lighthouse
    client.heartbeat("repA", telemetry_payload={
        "summary": json.dumps({"quorums": 1}),
        "anatomy": json.dumps({"steps": 3, "phases": {"compute": {"p50_s": 0.01}}}),
        "local_step_p50_s": 0.125, "slo_breach": True, "step": 3, "stuck": False,
        "last_heal_ts": 0.0})
    client.heartbeat("repB", telemetry_payload={"step": 2})
    cluster = poll_cluster(lh.address())
    a, b = cluster["replicas"]["repA"], cluster["replicas"]["repB"]
    assert a["local_step_p50_s"] == pytest.approx(0.125) and a["slo_breach"] is True
    assert a["anatomy"]["steps"] == 3 and a["anatomy"]["phases"]["compute"]["p50_s"] == 0.01
    assert b["slo_breach"] is False and b["anatomy"] == {}
    text = urllib.request.urlopen(lh.address() + "/metrics", timeout=5).read().decode()
    assert 'torchft_replica_local_step_p50_seconds{replica_id="repA"} 0.125' in text
    assert 'torchft_slo_breach{replica_id="repA"} 1' in text
    assert poll_cluster("http://127.0.0.1:9", timeout=0.5) is None


class TestBurnRateSlo:
    def mk(self, **kw):
        for k, v in dict(target=0.9, fast_s=10.0, slow_s=100.0, burn=2.0, min_events=2).items():
            kw.setdefault(k, v)
        return BurnRateSlo("step_time", 1.0, **kw)

    def test_no_breach_under_budget(self):
        s = self.mk()
        for i in range(20):
            assert s.observe(0.5, now=float(i + 1)) is False

    def test_breach_requires_both_windows(self):
        s = self.mk(target=0.5, burn=1.5)
        now = 0.0
        for _ in range(80):
            now += 1
            s.observe(0.5, now=now)
        for _ in range(10):
            now += 1
            s.observe(5.0, now=now)
        assert s.breached is False

    def test_breach_and_single_latch(self):
        s = self.mk()
        for i in range(8):
            s.observe(5.0, now=float(i + 1))
        assert s.breached is True and s.breaches == 1
        events = telemetry.EVENTS.recent("slo_breach")
        assert len(events) == 1 and events[0]["slo"] == "step_time"
        assert telemetry.SLO_BREACH_TOTAL.labels(slo="step_time").value == 1

    def test_recovery_unlatches_and_emits(self):
        s = self.mk()
        now = 0.0
        for _ in range(8):
            now += 1
            s.observe(5.0, now=now)
        assert s.breached
        now += 50.0
        for _ in range(5):
            now += 1
            s.observe(0.5, now=now)
        assert s.breached is False
        assert len(telemetry.EVENTS.recent("slo_recovered")) == 1

    def test_min_events_guard(self):
        assert self.mk(min_events=5).observe(99.0, now=1.0) is False

    def test_manager_pair_reads_the_step_threshold(self, monkeypatch):
        monkeypatch.delenv("TORCHFT_SLO_STEP_S", raising=False)
        off = PS.SloManager()
        assert off.step is None and off.rejoin is None and not off.breached()
        monkeypatch.setenv("TORCHFT_SLO_STEP_S", "0.5")
        monkeypatch.setattr(PS, "SLO_REJOIN_S", 2.0)
        on = PS.SloManager()
        assert on.step.threshold_s == 0.5 and on.rejoin.threshold_s == 2.0
        on.observe_rejoin(5.0)
        assert on.breached()


class TestStragglerDetector:
    def test_latch_after_k_and_exactly_one_event(self):
        d = StragglerDetector(factor=1.5, k=3)
        evs = [e for _ in range(6) for e in d.update({"g0": 0.1, "g1": 0.1, "g2": 0.5})]
        assert d.stragglers() == ["g2"]
        latched = [e for e in evs if e["event"] == "straggler_detected"]
        assert len(latched) == 1 and latched[0]["group"] == "g2"
        assert len(telemetry.EVENTS.recent("straggler_detected")) == 1
        assert telemetry.STRAGGLER_DETECTED.labels(group="g2").value == 1
        assert telemetry.STRAGGLERS.value == 1

    def test_consecutive_required(self):
        d = StragglerDetector(factor=1.5, k=3)
        for p in (0.5, 0.5, 0.1, 0.5, 0.5):
            d.update({"g0": 0.1, "g1": p})
        assert d.stragglers() == []

    def test_unlatch_hysteresis(self):
        d = StragglerDetector(factor=1.5, k=2)
        for _ in range(2):
            d.update({"g0": 0.1, "g1": 0.5})
        assert d.stragglers() == ["g1"]
        for _ in range(4):
            d.update({"g0": 0.1, "g1": 0.13})
        assert d.stragglers() == ["g1"]
        evs = [e for _ in range(2) for e in d.update({"g0": 0.1, "g1": 0.1})]
        assert d.stragglers() == [] and [e["event"] for e in evs] == ["straggler_cleared"]
        assert telemetry.STRAGGLERS.value == 0

    def test_gap_breaks_the_consecutive_streak(self):
        d = StragglerDetector(factor=1.5, k=3)
        for p in (0.5, 0.5, 0.0, 0.5):
            d.update({"g0": 0.1, "g1": p})
        assert d.stragglers() == []
        d.update({"g0": 0.1, "g1": 0.5})
        d.update({"g1": 0.5})
        d.update({"g0": 0.1, "g1": 0.5})
        assert d.stragglers() == []

    def test_merge_accepts_status_json_shape(self):
        m = merge_lathist({"rpc.serve": {"counts": [1, 2], "count": 3, "sum_ns": 1500}},
                          {"rpc.serve": {"counts": [2, 0], "count": 2, "sum_s": 2e-6,
                                         "p50_s": 1e-6}})
        assert m["rpc.serve"]["counts"] == [3, 2] and m["rpc.serve"]["count"] == 5
        assert m["rpc.serve"]["sum_ns"] == 3500

    def test_min_groups_guard(self):
        d = StragglerDetector(factor=1.5, k=1, min_groups=2)
        assert d.update({"only": 9.0}) == [] and d.stragglers() == []

    def test_leave_one_out_baseline(self):
        d = StragglerDetector(factor=1.5, k=2)
        for _ in range(4):
            d.update({"fast": 0.1, "slow": 0.9})
        assert d.stragglers() == ["slow"]

    def test_defaults_are_the_module_constants(self, monkeypatch):
        d = StragglerDetector()
        assert (d.factor, d.k) == (PS.STRAGGLER_FACTOR, PS.STRAGGLER_K)
        monkeypatch.setattr(PS, "STRAGGLER_K", 2)
        assert StragglerDetector().k == 2


# ---------------------------------------------------------------------------
# the two packages on the same seeded inputs
# ---------------------------------------------------------------------------


def _stream(rng, n=120):
    """A duration stream: warm-up spikes, jitter, one level shift (up or
    down), a lone spike and sometimes a recovery."""
    base = float(rng.uniform(0.03, 0.3))
    xs = list(base * rng.uniform(5, 40, size=int(rng.integers(0, 3))))
    onset, back = int(rng.integers(20, 70)), int(rng.integers(80, 130))
    shift = float(rng.choice([0.0, 0.5, 1.5, -0.4]))
    for i in range(n):
        level = base * (1 + (shift if onset <= i < back else 0.0))
        xs.append(level * float(rng.uniform(0.9, 1.1)))
    xs[int(rng.integers(0, len(xs)))] *= 12
    return xs


@pytest.mark.parametrize("seed", range(6))
def test_page_hinkley_equal_jax(seed):
    rng = np.random.default_rng(seed)
    kw = dict(delta=float(rng.choice([0.05, 0.1])), lam=float(rng.choice([3.0, 4.0])),
              min_n=int(rng.integers(4, 10)), k=int(rng.integers(2, 6)), floor=0.02)
    port, ref = PREG.PageHinkley(**kw), JR.PageHinkley(**kw)
    for x in _stream(rng):
        assert port.observe(x) == ref.observe(x)
        assert (port.latched, port.n, port.location, port.baseline) == \
            (ref.latched, ref.n, ref.location, ref.baseline)
    assert port.latches == ref.latches


@pytest.mark.parametrize("seed", range(3))
def test_regression_bank_equal_jax(seed):
    rng = np.random.default_rng(10 + seed)
    port = PREG.RegressionDetector(min_n=6, k=3)
    ref = JR.RegressionDetector(min_n=6, k=3)
    streams = {(f"g{r}", name): _stream(rng) for r in range(3)
               for name in ("local_s", "wall_s", "phase.compute", "phase.wire", "lat.dp.hop.p50_s")}
    for step in range(max(len(v) for v in streams.values())):
        for (rid, name), xs in streams.items():
            if step < len(xs):
                assert port.observe(rid, name, step, xs[step]) == \
                    ref.observe(rid, name, step, xs[step])
    assert port.regressed() == ref.regressed()
    assert _events(telemetry) == _events(J)
    assert _nonzero(telemetry.PERF_REGRESSION_TOTAL) == _nonzero(J.PERF_REGRESSION_TOTAL)


@pytest.mark.parametrize("seed", range(4))
def test_straggler_rounds_equal_jax(seed):
    rng = np.random.default_rng(20 + seed)
    kw = dict(factor=float(rng.choice([1.3, 1.5])), k=int(rng.integers(2, 5)))
    port, ref = PS.StragglerDetector(**kw), JS.StragglerDetector(**kw)
    slow = f"g{int(rng.integers(0, 4))}"
    for rnd in range(60):
        p50s = {f"g{g}": float(rng.uniform(0.09, 0.11)) for g in range(4)}
        if 15 <= rnd < 45:
            p50s[slow] *= float(rng.uniform(1.2, 2.5))
        if rng.random() < 0.1:
            p50s[f"g{int(rng.integers(0, 4))}"] = 0.0  # absent this round
        assert port.update(p50s) == ref.update(p50s)
        assert port.stragglers() == ref.stragglers()
    assert _events(telemetry) == _events(J)
    assert _nonzero(telemetry.STRAGGLER_DETECTED) == _nonzero(J.STRAGGLER_DETECTED)
    assert telemetry.STRAGGLERS.value == J.STRAGGLERS.value


@pytest.mark.parametrize("seed", range(3))
def test_burn_rate_slo_equal_jax(seed):
    rng = np.random.default_rng(30 + seed)
    kw = dict(target=0.95, fast_s=10.0, slow_s=60.0, burn=2.0, min_events=4)
    port, ref = PS.BurnRateSlo("step_time", 0.2, **kw), JS.BurnRateSlo("step_time", 0.2, **kw)
    now = 0.0
    for i in range(300):
        now += float(rng.exponential(0.5))
        bad = 60 <= i < 120 or rng.random() < 0.02
        v = float(rng.uniform(0.25, 1.0) if bad else rng.uniform(0.05, 0.19))
        assert port.observe(v, now=now) == ref.observe(v, now=now)
    assert port.breaches == ref.breaches and port.breaches >= 1
    assert _events(telemetry) == _events(J)
    assert _nonzero(telemetry.SLO_BREACH_TOTAL) == _nonzero(J.SLO_BREACH_TOTAL)


def _rows(rng, replicas, slow):
    rows = {}
    for r in replicas:
        compute = float(rng.uniform(0.05, 0.07)) + (0.1 if r == slow else 0.0)
        host = float(rng.uniform(0.005, 0.02))
        wire = float(rng.uniform(0.0, 0.1))
        phases = {"compute": compute, "host_copy": host, "wire": wire,
                  "idle": float(rng.uniform(0.0, 0.01))}
        if rng.random() < 0.2:
            phases.pop("host_copy")
        rows[r] = {"wall_s": sum(phases.values()), "phases": phases,
                   "local_s": sum(v for p, v in phases.items() if p != "wire")}
    return rows


@pytest.mark.parametrize("seed", range(3))
def test_attribution_and_report_equal_jax(seed):
    rng = np.random.default_rng(40 + seed)
    port, ref = PCP.CriticalPathAttributor(), JCP.CriticalPathAttributor()
    replicas = [f"g{i}" for i in range(int(rng.integers(2, 5)))]
    for step in range(40):
        rows = _rows(rng, replicas, slow=replicas[-1] if step >= 10 else None)
        if rng.random() < 0.1:
            rows = {replicas[0]: rows[replicas[0]]}  # a fleet of one: nothing
        assert PCP.attribute_step(rows) == JCP.attribute_step(rows)
        assert port.observe_step(step, rows) == ref.observe_step(step, rows)
    assert port.report() == ref.report()
    assert port.blame_by_replica() == ref.blame_by_replica()
    for cp, att in ((PCP, port), (JCP, ref)):
        cp.set_reporter(att)
    assert PCP.report_json() == JCP.report_json()
    assert _nonzero(telemetry.CRITICAL_PATH_SECONDS) == _nonzero(J.CRITICAL_PATH_SECONDS)


def test_history_monitors_equal_jax_on_one_reply():
    """Both packages' regression and critical-path monitors fed the same
    ``/timeseries.json`` replies give the same events and attributions."""
    rng = np.random.default_rng(50)
    monitors = [(PREG.RegressionMonitor("x", detector=PREG.RegressionDetector(min_n=5, k=2)),
                 PCP.CriticalPathMonitor("x")),
                (JR.RegressionMonitor("x", detector=JR.RegressionDetector(min_n=5, k=2)),
                 JCP.CriticalPathMonitor("x"))]
    samples = {}
    for step in range(40):
        for r in range(3):
            for name, v in _rows(rng, [f"g{r}"], slow="g2" if step >= 15 else None)[
                    f"g{r}"].items():
                if name == "phases":
                    for p, s in v.items():
                        samples.setdefault((f"g{r}", f"phase.{p}"), []).append([1, step, s])
                else:
                    samples.setdefault((f"g{r}", name), []).append([1, step, v])
        if step % 4 == 3:
            reply = {"replicas": {}}
            for (rid, name), ss in samples.items():
                reply["replicas"].setdefault(rid, {})[name] = {"samples": list(ss[-6:])}
            outs = [(rm.poll_once(reply=reply), cpm.poll_once(reply=reply))
                    for rm, cpm in monitors]
            assert outs[0] == outs[1]
    assert monitors[0][1].drain() == monitors[1][1].drain()
    assert monitors[0][1].attributor.report() == monitors[1][1].attributor.report()
    assert monitors[0][0].detector.regressed() == monitors[1][0].detector.regressed()
    assert ("g2", "local_s") in monitors[0][0].detector.regressed()


def test_fleet_monitors_equal_jax_on_one_lighthouse(lighthouse):
    """Both packages' FleetMonitors poll one lighthouse fed by heartbeats;
    a round runs only when the fleet's step advanced."""
    lh, client = lighthouse
    port = PS.FleetMonitor(lh.address(), detector=PS.StragglerDetector(factor=1.5, k=3))
    ref = JS.FleetMonitor(lh.address(), detector=JS.StragglerDetector(factor=1.5, k=3))
    rng = np.random.default_rng(60)
    for step in range(12):
        for g in range(3):
            p50 = float(rng.uniform(0.09, 0.11)) * (3.0 if g == 2 and step >= 3 else 1.0)
            client.heartbeat(f"g{g}", telemetry_payload={"step": step, "epoch": 1,
                                                         "local_step_p50_s": p50})
        assert port.poll_once() == ref.poll_once()
        assert port.poll_once() == [] and ref.poll_once() == []  # no new step
    assert port.detector.stragglers() == ref.detector.stragglers() == ["g2"]


# ---------------------------------------------------------------------------
# the Manager: its report, its monitors, its lifetime
# ---------------------------------------------------------------------------


def test_manager_report_keys_equal_jax():
    """The report of a Manager without forensics and without the divergence
    sentinel: the same top-level keys, series, summary, anatomy and
    histogram names in both packages after the same ledger rows."""
    from torchft_tpu.manager import Manager as JManager
    from torchft_tpu_torch.manager import Manager

    for pkg in (J, telemetry):
        for step in range(4):
            pkg.LEDGER.record("compute", 0.01)
            pkg.LEDGER.record("wire", 0.002)
            pkg.LEDGER.tick(step=step)
    port = _fake_manager(Manager)._telemetry_report()
    ref = _fake_manager(JManager, "warning", _diagnosis=None)._telemetry_report()
    assert set(port) == set(ref)
    assert not any(k.startswith("diag_") for k in port)
    keep = lambda d: {k for k in d if not k.startswith("lat.")}  # noqa: E731
    for key in ("series", "summary", "anatomy", "hist"):
        assert keep(port[key]) == keep(ref[key]), key
    assert port["series"]["flag.divergence"] == 0.0


def _armed_manager(monkeypatch, lighthouse_addr, store, replica_id="fleet"):
    from torchft_tpu_torch.collectives import CollectivesTcp
    from torchft_tpu_torch.manager import Manager

    monkeypatch.setenv("TORCHFT_STRAGGLER_MONITOR", "1")
    monkeypatch.setenv("TORCHFT_REGRESSION_MONITOR", "1")
    monkeypatch.setenv("TORCHFT_STRAGGLER_POLL_S", "0.05")
    monkeypatch.setenv("TORCHFT_REGRESSION_POLL_S", "0.05")
    timeout = timedelta(seconds=20)
    return Manager(collectives=CollectivesTcp(timeout=timeout), load_state_dict=lambda s: None,
                   state_dict=lambda: {}, min_replica_size=1, replica_id=replica_id,
                   store_addr=store.address(), rank=0, world_size=1,
                   lighthouse_addr=lighthouse_addr, timeout=timeout)


def test_armed_manager_names_the_slowed_replica(monkeypatch, lighthouse):
    """A rank-0 Manager with both monitors armed runs steps while two
    stand-in replicas report to its lighthouse, one slowed from step 10:
    its FleetMonitor latches that replica (``/metrics``), its history
    thread's sentinel latches it and its ``/critical_path.json`` blames it;
    the Manager's own report reaches ``/cluster.json``, ``/fleet.json`` and
    ``/timeseries.json`` as a delta chain without a resync."""
    from torchft_tpu_torch.store import StoreServer
    from torchft_tpu_torch.telemetry.fleetdelta import poll_fleet
    from torchft_tpu_torch.telemetry.native import poll_cluster

    lh, client = lighthouse
    store = StoreServer()
    manager = _armed_manager(monkeypatch, lh.address(), store)
    try:
        for step in range(40):
            manager.start_quorum()
            manager.allreduce(np.ones(16, np.float32)).wait()
            assert manager.should_commit()
            for rid, slow in (("gA", False), ("gB", step >= 10)):
                local = 0.05 + (0.15 if slow else 0.0) + 0.001 * (step % 3)
                # one local p50 over the window, as the ledger's: the
                # slowed replica's moves once most of its rows are slow
                p50 = 0.2 if slow and step >= 20 else 0.05
                client.heartbeat(rid, telemetry_payload={
                    "step": step, "epoch": 1, "local_step_p50_s": p50,
                    "series": {"local_s": local, "wall_s": 0.21, "phase.compute": local}})
            time.sleep(0.03)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            metrics = urllib.request.urlopen(manager._checkpoint_transport.metadata() + "/metrics",
                                             timeout=5).read().decode()
            cp = _get_json(manager._checkpoint_transport.metadata() + "/critical_path.json")
            if ('tft_straggler_detected_total{group="gB"} 1' in metrics
                    and 'tft_perf_regression_total{replica="gB"' in metrics
                    and cp["status"] == "ok"):
                break
            time.sleep(0.1)
        assert 'tft_straggler_detected_total{group="gB"} 1' in metrics
        assert 'tft_straggler_detected_total{group="gA"}' not in metrics
        regressed = {k for k in manager._regression_monitor.detector.regressed()}
        assert regressed and {rid for rid, _ in regressed} == {"gB"}, regressed
        assert cp["status"] == "ok" and cp["blame"][0]["replica"] == "gB"
        assert manager._critical_path_monitor.attributor.blame_by_replica()["gB"] > 0.8 * sum(
            manager._critical_path_monitor.attributor.blame_by_replica().values())
        cluster = poll_cluster(lh.address())
        mine = cluster["replicas"][manager._replica_id]
        assert mine["step"] >= 38 and mine["summary"]["quorums"] >= 39 and mine["anatomy"]
        fleet = poll_fleet(lh.address())["telemetry"]
        assert fleet["delta_fulls_total"] == 1 and fleet["delta_resyncs_total"] == 0
        assert fleet["delta_blobs_total"] >= 39
        ts = PT.poll_timeseries(lh.address(), replica=manager._replica_id, series="wall_s")
        assert len(ts["replicas"][manager._replica_id]["wall_s"]["samples"]) >= 38
        enc = manager._tdelta_encoder
        assert enc.fulls_total == 1 and enc.acked_version == enc.version
    finally:
        manager.shutdown()
        store.shutdown()


def test_stall_push_marks_the_replica_stuck(monkeypatch, lighthouse):
    """The watchdog fires on a held step: one heartbeat carrying the JSON
    row puts ``stuck: true`` on ``/cluster.json`` while the step is held;
    the vote clears it at the next report."""
    from torchft_tpu_torch.store import StoreServer
    from torchft_tpu_torch.telemetry.native import poll_cluster

    monkeypatch.setenv("TORCHFT_WATCHDOG_MIN_S", "0.3")
    lh, _ = lighthouse
    store = StoreServer()
    manager = _armed_manager(monkeypatch, lh.address(), store, "stall")
    try:
        manager.start_quorum()
        assert manager.should_commit()
        manager.start_quorum()
        manager.wait_quorum()
        seen = []
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and not seen:
            rec = (poll_cluster(lh.address()) or {}).get("replicas", {}).get(
                manager._replica_id, {})
            if rec.get("stuck"):
                seen.append(rec)
            time.sleep(0.05)
        assert seen and seen[0]["step"] == 1
        assert manager.should_commit()
        manager.start_quorum()
        manager.wait_quorum()
        rec = poll_cluster(lh.address())["replicas"][manager._replica_id]
        assert rec["stuck"] is False and rec["step"] == 2
    finally:
        manager.shutdown()
        store.shutdown()


def test_shutdown_frees_a_manager_with_both_monitors_armed(monkeypatch, lighthouse):
    """After ``shutdown()`` the monitor and history threads have stopped
    and nothing holds the Manager: it is collected. Before it, neither
    thread refers to the Manager."""
    from torchft_tpu_torch.store import StoreServer

    lh, _ = lighthouse
    store = StoreServer()
    try:
        manager = _armed_manager(monkeypatch, lh.address(), store, "lifetime")
        for _ in range(3):
            manager.start_quorum()
            manager.allreduce(np.ones(8, np.float32)).wait()
            assert manager.should_commit()
        threads = [t for t in threading.enumerate()
                   if t.name in ("tft_fleet_monitor", "tft_history_monitor")]
        assert sorted(t.name for t in threads) == ["tft_fleet_monitor", "tft_history_monitor"]
        assert not [t.name for t in threads if _refers(t, manager)]
        ref = weakref.ref(manager)
        manager.shutdown(wait=True)
        del manager
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and ref() is not None:
            gc.collect()
            time.sleep(0.05)
        assert ref() is None
        for t in threads:
            t.join(5.0)
            assert not t.is_alive(), t.name
    finally:
        store.shutdown()


def _refers(thread, obj):
    seen, todo = set(), [thread]
    for _ in range(5):  # target, bound self, closures and their cells
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
