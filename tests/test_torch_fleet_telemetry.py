"""The port's delta-encoded telemetry piggyback against the JAX package's.

Every case of ``tests/test_fleet_telemetry.py`` runs here on the port's
``torchft_tpu_torch.telemetry.fleetdelta``, its Manager and its bindings of
the shared C++ lighthouse: the flatten vocabulary, delta round trips of
every leaf type, version skew, the byte cap's field-by-field degradation,
the respawn resync against a live lighthouse, the fleet rollup's exact
fold, ``/cluster.json`` pagination, the Manager's self-metering and the
``tack`` ack loop through a real ManagerServer quorum.

Then the two packages side by side: over seeded multi-round report
sequences (numpy-made leaves of every type, deletions, acks, resyncs, a
tight cap) the port's encoder and the JAX encoder, with one pinned
incarnation, emit the same bytes; each package's decoder applies the
other's blobs to the sender's report; and the JAX package's lighthouse and
the port's take the same blobs to the same ``/cluster.json`` record.
"""

from __future__ import annotations

import json
import time
import urllib.request
from datetime import timedelta
from types import SimpleNamespace

import numpy as np
import pytest

from torchft_tpu import telemetry as J
from torchft_tpu.telemetry import fleetdelta as JF
from torchft_tpu_torch import _native, telemetry
from torchft_tpu_torch.telemetry.fleetdelta import (
    IDX,
    SEP,
    DeltaDecoder,
    DeltaEncoder,
    flatten,
    poll_fleet,
    tier_of,
    unflatten,
)

PINNED = bytes(range(1, 9))  # one incarnation for both packages' encoders


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    # this file tests the delta plane: an outer TORCHFT_TELEMETRY_DELTA=0
    # must not reroute it onto the JSON payload
    monkeypatch.setenv("TORCHFT_TELEMETRY_DELTA", "1")
    J.reset()
    telemetry.reset()
    yield
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


def _get_json(url):
    with urllib.request.urlopen(url, timeout=5) as resp:
        return json.loads(resp.read().decode())


def _report(step=1, **extra):
    base = {"step": step, "epoch": 1, "stuck": False, "slo_breach": False,
            "local_step_p50_s": 0.1, "last_heal_ts": 0.0}
    base.update(extra)
    return base


# ---------------------------------------------------------------------------
# flatten / unflatten
# ---------------------------------------------------------------------------


class TestFlatten:
    def test_nested_round_trip_with_lists(self):
        obj = {"a": {"b": 1, "c": [1.5, "x", True]}, "d": "plain", "e": []}
        assert unflatten(flatten(obj)) == obj

    def test_none_leaves_are_skipped(self):
        assert list(flatten({"a": None, "b": 2})) == ["b"]

    def test_list_paths_use_idx_and_length_markers(self):
        flat = flatten({"l": [7, 8]})
        assert flat["l" + SEP + IDX + "0"] == 7
        assert flat["l" + SEP + IDX + "#"] == 2

    def test_huge_int_degrades_to_float(self):
        assert isinstance(flatten({"big": 1 << 80})["big"], float)

    def test_foreign_type_degrades_to_str(self):
        assert flatten({"t": complex(1, 2)})["t"] == str(complex(1, 2))

    def test_tiers(self):
        assert tier_of("step") == 0
        assert tier_of("series" + SEP + "flag.slo_breach") == 0
        assert tier_of("summary" + SEP + "steps") == 1
        assert tier_of("series" + SEP + "local_s") == 1
        assert tier_of("anatomy" + SEP + "p50") == 2
        assert tier_of("hist" + SEP + "wall" + SEP + "3") == 2


# ---------------------------------------------------------------------------
# delta round trips
# ---------------------------------------------------------------------------


class TestDeltaRoundTrip:
    def test_every_leaf_type_round_trips(self):
        enc, dec = DeltaEncoder(), DeltaDecoder()
        r = _report(f=1.25, i=-42, b=True, s="héllo", raw=b"\x00\xffbin")
        out = dec.apply(enc.encode(r))
        assert out["ok"] and out["full"]
        assert dec.state() == r
        r2 = dict(r, f=2.5, i=43, b=False, s="next", raw=b"\x01")
        del r2["last_heal_ts"]
        out = dec.apply(enc.encode(r2))
        assert out["ok"] and not out["full"]
        assert dec.state() == r2
        assert "last_heal_ts" not in dec.flat

    def test_empty_delta_is_tiny_and_changes_nothing(self):
        enc, dec = DeltaEncoder(), DeltaDecoder()
        r = _report(summary={"steps": 5})
        full = enc.encode(r)
        assert dec.apply(full)["ok"]
        blob = enc.encode(r)
        assert len(blob) < len(full) / 4
        out = dec.apply(blob)
        assert out["ok"] and out["changed"] == []
        assert dec.state() == r

    def test_steady_state_bytes_are_o_changed_not_o_report(self):
        enc, dec = DeltaEncoder(), DeltaDecoder()
        r = _report(summary={f"c{i}": i for i in range(200)})
        dec.apply(enc.encode(r))
        sizes = []
        for step in range(2, 6):
            r = dict(r, step=step)
            blob = enc.encode(r)
            assert dec.apply(blob)["ok"]
            sizes.append(len(blob))
        assert max(sizes) < 40
        assert len(set(sizes)) == 1

    def test_type_sensitivity_1_vs_1p0_vs_true(self):
        enc, dec = DeltaEncoder(), DeltaDecoder()
        dec.apply(enc.encode(_report(v=1)))
        assert dec.flat["v"] == 1 and type(dec.flat["v"]) is int
        dec.apply(enc.encode(_report(v=1.0)))
        assert type(dec.flat["v"]) is float
        dec.apply(enc.encode(_report(v=True)))
        assert type(dec.flat["v"]) is bool

    def test_version_skew_requests_resync_and_full_recovers(self):
        enc, dec = DeltaEncoder(), DeltaDecoder()
        dec.apply(enc.encode(_report(step=1)))
        enc.encode(_report(step=2))  # lost on the wire
        out = dec.apply(enc.encode(_report(step=3)))
        assert not out["ok"] and out["resync_wanted"]
        assert dec.state()["step"] == 1
        enc.on_ack({enc.incarnation.hex(): {"ver": dec.version, "resync": True}})
        out = dec.apply(enc.encode(_report(step=4)))
        assert out["ok"] and out["full"]
        assert dec.state() == _report(step=4)

    def test_fresh_decoder_rejects_delta_from_unknown_incarnation(self):
        enc = DeltaEncoder()
        enc.encode(_report())
        out = DeltaDecoder().apply(enc.encode(_report(step=2)))
        assert out["resync_wanted"] and not out["ok"]

    def test_unacked_window_forces_defensive_full(self):
        enc = DeltaEncoder()
        enc.encode(_report())
        fulls_before = enc.fulls_total
        for step in range(2, 2 + enc.MAX_UNACKED + 2):
            enc.encode(_report(step=step))
        assert enc.fulls_total > fulls_before

    def test_seeded_multi_round_state_equality(self):
        enc, dec = DeltaEncoder(), DeltaDecoder()
        r = _report(summary={}, series={})
        for step in range(1, 30):
            r = dict(r, step=step, stuck=bool(step % 3 == 0))
            r["summary"] = dict(r["summary"], **{f"c{step % 7}": step})
            r["series"] = {"local_s": step * 0.01}
            if step % 5 == 0 and f"c{(step - 1) % 7}" in r["summary"]:
                r["summary"] = dict(r["summary"])
                del r["summary"][f"c{(step - 1) % 7}"]
            if step % 11 == 0:
                enc.on_ack({enc.incarnation.hex(): {"ver": dec.version}})
            assert dec.apply(enc.encode(r))["ok"]
            assert dec.state() == r


# ---------------------------------------------------------------------------
# the byte cap: field by field, latches first
# ---------------------------------------------------------------------------


class TestTruncation:
    FAT = {f"phase_{i}": {"p50": 0.001 * i, "p99": 0.002 * i, "n": i} for i in range(60)}

    def test_tier0_latches_survive_a_tiny_cap(self):
        enc, dec = DeltaEncoder(max_bytes=256), DeltaDecoder()
        r = _report(step=7, stuck=True, anatomy=self.FAT)
        assert dec.apply(enc.encode(r))["ok"]
        assert enc.last_truncated > 0
        for key in ("step", "epoch", "stuck", "slo_breach", "local_step_p50_s", "last_heal_ts"):
            assert key in dec.flat, key
        assert dec.flat["stuck"] is True

    def test_deferred_fields_ship_on_later_rounds(self):
        enc, dec = DeltaEncoder(max_bytes=256), DeltaDecoder()
        r = _report(anatomy=self.FAT)
        rounds = 0
        while True:
            rounds += 1
            assert rounds < 100
            assert dec.apply(enc.encode(r))["ok"]
            if enc.last_truncated == 0:
                break
        assert rounds > 1
        assert dec.state() == r
        assert enc.truncated_total > 0

    def test_module_cap_is_the_default(self, monkeypatch):
        """The cap is a module constant (no environment variable)."""
        from torchft_tpu_torch.telemetry import fleetdelta

        assert DeltaEncoder().cap == fleetdelta.DEFAULT_MAX_BYTES
        monkeypatch.setattr(fleetdelta, "MAX_BLOB_BYTES", 256)
        enc = DeltaEncoder()
        assert enc.cap == 256
        enc.encode(_report(anatomy=self.FAT))
        assert enc.last_truncated > 0


# ---------------------------------------------------------------------------
# kill and respawn: a new incarnation never inherits the dead chain
# ---------------------------------------------------------------------------


class TestRespawnResync:
    def _send(self, client, rid, blob, spans=None):
        payload = {"tdelta": blob}
        if spans:
            payload["spans"] = spans
        client.heartbeat(rid, telemetry_payload=payload)

    def test_respawn_resyncs_and_dead_tsdb_ring_is_retained(self, lighthouse):
        lh, client = lighthouse
        enc1 = DeltaEncoder()
        for step in range(3):
            r = _report(step=step, series={"local_s": 0.1 + step * 0.01})
            self._send(client, "repR", enc1.encode(r))
        old_samples = _native.tsdb_snapshot()["repR"]["local_s"]["samples"]
        assert [s[1] for s in old_samples] == [0, 1, 2]
        assert _get_json(lh.address() + "/cluster.json")["replicas"]["repR"]["step"] == 2

        enc2 = DeltaEncoder()
        enc2.encode(_report(step=100))  # the full blob never delivered
        fleet0 = poll_fleet(lh.address())
        self._send(client, "repR", enc2.encode(_report(step=101, series={"local_s": 0.5})))
        fleet1 = poll_fleet(lh.address())
        assert (fleet1["telemetry"]["delta_resyncs_total"]
                > fleet0["telemetry"]["delta_resyncs_total"])
        assert _get_json(lh.address() + "/cluster.json")["replicas"]["repR"]["step"] == 2

        enc2.force_full()
        self._send(client, "repR", enc2.encode(_report(step=102, series={"local_s": 0.6})))
        assert _get_json(lh.address() + "/cluster.json")["replicas"]["repR"]["step"] == 102
        steps = [s[1] for s in _native.tsdb_snapshot()["repR"]["local_s"]["samples"]]
        assert steps[:3] == [0, 1, 2] and steps[-1] == 102

    def test_legacy_and_delta_replicas_coexist(self, lighthouse):
        lh, client = lighthouse
        client.heartbeat("legacy", telemetry_payload={
            "step": 5, "epoch": 1, "summary": json.dumps({"steps": 5})})
        enc = DeltaEncoder()
        self._send(client, "delta", enc.encode(_report(step=9, summary={"steps": 9})))
        cl = _get_json(lh.address() + "/cluster.json")
        assert cl["replicas"]["legacy"]["step"] == 5
        assert cl["replicas"]["delta"]["step"] == 9
        assert cl["replicas"]["delta"]["summary"] == {"steps": 9}


# ---------------------------------------------------------------------------
# the fleet rollup's fold is exact
# ---------------------------------------------------------------------------


def _grid_quantile(counts, q):
    """The native grid quantile (``native/telemetry_delta.h``): bucket i
    spans (2^(i-21), 2^(i-20)] s, the overflow interpolates to 2x the last
    bound."""
    total = sum(counts)
    if not total:
        return 0.0
    target = q * total
    acc = 0.0
    for i, c in enumerate(counts):
        nxt = acc + c
        if nxt >= target and c:
            frac = (target - acc) / c
            lo = 0.0 if i == 0 else 2.0 ** (i - 21)
            hi = 2.0 ** (i - 20) if i < 27 else 2.0 ** 7
            return lo + (hi - lo) * frac
        acc = nxt
    return 2.0 ** 7


class TestRollupExactness:
    H_A = {"3": 5, "10": 2}
    H_B = {"3": 1, "12": 4, "27": 2}

    def _fold(self):
        counts = [0] * 28
        for h in (self.H_A, self.H_B):
            for k, v in h.items():
                counts[int(k)] += v
        return counts

    def _feed(self, client):
        for rid, h in (("repA", self.H_A), ("repB", self.H_B)):
            client.heartbeat(rid, telemetry_payload={
                "tdelta": DeltaEncoder().encode(_report(hist={"wall": h}))})

    def test_fleet_fold_is_exact_sum_and_quantiles_match_oracle(self, lighthouse):
        lh, client = lighthouse
        self._feed(client)
        wall = poll_fleet(lh.address())["hist"]["wall"]
        counts = self._fold()
        assert wall["count"] == sum(counts)
        for q, key in ((0.5, "p50_s"), (0.95, "p95_s"), (0.99, "p99_s")):
            assert wall[key] == pytest.approx(_grid_quantile(counts, q), rel=1e-4, abs=1e-6), key

    def test_group_drilldown_is_that_replicas_own_histogram(self, lighthouse):
        lh, client = lighthouse
        self._feed(client)
        fleet = poll_fleet(lh.address(), group="repB")
        assert fleet["group"]["id"] == "repB"
        assert fleet["group"]["hist"]["wall"]["count"] == sum(self.H_B.values())

    def test_absolute_bucket_counts_fold_across_delta_rounds(self, lighthouse):
        lh, client = lighthouse
        enc = DeltaEncoder()
        client.heartbeat("repA", telemetry_payload={
            "tdelta": enc.encode(_report(step=1, hist={"wall": {"3": 5}}))})
        client.heartbeat("repA", telemetry_payload={
            "tdelta": enc.encode(_report(step=2, hist={"wall": {"3": 8}}))})
        assert poll_fleet(lh.address())["hist"]["wall"]["count"] == 8

    def test_poll_fleet_degrades_on_an_unreachable_lighthouse(self):
        assert poll_fleet("http://127.0.0.1:9", timeout=0.5) is None


# ---------------------------------------------------------------------------
# /cluster.json pagination and ?since=
# ---------------------------------------------------------------------------


class TestPagination:
    def test_cursor_walk_covers_the_fleet_without_overlap(self, lighthouse):
        lh, client = lighthouse
        ids = [f"rep{c}" for c in "ABCDE"]
        for i, rid in enumerate(ids):
            client.heartbeat(rid, telemetry_payload={"step": i, "epoch": 1})
        seen, pages, cursor = [], 0, ""
        while True:
            pages += 1
            assert pages <= 10
            url = lh.address() + "/cluster.json?limit=2"
            if cursor:
                url += "&cursor=" + cursor
            page = _get_json(url)
            seen.extend(page["replicas"])
            cursor = page.get("next_cursor", "")
            if not cursor:
                break
        assert pages == 3
        assert sorted(seen) == sorted(ids)
        assert len(seen) == len(set(seen))

    def test_full_scrape_keeps_legacy_shape(self, lighthouse):
        lh, client = lighthouse
        client.heartbeat("repA", telemetry_payload={"step": 1, "epoch": 1})
        page = _get_json(lh.address() + "/cluster.json")
        assert "next_cursor" not in page
        assert page["replica_count"] == 1

    def test_since_filters_stale_replicas(self, lighthouse):
        lh, client = lighthouse
        client.heartbeat("old", telemetry_payload={"step": 1, "epoch": 1})
        time.sleep(0.4)
        client.heartbeat("fresh", telemetry_payload={"step": 2, "epoch": 1})
        page = _get_json(lh.address() + "/cluster.json?since=200")
        assert "fresh" in page["replicas"] and "old" not in page["replicas"]
        page = _get_json(lh.address() + "/cluster.json?since=60000")
        assert sorted(page["replicas"]) == ["fresh", "old"]


# ---------------------------------------------------------------------------
# the Manager's self-metering
# ---------------------------------------------------------------------------


def _fake_manager(manager_cls, logger_method="warn"):
    """The Manager's report methods on a stand-in holding the fields they
    read (the JAX Manager's logger method is ``warning``, the port's
    ``warn``)."""
    fake = SimpleNamespace(
        _slo=SimpleNamespace(breached=lambda: False),
        _watchdog=SimpleNamespace(stalled=False),
        _step=3, _quorum_id=2, _last_heal_ts=0.0, _divergence_latched=False,
        _tdelta_encoder=None, _anatomy_oversize_warned=False,
        _logger=SimpleNamespace(**{logger_method: lambda *a, **k: None}),
    )
    for name in ("_delta_encoder", "_telemetry_report", "_telemetry_payload_delta",
                 "_telemetry_payload", "_telemetry_payload_json"):
        setattr(fake, name, getattr(manager_cls, name).__get__(fake))
    return fake


def _port_fake():
    from torchft_tpu_torch.manager import Manager

    return _fake_manager(Manager)


class TestSelfMetering:
    def test_payload_is_a_decodable_delta_and_bytes_are_metered(self):
        fake = _port_fake()
        before = telemetry.TELEMETRY_BYTES.labels(channel="piggyback").value
        payload = fake._telemetry_payload()
        assert payload is not None and isinstance(payload["tdelta"], bytes)
        after = telemetry.TELEMETRY_BYTES.labels(channel="piggyback").value
        assert after - before == len(payload["tdelta"])
        dec = DeltaDecoder()
        assert dec.apply(payload["tdelta"])["ok"]
        state = dec.state()
        assert state["step"] == 3 and state["epoch"] == 2
        assert "summary" in state and "hist" in state

    def test_encoder_survives_across_steps_with_one_incarnation(self):
        fake = _port_fake()
        fake._telemetry_payload()
        inc = fake._tdelta_encoder.incarnation
        fake._step = 4
        payload = fake._telemetry_payload()
        assert fake._tdelta_encoder.incarnation is inc
        assert payload["tdelta"][3:11] == inc
        assert not payload["tdelta"][2] & 0x01

    def test_telemetry_is_a_first_class_anatomy_phase(self):
        from torchft_tpu_torch.telemetry.anatomy import PHASES

        assert "telemetry" in PHASES
        _port_fake()._telemetry_payload()
        summary = telemetry.LEDGER.summary()
        assert "telemetry" in str(summary.get("phases", summary))

    def test_kill_switch_still_wins_over_delta(self, monkeypatch):
        monkeypatch.setenv("TORCHFT_TELEMETRY_PIGGYBACK", "0")
        assert _port_fake()._telemetry_payload() is None

    def test_json_leg_carries_the_jax_keys(self, monkeypatch):
        """``TORCHFT_TELEMETRY_DELTA=0``: the full-JSON row of both Managers
        has the same keys, with the summary and anatomy as JSON strings."""
        from torchft_tpu.manager import Manager as JManager

        monkeypatch.setenv("TORCHFT_TELEMETRY_DELTA", "0")
        for pkg in (J, telemetry):
            pkg.LEDGER.tick(step=0)
            pkg.LEDGER.tick(step=1)
        port = _port_fake()._telemetry_payload()
        ref = _fake_manager(JManager, "warning")._telemetry_payload()
        assert "tdelta" not in port and set(port) == set(ref)
        assert set(json.loads(port["anatomy"])) == set(json.loads(ref["anatomy"]))
        assert set(json.loads(port["summary"])) == set(json.loads(ref["summary"]))


# ---------------------------------------------------------------------------
# the tack ack loop through a real ManagerServer quorum
# ---------------------------------------------------------------------------


class TestTackLoop:
    def test_acks_advance_and_deltas_keep_applying(self):
        from torchft_tpu_torch.coordination import LighthouseServer, ManagerClient, ManagerServer

        _native.tsdb_reset()
        lh = LighthouseServer(bind="[::]:0", min_replicas=1)
        mgr = ManagerServer(replica_id="repT", lighthouse_addr=lh.address(),
                            hostname="localhost", bind="[::]:0", store_addr="s", world_size=1)
        try:
            c = ManagerClient(mgr.address(), connect_timeout=timedelta(seconds=10))
            enc = DeltaEncoder()
            acked = []
            for step in range(3):
                res = c._quorum(rank=0, step=step, checkpoint_metadata="m", shrink_only=False,
                                timeout=timedelta(seconds=10),
                                telemetry_payload={"tdelta": enc.encode(
                                    _report(step=step, summary={"steps": step}))})
                ack = res.telemetry_ack
                assert ack is not None
                mine = ack[enc.incarnation.hex()]
                assert not mine.get("resync")
                acked.append(mine["ver"])
                enc.on_ack(ack)
            c.close()
            assert acked == sorted(acked) and acked[-1] > acked[0]
            assert enc.acked_version == acked[-1]
            assert enc.fulls_total == 1
            cl = _get_json(lh.address() + "/cluster.json")
            assert cl["replicas"]["repT"]["step"] == 2
            assert cl["replicas"]["repT"]["summary"] == {"steps": 2}
        finally:
            mgr.shutdown()
            lh.shutdown()
            _native.tsdb_reset()


# ---------------------------------------------------------------------------
# the two packages side by side
# ---------------------------------------------------------------------------


def _seeded_reports(seed, rounds):
    """A report sequence from a numpy generator: health scalars, a
    counters digest whose keys come and go, a list, every leaf type, a
    string and bytes, and histogram buckets that move."""
    rng = np.random.default_rng(seed)
    summary, hist = {}, {}
    out = []
    for step in range(rounds):
        for _ in range(int(rng.integers(0, 4))):
            summary[f"c{int(rng.integers(0, 12))}"] = int(rng.integers(-1000, 1000))
        if summary and rng.random() < 0.3:
            del summary[sorted(summary)[int(rng.integers(0, len(summary)))]]
        b = str(int(rng.integers(5, 15)))
        hist[b] = hist.get(b, 0) + 1
        report = _report(
            step=step, epoch=int(rng.integers(1, 4)), stuck=bool(rng.random() < 0.2),
            slo_breach=bool(rng.random() < 0.1),
            local_step_p50_s=float(rng.exponential(0.05)),
            summary=dict(summary),
            anatomy={"steps": step, "phases": {
                p: {"p50_s": float(rng.random()), "p99_s": float(rng.random())}
                for p in ("compute", "wire", "idle")[: 1 + step % 3]}},
            hist={"wall": dict(hist)},
            series={"local_s": float(rng.random()), "wall_s": float(rng.random())},
            tags=[str(x) for x in rng.integers(0, 9, size=step % 4)],
            label="é" * int(rng.integers(0, 3)), raw=rng.bytes(int(rng.integers(0, 6))),
            big=int(rng.integers(0, 1 << 62)) << int(rng.integers(0, 4)),
        )
        out.append(report)
    return out


def _encoders(max_bytes=None):
    port, ref = DeltaEncoder(max_bytes=max_bytes), JF.DeltaEncoder(max_bytes=max_bytes)
    port.incarnation = ref.incarnation = PINNED
    return port, ref


@pytest.mark.parametrize("seed,max_bytes", [(0, None), (1, None), (2, 300), (3, 160)])
def test_blobs_equal_jax_byte_for_byte(seed, max_bytes):
    """Over 40 seeded rounds, with acks every few rounds and a resync, the
    two encoders emit the same bytes and the same counters; each package's
    decoder rebuilds the sender's report from the other's blobs (once the
    cap stops deferring fields)."""
    port, ref = _encoders(max_bytes)
    pdec, jdec = DeltaDecoder(), JF.DeltaDecoder()
    rng = np.random.default_rng(100 + seed)
    reports = _seeded_reports(seed, 40)
    for i, report in enumerate(reports):
        pb, jb = port.encode(report), ref.encode(report)
        assert pb == jb, f"round {i}"
        assert jdec.apply(pb)["ok"] and pdec.apply(jb)["ok"], f"round {i}"
        if port.last_truncated == 0:
            want = unflatten(flatten(report))
            assert jdec.state() == want and pdec.state() == want
        if rng.random() < 0.3:
            ack = {PINNED.hex(): {"ver": jdec.version, "resync": bool(rng.random() < 0.2)}}
            port.on_ack(ack)
            ref.on_ack(ack)
    for key in ("version", "acked_version", "fulls_total", "blobs_total", "bytes_total",
                "truncated_total"):
        assert getattr(port, key) == getattr(ref, key), key


def test_decoders_agree_on_bad_blobs():
    """A truncated blob, a bad magic and a foreign incarnation's delta are
    refused the same way by both decoders, which then ask for a resync."""
    port, _ = _encoders()
    full = port.encode(_report(summary={"a": 1}))
    delta = port.encode(_report(step=2, summary={"a": 2}))
    cases = [full[:-3], b"\x00" + full[1:], delta, full[:9]]
    for blob in cases:
        p, j = DeltaDecoder().apply(blob), JF.DeltaDecoder().apply(blob)
        assert {k: p[k] for k in ("ok", "full", "resync_wanted")} == \
            {k: j[k] for k in ("ok", "full", "resync_wanted")}
        assert not p["ok"] and p["resync_wanted"]


def test_both_lighthouses_take_the_port_blobs_alike():
    """The port's blobs to the JAX package's lighthouse and to the port's
    (one C++ core, two builds): the same ``/cluster.json`` record and the
    same ``/fleet.json`` counters."""
    from torchft_tpu import _native as JN
    from torchft_tpu.coordination import LighthouseClient as JClient
    from torchft_tpu.coordination import LighthouseServer as JServer
    from torchft_tpu_torch.coordination import LighthouseClient, LighthouseServer

    JN.tsdb_reset()
    _native.tsdb_reset()
    servers = [JServer(bind="[::]:0", min_replicas=1), LighthouseServer(bind="[::]:0",
                                                                         min_replicas=1)]
    clients = [JClient(servers[0].address(), connect_timeout=timedelta(seconds=5)),
               LighthouseClient(servers[1].address(), connect_timeout=timedelta(seconds=5))]
    try:
        enc = DeltaEncoder()
        for report in _seeded_reports(7, 6):
            blob = enc.encode(dict(report, summary={"steps": report["step"]}))
            for c in clients:
                c.heartbeat("repX", telemetry_payload={"tdelta": blob})
        recs, fleets = [], []
        for s in servers:
            rec = _get_json(s.address() + "/cluster.json")["replicas"]["repX"]
            for key in ("last_seen_ms_ago", "heartbeat_ms_ago"):
                rec.pop(key, None)
            recs.append(rec)
            fleets.append(_get_json(s.address() + "/fleet.json")["telemetry"])
        assert recs[0] == recs[1]
        assert recs[1]["step"] == 5 and recs[1]["summary"] == {"steps": 5}
        for key in ("delta_blobs_total", "delta_fulls_total", "delta_resyncs_total"):
            assert fleets[0][key] == fleets[1][key], key
        assert fleets[1]["delta_blobs_total"] == 6 and fleets[1]["delta_resyncs_total"] == 0
    finally:
        for c in clients:
            c.close()
        for s in servers:
            s.shutdown()
        JN.tsdb_reset()
        _native.tsdb_reset()


def test_collect_hists_equal_jax():
    """The same step rows in both ledgers give the same sparse buckets."""
    from torchft_tpu_torch.telemetry.fleetdelta import collect_hists

    for pkg in (J, telemetry):
        for step in range(5):
            pkg.STEP_WALL_SECONDS.observe(0.01 * (step + 1))
            pkg.STEP_LOCAL_SECONDS.observe(0.004 * (step + 1))
            pkg.STEP_PHASE_SECONDS.labels(phase="compute").observe(0.003 * (step + 1))
    port, ref = collect_hists(), JF.collect_hists()
    keep = lambda h: {k: v for k, v in h.items() if not k.startswith("lat.")}  # noqa: E731
    assert keep(port) == keep(ref)
    assert port["wall"] and port["phase.compute"]


# ---------------------------------------------------------------------------
# three worker processes, one slowed (chip_smoke.py phase 17 on the CPU)
# ---------------------------------------------------------------------------


def test_three_worker_fleet_names_the_slowed_group(monkeypatch):
    """``recovery.run_fleet`` with three tiny CPU workers, group 2 sleeping
    three of its steady steps from step 10 and group 0 hosting both
    monitors: every check of ``recovery.fleet_checks`` holds (one state,
    ``/cluster.json``, the delta chains without a resync, ``/fleet.json``,
    ``/timeseries.json``, the straggler latch on group 2 alone, the
    regression latch on its ``local_s``, its critical-path blame and
    gating, its SLO breach, the merged trace), the fleet's lighthouse
    serves no ring of an earlier one, and each worker's chain began with
    one full blob."""
    from torchft_tpu_torch.benchmarks.recovery import fleet_checks, run_fleet
    from torchft_tpu_torch.coordination import LighthouseClient, LighthouseServer

    monkeypatch.setenv("DEVICE", "cpu")
    # an earlier lighthouse of this process leaves its rings in the native
    # time-series store: the fleet's lighthouse must not serve them
    old = LighthouseServer(bind="[::]:0", min_replicas=1)
    client = LighthouseClient(old.address(), connect_timeout=timedelta(seconds=5))
    for step in range(40):
        client.heartbeat("stale", telemetry_payload={
            "step": step, "epoch": 1, "series": {"local_s": 5.0, "wall_s": 5.0}})
    client.close()
    old.shutdown()
    monitors = {"TORCHFT_STRAGGLER_MONITOR": "1", "TORCHFT_REGRESSION_MONITOR": "1",
                "TORCHFT_STRAGGLER_POLL_S": "0.1", "TORCHFT_REGRESSION_POLL_S": "0.1"}
    steps = 32
    r = run_fleet(num_groups=3, total_steps=steps, slow_group=2, slow_from=10, slow_steps=3.0,
                  step_sleep=0.05, op_timeout=10.0, timeout_s=150.0,
                  env_extra={"TORCHFT_SLO_STEP_S": "0.15"}, group_env={0: monitors})
    # the CPU is shared with the rest of the test run: another worker's
    # compute may shift too, and the sentinel latches it (on the card
    # chip_smoke.py holds the latch to group 2 alone)
    failed = [c for c in fleet_checks(r, 2, 10, steps, regression_alone=False) if not c[1]]
    assert not failed, failed
    assert "stale" not in r["timeseries"]["replicas"]
    assert sorted(r["slowed"]) == [2] and r["slowed"][2]["step"] == 10
    for final in r["finals"].values():
        tel = final["telemetry"]
        assert tel["fulls"] == 1 and len(tel["blobs"]) >= steps
        assert tel["full_blob_now"] > 0 and tel["json_payload_now"] > 0


@pytest.mark.parametrize("off_main_s,want_telemetry,want_idle", [
    (0.005, 0.005, 0.005),  # within the residual: as the JAX ledger
    (0.02, 0.01, 0.0),      # past it: the port fills the residual only
])
def test_quorum_thread_telemetry_fills_the_rows_residual(monkeypatch, off_main_s,
                                                         want_telemetry, want_idle):
    """The report is encoded on the quorum thread, beside the main thread's
    compute or inside its quorum wait. Its ``telemetry`` record takes at
    most the row's residual, so the row still sums to its wall; the JAX
    ledger adds it in full, and its row passes the wall when the encode
    overlapped a recorded main-thread phase."""
    import threading

    import torchft_tpu.telemetry.anatomy as JA
    import torchft_tpu_torch.telemetry.anatomy as PA

    now = [100.0]
    monkeypatch.setattr("time.perf_counter", lambda: now[0])
    rows = {}
    for name, mod in (("port", PA), ("jax", JA)):
        led = mod.StepLedger()
        now[0] = 100.0
        led.tick(0)
        led.record("compute", 0.09)
        th = threading.Thread(target=led.record, args=("telemetry", off_main_s))
        th.start()
        th.join()
        now[0] = 100.1
        rows[name] = led.tick(1)
    port = rows["port"]
    assert port["phases"]["telemetry"] == pytest.approx(want_telemetry)
    assert port["phases"].get("idle", 0.0) == pytest.approx(want_idle, abs=1e-12)
    assert sum(port["phases"].values()) == pytest.approx(port["wall_s"], rel=1e-9)
    jax_sum = sum(rows["jax"]["phases"].values())
    if off_main_s <= 0.01:
        assert rows["jax"]["phases"] == pytest.approx(port["phases"])
    else:
        assert jax_sum > rows["jax"]["wall_s"] + 0.009
