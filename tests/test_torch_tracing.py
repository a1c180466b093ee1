"""The port's spans against the JAX package's, and the trace across a heal.

The same span trees go into a ``torchft_tpu.telemetry.tracing.Tracer`` and
the port's: names, trace ids of the form ``replica_id:step:quorum_epoch``,
parent links, span ids (the pid and a per-tracer sequence), attributes,
the JSONL sink, the Chrome export and the piggyback fragments are equal
but for wall timestamps. A carrier formatted by either package parses in
the other and links the span. A heal between two of the port's HTTP
transports puts the serving side's ``checkpoint_serve`` span in the
healer's trace (the ``X-TFT-Trace`` header), the fetches on pool threads
too. Last, a threaded two-group FT run of the tiny model on each package,
one group healing at the bootstrap quorum: the (event, step, quorum id,
participants) records of the trail, and the span names of every step,
are the same on both.
"""

import collections
import json
import os
import threading
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchft_tpu import telemetry as J
from torchft_tpu.telemetry import tracing as JT
from torchft_tpu_torch import telemetry as P
from torchft_tpu_torch.telemetry import tracing as PT


@pytest.fixture(autouse=True)
def _clean():
    J.reset()
    P.reset()
    yield
    J.reset()
    P.reset()


_VOLATILE = ("ts", "dur_s", "dur", "tid")


def _stable(d):
    return {k: v for k, v in d.items() if k not in _VOLATILE}


def _tree(tracing):
    tr = tracing.Tracer(maxlen=64)
    tr.set_context(replica_id="g0_abc", step=4, quorum_epoch=2)
    with tr.span("quorum", rank=0) as q:
        with tr.span("quorum_rpc", rank=0, step=4):
            pass
        q.set(quorum_id=2, heal=False)
    with tr.span("heal_recv", trace_id="g0_abc:4:3", src="http://x"):
        carrier = tr.inject()
    with tr.span("should_commit", vote=True):
        try:
            with tr.span("should_commit_rpc"):
                raise ValueError("vote lost")
        except ValueError:
            pass
    with tr.span("checkpoint_serve", parent=carrier, replica_id="g1_def", bytes=10):
        pass
    bare = tr.inject()
    return tr, carrier, bare


def test_span_trees_match_jax():
    (jt, jc, jb), (pt, pc, pb) = _tree(JT), _tree(PT)
    assert [_stable(s) for s in pt.recent()] == [_stable(s) for s in jt.recent()]
    assert (pc, pb) == (jc, jb)
    assert pb == {"trace_id": "g0_abc:4:2", "span_id": ""}
    names = [s["name"] for s in pt.recent()]
    assert names == ["quorum_rpc", "quorum", "heal_recv", "should_commit_rpc",
                     "should_commit", "checkpoint_serve"]
    serve = pt.recent("checkpoint_serve")[-1]
    assert serve["trace_id"] == "g0_abc:4:3" and serve["parent_id"] == pc["span_id"]
    assert serve["replica_id"] == "g1_def"
    assert pt.recent("should_commit_rpc")[-1]["attrs"]["error"] == "ValueError('vote lost')"
    assert [_stable(e) for e in pt.chrome_events()] == [_stable(e) for e in jt.chrome_events()]
    assert pt.current_trace_id() == jt.current_trace_id() == "g0_abc:4:2"


def test_carriers_cross_parse():
    jt, pt = JT.Tracer(), PT.Tracer()
    jt.set_context(replica_id="healer", step=9, quorum_epoch=5)
    pt.set_context(replica_id="server", step=9, quorum_epoch=5)
    with jt.span("heal_recv") as heal:
        header = JT.Tracer.format_carrier(jt.inject())
    assert PT.Tracer.format_carrier(PT.Tracer.parse_carrier(header)) == header
    with pt.span("checkpoint_serve", parent=PT.Tracer.parse_carrier(header),
                 replica_id="server"):
        pass
    serve = pt.recent("checkpoint_serve")[-1]
    assert serve["trace_id"] == heal.trace_id == "healer:9:5"
    assert serve["parent_id"] == heal.span_id
    # and the other way round
    with pt.span("heal_recv") as heal2:
        header2 = PT.Tracer.format_carrier(pt.inject())
    with jt.span("checkpoint_serve", parent=JT.Tracer.parse_carrier(header2)):
        pass
    assert jt.recent("checkpoint_serve")[-1]["parent_id"] == heal2.span_id
    assert PT.Tracer.parse_carrier("") is None and JT.Tracer.parse_carrier("") is None


def test_sinks_exports_and_fragments_match_jax(tmp_path):
    out = []
    for name, tracing in (("jax", JT), ("port", PT)):
        tr, _, _ = _tree(tracing)
        path = str(tmp_path / name / "spans.jsonl")
        tr.configure(path)
        with tr.span("heal_send", dst_ranks=[1]):
            pass
        tr.configure(None)
        chrome = tracing.chrome_trace(str(tmp_path / f"{name}.json"), tr.recent())
        with open(chrome) as f:
            doc = json.load(f)
        frag = tr.drain_chrome_fragment(max_events=3)
        tr.requeue_last_batch()
        again = tr.drain_chrome_fragment(max_events=64, max_bytes=300)
        rest = tr.drain_chrome_fragment()
        out.append((
            [_stable(s) for s in tracing.read_spans(path)],
            doc["displayTimeUnit"], [_stable(e) for e in doc["traceEvents"]],
            [_stable(e) for e in json.loads(f"[{frag}]")],
            [_stable(e) for e in json.loads(f"[{again}]")],
            [_stable(e) for e in json.loads(f"[{rest}]")] if rest else [],
        ))
    assert out[1] == out[0]
    assert [s["name"] for s in out[1][0]] == ["heal_send"]


# ---------------------------------------------------------------------------
# the heal's serve span joins the healer's trace
# ---------------------------------------------------------------------------


def _state(seed):
    rng = np.random.default_rng(seed)
    return {"user": {"w": torch.from_numpy(rng.standard_normal((64, 32), dtype=np.float32))},
            "torchft": {"step": 3, "batches_committed": 6}}


@pytest.mark.parametrize("nsources", [1, 2])
def test_serve_spans_join_the_healers_trace(nsources):
    from torchft_tpu_torch.checkpointing.http_transport import TRACE_HEADER, HTTPTransport

    assert TRACE_HEADER == "X-TFT-Trace"
    timeout = timedelta(seconds=20)
    sources = [HTTPTransport(timeout=timeout, hostname="localhost") for _ in range(nsources)]
    healer = HTTPTransport(timeout=timeout, hostname="localhost")
    try:
        for src in sources:
            src.send_checkpoint([1], step=3, state_dict=_state(0), timeout=timeout)
        P.TRACER.set_context(replica_id="healer_x", step=3, quorum_epoch=7)
        with P.TRACER.span("heal_recv", trace_id="healer_x:3:7") as heal:
            got = healer.recv_checkpoint_multi([s.metadata() for s in sources], step=3,
                                               timeout=timeout)
        assert torch.equal(got["user"]["w"], _state(0)["user"]["w"])
    finally:
        for t in sources + [healer]:
            t.shutdown()
    serves = P.TRACER.recent("checkpoint_serve")
    # each source served at least its stripe plan's metadata over HTTP
    assert len(serves) >= nsources
    assert all(s["trace_id"] == "healer_x:3:7" and s["parent_id"] == heal.span_id
               for s in serves), serves
    recvs = [r for r in P.EVENTS.recent() if r["event"] == "checkpoint_recv"]
    assert len(recvs) == 1 and recvs[0]["transport"] == "http"
    assert P.LEDGER.heal_stage_snapshot().keys() >= {"meta", "recv", "decode"}


# ---------------------------------------------------------------------------
# a threaded two-group FT run of both packages
# ---------------------------------------------------------------------------

BASE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64)
STEPS = 3
TIMEOUT = timedelta(seconds=30)


def _tokens(gid, step):
    return np.random.default_rng(1000 + 17 * gid + step).integers(0, 64, (2, 128)).astype(np.int32)


def _run_groups(target, n=2, timeout=240):
    errors, results = [], {}

    def wrap(gid):
        try:
            results[gid] = target(gid)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=wrap, args=(g,)) for g in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout)
    assert all(not th.is_alive() for th in threads), "a replica group hung"
    if errors:
        raise errors[0]
    return results


def _port_run(np_params, trails=None):
    """The port's two threaded groups; with ``trails`` (a dict), each
    group's trail records land in ``trails[gid]`` in emit order: the trail
    is process-wide, so a record is charged to the group whose main or
    quorum thread emitted it."""
    from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport
    from torchft_tpu_torch.collectives import CollectivesTcp
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.models import transformer as T
    from torchft_tpu_torch.parallel.ft import FTTrainer
    from torchft_tpu_torch.parallel.train_step import TrainStep
    from torchft_tpu_torch.store import StoreServer

    cfg = T.TransformerConfig(**BASE, dtype=torch.float32, attention_impl="flash")
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=2)
    mains = {}

    def charge(record):
        me = threading.current_thread()
        gid = mains.get(me.ident)
        if gid is None and me.name.startswith("tft_g") and "_quorum" in me.name:
            gid = int(me.name[len("tft_g"):].split("_")[0])
        trails.setdefault(gid, []).append(record)

    if trails is not None:
        P.EVENTS.subscribe(charge)

    def group(gid):
        mains[threading.current_thread().ident] = gid
        store = StoreServer()
        manager = Manager(
            collectives=CollectivesTcp(timeout=TIMEOUT, native_plane=True),
            load_state_dict=None, state_dict=None, min_replica_size=2, replica_id=f"g{gid}",
            store_addr=store.address(), rank=0, world_size=1,
            lighthouse_addr=lighthouse.address(), timeout=TIMEOUT,
            checkpoint_transport=HTTPTransport(timeout=TIMEOUT, hostname="localhost"))
        # the quorum thread's name says its group (it starts at the first
        # start_quorum)
        manager._executor._thread_name_prefix = f"tft_g{gid}_quorum"
        try:
            trainer = FTTrainer(manager, TrainStep(cfg, device="cpu"))
            trainer.init(params=T.params_from_jax(np_params, device="cpu"))
            while manager.current_step() < STEPS:
                tokens = torch.from_numpy(_tokens(gid, manager.current_step()))
                assert trainer.step(tokens)[1]
        finally:
            manager.shutdown(wait=False)
            store.shutdown()

    try:
        _run_groups(group)
    finally:
        if trails is not None:
            P.EVENTS.unsubscribe(charge)
        lighthouse.shutdown()


def _jax_run(np_params):
    from torchft_tpu.checkpointing.http_transport import HTTPTransport
    from torchft_tpu.collectives import CollectivesTcp
    from torchft_tpu.coordination import LighthouseServer
    from torchft_tpu.ddp import allreduce_gradients
    from torchft_tpu.manager import Manager
    from torchft_tpu.models import transformer as JM
    from torchft_tpu.parallel.mesh import MeshConfig, make_mesh
    from torchft_tpu.parallel.train_step import TrainStep
    from torchft_tpu.store import StoreServer

    cfg = JM.TransformerConfig(**BASE, dtype=jnp.float32, attention_impl="flash")
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=2)

    def group(gid):
        store = StoreServer()
        manager = Manager(
            collectives=CollectivesTcp(timeout=TIMEOUT), load_state_dict=None,
            state_dict=None, min_replica_size=2, replica_id=f"g{gid}",
            store_addr=store.address(), rank=0, world_size=1,
            lighthouse_addr=lighthouse.address(), timeout=TIMEOUT,
            checkpoint_transport=HTTPTransport(timeout=TIMEOUT, hostname="localhost"))
        try:
            ts = TrainStep(cfg, optax.adamw(3e-4), make_mesh(MeshConfig(), jax.devices()[:1]))
            st = {"params": jax.device_put(np_params, ts._param_shardings)}
            st["opt_state"] = ts.init_opt(st["params"])

            def load(state):
                st["params"] = jax.device_put(state["params"], ts._param_shardings)
                st["opt_state"] = state["opt_state"]

            manager.set_state_dict_fns(load, lambda: dict(st))
            while manager.current_step() < STEPS:
                tokens = ts.shard_batch(jnp.asarray(_tokens(gid, manager.current_step())))
                manager.start_quorum()
                _, grads = ts.grads(st["params"], tokens)
                grads = allreduce_gradients(manager, grads)
                assert manager.should_commit()
                st["params"], st["opt_state"] = ts.apply(st["params"], st["opt_state"], grads)
        finally:
            manager.shutdown(wait=False)
            store.shutdown()

    try:
        _run_groups(group)
    finally:
        lighthouse.shutdown()


def _records(pkg):
    """The trail as (event, step, quorum id, participants) tuples, sorted
    (the two groups' threads interleave), and the span names of every step
    (from the trace id's step field)."""
    recs = []
    for r in pkg.EVENTS.recent():
        parts = r.get("participants")
        recs.append((r["event"], r.get("step"), r.get("quorum_id"),
                     len(parts) if isinstance(parts, list) else parts))
    spans = collections.defaultdict(collections.Counter)
    for s in pkg.TRACER.recent():
        spans[int(s["trace_id"].split(":")[1])][s["name"]] += 1
    return sorted(recs, key=repr), {k: dict(v) for k, v in sorted(spans.items())}


def test_two_group_heal_trail_and_spans_match_jax():
    from torchft_tpu.models import transformer as JM

    params = JM.init_params(jax.random.PRNGKey(0), JM.TransformerConfig(**BASE, dtype=jnp.float32))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    J.reset()
    _jax_run(np_params)
    ref = _records(J)
    P.reset()
    trails = {}
    _port_run(np_params, trails)
    got = _records(P)
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    events = [e for e, *_ in got[0]]
    # one group healed from the other at the bootstrap quorum, and both
    # committed every step
    assert events.count("heal_begin") == events.count("heal_end") == 1
    assert events.count("commit") == 2 * STEPS
    assert got[1][0].get("heal_recv") == 1 and got[1][0].get("heal_send") == 1
    assert got[1][0].get("checkpoint_serve", 0) >= 1
    # the serve span joins the healer's trace on the port too
    heal = P.TRACER.recent("heal_recv")[-1]
    assert any(s["trace_id"] == heal["trace_id"] and s["parent_id"] == heal["span_id"]
               for s in P.TRACER.recent("checkpoint_serve"))
    # each group's trail replayed through the JAX package's protocol
    # checker (epoch and step regressions, commits during a heal): clean
    from torchft_tpu.analysis.protocol.conformance import check_records

    for gid in (0, 1):
        rep = check_records(trails[gid], source=f"g{gid}")
        kinds = [r["event"] for r in trails[gid]]
        assert kinds.count("commit") == STEPS and kinds.count("quorum_ready") >= STEPS, kinds
        assert not rep.findings, rep.render()
    assert not [r for r in trails.get(None, []) if r["event"] in (
        "quorum_start", "quorum_ready", "heal_begin", "heal_end", "commit", "abort")]
