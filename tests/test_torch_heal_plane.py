"""The heal plane of the port: the cases of ``tests/test_heal_plane.py``
on ``torchft_tpu_torch`` (stripe planning, the native blob plane, the
striped multi-source receive with a source that diverges, round-trips or
dies mid-heal, the header callback, the differential heal, the serving
window's consistency and the quorum's heal sources), the chunked
``recv_checkpoint``, and parity with the JAX package on the same numpy
trees: stripe plans, chunk groups, leaf and tree digests, the delta's
changed leaves and the per-source byte and range counts of
``last_heal_stats`` are equal, exactly. The headers differ by design
(the port's tree spec against jax treedefs), so trees are compared leaf
by leaf."""

from __future__ import annotations

import pickle
import threading
import time
from datetime import timedelta

import numpy as np
import pytest
import torch

from torchft_tpu.checkpointing import delta as jdm
from torchft_tpu.checkpointing import serialization as jser
from torchft_tpu.checkpointing import stripes as jstripes
from torchft_tpu.checkpointing.http_transport import HTTPTransport as JHTTPTransport
from torchft_tpu_torch import _native
from torchft_tpu_torch.checkpointing import delta as dm
from torchft_tpu_torch.checkpointing import http_transport as ht
from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport
from torchft_tpu_torch.checkpointing.serialization import (
    TensorSpec,
    flatten_state,
    spec_tree_from_header,
    unflatten_state,
)
from torchft_tpu_torch.checkpointing.stripes import (
    assign_chunk_groups,
    slice_buffers,
    stripe_ranges,
)
from torchft_tpu_torch.utils.tree import tree_flatten

T = timedelta(seconds=20)


def _state(seed: int = 0):
    """The JAX test's tree, numpy leaves (parity with the JAX package)."""
    rng = np.random.default_rng(seed)
    return {
        "big": rng.standard_normal((512, 512)).astype(np.float32),
        "small": np.arange(37, dtype=np.int64),
        "empty": np.zeros(0, dtype=np.float32),
        "scalar": np.float32(3.25),
        "obj": {"step": seed, "note": "x"},
    }


def _torch_state(seed: int = 0):
    """A state of tensors as a trainer serves it: float32 params, bf16,
    an int leaf, an empty one and an optimizer step count."""
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(256, 64, generator=g),
                   "b16": torch.randn(33, generator=g).to(torch.bfloat16),
                   "empty": torch.zeros(0, 3)},
        "ids": torch.arange(7, dtype=torch.int64),
        "opt": {"step": seed, "lr": 3e-4},
    }


def _tree_equal(a, b):
    la, sa = tree_flatten(a)
    lb, sb = tree_flatten(b)
    assert sa == sb and len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert isinstance(y, torch.Tensor) and x.dtype == y.dtype and x.shape == y.shape
            assert x.reshape(-1).view(torch.uint8).equal(y.reshape(-1).view(torch.uint8))
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()
        else:
            assert x == y


@pytest.fixture
def transports():
    made = []

    def make(cls=HTTPTransport, **kwargs):
        t = cls(T, hostname="localhost", **kwargs)
        made.append(t)
        return t

    yield make
    for t in made:
        t.shutdown()


# ---------------------------------------------------------------------------
# stripe planning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8])
def test_stripe_ranges_cover_balance_and_equal_jax(n):
    for total in (10_000_000 + 13, 1000, 64, 10, 1_048_872):
        ranges = stripe_ranges(total, n)
        assert ranges == jstripes.stripe_ranges(total, n)
        assert sum(ln for _, ln in ranges) == total
        pos = 0
        for off, ln in ranges:
            assert off == pos and ln > 0
            pos += ln
        if total >= 64 * n:
            lens = [ln for _, ln in ranges]
            assert max(lens) - min(lens) <= 64 + total % 64


def test_stripe_ranges_deterministic_and_degenerate():
    assert stripe_ranges(1000, 3) == stripe_ranges(1000, 3)
    assert stripe_ranges(0, 4) == []
    assert sum(ln for _, ln in stripe_ranges(10, 8)) == 10


def test_slice_buffers_round_trip_with_zero_len():
    bufs = [
        np.arange(100, dtype=np.uint8),
        np.zeros(0, dtype=np.uint8),
        np.arange(50, dtype=np.float32).view(np.uint8),
    ]
    sizes = [b.nbytes for b in bufs]
    total = sum(sizes)
    flat = b"".join(bytes(b) for b in bufs)
    for off, ln in stripe_ranges(total, 3) + [(0, total), (99, 150)]:
        got = b"".join(bytes(mv) for mv in slice_buffers(bufs, sizes, off, ln))
        assert got == flat[off : off + ln], (off, ln)
        jgot = b"".join(bytes(mv) for mv in jstripes.slice_buffers(bufs, sizes, off, ln))
        assert got == jgot


def test_chunk_groups_equal_jax():
    rng = np.random.default_rng(3)
    for _ in range(20):
        sizes = [int(x) for x in rng.integers(0, 1 << 20, int(rng.integers(1, 30)))]
        for k in (1, 2, 3, 5):
            assert assign_chunk_groups(sizes, k) == jstripes.assign_chunk_groups(sizes, k)


# ---------------------------------------------------------------------------
# digests and the delta manifest against the JAX package
# ---------------------------------------------------------------------------


def test_digests_equal_jax():
    for seed in range(3):
        state = _state(seed)
        _, jbufs = jser.flatten_state(state)
        _, tbufs = flatten_state(state)
        assert dm.leaf_digests(tbufs) == jdm.leaf_digests(jbufs)
        assert dm.tree_digest(dm.leaf_digests(tbufs)) == jdm.tree_digest(jdm.leaf_digests(jbufs))
    # a tree of tensors digests its raw bytes: equal to the numpy tree of
    # the same bytes
    t = _torch_state(1)
    _, tbufs = flatten_state(t)
    as_np = {"params": {"w": t["params"]["w"].numpy(),
                        "b16": t["params"]["b16"].view(torch.int16).numpy(),
                        "empty": t["params"]["empty"].numpy()},
             "ids": t["ids"].numpy(), "opt": t["opt"]}
    _, jbufs = jser.flatten_state(as_np)
    assert dm.leaf_digests(tbufs) == jdm.leaf_digests(jbufs)
    # past 64 MB the leaves hash on threads: the same digests, in order
    rng = np.random.default_rng(7)
    big = [np.frombuffer(rng.bytes(n), np.uint8) for n in (40 << 20, 1000, 30 << 20, 0)]
    assert dm.leaf_digests(big) == jdm.leaf_digests(big)


def _staged_pair():
    """(state at S as the healer holds it, state at S+1): 'big', 'scalar'
    and 'obj' changed, 'small' and 'empty' not."""
    s0 = _state(1)
    s1 = dict(s0)
    s1["big"] = s0["big"] * 2.0
    s1["scalar"] = np.float32(4.5)
    s1["obj"] = {"step": 99, "note": "x"}
    return s0, s1


def test_build_delta_changed_equals_jax():
    s0, s1 = _staged_pair()
    h1, b1 = flatten_state(s1)
    _, b0 = flatten_state(s0)
    jh1, jb1 = jser.flatten_state(s1)
    _, jb0 = jser.flatten_state(s0)
    ent = {"tree": dm.tree_digest(dm.leaf_digests(b0)), "leaves": dm.leaf_digests(b0),
           "sizes": [b.nbytes for b in b0]}
    jent = {"tree": jdm.tree_digest(jdm.leaf_digests(jb0)), "leaves": jdm.leaf_digests(jb0),
            "sizes": [b.nbytes for b in jb0]}
    manifest, changed = dm.build_delta(h1, b1, dm.leaf_digests(b1), ent, ent["tree"])
    jmanifest, jchanged = jdm.build_delta(jh1, jb1, jdm.leaf_digests(jb1), jent, jent["tree"])
    assert manifest["changed"] == jmanifest["changed"] == [0]
    assert manifest["sizes"] == jmanifest["sizes"]
    assert [bytes(c) for c in changed] == [bytes(c) for c in jchanged]


# ---------------------------------------------------------------------------
# native blob plane
# ---------------------------------------------------------------------------


def test_blob_round_trip_stale_and_unstage():
    srv = _native.BlobServer()
    try:
        a = np.arange(5000, dtype=np.float32)
        z = np.zeros(0, dtype=np.uint8)
        b = np.arange(17, dtype=np.uint8)
        bufs = [a, z, b]
        srv.stage([x.ctypes.data for x in bufs], [x.nbytes for x in bufs], token=7)
        total = sum(x.nbytes for x in bufs)
        dst = memoryview(bytearray(total))
        for off, ln in stripe_ranges(total, 3):  # ranges that cross buffers
            _native.blob_fetch("localhost", srv.port, 7, off, ln, dst[off : off + ln])
        assert bytes(dst) == bytes(a.view(np.uint8)) + bytes(b)
        # a stale token is a loud error, never stale bytes
        with pytest.raises(ConnectionError, match="stale"):
            _native.blob_fetch("localhost", srv.port, 8, 0, 4, dst[:4])
        with pytest.raises(ConnectionError, match="range"):
            _native.blob_fetch("localhost", srv.port, 7, total - 2, 8, dst[:8])
        srv.unstage()
        with pytest.raises(ConnectionError, match="stale"):
            _native.blob_fetch("localhost", srv.port, 7, 0, 4, dst[:4])
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# striped multi-source receive
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make_state", [_state, _torch_state], ids=["numpy", "tensors"])
def test_two_sources_bit_identical(transports, make_state, monkeypatch):
    # each source's worker fetches one range a round: without it, a worker
    # thread the host schedules late finds the queue drained by the other
    # and its source serves 0 bytes (a correct heal, but the per-source
    # check below would then follow thread timing)
    _paired_fetch(_native, monkeypatch, 2)
    state = make_state(1)
    s1, s2, rx = transports(), transports(), transports()
    s1.send_checkpoint([1], 3, state, T)
    s2.send_checkpoint([1], 3, state, T)
    out = rx.recv_checkpoint_multi([s1.metadata(), s2.metadata()], 3, T)
    _tree_equal(out, state)
    stats = rx.last_heal_stats
    assert stats["mode"] == "striped" and stats["nsources"] == 2 and stats["failures"] == {}
    for src_stats in stats["sources"].values():
        assert src_stats["bytes"] > 0 and "gb_per_sec" in src_stats
        assert src_stats["route"] == "blob"
    assert {"meta_s", "recv_s", "decode_s"} <= set(stats["stages"])
    assert stats["bytes"] == rx.last_recv_bytes


def test_divergent_source_excluded(transports):
    state, other = _state(1), _state(2)
    s1, s2, rx = transports(), transports(), transports()
    s1.send_checkpoint([1], 4, state, T)
    s2.send_checkpoint([1], 4, other, T)
    out = rx.recv_checkpoint_multi([s1.metadata(), s2.metadata()], 4, T)
    _tree_equal(out, state)
    assert rx.last_heal_stats["nsources"] == 1


def test_healed_round_trip_source_not_excluded(transports):
    """pickle is not canonical: a heal-round-tripped tree may serialize to
    another header than a freshly built one, so the digest covers buffer
    bytes only and such a source still stripes."""
    state = _torch_state(1)
    h, b = flatten_state(state)
    rebuilt = unflatten_state(h, b)  # the once-healed lineage
    s1, s2, rx = transports(), transports(), transports()
    s1.send_checkpoint([1], 5, state, T)
    s2.send_checkpoint([1], 5, rebuilt, T)
    out = rx.recv_checkpoint_multi([s1.metadata(), s2.metadata()], 5, T)
    _tree_equal(out, state)
    assert rx.last_heal_stats["nsources"] == 2


def test_source_death_mid_heal_re_stripes(transports):
    state = _state(3)
    s1, rx = transports(), transports()
    s2 = HTTPTransport(T, hostname="localhost")
    s1.send_checkpoint([1], 6, state, T)
    s2.send_checkpoint([1], 6, state, T)
    # s2 dies after the planning saw it: its ranges move to s1
    out = rx.recv_checkpoint_multi([s1.metadata(), s2.metadata()], 6, T,
                                   header_cb=lambda h: s2.shutdown())
    _tree_equal(out, state)
    stats = rx.last_heal_stats
    assert stats["nsources"] == 1 and list(stats["failures"]) == [s2.metadata()]
    assert stats["sources"][s1.metadata()]["bytes"] == stats["bytes"] - len(
        flatten_state(state)[0])


def test_header_cb_fires_with_spec_tree(transports):
    state = {**_state(4), "t": torch.zeros(3, 5, dtype=torch.bfloat16)}
    s1, rx = transports(), transports()
    s1.send_checkpoint([1], 7, state, T)
    seen = []
    rx.recv_checkpoint_multi([s1.metadata()], 7, T, header_cb=seen.append)
    assert len(seen) == 1
    spec = spec_tree_from_header(seen[0])
    assert spec["big"] == TensorSpec((512, 512), torch.float32)
    assert spec["empty"].shape == (0,)
    assert spec["t"] == TensorSpec((3, 5), torch.bfloat16)
    assert spec["obj"] == {"step": 4, "note": "x"}  # obj leaves verbatim


def test_single_source_path(transports):
    state = _torch_state(5)
    s1, rx = transports(), transports()
    s1.send_checkpoint([1], 8, state, T)
    out = rx.recv_checkpoint_multi([s1.metadata()], 8, T)
    _tree_equal(out, state)
    assert rx.last_heal_stats["nsources"] == 1


def test_http_range_fallback(transports, monkeypatch):
    """Without the blob plane a source advertises no port and the ranges
    ride HTTP."""
    monkeypatch.setattr(ht, "HEAL_NATIVE", False)
    state = _torch_state(6)
    s1, s2, rx = transports(), transports(), transports()
    s1.send_checkpoint([1], 2, state, T)
    s2.send_checkpoint([1], 2, state, T)
    out = rx.recv_checkpoint_multi([s1.metadata(), s2.metadata()], 2, T)
    _tree_equal(out, state)
    assert {v["route"] for v in rx.last_heal_stats["sources"].values()} == {"http"}


def test_received_tensors_view_one_buffer(transports):
    """The striped receive decodes without a second copy: the tensor leaves
    are views into the one receive buffer."""
    state = {"a": torch.arange(64, dtype=torch.float32), "b": torch.ones(32)}
    s1, rx = transports(), transports()
    s1.send_checkpoint([1], 1, state, T)
    out = rx.recv_checkpoint_multi([s1.metadata()], 1, T)
    _tree_equal(out, state)
    base = out["a"].untyped_storage().data_ptr()
    assert out["b"].data_ptr() == base + 64 * 4


def test_chunked_recv_checkpoint(transports):
    state = _torch_state(7)
    src = transports(num_chunks=3)
    rx = transports(num_chunks=3)
    src.send_checkpoint([1], 9, state, T)
    header, groups = pickle.loads(b"".join(src._render("metadata")))
    assert len(groups) == 3  # the chunk endpoints really served
    _tree_equal(rx.recv_checkpoint(0, src.metadata(), 9, T), state)
    # a receiver in chunked mode reads an unchunked sender's /full
    plain = transports()
    plain.send_checkpoint([1], 9, state, T)
    _tree_equal(rx.recv_checkpoint(0, plain.metadata(), 9, T), state)
    assert rx.last_recv_bytes > sum(t.nbytes for t in
                                    (state["params"]["w"], state["ids"]))


def _paired_fetch(module, monkeypatch, n):
    """Make each of ``n`` stripe workers fetch one range per round: every
    fetch waits for the other workers' before it runs, so no worker takes
    two ranges while another has none. The per-source counts are then
    fixed by the plan, not by thread timing."""
    real = module.blob_fetch
    barrier = threading.Barrier(n, timeout=10)

    def fetch(*args, **kwargs):
        barrier.wait()
        return real(*args, **kwargs)

    monkeypatch.setattr(module, "blob_fetch", fetch)


def test_per_source_counts_equal_jax(monkeypatch):
    """Two sources, four ranges of equal length (the tree is 4 x 64 x k
    bytes): each source serves two ranges of the same bytes in both
    packages."""
    from torchft_tpu import _native as jnative

    rng = np.random.default_rng(11)
    state = {"big": rng.standard_normal((512, 512)).astype(np.float32),
             "small": np.arange(64, dtype=np.int64)}
    _paired_fetch(_native, monkeypatch, 2)
    _paired_fetch(jnative, monkeypatch, 2)
    got = {}
    for name, cls in (("port", HTTPTransport), ("jax", JHTTPTransport)):
        made = [cls(T, hostname="localhost") for _ in range(3)]
        try:
            s1, s2, rx = made
            s1.send_checkpoint([1], 3, state, T)
            s2.send_checkpoint([1], 3, state, T)
            out = rx.recv_checkpoint_multi([s1.metadata(), s2.metadata()], 3, T)
            assert np.asarray(out["big"]).tobytes() == state["big"].tobytes()
            stats = rx.last_heal_stats
            got[name] = (stats["nsources"], [
                (stats["sources"][u]["bytes"], stats["sources"][u]["ranges"])
                for u in (s1.metadata(), s2.metadata())])
        finally:
            for t in made:
                t.shutdown()
    assert got["port"] == got["jax"]
    total = state["big"].nbytes + state["small"].nbytes
    assert got["port"] == (2, [(total // 2, 2), (total // 2, 2)])


def test_counts_equal_jax_with_a_divergent_and_a_dead_source():
    """The source set the plan takes, against the JAX package's: a
    divergent source is left out, a dead one fails its ranges over; one
    survivor serves every byte in both packages."""
    state, other = _state(1), _state(2)
    got = {}
    for name, cls in (("port", HTTPTransport), ("jax", JHTTPTransport)):
        made = [cls(T, hostname="localhost") for _ in range(4)]
        try:
            good, divergent, dying, rx = made
            good.send_checkpoint([1], 4, state, T)
            divergent.send_checkpoint([1], 4, other, T)
            dying.send_checkpoint([1], 4, state, T)
            urls = [good.metadata(), divergent.metadata(), dying.metadata()]
            rx.recv_checkpoint_multi(urls, 4, T, header_cb=lambda h: dying.shutdown())
            stats = rx.last_heal_stats
            got[name] = (stats["nsources"], sorted(stats["failures"]),
                         {u: (v["bytes"], v["ranges"]) for u, v in stats["sources"].items()
                          if v["ranges"]})
        finally:
            for t in made:
                t.shutdown()
    assert got["port"][0] == got["jax"][0] == 1
    assert len(got["port"][1]) == len(got["jax"][1]) == 1
    assert list(got["port"][2].values()) == list(got["jax"][2].values())


# ---------------------------------------------------------------------------
# differential heal
# ---------------------------------------------------------------------------


def test_delta_ships_strictly_fewer_bytes_and_round_trips(transports):
    s0, s1 = _staged_pair()
    h0, b0 = flatten_state(s0)
    srv, rx = transports(), transports()
    trail = dm.CommitTrail(horizon=4)
    srv.commit_trail = trail
    d0 = trail.record(3, b0)
    own = (b0, dm.tree_digest(d0))
    srv.send_checkpoint([1], 4, s1, T)
    out = rx.recv_checkpoint_multi([srv.metadata()], 4, T, since_step=3, own=own)
    _tree_equal(out, s1)  # dtype, shape and the zero-length leaf kept
    stats = rx.last_heal_stats
    assert stats["mode"] == "delta"
    assert stats["bytes"] < len(h0) + sum(int(b.nbytes) for b in b0)
    # only the changed array buffer travelled ('scalar' and 'obj' ride the
    # header; 'small' and 'empty' are the healer's own)
    assert stats["delta"]["changed"] == 1 and stats["delta"]["leaves"] == 3


def test_delta_of_tensors(transports):
    s0 = _torch_state(2)
    s1 = {**s0, "params": {**s0["params"], "w": s0["params"]["w"] + 1}}
    _, b0 = flatten_state(s0)
    srv, rx = transports(), transports()
    srv.commit_trail = dm.CommitTrail()
    srv.commit_trail.record(5, b0)
    srv.send_checkpoint([1], 6, s1, T)
    own = (b0, dm.tree_digest(dm.leaf_digests(b0)))
    _tree_equal(rx.recv_checkpoint_multi([srv.metadata()], 6, T, since_step=5, own=own), s1)
    assert rx.last_heal_stats["mode"] == "delta"
    assert rx.last_heal_stats["delta"]["changed"] == 1


def test_digest_mismatch_falls_back_to_full(transports):
    s0, s1 = _staged_pair()
    _, b0 = flatten_state(s0)
    srv, rx = transports(), transports()
    trail = dm.CommitTrail(horizon=4)
    srv.commit_trail = trail
    trail.record(3, b0)
    srv.send_checkpoint([1], 4, s1, T)
    out = rx.recv_checkpoint_multi([srv.metadata()], 4, T, since_step=3, own=(b0, "0badd1635"))
    _tree_equal(out, s1)
    assert rx.last_heal_stats["mode"] == "striped"


def test_trail_horizon_eviction_forces_full(transports):
    s0, s1 = _staged_pair()
    _, b0 = flatten_state(s0)
    srv, rx = transports(), transports()
    trail = dm.CommitTrail(horizon=2)
    srv.commit_trail = trail
    d0 = trail.record(3, b0)
    own = (b0, dm.tree_digest(d0))
    trail.record(4, b0)
    trail.record(5, b0)  # two more steps evict step 3 past the horizon
    assert trail.get(3) is None
    assert trail.steps() == [4, 5]
    srv.send_checkpoint([1], 6, s1, T)
    out = rx.recv_checkpoint_multi([srv.metadata()], 6, T, since_step=3, own=own)
    _tree_equal(out, s1)
    assert rx.last_heal_stats["mode"] == "striped"


def test_apply_delta_layout_checks():
    s0, _ = _staged_pair()
    h, b = flatten_state(s0)
    with pytest.raises(ValueError, match="truncated"):
        dm.apply_delta({"header": h, "changed": [0], "sizes": [8]}, b"", b)
    with pytest.raises(ValueError, match="out of range"):
        dm.apply_delta({"header": h, "changed": [99], "sizes": [1]}, b"\0", b)
    with pytest.raises(ValueError, match="mismatch"):
        dm.apply_delta({"header": h, "changed": [0, 1], "sizes": [1]}, b"\0", b)


def test_build_delta_refusals():
    _, s1 = _staged_pair()
    h1, b1 = flatten_state(s1)
    d1 = dm.leaf_digests(b1)
    assert dm.build_delta(h1, b1, d1, None, "x") is None  # no trail entry
    ent = {"tree": "notit", "leaves": d1, "sizes": [b.nbytes for b in b1]}
    assert dm.build_delta(h1, b1, d1, ent, "x") is None  # tree digest mismatch
    ent = {"tree": "t", "leaves": d1 + ["extra"], "sizes": []}
    assert dm.build_delta(h1, b1, d1, ent, "t") is None  # leaf count drift


# ---------------------------------------------------------------------------
# serving-window consistency
# ---------------------------------------------------------------------------


def test_restage_never_serves_mixed_bytes(transports):
    """A slow reader overlapping disallow + restage gets the old staging
    whole or a loud failure, never bytes of both: the write lock waits
    readers out, and the blob plane's token turns a fetch after the
    restage into a stale error."""
    state_a, state_b = _state(1), _state(2)
    srv = transports()
    srv.send_checkpoint([1], 1, state_a, T)
    total = srv._total
    meta_a = pickle.loads(b"".join(srv._render("stripemeta")))
    errors, goods = [], []

    def reader():
        dst = memoryview(bytearray(total))
        try:
            for off, ln in stripe_ranges(total, 4):
                _native.blob_fetch("localhost", meta_a["blob_port"], meta_a["token"],
                                   off, ln, dst[off : off + ln])
            goods.append(bytes(dst))
        except ConnectionError as e:
            errors.append(str(e))

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.005)
    srv.send_checkpoint([1], 2, state_b, T)  # disallow + restage
    for t in threads:
        t.join()
    _, bufs_a = flatten_state(state_a)
    flat_a = b"".join(bytes(np.ascontiguousarray(b).view(np.uint8)) for b in bufs_a)
    for g in goods:
        assert g == flat_a  # a completed read is the old bytes, whole
    for e in errors:
        assert "stale" in e or "recv" in e or "closed" in e
    assert len(goods) + len(errors) == 4


def test_rwlock_per_acquire_timeout():
    from torchft_tpu_torch.checkpointing._rwlock import RWLock

    lock = RWLock(timeout=30.0)
    lock.w_acquire()
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        lock.r_acquire(timeout=0.1)
    assert time.perf_counter() - t0 < 5.0  # bounded, not the default


def test_stripemeta_waits_only_the_meta_timeout(transports, monkeypatch):
    """A source with no staging window answers the striped endpoints with
    503 after META_TIMEOUT_S, and the healer drops it."""
    monkeypatch.setattr(ht, "META_TIMEOUT_S", 0.2)
    idle, rx = transports(), transports()
    t0 = time.perf_counter()
    with pytest.raises(ConnectionError, match="no heal source reachable"):
        rx.recv_checkpoint_multi([idle.metadata()], 1, T)
    assert time.perf_counter() - t0 < 10.0


def test_stripemeta_waits_out_a_slow_staging(transports, monkeypatch):
    """A source whose staging outlasts META_TIMEOUT_S (at the Llama-2-7B
    width the host copy and digests of 4.3 GB take longer) answers the
    striped endpoint "staging in progress"; the healer asks again until its
    deadline and heals, instead of dropping the source every round."""
    monkeypatch.setattr(ht, "META_TIMEOUT_S", 0.2)
    real = ht.flatten_state

    def slow(state):
        time.sleep(1.0)
        return real(state)

    monkeypatch.setattr(ht, "flatten_state", slow)
    src, rx = transports(), transports()
    state = _torch_state(3)
    th = threading.Thread(target=src.send_checkpoint, args=([1], 5, state, T))
    th.start()
    time.sleep(0.05)  # the healer asks while the staging is under way
    out = rx.recv_checkpoint_multi([src.metadata()], 5, T)
    th.join()
    _tree_equal(out, state)


def test_commit_trail_thread_consistency():
    """Concurrent record (the step boundary) and get (a serve) always see a
    complete entry or none."""
    trail = dm.CommitTrail(horizon=4)
    bufs = [np.arange(64, dtype=np.uint8)]
    stop = threading.Event()
    bad = []

    def server():
        while not stop.is_set():
            for s in range(16):
                ent = trail.get(s)
                if ent is not None and ("tree" not in ent or len(ent["leaves"]) != 1):
                    bad.append(ent)

    th = threading.Thread(target=server)
    th.start()
    for s in range(16):
        trail.record(s, bufs)
    stop.set()
    th.join()
    assert not bad
    assert len(trail.steps()) == 4  # the horizon holds throughout


# ---------------------------------------------------------------------------
# the quorum's heal sources
# ---------------------------------------------------------------------------


def _quorum(steps):
    members = [
        {"replica_id": f"g{i}", "address": f"addr{i}", "store_address": f"store{i}",
         "step": s, "world_size": 1, "shrink_only": False}
        for i, s in enumerate(steps)
    ]
    return {"quorum_id": 9, "participants": members, "created": 0}


@pytest.mark.parametrize("steps,who,pending,heal,addresses", [
    # g2 behind: the sources are the whole max-step cohort, and everyone
    # sees heal_pending
    ([5, 5, 3], "g0", True, False, ["addr0", "addr1"]),
    ([5, 5, 3], "g2", True, True, ["addr0", "addr1"]),
    # max_step 0: the states are not yet proven equal, so only the
    # bootstrap source is a sound stripe source
    ([0, 0, 0], "g1", True, True, ["addr0"]),
    ([4, 4, 4], "g1", False, False, None),
])
def test_quorum_heal_sources(steps, who, pending, heal, addresses):
    """The port's QuorumResult parses what the native quorum computes, as
    the JAX package's does."""
    from torchft_tpu import _native as jnative
    from torchft_tpu.coordination import QuorumResult as JQuorumResult
    from torchft_tpu_torch.coordination import QuorumResult

    wire = jnative.compute_quorum_results(_quorum(steps), who, 0)
    q = QuorumResult._from_wire(wire)
    jq = JQuorumResult._from_wire(wire)
    assert q.heal_pending is jq.heal_pending is pending
    assert q.heal is heal
    assert q.recover_src_addresses == jq.recover_src_addresses
    if addresses is not None:
        assert q.recover_src_addresses == addresses


def test_striped_heal_rows_with_a_killed_source():
    """``crossgroup.measure_striped_heal`` on the CPU: two source processes
    (one started for the kill plan's use), the plans' rows in order, the
    second plan's last source SIGKILLed after the plan; one sha256 on every
    row."""
    from torchft_tpu_torch.benchmarks.crossgroup import measure_striped_heal

    rows = measure_striped_heal(1 << 20, [(2, False), (2, True)], "cpu")
    assert [r["nsources"] for r in rows] == [2, 1]
    assert [len(r["failures"]) for r in rows] == [0, 1]
    for r in rows:
        assert set(r["sha256_sources"]) == {r["sha256_healed"]}
        assert sum(v["bytes"] for v in r["per_source"].values()) == r["total_bytes"]
        assert all(v["route"] == "blob" for v in r["per_source"].values())


@pytest.mark.parametrize("args", [["--num-chunks", "0"], ["--num-chunks", "3"],
                                  ["--transport", "collectives"],
                                  ["--transport", "collectives", "--window", "1"]],
                         ids=["full", "chunks", "collectives", "collectives-serial"])
def test_checkpointing_bench_round_trips(monkeypatch, capsys, args):
    """``python -m torchft_tpu_torch.checkpointing.bench`` on the CPU: the
    received tensors' sha256 equals the sent ones' in every mode."""
    from torchft_tpu_torch.checkpointing import bench

    monkeypatch.setenv("DEVICE", "cpu")
    assert bench.main(["--total-gb", "0.004", "--tensor-mb", "1", *args]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    sent, got = line.split("sha256 sent ")[1].split(" received ")
    assert sent == got
