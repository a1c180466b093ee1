"""``WorldSizeMode.FIXED_WITH_SPARES`` on the port against the JAX package.

The case of ``tests/test_manager.py`` (a third healthy group with
``min_replica_size=2`` is demoted to a spare that contributes zeros) on the
port's commit-pipeline harness and on the JAX Manager; then the shape of
``tests/test_integration.py``'s promotion case as three threaded groups
with real lighthouses, stores and CollectivesTcp, ``min_replica_size=2``:
each group's participating rank, participant count, commit and averaged
gradient at every step equal the JAX package's on the same script, with
and without group 1 leaving for good after step 2 (the spare is promoted
into its slot and the divisor stays 2).
"""

from __future__ import annotations

import threading
from datetime import timedelta

import numpy as np
import pytest

from tests.test_torch_commit_pipeline import ManagerHarness, quorum_result
from torchft_tpu_torch.manager import WorldSizeMode
from torchft_tpu_torch.store import StoreServer

STEPS = 5
LEAVE_AFTER = 2  # group 1 leaves once it has committed this step
SHAPE = (16,)


@pytest.fixture
def store_server():
    s = StoreServer()
    yield s
    s.shutdown()


def _spare_case(manager, allreduce):
    manager.start_quorum()
    manager.wait_quorum()
    t = np.ones(2, dtype=np.float32)
    allreduce(t)
    return manager.num_participants(), manager.participating_rank(), t.tolist()


def test_fixed_with_spares_demotion(store_server):
    """Three healthy replicas, min_replica_size=2: the third is a spare."""
    from tests.test_manager import ManagerHarness as JaxHarness
    from torchft_tpu.manager import WorldSizeMode as JaxMode
    from torchft_tpu.store import StoreServer as JaxStoreServer

    q = dict(max_rank=2, max_world_size=3, replica_rank=2, replica_world_size=3)
    h = ManagerHarness(store_server, world_size_mode=WorldSizeMode.FIXED_WITH_SPARES,
                       commit_pipeline=False)
    try:
        h.client._quorum.return_value = quorum_result(**q)
        port = _spare_case(h.manager, lambda t: h.manager.allreduce(t).wait())
    finally:
        h.shutdown()

    from tests.test_manager import quorum_result as jax_quorum_result

    jstore = JaxStoreServer()
    jh = JaxHarness(jstore, world_size_mode=JaxMode.FIXED_WITH_SPARES)
    try:
        jh.client._quorum.return_value = jax_quorum_result(**q)
        jax = _spare_case(jh.manager, lambda t: jh.manager.allreduce(t).wait())
    finally:
        jh.shutdown()
        jstore.shutdown()
    assert port == jax == (2, None, [0.0, 0.0])


def _grad(gid: int, step: int) -> np.ndarray:
    return np.random.default_rng((gid << 8) ^ step).standard_normal(SHAPE).astype(np.float32)


def _run_groups(pkg, leave: bool):
    """Three groups of ``pkg`` (the port or the JAX package) as threads, a
    barrier before each step's quorum so every quorum sees the same
    members. Returns each group's per-step records."""
    if pkg == "port":
        from torchft_tpu_torch.collectives import CollectivesTcp
        from torchft_tpu_torch.coordination import LighthouseServer
        from torchft_tpu_torch.manager import Manager, WorldSizeMode as Mode
        from torchft_tpu_torch.store import StoreServer as Store
    else:
        from torchft_tpu.collectives import CollectivesTcp
        from torchft_tpu.coordination import LighthouseServer
        from torchft_tpu.manager import Manager, WorldSizeMode as Mode
        from torchft_tpu.store import StoreServer as Store

    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=2, join_timeout_ms=100)
    together = threading.Barrier(3)
    after = threading.Barrier(2 if leave else 3)
    records = {g: [] for g in range(3)}
    errors = []

    def group(gid: int) -> None:
        state = {"w": np.zeros(SHAPE, np.float32)}

        def load(s):
            state["w"] = np.asarray(s["w"], np.float32).copy()

        store = Store()
        m = Manager(
            collectives=CollectivesTcp(timeout=timedelta(seconds=20)),
            load_state_dict=load, state_dict=lambda: {"w": state["w"].copy()},
            min_replica_size=2, world_size_mode=Mode.FIXED_WITH_SPARES,
            replica_id=f"spares_g{gid}_", store_addr=store.address(), rank=0, world_size=1,
            lighthouse_addr=lighthouse.address(), timeout=timedelta(seconds=20),
        )
        try:
            while m.current_step() < STEPS:
                step = m.current_step()
                (together if step <= LEAVE_AFTER else after).wait(timeout=60)
                m.start_quorum()
                g = _grad(gid, step)
                m.allreduce(g).wait()
                rec = (step, m.participating_rank(), m.num_participants())
                committed = m.should_commit()
                records[gid].append(rec + (committed, g.tolist()))
                if committed:
                    state["w"] -= 0.1 * g
                if leave and gid == 1 and m.current_step() > LEAVE_AFTER:
                    return  # gone for good: no restart
        except Exception as e:  # noqa: BLE001 — reported by the test
            errors.append((gid, repr(e)))
            for b in (together, after):
                b.abort()
        finally:
            m.shutdown(wait=False)
            store.shutdown()

    threads = [threading.Thread(target=group, args=(g,)) for g in range(3)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
    finally:
        lighthouse.shutdown()
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    return records


@pytest.mark.parametrize("leave", [False, True], ids=["steady", "promotion"])
def test_three_groups_match_the_jax_package(leave):
    port = _run_groups("port", leave)
    jax = _run_groups("jax", leave)
    assert port == jax
    # the divisor never moves: two participants at every committed step
    for gid, recs in port.items():
        assert all(n == 2 for _s, _r, n, committed, _g in recs if committed), (gid, recs)
    if leave:
        # group 1 left after committing step 2; group 2 was a spare and is
        # promoted: it holds participating rank 1 after the leave
        assert max(s for s, *_ in port[1]) == LEAVE_AFTER
        assert any(s > LEAVE_AFTER and r == 1 for s, r, *_ in port[2])
    else:
        assert all(r is None for s, r, *_ in port[2] if s > 0)  # the spare stays a spare
