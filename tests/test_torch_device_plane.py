"""The slice as a whole: replica groups as threads over the port's device
data plane (``CollectivesDevice(device="cpu")``), healing over it with
``CollectivesTransport``, real native lighthouse, stores and manager
servers.

* Against JAX: two port groups train the tiny transformer of
  ``tests/test_torch_ft_slice.py`` through FTTrainer; two JAX groups run
  the same protocol over the JAX package's CollectivesDevice and
  CollectivesTransport, one virtual CPU device per group, from the same
  numpy init and tokens. Per-step losses within rtol 1e-4 (the bar of
  ``test_torch_ft_slice.py``: float32 summation order and the two AdamW
  formulations' rounding); the port's groups end bit-identical.
* A late joiner heals over CollectivesTransport, with async and with sync
  quorum, and ends bit-identical.
* One DiLoCo run (two joint syncs) on the device plane ends with the very
  params and outer momentum of the same run on the TCP plane: with two
  participants the sum is one IEEE add on either plane.
* ``allreduce_gradients`` on the device plane never writes into the
  caller's gradients, a healing group's included; one group alone gets its
  own tensors back; two groups get exactly the plain ``(g0 + g1) / 2``.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_ft_slice import (
    JCFG,
    STEPS,
    TCFG,
    TIMEOUT,
    _digest,
    _np_init,
    _run_groups,
    _tokens,
)
from tests.test_torch_local_sgd import SYNC_EVERY, _momentum, _register, nesterov_sgd
from torchft_tpu_torch.checkpointing import CollectivesTransport, HTTPTransport
from torchft_tpu_torch.collectives import CollectivesTcp
from torchft_tpu_torch.collectives_device import CollectivesDevice
from torchft_tpu_torch.coordination import LighthouseServer
from torchft_tpu_torch.ddp import allreduce_gradients
from torchft_tpu_torch.local_sgd import DiLoCo
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.models import transformer as T
from torchft_tpu_torch.parallel.ft import FTTrainer
from torchft_tpu_torch.parallel.train_step import TrainStep
from torchft_tpu_torch.store import StoreServer
from torchft_tpu_torch.utils.tree import tree_leaves


def device_manager(gid, lighthouse, store, min_replica_size, plane="device", **kwargs):
    """A group's Manager: the device plane healing over it, or the TCP
    plane healing over HTTP."""
    if plane == "device":
        collectives = CollectivesDevice(timeout=TIMEOUT, device="cpu")
        transport = CollectivesTransport(collectives, timeout=TIMEOUT)
    else:
        collectives = CollectivesTcp(timeout=TIMEOUT)
        transport = HTTPTransport(timeout=TIMEOUT, hostname="localhost")
    return Manager(
        collectives=collectives, load_state_dict=None, state_dict=None,
        min_replica_size=min_replica_size, replica_id=f"g{gid}",
        store_addr=store.address(), rank=0, world_size=1,
        lighthouse_addr=lighthouse.address(), timeout=TIMEOUT,
        checkpoint_transport=transport, **kwargs,
    )


def _groups(target, min_replicas, n=2):
    """Run ``target(gid, lighthouse)`` per group on threads, with a store
    each; the lighthouse is shut down after."""
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=min_replicas)
    try:
        return _run_groups(lambda gid: target(gid, lighthouse), n=n)
    finally:
        lighthouse.shutdown()


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def _port_run(np_params):
    def group(gid, lighthouse):
        store = StoreServer()
        manager = device_manager(gid, lighthouse, store, min_replica_size=2)
        try:
            assert manager.device_data_plane()
            assert manager._checkpoint_transport.metadata() == "<collectives>"
            trainer = FTTrainer(manager, TrainStep(TCFG, device="cpu"))
            trainer.init(params=T.params_from_jax(np_params, device="cpu"))
            losses = []
            while manager.current_step() < STEPS:
                tokens = torch.from_numpy(_tokens(gid, manager.current_step()))
                loss, committed = trainer.step(tokens)
                assert committed
                losses.append(loss)
            return losses, _digest(trainer.params)
        finally:
            manager.shutdown(wait=False)
            store.shutdown()

    return _groups(group, min_replicas=2)


def _jax_run(np_params):
    from torchft_tpu.checkpointing.collectives_transport import (
        CollectivesTransport as JTransport,
    )
    from torchft_tpu.collectives_device import CollectivesDevice as JDevice
    from torchft_tpu.coordination import LighthouseServer as JLighthouse
    from torchft_tpu.ddp import allreduce_gradients as jallreduce
    from torchft_tpu.manager import Manager as JManager
    from torchft_tpu.parallel.mesh import MeshConfig, make_mesh
    from torchft_tpu.parallel.train_step import TrainStep as JTrainStep
    from torchft_tpu.store import StoreServer as JStore

    lighthouse = JLighthouse(bind="[::]:0", min_replicas=2)

    def group(gid):
        store = JStore()
        collectives = JDevice(timeout=TIMEOUT)
        manager = JManager(
            collectives=collectives, load_state_dict=None, state_dict=None,
            min_replica_size=2, replica_id=f"g{gid}", store_addr=store.address(),
            rank=0, world_size=1, lighthouse_addr=lighthouse.address(),
            timeout=TIMEOUT, checkpoint_transport=JTransport(collectives, timeout=TIMEOUT),
        )
        try:
            assert manager.device_data_plane()
            # each group's arrays on a device of its own (the 'ft' psum
            # stacks the groups over devices)
            mesh = make_mesh(MeshConfig(), jax.devices()[gid:gid + 1])
            ts = JTrainStep(JCFG, optax.adamw(3e-4), mesh)
            st = {"params": jax.device_put(np_params, ts._param_shardings)}
            st["opt_state"] = ts.init_opt(st["params"])

            def load(state):
                st["params"] = jax.device_put(state["params"], ts._param_shardings)
                st["opt_state"] = jax.device_put(state["opt_state"], jax.devices()[gid])

            manager.set_state_dict_fns(load, lambda: dict(st))
            losses = []
            while manager.current_step() < STEPS:
                tokens = ts.shard_batch(jnp.asarray(_tokens(gid, manager.current_step())))
                manager.start_quorum()
                loss, grads = ts.grads(st["params"], tokens)
                grads = jallreduce(manager, grads)
                assert manager.should_commit()
                st["params"], st["opt_state"] = ts.apply(st["params"], st["opt_state"], grads)
                losses.append(float(loss))
            return losses
        finally:
            manager.shutdown(wait=False)
            store.shutdown()

    try:
        return _run_groups(group)
    finally:
        lighthouse.shutdown()


def test_two_groups_match_jax_and_each_other():
    np_params = _np_init()
    jax_losses = _jax_run(np_params)
    port = _port_run(np_params)
    for gid in (0, 1):
        np.testing.assert_allclose(port[gid][0], jax_losses[gid], rtol=1e-4)
    assert port[0][1] == port[1][1], "port groups diverged"


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_async_quorum", [True, False])
def test_late_joiner_heals_over_the_plane(use_async_quorum):
    first_commit = threading.Event()

    def group(gid, lighthouse):
        if gid == 1 and not first_commit.wait(timeout=120):
            raise TimeoutError("group 0 never committed")
        store = StoreServer()
        manager = device_manager(gid, lighthouse, store, min_replica_size=1,
                                 use_async_quorum=use_async_quorum)
        try:
            trainer = FTTrainer(manager, TrainStep(TCFG, device="cpu"))
            trainer.init(seed=10 + gid)  # different inits: the heal must matter
            joint = healed_to = 0
            while joint < 2:
                before = manager.current_step()
                _, committed = trainer.step(torch.from_numpy(_tokens(gid, before)))
                if manager.current_step() > before + 1:
                    healed_to = manager.current_step()
                if committed and manager.num_participants() == 2:
                    joint += 1
                if committed:
                    first_commit.set()
            return manager.current_step(), _digest(trainer.params), healed_to
        finally:
            first_commit.set()
            manager.shutdown(wait=False)
            store.shutdown()

    (s0, d0, _), (s1, d1, healed_to) = (r for _, r in sorted(_groups(group, 1).items()))
    assert healed_to >= 1, "group 1 did not heal"
    assert s0 == s1 and d0 == d1


def _diloco_run(plane, np_params):
    def group(gid, lighthouse):
        store = StoreServer()
        manager = device_manager(gid, lighthouse, store, min_replica_size=2, plane=plane,
                                 use_async_quorum=False)
        try:
            assert manager.device_data_plane() == (plane == "device")
            ts = TrainStep(TCFG, device="cpu")
            params = T.params_from_jax(np_params, device="cpu")
            diloco = DiLoCo(manager, nesterov_sgd, sync_every=SYNC_EVERY)
            diloco.save(params)
            state = _register(manager, ts, params, diloco)
            k = 0
            while manager.current_step() < 2:
                ts.step(params, state["opt"], torch.from_numpy(_tokens(gid, k)))
                k += 1
                if diloco.step(params):
                    state["opt"] = ts.init_opt(params)
            return _digest(tree_leaves(params)), _digest(_momentum(diloco))
        finally:
            manager.shutdown(wait=False)
            store.shutdown()

    return _groups(group, min_replicas=2)


def test_diloco_device_plane_matches_tcp_plane_bitwise():
    np_params = _np_init()
    device = _diloco_run("device", np_params)
    tcp = _diloco_run("tcp", np_params)
    assert device[0] == device[1] == tcp[0] == tcp[1]


def _grads(key, gid):
    rng = np.random.default_rng(1000 * key + gid)
    return {"a": torch.from_numpy(rng.standard_normal((5, 3)).astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal(7).astype(np.float32))}


def test_allreduce_gradients_owns_its_memory_and_is_the_plain_mean():
    """Group 0 trains alone (its own tensors come back), group 1 joins and
    heals (async quorum: it contributes zeros that the call allocates),
    then both average. Every call leaves the caller's gradients as they
    were, and a joint step's result is bit for bit ``(g0 + g1) / 2``."""
    first_commit = threading.Event()

    def group(gid, lighthouse):
        if gid == 1 and not first_commit.wait(timeout=120):
            raise TimeoutError("group 0 never committed")
        store = StoreServer()
        manager = device_manager(gid, lighthouse, store, min_replica_size=1)
        state = {"w": torch.zeros(3)}
        manager.set_state_dict_fns(lambda s: state["w"].copy_(s["w"]), lambda: state)
        calls, joint = [], 0
        try:
            while joint < 2:
                manager.start_quorum()
                manager.wait_quorum()  # a heal's step is known after it
                key = manager.current_step()
                grads = _grads(key, gid)
                before = {k: v.clone() for k, v in grads.items()}
                out = allreduce_gradients(manager, grads)
                for k in grads:
                    assert torch.equal(grads[k], before[k]), "the caller's gradient changed"
                n, healing = manager.num_participants(), not manager.is_participating()
                alone = manager._collectives.size() == 1
                assert all((out[k] is grads[k]) == alone for k in grads)
                calls.append(dict(step=key, n=n, healing=healing,
                                  out={k: v.clone() for k, v in out.items()}))
                if manager.should_commit():
                    first_commit.set()
                    joint += n == 2
            return calls
        finally:
            first_commit.set()
            manager.shutdown(wait=False)
            store.shutdown()

    calls = _groups(group, min_replicas=1)
    assert any(c["healing"] for c in calls[1]), "group 1 never contributed zeros"
    joint = 0
    for c0 in calls[0]:
        for c1 in calls[1]:
            if c0["n"] == c1["n"] == 2 and c0["step"] == c1["step"]:
                g0, g1 = _grads(c0["step"], 0), _grads(c0["step"], 1)
                for k in g0:
                    plain = (g0[k] + g1[k]) / 2
                    assert torch.equal(c0["out"][k], plain) and torch.equal(c1["out"][k], plain)
                joint += 1
    assert joint >= 1
