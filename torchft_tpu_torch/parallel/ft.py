"""Fault-tolerant trainer — the port's counterpart of
``torchft_tpu/parallel/ft.py``: quorum -> gradients on the device ->
cross-group average through the Manager -> commit vote -> optimizer
update.

``init`` registers the trainer's ``state_dict`` / ``load_state_dict``
with the Manager, so a healing group receives the params and the
optimizer state of a group at the max step; both are copied into the
trainer's own tensors in place, which the train step's CUDA graphs read.

Sharded (a ``TrainStep`` with a mesh, the HSDP composition): the params
and the optimizer state are DTensors, ``state_dict`` serves them as they
are (the transports ship each rank's shards, ``serialization``'s
``"shards"`` leaves, so a healing rank receives exactly its same-rank
peer's shards and no group gathers its model onto one host), and
``load_state_dict`` rebuilds them on this group's mesh and re-places
them with the step's placements before copying them in. The heal
warm-up (``Manager.set_heal_warmup``) builds the optimizer's state from
the transfer's header while its bytes stream (``TrainStep.warm_apply``).

On the card the step's halves replay from CUDA graphs (``TrainStep``):
the gradients ``grads`` returns are the graph's static tensors, consumed
by the cross-group average and the update before the next ``grads``.

Pipelined commit (``Manager(commit_pipeline=True)``): ``step`` applies the
update at once, keeping a copy of the pre-update state as the rollback
snapshot, issues the vote asynchronously, and the next step's
forward/backward runs while the vote is in flight. The vote resolves
before the next step's own collectives; on a veto the snapshot is restored
and the in-flight batch is replayed on it, so the sequence of committed
states is the sync mode's.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

import torch

from torchft_tpu_torch.checkpointing.serialization import from_transfer_tree
from torchft_tpu_torch.ddp import allreduce_gradients
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.optim import SpeculativeCommitMixin
from torchft_tpu_torch.parallel.mesh import place
from torchft_tpu_torch.parallel.train_step import TrainStep

__all__ = ["FTTrainer"]


class FTTrainer(SpeculativeCommitMixin):
    def __init__(self, manager: Manager, train_step: TrainStep) -> None:
        self._manager = manager
        self._ts = train_step
        self._params: Optional[Dict[str, Any]] = None
        self._opt: Optional[torch.optim.Optimizer] = None
        # the heal warm-up's thread and the heal's load both fill the
        # optimizer's state: one at a time
        self._state_lock = threading.Lock()

    def init(self, params: Optional[Dict[str, Any]] = None, seed: int = 0) -> None:
        """Start from ``params`` (moved to the step's device, or placed on
        its mesh) or from a seeded random init."""
        params = self._ts.init_params(seed) if params is None else self._ts.place(params)
        self._params = params
        self._opt = self._ts.init_opt(params)
        self._manager.set_state_dict_fns(self.load_state_dict, self.state_dict)
        if self._ts.mesh is not None and hasattr(self._manager, "set_heal_warmup"):
            # only the sharded step: without a mesh the heal's load builds
            # the optimizer's state itself, and nothing is compiled ahead
            self._manager.set_heal_warmup(self._heal_warmup)

    def _heal_warmup(self, spec_tree: Any) -> None:
        """Runs on a daemon thread as soon as a heal's header lands: build
        the optimizer's state from the transferred shapes while the bytes
        still stream, so the heal's load copies into it."""
        user = spec_tree.get("user") if isinstance(spec_tree, dict) else None
        opt_state = user.get("opt_state") if isinstance(user, dict) else None
        if not isinstance(opt_state, dict) or "state" not in opt_state:
            return
        with self._state_lock:
            self._ts.warm_apply(self._opt, opt_state)

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        mesh = self._ts.mesh
        if mesh is not None:
            # rebuild the sharded leaves shard by shard on this group's
            # mesh, then pin them to the step's placements (a no-op where
            # they already are; a dense leaf contributes this rank's slice)
            state = from_transfer_tree(state, mesh)
            state = dict(state, params=self._ts.place(state["params"]),
                         opt_state=self._place_opt_state(state["opt_state"]))
        with self._state_lock:
            super().load_state_dict(state)

    def _place_opt_state(self, opt_state: Dict[str, Any]) -> Dict[str, Any]:
        """An ``Optimizer.state_dict()`` whose per-param tensors (but the
        step count) are placed as their params, in the param order."""
        ids = [i for group in opt_state["param_groups"] for i in group["params"]]
        places = dict(zip(ids, self._ts.placements))
        mesh = self._ts.mesh

        def put(k, t, target):
            if k == "step" or not isinstance(t, torch.Tensor) or t.dim() == 0:
                return t
            return place(t, mesh, target)

        state = {i: {k: put(k, v, places[i]) for k, v in st.items()}
                 for i, st in opt_state["state"].items()}
        return dict(opt_state, state=state)

    @property
    def params(self) -> Dict[str, Any]:
        return self._params

    @property
    def opt(self) -> torch.optim.Optimizer:
        return self._opt

    # -- drive --

    def step(self, tokens: torch.Tensor) -> Tuple[float, bool]:
        """One fault-tolerant step; returns (loss, committed).

        Under the pipelined commit ``committed`` is the expected outcome
        (True): the vote lands in the next step (or :meth:`finish`), and a
        veto rolls the update back, replays, and bumps :attr:`rollbacks`."""
        self._start_quorum()
        # under the pipeline (async quorum) this is the compute that hides
        # the previous step's vote
        loss, grads = self._ts.grads(self._params, tokens)
        if self._resolve_speculation():
            # the previous step was vetoed: these gradients were taken on
            # the rolled-back params; replay the batch on the restored state
            loss, grads = self._ts.grads(self._params, tokens)
        grads = allreduce_gradients(self._manager, grads)
        committed = self._commit(grads, lambda g: self._ts.apply(self._params, self._opt, g))
        return float(loss), committed
