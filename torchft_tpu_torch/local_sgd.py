"""LocalSGD and DiLoCo — the port's counterpart of
``torchft_tpu/local_sgd.py``.

LocalSGD (arxiv 1805.09767) runs ``sync_every`` purely local optimizer
steps, then averages the *parameters* across replica groups; DiLoCo (arxiv
2311.08105) averages *pseudogradients* (the parameter change since the
last sync) and feeds them to an outer optimizer.

The caller's parameter tree is updated in place, as torch optimizers do::

    lsgd = LocalSGD(manager, sync_every=32)
    lsgd.save(params)                   # backup before the first step
    for batch in data:
        train_step.step(params, opt, batch)
        if lsgd.step(params):           # a sync ran: params hold its result
            opt = train_step.init_opt(params)

The backup of the last synced params lives on the params' device, and so
does DiLoCo's outer optimizer state, so the outer step is one device pass.
A sync that does not commit restores the backup into the params: the
``sync_every`` local steps are discarded.

DiLoCo keeps the JAX package's (and the paper's) pseudogradient sign
``backup − local``, so the outer optimizer descends toward the inner
progress.

A pipelined manager: LocalSGD resolves a vote that a pipelined per-step
trainer left in flight before its own quorum and collectives, then takes the
synchronous commit. DiLoCo rejects a pipelined manager, and an async-quorum
one: the outer step must start from a fully settled, fully healed state on
every replica.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

import torch

from torchft_tpu_torch.ddp import allreduce_gradients
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.optim import check_exact_wire
from torchft_tpu_torch.utils.tree import tree_leaves, tree_map

__all__ = ["LocalSGD", "DiLoCo"]

OUTER_RANK_ENV = "TORCHFT_WIRE_OUTER_RANK"


def _copy_into(dst: Any, src: Any) -> None:
    with torch.no_grad():
        for d, s in zip(tree_leaves(dst), tree_leaves(src)):
            d.copy_(s)


class LocalSGD:
    """Parameter averaging every ``sync_every`` local steps."""

    def __init__(
        self, manager: Manager, sync_every: int, error_feedback: Any = None
    ) -> None:
        if sync_every < 1:
            raise ValueError("sync_every must be >= 1")
        check_exact_wire(error_feedback)
        self._manager = manager
        self._sync_every = sync_every
        self._local_step = 0
        self._backup: Optional[Any] = None
        self._just_healed = False

    def save(self, params: Any) -> None:
        """Copy ``params`` as the restore point (a copy, never an alias:
        in-place inner steps would corrupt it)."""
        if self._backup is None:
            self._backup = tree_map(lambda t: t.detach().clone(), params)
        else:
            _copy_into(self._backup, params)

    def step(self, params: Any) -> bool:
        """Count one local optimizer step; every ``sync_every`` calls run a
        fault-tolerant sync. True when a sync ran (committed or not): the
        params then hold its result, and the inner optimizer's state
        belongs to the old params."""
        if self._backup is None:
            raise RuntimeError("call save(params) before the first step")
        self._local_step += 1
        if self._local_step < self._sync_every:
            return False
        self.sync(params)
        self._local_step = 0
        return True

    def sync(self, params: Any) -> bool:
        """Average across replica groups now; returns whether it committed."""
        # the manager refuses collectives while a pipelined vote is
        # pending; the trainer's own callback handles its rollback
        if self._manager.pending_commit() is not None:
            self._manager.resolve_pending_commit()
        self._manager.start_quorum()
        if self._just_healed:
            # the heal replaced the backup, but the caller's params are
            # whatever the source served: a just-healed group's consistent
            # state is the received backup, which contributes a zero
            # pseudogradient (DiLoCo) or the healed params (LocalSGD)
            _copy_into(params, self._backup)
        try:
            return self._perform_sync(params)
        finally:
            # also covers a heal that lands inside the commit barrier (async
            # quorum): the backup is reconciled there, so the flag must not
            # leak into the next sync and discard real work
            self._just_healed = False

    # live-recovery state: register it with the Manager beside the
    # caller's params and inner optimizer state
    def state_dict(self) -> Dict[str, Any]:
        return {"backup": self._backup, "local_step": self._local_step}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if self._backup is None:
            raise RuntimeError("call save(params) before loading a state")
        # a received backup lies on the host: copy it onto the device
        _copy_into(self._backup, state["backup"])
        self._local_step = int(state["local_step"])
        # the caller's local params are stale beside this state; the next
        # sync starts from the backup (see sync())
        self._just_healed = True

    def _perform_sync(self, params: Any) -> bool:
        averaged = allreduce_gradients(self._manager, list(tree_leaves(params)))
        if self._manager.should_commit():
            _copy_into(params, averaged)
            _copy_into(self._backup, averaged)
            return True
        _copy_into(params, self._backup)
        return False


class DiLoCo(LocalSGD):
    """Pseudogradient averaging with an outer optimizer.

    ``outer_optimizer`` is a factory called with the list of backup
    tensors, e.g. ``lambda ps: torch.optim.SGD(ps, lr=0.7, momentum=0.9,
    nesterov=True)`` (the paper's outer step; with ``dampening=0`` it
    computes what ``optax.sgd(0.7, 0.9, nesterov=True)`` computes). The
    outer optimizer steps the backup in place. Requires a Manager with
    ``use_async_quorum=False`` and without the pipelined commit."""

    def __init__(
        self,
        manager: Manager,
        outer_optimizer: Callable[[List[torch.Tensor]], torch.optim.Optimizer],
        sync_every: int,
        error_feedback: Any = None,
        outer_rank: Optional[int] = None,
    ) -> None:
        if manager._use_async_quorum:
            raise ValueError(
                "DiLoCo requires synchronous quorum; construct the Manager "
                "with use_async_quorum=False"
            )
        if manager.commit_pipeline_enabled():
            raise ValueError(
                "DiLoCo requires the synchronous commit barrier; construct "
                "the Manager with commit_pipeline=False (the outer step "
                "must start from a fully-settled state on every replica)"
            )
        if outer_rank is None:
            try:
                outer_rank = int(os.environ.get(OUTER_RANK_ENV, "0"))
            except ValueError:
                outer_rank = 0
        if outer_rank > 0:
            raise NotImplementedError(
                "outer_rank ships a low-rank projection of the pseudogradient "
                "over the wire codecs, which are not ported yet (ROADMAP "
                "queue 1: the wire codecs)"
            )
        super().__init__(manager, sync_every, error_feedback=error_feedback)
        self._make_outer = outer_optimizer
        self._outer: Optional[torch.optim.Optimizer] = None
        self._outer_syncs = 0  # committed outer steps

    def save(self, params: Any) -> None:
        super().save(params)
        if self._outer is None:
            self._outer = self._make_outer(list(tree_leaves(self._backup)))

    @property
    def outer_optimizer(self) -> Optional[torch.optim.Optimizer]:
        return self._outer

    def _perform_sync(self, params: Any) -> bool:
        backup = list(tree_leaves(self._backup))
        # paper-sign pseudogradient: descend from the backup toward the
        # averaged inner progress
        with torch.no_grad():
            pseudograd = [b - p for b, p in zip(backup, tree_leaves(params))]
        pseudograd = allreduce_gradients(self._manager, pseudograd)
        if not self._manager.should_commit():
            _copy_into(params, self._backup)
            return False
        self._outer_syncs += 1
        for b, g in zip(backup, pseudograd):
            b.grad = g
        self._outer.step()
        self._outer.zero_grad(set_to_none=True)
        _copy_into(params, self._backup)
        return True

    def state_dict(self) -> Dict[str, Any]:
        d = super().state_dict()
        d["outer_state"] = self._outer.state_dict()
        d["outer_syncs"] = self._outer_syncs
        return d

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        super().load_state_dict(state)
        # SGD's load_state_dict casts the momentum buffers onto the
        # backup's device
        self._outer.load_state_dict(state["outer_state"])
        self._outer_syncs = int(state.get("outer_syncs", 0))
