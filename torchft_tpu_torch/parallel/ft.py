"""Fault-tolerant trainer — the port's counterpart of
``torchft_tpu/parallel/ft.py``: quorum -> gradients on the device ->
cross-group average through the Manager -> commit vote -> optimizer
update.

``init`` registers the trainer's ``state_dict`` / ``load_state_dict``
with the Manager, so a healing group receives the params and the
optimizer state of a group at the max step; both are copied into the
trainer's own tensors in place, which the train step's CUDA graphs read.

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

from typing import Any, Dict, Optional, Tuple

import torch

from torchft_tpu_torch.ddp import allreduce_gradients
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.optim import SpeculativeCommitMixin
from torchft_tpu_torch.parallel.train_step import TrainStep
from torchft_tpu_torch.utils.tree import tree_map

__all__ = ["FTTrainer"]


class FTTrainer(SpeculativeCommitMixin):
    def __init__(self, manager: Manager, train_step: TrainStep) -> None:
        self._manager = manager
        self._ts = train_step
        self._params: Optional[Dict[str, Any]] = None
        self._opt: Optional[torch.optim.Optimizer] = None

    def init(self, params: Optional[Dict[str, Any]] = None, seed: int = 0) -> None:
        """Start from ``params`` (moved to the step's device) or from a
        seeded random init."""
        if params is None:
            params = self._ts.init_params(seed)
        else:
            params = tree_map(lambda t: t.detach().to(self._ts.device).clone(), params)
        self._params = params
        self._opt = self._ts.init_opt(params)
        self._manager.set_state_dict_fns(self.load_state_dict, self.state_dict)

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
