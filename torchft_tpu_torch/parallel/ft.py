"""Fault-tolerant trainer — the port's counterpart of
``torchft_tpu/parallel/ft.py`` with the synchronous commit: quorum ->
gradients on the device -> cross-group average through the Manager ->
commit vote -> optimizer update.

``init`` registers the trainer's ``state_dict`` / ``load_state_dict``
with the Manager, so a healing group receives the params and the
optimizer state of a group at the max step. The pipelined commit
(``SpeculativeCommitMixin``) is not ported yet (ROADMAP).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from torchft_tpu_torch.ddp import allreduce_gradients
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.parallel.train_step import TrainStep
from torchft_tpu_torch.utils.tree import tree_leaves, tree_map

__all__ = ["FTTrainer"]


class FTTrainer:
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

    # -- state (registered with the Manager for live recovery) --

    def state_dict(self) -> Dict[str, Any]:
        return {"params": self._params, "opt_state": self._opt.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        # a received state lies on the host; copy_ puts the params on this
        # trainer's device in place (the optimizer holds these very
        # tensors), and Optimizer.load_state_dict casts the moments onto
        # each param's device
        with torch.no_grad():
            for dst, src in zip(tree_leaves(self._params), tree_leaves(state["params"])):
                dst.copy_(src)
        opt_state = state["opt_state"]
        for per_param in opt_state["state"].values():
            # torch.optim keeps AdamW's step count on the host unless the
            # optimizer is capturable or fused
            if isinstance(per_param.get("step"), torch.Tensor):
                per_param["step"] = per_param["step"].cpu()
        self._opt.load_state_dict(opt_state)

    # -- drive --

    def step(self, tokens: torch.Tensor) -> Tuple[float, bool]:
        """One fault-tolerant step; returns (loss, committed)."""
        self._manager.start_quorum()
        loss, grads = self._ts.grads(self._params, tokens)
        grads = allreduce_gradients(self._manager, grads)
        committed = self._manager.should_commit()
        if committed:
            self._ts.apply(self._params, self._opt, grads)
        return float(loss), committed
