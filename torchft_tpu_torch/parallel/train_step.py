"""Train step — the port's counterpart of
``torchft_tpu/parallel/train_step.py``: the transformer's loss and
gradients (``grads``), the optimizer update (``apply``) and the two fused
(``step``), on one device.

The split pair is what fault-tolerant training drives: gradients cross
the replica axis through the Manager between ``grads`` and ``apply``. The
optimizer is ``torch.optim.AdamW`` set to ``optax.adamw(3e-4)``'s
defaults; it updates the float32 master params in place.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch

from torchft_tpu_torch.models.transformer import TransformerConfig, init_params, loss_fn
from torchft_tpu_torch.utils.platform import resolve_device
from torchft_tpu_torch.utils.tree import tree_flatten, tree_leaves, tree_unflatten

__all__ = ["TrainStep"]


class TrainStep:
    def __init__(
        self,
        cfg: TransformerConfig,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)

    # -- state --

    def init_params(self, seed: int = 0) -> Dict[str, Any]:
        return init_params(
            self.cfg, torch.Generator().manual_seed(seed), device=self.device
        )

    def init_opt(self, params: Dict[str, Any]) -> torch.optim.AdamW:
        # optax.adamw(3e-4) with its defaults: b1=0.9, b2=0.999, eps=1e-8
        # and weight_decay=1e-4. torch's AdamW defaults weight_decay to
        # 1e-2, so it is passed explicitly.
        return torch.optim.AdamW(
            tree_leaves(params), lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=1e-4,
        )

    # -- drive --

    def grads(self, params: Dict[str, Any], tokens: torch.Tensor) -> Tuple[torch.Tensor, Any]:
        """Loss and the gradient tree (same structure as ``params``)."""
        leaves, treedef = tree_flatten(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_fn(params, tokens.to(self.device), self.cfg)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_unflatten(treedef, list(grads))

    def apply(
        self, params: Dict[str, Any], opt: torch.optim.Optimizer, grads: Any
    ) -> Tuple[Dict[str, Any], torch.optim.Optimizer]:
        """Apply (possibly cross-group averaged) gradients in place."""
        for p, g in zip(tree_leaves(params), tree_leaves(grads)):
            p.grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)
        return params, opt

    def step(
        self, params: Dict[str, Any], opt: torch.optim.Optimizer, tokens: torch.Tensor
    ) -> Tuple[torch.Tensor, Dict[str, Any], torch.optim.Optimizer]:
        """Fused grads + update (a single replica group, no averaging)."""
        loss, grads = self.grads(params, tokens)
        params, opt = self.apply(params, opt, grads)
        return loss, params, opt
