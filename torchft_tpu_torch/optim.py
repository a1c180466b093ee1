"""Commit-gated optimizer — the port's counterpart of
``torchft_tpu/optim.py``.

The optimizer is a factory ``params -> torch.optim.Optimizer`` (for
example ``TrainStep.init_opt``); ``init(params)`` builds it over the
caller's parameter tree, which it then updates in place::

    opt = ManagedOptimizer(manager, train_step.init_opt)
    opt.init(params)                      # registers state fns on the manager
    for batch in data:
        opt.begin_step()                  # start the quorum
        loss, grads = train_step.grads(opt.params, batch)
        opt.step(grads)                   # average + commit gate + update

``step`` averages the gradients across replica groups through the Manager
and applies the update only if ``should_commit()``.

Pipelined commit (``Manager(commit_pipeline=True)``): ``step`` applies the
update speculatively and issues the vote asynchronously; the vote of step
*k* resolves inside step *k+1*'s ``step()``, so the gradient computation
between ``begin_step`` and ``step`` overlaps it (a sync quorum resolves it
in ``begin_step`` instead, before the gradients). On a veto the pre-update
state is restored; pass ``grad_fn`` (``params -> grads``) so the in-flight
batch is replayed on it (without it the in-flight batch is dropped too).
Torch updates in place, so the rollback snapshot is a copy: a clone of
every parameter and of every optimizer state tensor. A heal and a rollback
copy their state into the live tensors in place
(:func:`load_optimizer_state`), so a CUDA graph that captured them (the
graphed ``TrainStep``) goes on reading the right values.

Error feedback (``error_feedback``, on by default when the Manager's wire
codec is lossy): each step's quantization residuals follow the step's
fate, committed with a committed vote and dropped on a veto or an abort
(the pipelined commit's late veto included), and the committed ones ride
``state_dict()["ef"]`` through heals.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from torchft_tpu_torch.ddp import allreduce_gradients
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.utils.tree import tree_leaves, tree_map
from torchft_tpu_torch.wire_codec import ErrorFeedback, ErrorFeedbackBinding

__all__ = [
    "ManagedOptimizer",
    "SpeculativeCommitMixin",
    "load_optimizer_state",
]


def load_optimizer_state(opt: torch.optim.Optimizer, state: Dict[str, Any]) -> None:
    """Load ``state`` (an ``Optimizer.state_dict()``, e.g. received by a
    heal or kept as a rollback snapshot) into ``opt`` by copying into the
    state tensors it already holds, where ``Optimizer.load_state_dict``
    would replace them (and a captured optimizer step would go on reading
    the old ones). Each tensor keeps its device, so a capturable
    optimizer's step count stays on the card. A param whose state ``opt``
    lacks gets new tensors (an optimizer that has not stepped yet; no graph
    can hold them); a param whose state ``state`` lacks (a sender that has
    not stepped) gets its tensors zeroed, the state a first step starts
    from. The hyperparameters stay ``opt``'s own, as optax's stay its
    transform's."""
    params = [p for group in opt.param_groups for p in group["params"]]
    ids = [i for group in state["param_groups"] for i in group["params"]]
    if len(ids) != len(params):
        raise ValueError(f"optimizer state for {len(ids)} params, this optimizer has {len(params)}")
    on_device = any(g.get("capturable") or g.get("fused") for g in opt.param_groups)
    with torch.no_grad():
        for i, p in zip(ids, params):
            src, dst = state["state"].get(i), opt.state.get(p)
            if not src:
                for t in (dst or {}).values():
                    if isinstance(t, torch.Tensor):
                        t.zero_()
                continue
            if dst is None or set(dst) != set(src):
                # torch.optim keeps AdamW's step count on the host unless
                # the optimizer is capturable or fused
                opt.state[p] = {
                    k: (v.to(p.device if k != "step" or on_device else "cpu",
                             p.dtype if v.is_floating_point() and k != "step" else v.dtype,
                             copy=True)
                        if isinstance(v, torch.Tensor) else v)
                    for k, v in src.items()
                }
                continue
            for k, v in src.items():
                if isinstance(v, torch.Tensor):
                    dst[k].copy_(v)
                else:
                    dst[k] = v


def _clone(tree: Any) -> Any:
    return tree_map(
        lambda x: x.detach().clone() if isinstance(x, torch.Tensor) else x, tree
    )


class SpeculativeCommitMixin:
    """Pipelined-commit snapshot plumbing and the live-recovery state,
    shared by :class:`ManagedOptimizer` and
    :class:`~torchft_tpu_torch.parallel.ft.FTTrainer`.

    The owner keeps its parameter tree in ``_params``, its optimizer in
    ``_opt`` and its manager in ``_manager``. This mixin owns the rollback
    snapshot, the resolution callback and the *sticky* replay flag: sticky
    so that a vote resolved out of band (e.g. by a LocalSGD sync) still has
    its rollback handled at the next ``step``."""

    _params: Any = None
    _opt: Optional[torch.optim.Optimizer] = None
    _snapshot: Optional[Tuple[Any, Dict[str, Any]]] = None
    _replay_needed = False
    _efb: Optional[ErrorFeedbackBinding] = None  # wire-plane error feedback
    rollbacks = 0  # speculative steps undone by a veto

    @property
    def error_feedback(self) -> Optional[ErrorFeedback]:
        return self._efb.instance if self._efb is not None else None

    # -- state (registered with the Manager for live recovery) --

    def state_dict(self) -> Dict[str, Any]:
        if self._snapshot is not None:
            # mid-speculation a peer must heal from the committed state
            out = {"params": self._snapshot[0], "opt_state": self._snapshot[1]}
        else:
            out = {"params": self._params, "opt_state": self._opt.state_dict()}
        ef = self.error_feedback
        if ef is not None:
            # committed residuals only: a healed group resumes the
            # compensation instead of restarting it from zero
            out["ef"] = ef.state_dict()
        return out

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        # a received state lies on the host; copy_ puts the params and the
        # optimizer state on this owner's device in place (the optimizer,
        # and any graph that captured a step, hold these very tensors)
        self._restore(state["params"], state["opt_state"])
        # a heal supersedes any speculative lineage, a pending replay
        # included: the next step's gradients are taken on this state
        self._snapshot = None
        self._replay_needed = False
        ef = self.error_feedback
        if ef is None and "ef" in state and self._efb is not None:
            # auto mode may not have made the instance yet: adopt the
            # healed accumulators rather than drop them
            ef = self._efb.ensure_for_state(state["ef"])
        if ef is not None:
            # healed from a peer without EF state: start clean rather than
            # compensate with residuals of a dead lineage
            ef.load_state_dict(state.get("ef") or {"codec": None, "acc": {}})

    def _restore(self, params: Any, opt_state: Dict[str, Any]) -> None:
        with torch.no_grad():
            for dst, src in zip(tree_leaves(self._params), tree_leaves(params)):
                dst.copy_(src)
        load_optimizer_state(self._opt, opt_state)

    # -- snapshot and rollback --

    def _take_snapshot(self) -> None:
        """Copy the committed params and optimizer state before the
        speculative update: ``state_dict()`` returns references to the live
        moment tensors, which the update then changes in place."""
        self._snapshot = (_clone(self._params), _clone(self._opt.state_dict()))

    def _on_vote_resolved(self, committed: bool) -> None:
        """Runs on the main thread inside ``resolve_pending_commit``, before
        the speculation fence lifts, so the quorum thread never serves a
        half-rolled-back state."""
        if not committed and self._snapshot is not None:
            self._restore(*self._snapshot)
            self.rollbacks += 1
            self._replay_needed = True
        self._snapshot = None
        self._resolve_error_feedback(committed)

    def _resolve_error_feedback(self, committed: bool) -> None:
        """The step's residuals share its lineage: a vetoed or aborted
        step's must never compensate the next step."""
        ef = self.error_feedback
        if ef is not None:
            if committed:
                ef.commit()
            else:
                ef.rollback()

    def _consume_replay(self) -> bool:
        """True once per rollback: the in-flight gradients were computed on
        the rolled-back state and must be replayed or dropped."""
        if self._replay_needed:
            self._replay_needed = False
            return True
        return False

    def _start_quorum(self, allow_heal: bool = True, shrink_only: bool = False) -> None:
        """Start the step's quorum. A sync quorum resolves the previous
        vote inside ``start_quorum``: a rollback there lands before this
        step's gradients are taken, so there is nothing to replay."""
        m = self._manager
        pending = m.pending_commit() is not None
        m.start_quorum(allow_heal=allow_heal, shrink_only=shrink_only)
        if pending and m.pending_commit() is None:
            self._replay_needed = False

    def _resolve_speculation(self) -> bool:
        """Resolve the previous step's vote (a no-op when none is pending).
        True when a rollback happened, here or out of band."""
        if self._manager.pending_commit() is not None:
            self._manager.resolve_pending_commit()
        return self._consume_replay()

    def _commit(self, grads: Any, apply: Callable[[Any], None]) -> bool:
        """The step's tail: with speculation allowed, snapshot, ``apply``
        the averaged ``grads`` and vote asynchronously (returns the expected
        outcome, True); else vote and ``apply`` on commit."""
        m = self._manager
        if m.speculation_allowed():
            # the snapshot is published before the update, so a concurrent
            # checkpoint serve never sees a half-updated state
            self._take_snapshot()
            apply(grads)
            m.should_commit_async(on_resolved=self._on_vote_resolved)
            return True
        # should_commit may heal: the params then hold the received state,
        # and the average applied to them is the participants' (a heal
        # also restored the residuals, so the pending set is empty)
        committed = m.should_commit()
        self._resolve_error_feedback(committed)
        if committed:
            apply(grads)
        return committed

    def finish(self) -> Optional[bool]:
        """Resolve the trailing speculative vote; call after the last
        ``step`` of a pipelined run. Returns the vote, or None when nothing
        was outstanding."""
        if self._manager.pending_commit() is None:
            return None
        # no step follows: the watchdog stays disarmed
        return self._manager.resolve_pending_commit(rearm=False)


class ManagedOptimizer(SpeculativeCommitMixin):
    def __init__(
        self,
        manager: Manager,
        optimizer: Callable[[Any], torch.optim.Optimizer],
        error_feedback: Any = None,
    ) -> None:
        """``optimizer`` is a factory ``params -> torch.optim.Optimizer``.
        ``init`` registers this wrapper's ``state_dict`` /
        ``load_state_dict`` with the manager, so a healing group receives
        params and optimizer state; a caller whose state covers more calls
        ``manager.set_state_dict_fns`` after ``init`` (and includes
        ``state_dict()`` in it). ``error_feedback``: residual compensation
        for a lossy wire codec; None (the default) turns it on when the
        manager's plane reports a lossy codec; False turns it off; an
        :class:`~torchft_tpu_torch.wire_codec.ErrorFeedback` is used as
        given."""
        self._manager = manager
        self._efb = ErrorFeedbackBinding(manager, error_feedback)
        self._make_opt = optimizer
        self._params = None
        self._opt = None

    @property
    def params(self) -> Any:
        if self._params is None:
            raise RuntimeError("call init(params) first")
        return self._params

    @property
    def optimizer(self) -> torch.optim.Optimizer:
        return self._opt

    def init(self, params: Any) -> None:
        self._params = params
        self._opt = self._make_opt(params)
        self._manager.set_state_dict_fns(self.load_state_dict, self.state_dict)

    def begin_step(self, allow_heal: bool = True, shrink_only: bool = False) -> None:
        """Start the quorum; call before the forward pass so the RPC
        overlaps compute. With async quorum a pipelined vote stays in
        flight here: it resolves inside the next ``step()``."""
        self._start_quorum(allow_heal=allow_heal, shrink_only=shrink_only)

    def step(
        self,
        grads: Any,
        average: bool = True,
        grad_fn: Optional[Callable[[Any], Any]] = None,
    ) -> Any:
        """Average ``grads`` across replica groups, then apply the update
        iff the step commits (or speculatively, under the pipeline).
        Returns the params (healed and/or updated in place). Pass
        ``average=False`` if the gradients were already averaged through
        the manager. ``grad_fn`` (``params -> grads``) recomputes the
        gradients after a rollback so the in-flight batch is replayed."""
        m = self._manager
        replay = self._resolve_speculation()
        ef = self._efb.live()
        if replay:
            # ``grads`` were computed on the rolled-back params
            if grad_fn is None:
                return self._params  # cannot replay: drop this batch too
            # replayed gradients always take the managed average: any
            # averaging the caller did belongs to the vetoed lineage
            grads = allreduce_gradients(m, grad_fn(self._params), error_feedback=ef)
        elif average:
            grads = allreduce_gradients(m, grads, error_feedback=ef)
        self._commit(grads, self._apply_update)
        return self._params

    def _apply_update(self, grads: Any) -> None:
        for p, g in zip(tree_leaves(self._params), tree_leaves(grads)):
            p.grad = g
        self._opt.step()
        self._opt.zero_grad(set_to_none=True)
