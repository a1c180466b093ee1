"""Train step — the port's counterpart of
``torchft_tpu/parallel/train_step.py``: the transformer's loss and
gradients (``grads``), the optimizer update (``apply``) and the two fused
(``step``), on one device.

The split pair is what fault-tolerant training drives: gradients cross
the replica axis through the Manager between ``grads`` and ``apply``. The
optimizer is ``torch.optim.AdamW`` set to ``optax.adamw(3e-4)``'s
defaults; it updates the float32 master params in place.

On a CUDA device each half runs as a captured CUDA graph
(:class:`StepGraphs`), the counterpart of the JAX step's ``jax.jit``:
``grads`` replays forward and backward from a static token buffer into
static gradient tensors, and ``apply`` copies the (averaged) gradients into
static ``.grad`` tensors and replays a captured AdamW step. ``graph=False``
keeps the eager step; on the CPU the step is always eager.

Both halves record their main-thread host time as the step-anatomy
``compute`` phase. The record wraps the replay (or the eager call), never
the captured function: a Python call inside a capture runs once, at the
capture, and never on replay. A replay returns once its work is enqueued,
so the device's tail lands in whichever phase blocks on it next.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from torchft_tpu_torch.models.transformer import TransformerConfig, init_params, loss_fn
from torchft_tpu_torch.ops import flash_attention as fa
from torchft_tpu_torch.telemetry.anatomy import LEDGER
from torchft_tpu_torch.utils.platform import resolve_device
from torchft_tpu_torch.utils.tree import tree_flatten, tree_leaves, tree_unflatten

__all__ = ["TrainStep", "GraphedStep", "StepGraphs", "synchronize"]

# one capture at a time in the process: replica groups run as threads, and
# a capture's warm-up and recording must not interleave with another's
_CAPTURE_LOCK = threading.Lock()


def synchronize(device: Optional[Union[str, torch.device]] = None) -> None:
    """``torch.cuda.synchronize(device)`` once no capture is underway in the
    process. CUDA refuses to synchronize a device while one of its streams
    is capturing, whatever the capture mode, and fails that capture with
    it; so a thread that shares the card with another group's step (replica
    groups as threads) synchronizes the device through this. A thread's
    own stream (``torch.cuda.current_stream().synchronize()``) needs no
    lock. On the CPU it only waits for the lock."""
    with _CAPTURE_LOCK:
        if device is None or torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)


def _ptrs(tensors: Sequence[torch.Tensor]) -> Tuple[int, ...]:
    return tuple(t.data_ptr() for t in tensors)


def _state_tensors(opt: torch.optim.Optimizer) -> List[torch.Tensor]:
    return [t for group in opt.param_groups for p in group["params"]
            for t in opt.state.get(p, {}).values() if isinstance(t, torch.Tensor)]


class _Graph:
    """A captured graph, the static inputs it reads, the outputs it
    writes, the tensors it reads by address (kept alive here) and the flash
    launches it recorded."""

    def __init__(self, graph, inputs, outputs, keep, launches, owner=None) -> None:
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.keep, self.launches, self.owner = keep, launches, owner

    def replay(self) -> None:
        self.graph.replay()
        fa.add_launches(self.launches)


class StepGraphs:
    """The CUDA graphs of a train step, cached as ``jit`` caches its
    traces: a gradient function per input shape and per storage of the
    tensors it reads by address (the params), and an optimizer step per
    optimizer and storage of its params, gradients and state. A call that
    misses the cache runs eagerly on the capture stream (the warm-up the
    capture needs, whose result is the call's), then captures the same
    work for the calls after it; a capture that fails raises.

    Each owner (one per replica group) has its own capture stream and graph
    pool, and captures in ``"thread_local"`` mode, so another group's thread
    may run eager work while this one captures; a device-wide sync in that
    thread goes through :func:`synchronize`. A graph's outputs are
    static: the next replay overwrites them, so a caller consumes them
    before it calls again. Replays run on the caller's current stream."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self._stream = torch.cuda.Stream(device)
        self._pool = torch.cuda.graph_pool_handle()
        self._fns: Dict[Any, _Graph] = {}
        self._step: Optional[_Graph] = None
        self._step_key: Any = None
        self.captures = {"grads": 0, "apply": 0}

    def _capture(self, fn: Callable[..., Any], args: Sequence[Any]) -> Tuple[Any, Any, Any, Dict]:
        """Run ``fn(*args)`` eagerly on the capture stream, then capture it;
        returns (the eager result, the graph's outputs, the graph, its
        recorded launches). The caller holds ``_CAPTURE_LOCK`` and the
        capture stream's context."""
        eager = fn(*args)
        self._stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        with fa.recorded_launches(self._stream) as launches:
            graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
            try:
                outputs = fn(*args)
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            graph.capture_end()
        return eager, outputs, graph, dict(launches)

    def run(self, fn: Callable[..., Any], reads: Sequence[torch.Tensor],
            inputs: Sequence[torch.Tensor]) -> Any:
        """``fn(*inputs)``, a tree of tensors, replayed from a graph. ``fn``
        reads ``reads`` by address and ``inputs`` from static buffers that
        each call fills with ``copy_``."""
        key = (tuple((tuple(x.shape), x.dtype) for x in inputs), _ptrs(reads))
        entry = self._fns.get(key)
        if entry is not None:
            for dst, src in zip(entry.inputs, inputs):
                dst.copy_(src, non_blocking=True)
            entry.replay()
            return entry.outputs
        caller = torch.cuda.current_stream(self.device)
        with _CAPTURE_LOCK:
            self._stream.wait_stream(caller)
            with torch.cuda.stream(self._stream):
                static = [x.to(self.device, copy=True) for x in inputs]
                eager, outputs, graph, launches = self._capture(fn, static)
        caller.wait_stream(self._stream)
        for t in tree_leaves(eager):
            if isinstance(t, torch.Tensor):
                t.record_stream(caller)
        self._fns[key] = _Graph(graph, static, outputs, list(reads), launches)
        self.captures["grads"] += 1
        return eager

    def step(self, opt: torch.optim.Optimizer, params: Sequence[torch.Tensor],
             grads: Sequence[torch.Tensor]) -> None:
        """Copy ``grads`` into each param's static ``.grad`` and replay the
        captured ``opt.step()``. The optimizer must be graph-safe (AdamW
        with ``capturable=True``; SGD). Its hyperparameters are captured
        as they are at the capture."""
        with torch.no_grad():
            for p, g in zip(params, grads):
                if p.grad is None:
                    p.grad = torch.empty_like(p)
                if p.grad is not g:
                    p.grad.copy_(g, non_blocking=True)
        key = (_ptrs(params), _ptrs([p.grad for p in params]), _ptrs(_state_tensors(opt)))
        if self._step is not None and self._step.owner is opt and key == self._step_key:
            self._step.replay()
            return
        caller = torch.cuda.current_stream(self.device)
        with _CAPTURE_LOCK:
            self._stream.wait_stream(caller)
            with torch.cuda.stream(self._stream):
                _, _, graph, launches = self._capture(opt.step, ())
        caller.wait_stream(self._stream)
        self._step = _Graph(graph, (), None, list(params), launches, owner=opt)
        # the eager step may have created the optimizer's state
        self._step_key = (key[0], key[1], _ptrs(_state_tensors(opt)))
        self.captures["apply"] += 1


class GraphedStep:
    """What a train step on one device shares with another: its device, the
    choice of CUDA graphs and the optimizer update. ``graph``: replay the
    step from CUDA graphs (``None``: on a CUDA device, not on the CPU;
    ``True`` on the CPU raises; ``False`` runs the step eagerly)."""

    def __init__(self, device: Union[str, torch.device], graph: Optional[bool]) -> None:
        self.device = resolve_device(device)
        if graph is None:
            graph = self.device.type == "cuda"
        if graph and self.device.type != "cuda":
            raise ValueError("graph=True needs a CUDA device: CUDA graphs run on the card")
        self.graphs = StepGraphs(self.device) if graph else None

    def _compute(self, fn: Callable[..., Any], reads: Sequence[torch.Tensor],
                 inputs: Sequence[torch.Tensor]) -> Any:
        """``fn(*inputs)``, a tuple led by the loss, eagerly or from a graph
        (``StepGraphs.run``); a graph's loss is cloned, its other outputs
        are its static tensors."""
        t0 = time.perf_counter()
        try:
            if self.graphs is None:
                return fn(*(x.to(self.device) for x in inputs))
            loss, *rest = self.graphs.run(fn, reads, inputs)
            return (loss.clone(), *rest)
        finally:
            LEDGER.record("compute", time.perf_counter() - t0)

    def apply(self, params: Any, opt: torch.optim.Optimizer, grads: Any) -> Tuple[Any, Any]:
        """Apply (possibly cross-group averaged) gradients in place."""
        t0 = time.perf_counter()
        try:
            leaves = tree_leaves(params)
            if self.graphs is not None:
                self.graphs.step(opt, leaves, tree_leaves(grads))
                return params, opt
            for p, g in zip(leaves, tree_leaves(grads)):
                p.grad = g
            opt.step()
            opt.zero_grad(set_to_none=True)
            return params, opt
        finally:
            LEDGER.record("compute", time.perf_counter() - t0)


class TrainStep(GraphedStep):
    def __init__(
        self,
        cfg: TransformerConfig,
        device: Union[str, torch.device] = "cuda",
        graph: Optional[bool] = None,
    ) -> None:
        super().__init__(device, graph)
        self.cfg = cfg

    # -- state --

    def init_params(self, seed: int = 0) -> Dict[str, Any]:
        return init_params(
            self.cfg, torch.Generator().manual_seed(seed), device=self.device
        )

    def init_opt(self, params: Dict[str, Any]) -> torch.optim.AdamW:
        # optax.adamw(3e-4) with its defaults: b1=0.9, b2=0.999, eps=1e-8
        # and weight_decay=1e-4. torch's AdamW defaults weight_decay to
        # 1e-2, so it is passed explicitly. On the card it is capturable
        # (its step count lives on the device), eager or graphed alike.
        on_cuda = self.device.type == "cuda"
        return torch.optim.AdamW(
            tree_leaves(params), lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=1e-4, capturable=on_cuda, foreach=True if on_cuda else None,
        )

    # -- drive --

    def grads(self, params: Dict[str, Any], tokens: torch.Tensor) -> Tuple[torch.Tensor, Any]:
        """Loss and the gradient tree (same structure as ``params``). Graphed,
        the gradients are the graph's static tensors: the next call
        overwrites them."""
        leaves, treedef = tree_flatten(params)
        for p in leaves:
            p.requires_grad_(True)

        def loss_and_grads(toks):
            loss = loss_fn(params, toks, self.cfg)
            return loss.detach(), list(torch.autograd.grad(loss, leaves))

        loss, grads = self._compute(loss_and_grads, leaves, [tokens])
        return loss, tree_unflatten(treedef, grads)

    def step(
        self, params: Dict[str, Any], opt: torch.optim.Optimizer, tokens: torch.Tensor
    ) -> Tuple[torch.Tensor, Dict[str, Any], torch.optim.Optimizer]:
        """Fused grads + update (a single replica group, no averaging);
        graphed, the two graphs replay back to back."""
        loss, grads = self.grads(params, tokens)
        params, opt = self.apply(params, opt, grads)
        return loss, params, opt
