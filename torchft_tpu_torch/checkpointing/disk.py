"""Periodic disk checkpointing — the port's copy of
``torchft_tpu/checkpointing/disk.py``, the user-owned half of recovery.

The reference documents but does not implement this composition: "users
should checkpoint [manager + model + optimizer + dataloader] frequently"
(torchft/manager.py:83-85, train_ddp.py:141-148 shows the workflow).
``DiskCheckpointer`` packages it: step-tagged atomic snapshots of
``{"torchft": manager.state_dict(), "user": state_dict()}``, retention of
the newest ``keep``, and restore-latest. The files are
``serialization.save_state`` streams: a tree of numpy leaves written here
restores in the JAX package's ``DiskCheckpointer`` and the reverse
(tensor leaves travel as the port's ``"tensor"`` buffers).

Division of labor with live healing: the quorum heal covers *partial*
failures (a surviving peer serves current state); the disk checkpoint
covers *total* failures (every group lost) and planned restarts. Load
happens BEFORE the first quorum so a resumed group reports its true step
and heals forward, never backward.

Multi-rank groups: for state that every rank holds whole, exactly one
writer per group (rank 0 by convention — pass ``is_writer=False``
elsewhere) and every rank restores from the shared file. When the state
holds a DTensor on a mesh of more than one process (a sharded group), one
writer can serialize only its own shards, so EVERY process writes its own
``.proc<I>of<N>`` file (I its rank in the group's ``torch.distributed``
world; the ``is_writer`` convention then applies per process) and
:meth:`restore` pools the shards of all N files before the user callback
rebuilds its DTensors (``serialization.from_transfer_tree``). Each
process claims its write generation from the directory when its
checkpointer is built, so a group builds all of them before any saves
(as a train loop does: the first save follows a step together). The names
keep the JAX package's grammar: ``<tag>_step<N>``, a write generation
``.g<K>`` (each incarnation claims the next one, so arbitration never
hinges on mtime) and the per-process sets; a set counts only when
complete. Sets cross-read with the JAX package's both ways.
"""

from __future__ import annotations

import logging
import os
import re
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from torchft_tpu_torch.checkpointing.serialization import ShardedArray, load_state, save_state
from torchft_tpu_torch.parallel.mesh import is_dtensor
from torchft_tpu_torch.utils.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

logger = logging.getLogger(__name__)

__all__ = ["DiskCheckpointer"]

_NAME = re.compile(
    r"^(?P<tag>.+)_step(?P<step>\d+)(?:\.g(?P<gen>\d+))?"
    r"(?:\.proc(?P<pidx>\d+)of(?P<pcount>\d+))?\.ckpt$"
)


def _needs_per_process(state: Any) -> bool:
    """Whether a leaf is a DTensor whose mesh spans more than one process
    (each rank of a group is one): one writer's shards would then be an
    incomplete checkpoint."""
    return any(is_dtensor(leaf) and leaf.device_mesh.size() > 1
               for leaf in tree_leaves(state))


def _merge_shard_trees(trees: List[Any]) -> Any:
    """Merge per-process checkpoint trees: :class:`ShardedArray` leaves pool
    their shards (deduplicated by index); every other leaf is taken from
    the first tree (the writers replicate it)."""
    flat = [tree_flatten(t) for t in trees]
    leaves0, spec = flat[0]
    for _, other in flat[1:]:
        if other != spec:
            # never pool shards across mismatched structures (a partial
            # rollout renaming a key would pair shards with the wrong leaf)
            raise ValueError(
                f"per-process checkpoints disagree on tree structure: {other} != {spec}")
    merged: List[Any] = []
    for i, leaf in enumerate(leaves0):
        if not isinstance(leaf, ShardedArray):
            merged.append(leaf)
            continue
        seen: dict = {}
        for leaves, _ in flat:
            other = leaves[i]
            if (not isinstance(other, ShardedArray) or other.shape != leaf.shape
                    or other.dtype != leaf.dtype):
                raise ValueError(
                    f"per-process checkpoints disagree on leaf {leaf.shape}/{leaf.dtype}")
            for idx, data in other.shards:
                seen.setdefault(tuple(tuple(b) for b in idx), data)
        merged.append(ShardedArray(leaf.dtype, leaf.shape, leaf.mesh_desc, leaf.spec_entries,
                                   list(seen.items())))
    return tree_unflatten(spec, merged)


def _copy_leaf(leaf: Any) -> Any:
    """A leaf that training will not change under the writer: tensors are
    cloned on their own device (the host copy happens on the writer
    thread), numpy arrays copied; other leaves are immutable values."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().clone()
    if isinstance(leaf, np.ndarray):
        return leaf.copy()
    return leaf


class DiskCheckpointer:
    def __init__(
        self,
        directory: str,
        manager,
        state_dict: Callable[[], Any],
        load_state_dict: Callable[[Any], None],
        every: int = 5,
        keep: int = 3,
        tag: str = "group0",
        is_writer: bool = True,
        async_save: bool = False,
    ) -> None:
        """
        Args:
            directory: checkpoint directory (created if missing)
            manager: the Manager whose progress counters ride along
            state_dict / load_state_dict: user snapshot/restore callbacks
                (params, optimizer, sampler position, ...); restored tensor
                leaves lie on the host, and the callback copies them into
                its own tensors (``ManagedOptimizer.load_state_dict`` does)
            every: save cadence in committed steps
            keep: newest checkpoints retained (older ones pruned)
            tag: filename prefix — one distinct tag per replica group
            is_writer: exactly one rank per group writes and all ranks read
            async_save: serialize and write on a background thread so the
                train loop never blocks on disk. The state is captured
                synchronously — tensors are cloned on their device and
                numpy leaves copied — so later in-place training steps
                cannot tear the snapshot. At most one save is in flight; a
                cadence hit while one is running is skipped (the next hit
                retries).
        """
        self._dir = directory
        self._manager = manager
        self._state_dict = state_dict
        self._load_state_dict = load_state_dict
        self._every = max(1, every)
        self._keep = max(1, keep)
        self._tag = tag
        self._is_writer = is_writer
        self._async = async_save
        self._executor: Optional[ThreadPoolExecutor] = None
        self._inflight: Optional[Future] = None
        self._io_lock = threading.Lock()  # serializes writes with prune
        os.makedirs(directory, exist_ok=True)
        # progress gate: never snapshot the step we started at (a pristine
        # step-0 checkpoint on a fresh start is pure noise)
        # unguarded-ok: a failed async write's callback only moves it back
        # one step (an atomic int store), so the next cadence hit retries
        self._last_saved = manager.current_step()
        # Write generation: each incarnation claims max(existing gen) + 1
        # once at construction, so a dense file and a stale per-process set
        # at the SAME step are ranked without filesystem mtimes. Generation
        # 0 keeps the suffix-free filename.
        self._gen = self._scan_max_gen()
        self._cleanup_stale()

    def _scan_max_gen(self) -> int:
        try:
            names = os.listdir(self._dir)
        except FileNotFoundError:
            return 0
        gens = [
            int(m.group("gen") or 0)
            for m in (_NAME.match(n) for n in names)
            if m and m.group("tag") == self._tag
        ]
        return max(gens) + 1 if gens else 0

    def _cleanup_stale(self) -> None:
        for name in os.listdir(self._dir):
            if name.endswith(".ckpt.tmp"):
                # a writer died mid-save; the partial file is garbage.
                # Exact-tag match only ("group1" must not touch
                # "group10_step5.ckpt.tmp" in a shared directory).
                m = _NAME.match(name[: -len(".tmp")])
                if m and m.group("tag") == self._tag:
                    try:
                        os.remove(os.path.join(self._dir, name))
                    except OSError:
                        pass
            elif name == f"{self._tag}.ckpt":
                # pre-DiskCheckpointer layout (unstepped single file)
                logger.warning(
                    "ignoring old-layout checkpoint %s (expected '%s_step<N>.ckpt'); "
                    "it will NOT be restored", name, self._tag,
                )

    # -- paths --

    def _gen_suffix(self) -> str:
        return f".g{self._gen}" if self._gen else ""

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"{self._tag}_step{step}{self._gen_suffix()}.ckpt")

    def _proc_path(self, step: int, pidx: int, pcount: int) -> str:
        return os.path.join(
            self._dir, f"{self._tag}_step{step}{self._gen_suffix()}.proc{pidx}of{pcount}.ckpt"
        )

    def _existing(self) -> List[Tuple[int, List[str]]]:
        """``[(step, [paths])]`` sorted by step, only *complete* steps: a
        dense checkpoint is one file; a per-process checkpoint counts only
        when all N ``procIofN`` files of one generation are present (a
        host that died mid-save must not offer a half checkpoint)."""
        dense: dict = {}  # step -> (gen, path), highest gen wins
        procs: dict = {}  # (step, gen) -> {pidx: (path, pcount)}
        try:
            names = os.listdir(self._dir)
        except FileNotFoundError:
            return []
        for name in names:
            m = _NAME.match(name)
            if not m or m.group("tag") != self._tag:
                continue
            step = int(m.group("step"))
            gen = int(m.group("gen") or 0)
            path = os.path.join(self._dir, name)
            if m.group("pidx") is None:
                if step not in dense or gen > dense[step][0]:
                    dense[step] = (gen, path)
            else:
                procs.setdefault((step, gen), {})[int(m.group("pidx"))] = (
                    path, int(m.group("pcount")))
        complete_procs: dict = {}  # step -> (gen, [paths])
        for (step, gen), by_idx in procs.items():
            counts = {pcount for _, pcount in by_idx.values()}
            if len(counts) == 1 and len(by_idx) == next(iter(counts)):
                if step not in complete_procs or gen > complete_procs[step][0]:
                    complete_procs[step] = (gen, [by_idx[i][0] for i in sorted(by_idx)])

        def _mtime_ns(paths: List[str]) -> int:
            # the tiebreak of generation-0 files only: ignore unstatable
            # members rather than zeroing the whole set
            times = []
            for p in paths:
                try:
                    times.append(os.stat(p).st_mtime_ns)
                except OSError:
                    pass
            return max(times, default=0)

        out: List[Tuple[int, List[str]]] = []
        for step in dense.keys() | complete_procs.keys():
            # one entry per step: an elastic resize can leave BOTH a dense
            # file and a complete set at the same step — offer only the
            # newer write, by generation, then ns mtime, then dense
            if step in dense and step in complete_procs:
                dg, dpath = dense[step]
                pg, ppaths = complete_procs[step]
                if dg != pg:
                    pick = [dpath] if dg > pg else ppaths
                else:
                    pick = [dpath] if _mtime_ns([dpath]) >= _mtime_ns(ppaths) else ppaths
                out.append((step, pick))
            elif step in dense:
                out.append((step, [dense[step][1]]))
            else:
                out.append((step, complete_procs[step][1]))
        return sorted(out)

    def latest(self) -> Optional[str]:
        """Path of the newest complete checkpoint (first file of a
        per-process set)."""
        existing = self._existing()
        return existing[-1][1][0] if existing else None

    # -- save --

    def _snapshot(self) -> Any:
        """The state to write; with ``async_save`` captured tear-free (see
        ``__init__``)."""
        state = {"torchft": self._manager.state_dict(), "user": self._state_dict()}
        if not self._async:
            return state
        return tree_map(_copy_leaf, state)

    def _target_path(self, step: int, state: Any) -> str:
        """The dense single-writer file, or this process's file of the set
        when the state is sharded across processes."""
        if _needs_per_process(state):
            import torch.distributed as dist

            return self._proc_path(step, dist.get_rank(), dist.get_world_size())
        return self._path(step)

    def _write(self, step: int, state: Any, path: str) -> str:
        tmp = path + ".tmp"
        with self._io_lock:
            with open(tmp, "wb") as f:
                save_state(state, f)
            os.replace(tmp, path)
            self._prune()
        logger.info("checkpointed step %d to %s", step, path)
        return path

    def save(self) -> str:
        """Write a snapshot for the current committed step (atomic: a
        crash mid-write leaves the previous checkpoints intact). Blocks
        until the bytes are on disk regardless of ``async_save``."""
        step = self._manager.current_step()
        self._last_saved = step
        state = self._snapshot()
        return self._write(step, state, self._target_path(step, state))

    def maybe_save(self) -> Optional[str]:
        """Call once per loop iteration after ``should_commit``; saves at
        the configured cadence, only on progress, only on the writer.
        With ``async_save`` the write happens in the background and the
        eventual path is returned immediately."""
        step = self._manager.current_step()
        if not (self._is_writer and step % self._every == 0 and step > self._last_saved):
            return None
        if not self._async:
            return self.save()
        if self._inflight is not None and not self._inflight.done():
            logger.warning(
                "skipping checkpoint at step %d: previous save still writing "
                "(cadence faster than disk)", step,
            )
            return None
        if self._executor is None:
            self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="tft_ckpt_disk")
        self._last_saved = step
        state = self._snapshot()  # captured NOW, written later
        path = self._target_path(step, state)
        fut = self._executor.submit(self._write, step, state, path)

        def on_done(f: Future) -> None:
            exc = f.exception()
            if exc is not None:
                # surface the failure even if nobody calls flush(), and
                # let the next cadence hit retry this step
                logger.error("async checkpoint of step %d failed: %s", step, exc)
                if self._last_saved == step:
                    self._last_saved = step - 1

        fut.add_done_callback(on_done)
        self._inflight = fut
        return path

    def flush(self) -> None:
        """Block until any in-flight async save has landed (call before
        shutdown; a pending write surfaces its error here)."""
        if self._inflight is not None:
            self._inflight.result()
            self._inflight = None

    def close(self) -> None:
        """Flush, then stop the writer thread."""
        self.flush()
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None

    def _prune(self) -> None:
        existing = self._existing()
        for _, paths in existing[: -self._keep]:
            for path in paths:
                try:
                    os.remove(path)
                except OSError:
                    pass
        # Orphan sweep: incomplete per-process sets are invisible to
        # _existing() and would otherwise leak forever. Anything older than
        # the oldest *retained complete* step is dead; newer incomplete
        # sets are left alone (a peer may still be mid-write).
        kept = existing[-self._keep:]
        if not kept:
            return
        floor = kept[0][0]
        # the winning generation per retained step: files AT a retained
        # step of a strictly older generation lost arbitration and would
        # otherwise accumulate one checkpoint per crash-restart incarnation
        win_gen = {}
        for step, paths in kept:
            m = _NAME.match(os.path.basename(paths[0]))
            if m:
                win_gen[step] = int(m.group("gen") or 0)
        try:
            names = os.listdir(self._dir)
        except FileNotFoundError:
            return
        for name in names:
            m = _NAME.match(name)
            if not m or m.group("tag") != self._tag:
                continue
            step = int(m.group("step"))
            gen = int(m.group("gen") or 0)
            # at a retained step only a strictly LOWER generation is
            # provably dead (a higher one may be a newer incarnation
            # mid-write)
            if step < floor or gen < win_gen.get(step, 0):
                try:
                    os.remove(os.path.join(self._dir, name))
                except OSError:
                    pass

    # -- restore --

    def restore(self) -> bool:
        """Load the newest complete snapshot if one exists; returns True on
        resume. Restores manager progress first so the first quorum reports
        the resumed step. Call before the first quorum. A per-process set is
        merged first (:class:`ShardedArray` leaves pool every writer's
        shards), so ``from_transfer_tree`` finds any rank's shard whichever
        process wrote it."""
        existing = self._existing()
        if not existing:
            return False
        _, paths = existing[-1]
        trees = []
        for path in paths:
            with open(path, "rb") as f:
                trees.append(load_state(f))
        state = trees[0] if len(trees) == 1 else _merge_shard_trees(trees)
        self._manager.load_state_dict(state["torchft"])
        self._load_state_dict(state["user"])
        self._last_saved = self._manager.current_step()
        logger.info("resumed from %s at step %d%s", paths[0], self._manager.current_step(),
                    "" if len(paths) == 1 else f" ({len(paths)} files merged)")
        return True
