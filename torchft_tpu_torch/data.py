"""Fault-tolerant data sharding — the port's copy of
``torchft_tpu/data.py`` (the DistributedSampler analogue), numpy only.

Shards the dataset over a virtual grid of ``num_replica_groups ×
num_replicas`` workers: this worker takes global shard ``rank +
num_replicas * replica_group`` of ``num_replicas * num_replica_groups``.
Deliberately lossy on failure: if a replica group dies, its shard simply
isn't visited this epoch, which keeps recovery stateless. A batch's
indices derive from the committed step (:func:`step_indices`), the one
clock every replica group agrees on.

Also usable as a ``torch.utils.data`` sampler, since it just yields
indices.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

__all__ = ["DistributedSampler", "step_indices"]


def step_indices(sampler: "DistributedSampler", step: int, batch: int) -> np.ndarray:
    """This group's sample indices for committed step ``step``.

    Derives the sampler's (epoch, position) purely from the committed step
    count — the one clock every replica group provably agrees on — so a
    killed/healed/disk-resumed group picks up exactly where its last
    committed step left off (no sample double-trained, none skipped) and
    groups can never desync epochs (partitions stay disjoint). Crosses
    epoch boundaries as needed; a failed commit retries the same batch
    because the step didn't advance. The reference leans on torchdata's
    StatefulDataLoader position checkpointing for this
    (train_ddp.py:57-61); deriving from the committed step is strictly
    stronger — correct even when the position snapshot is stale."""
    part_len = len(sampler)
    parts = [np.empty(0, dtype=np.int64)]
    pos = step * batch
    need = batch
    while need > 0:
        epoch, off = divmod(pos, part_len)
        chunk = sampler._partition(epoch)[off : off + need]
        parts.append(chunk)
        pos += chunk.size
        need -= chunk.size
    return np.concatenate(parts).astype(np.int64, copy=False)


class DistributedSampler:
    def __init__(
        self,
        dataset_len: int,
        replica_group: int,
        num_replica_groups: int,
        rank: int = 0,
        num_replicas: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ) -> None:
        """
        Args:
            dataset_len: number of examples (or pass a sized dataset's len)
            replica_group: which fault-tolerance replica group this is
            num_replica_groups: total replica groups in the job
            rank: local rank within the replica group
            num_replicas: local world size within the replica group
        """
        self._dataset_len = dataset_len
        self._global_rank = rank + num_replicas * replica_group
        self._global_world = num_replicas * num_replica_groups
        self._shuffle = shuffle
        self._seed = seed
        self._drop_last = drop_last
        self._epoch = 0
        self._position = 0  # resume offset within the current epoch
        # one-epoch partition cache: step_indices is called every training
        # step, and regenerating rng.permutation(dataset_len) per step is
        # O(dataset) time/memory — at odds with the pretraining-scale
        # target (round-3 advisor finding)
        self._part_cache: tuple[int, np.ndarray] | None = None

    def set_epoch(self, epoch: int) -> None:
        """Reseed shuffling per epoch (all workers must agree)."""
        self._epoch = epoch

    # dataloader-position checkpointing (the reference leans on torchdata's
    # StatefulDataLoader for this — train_ddp.py:57-61; here it's built in)
    def state_dict(self) -> dict:
        return {"epoch": self._epoch, "position": self._position}

    def load_state_dict(self, state: dict) -> None:
        self._epoch = state["epoch"]
        self._position = state["position"]

    def __len__(self) -> int:
        if self._drop_last:
            return self._dataset_len // self._global_world
        return (
            self._dataset_len + self._global_world - 1
        ) // self._global_world

    def _partition(self, epoch: int) -> np.ndarray:
        """This worker's full index partition for ``epoch`` (cached — the
        permutation is regenerated only when the epoch changes)."""
        if self._part_cache is not None and self._part_cache[0] == epoch:
            return self._part_cache[1]
        if self._shuffle:
            rng = np.random.default_rng(self._seed + epoch)
            order = rng.permutation(self._dataset_len)
        else:
            order = np.arange(self._dataset_len)
        target = len(self) * self._global_world
        if self._drop_last:
            order = order[:target]
        else:
            # pad (tiling as needed) to a grid multiple so every worker
            # sees exactly len(self) indices and replicas stay in lockstep
            order = np.resize(order, target)
        mine = np.ascontiguousarray(order[self._global_rank :: self._global_world])
        self._part_cache = (epoch, mine)
        return mine

    def __iter__(self) -> Iterator[int]:
        mine = self._partition(self._epoch)
        start = self._position
        for i, idx in enumerate(mine[start:].tolist()):
            self._position = start + i + 1
            yield idx
        self._position = 0  # epoch exhausted
