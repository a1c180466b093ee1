"""The port's sampler (``torchft_tpu_torch/data.py``, a copy) against the
JAX package's: ``DistributedSampler`` and ``step_indices`` give exactly
the same indices, with shuffle on and off, ``drop_last`` on and off, 1-3
replica groups (and 2 ranks a group), a resumed position, and steps that
cross an epoch. Within an epoch the groups' indices are disjoint."""

import numpy as np
import pytest

from torchft_tpu import data as J
from torchft_tpu_torch import data as T

CASES = [
    pytest.param(n, groups, ranks, shuffle, drop_last,
                 id=f"n{n}-g{groups}-r{ranks}-{'shuf' if shuffle else 'seq'}"
                    f"{'-drop' if drop_last else ''}")
    for n in (50, 64)
    for groups, ranks in ((1, 1), (2, 1), (3, 1), (2, 2))
    for shuffle in (True, False)
    for drop_last in (False, True)
]


def _pair(n, group, groups, rank, ranks, shuffle, drop_last, seed=3):
    kw = dict(replica_group=group, num_replica_groups=groups, rank=rank, num_replicas=ranks,
              shuffle=shuffle, seed=seed, drop_last=drop_last)
    return J.DistributedSampler(n, **kw), T.DistributedSampler(n, **kw)


@pytest.mark.parametrize("n,groups,ranks,shuffle,drop_last", CASES)
def test_sampler_equals_jax(n, groups, ranks, shuffle, drop_last):
    for group in range(groups):
        for rank in range(ranks):
            js, ts = _pair(n, group, groups, rank, ranks, shuffle, drop_last)
            assert len(ts) == len(js)
            for epoch in (0, 1):
                js.set_epoch(epoch)
                ts.set_epoch(epoch)
                assert list(ts) == list(js)
            # a resumed position within the epoch
            js.load_state_dict({"epoch": 2, "position": 3})
            ts.load_state_dict({"epoch": 2, "position": 3})
            assert list(ts) == list(js) and ts.state_dict() == js.state_dict()
            # step_indices across the epoch boundary (batch 7 does not
            # divide the partition)
            for step in range(2 * len(ts) // 7 + 2):
                np.testing.assert_array_equal(T.step_indices(ts, step, 7),
                                              J.step_indices(js, step, 7))


@pytest.mark.parametrize("groups", [2, 3])
def test_groups_disjoint_within_an_epoch(groups):
    n, batch = 96, 8
    samplers = [T.DistributedSampler(n, replica_group=g, num_replica_groups=groups, seed=5)
                for g in range(groups)]
    steps = len(samplers[0]) // batch  # one epoch
    seen = [np.concatenate([T.step_indices(s, k, batch) for k in range(steps)])
            for s in samplers]
    for a in range(groups):
        for b in range(a + 1, groups):
            assert not set(seen[a].tolist()) & set(seen[b].tolist())
    assert sorted(np.concatenate(seen).tolist()) == list(range(n))
