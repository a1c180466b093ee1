"""The port's disk checkpointer against the JAX package's: the cases of
``tests/test_checkpointing.py:330-700`` that hold no sharded leaf, on
``torchft_tpu_torch.checkpointing.disk``, and the files read across.

* Cadence, retention and restore; a non-writer and an empty directory; the
  tear-free ``async_save`` (numpy and tensor leaves mutated in place right
  after the call); an incomplete per-process set is not restorable; a dense
  file against a per-process set at the same step (the newer write wins);
  the write generation over mtime; pruning of superseded generations. Each
  case runs the same schedule on both packages where the JAX one takes it,
  and the directories hold the same file names.
* The cross-read, both ways: a directory the JAX ``DiskCheckpointer``
  wrote (numpy trees) restores in the port with equal arrays and manager
  state, and the reverse; generations continue across the packages.
* The port's own: a complete set of more than one per-process file raises
  (its sharded leaves wait for ROADMAP queue 1 item 5), and tensor trees
  (params and Adam state) round-trip exactly.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from torchft_tpu.checkpointing import disk as JD
from torchft_tpu.checkpointing import serialization as JSer
from torchft_tpu_torch.checkpointing import disk as PD
from torchft_tpu_torch.checkpointing import serialization as PSer

PACKAGES = {"port": (PD, PSer), "jax": (JD, JSer)}


class _ManagerStub:
    def __init__(self) -> None:
        self.step = 0
        self.batches = 0

    def current_step(self) -> int:
        return self.step

    def state_dict(self):
        return {"step": self.step, "batches_committed": self.batches}

    def load_state_dict(self, s) -> None:
        self.step = s["step"]
        self.batches = s["batches_committed"]


def _names(path, suffix=".ckpt"):
    return sorted(p.name for p in path.iterdir() if p.name.endswith(suffix))


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_cadence_retention_restore(tmp_path, pkg):
    disk, _ = PACKAGES[pkg]
    mgr = _ManagerStub()
    state = {"w": np.arange(4, dtype=np.float32)}
    ck = disk.DiskCheckpointer(str(tmp_path), mgr, state_dict=lambda: dict(state),
                               load_state_dict=lambda s: state.update(s), every=2, keep=2,
                               tag="g0")
    saved = []
    for step in range(1, 9):
        mgr.step = step
        mgr.batches = step * 2
        state["w"] = state["w"] + 1.0
        if ck.maybe_save():
            saved.append(step)
    assert saved == [2, 4, 6, 8]  # cadence honored, no re-save on stall
    mgr.step = 8
    assert ck.maybe_save() is None  # no progress since the last save
    assert _names(tmp_path) == ["g0_step6.ckpt", "g0_step8.ckpt"]  # keep=2 pruned

    # total failure: fresh process state, restore the newest
    mgr2 = _ManagerStub()
    state2 = {}
    ck2 = disk.DiskCheckpointer(str(tmp_path), mgr2, state_dict=lambda: dict(state2),
                                load_state_dict=lambda s: state2.update(s), every=2, tag="g0")
    assert ck2.restore() is True
    assert mgr2.step == 8 and mgr2.batches == 16
    np.testing.assert_array_equal(state2["w"], np.arange(4, dtype=np.float32) + 8)


def test_non_writer_and_empty(tmp_path):
    mgr = _ManagerStub()
    ck = PD.DiskCheckpointer(str(tmp_path), mgr, state_dict=dict,
                             load_state_dict=lambda s: None, tag="g1", is_writer=False)
    mgr.step = 5
    assert ck.maybe_save() is None  # readers never write
    assert ck.restore() is False  # nothing to restore
    assert ck.latest() is None


def test_async_save_tear_free(tmp_path):
    """The snapshot is captured at ``maybe_save()``: numpy and tensor leaves
    mutated in place right after must not leak into the file."""
    mgr = _ManagerStub()
    state = {"w": np.full(1 << 16, 1.0, dtype=np.float32),
             "t": torch.full((1 << 16,), 2.0)}
    ck = PD.DiskCheckpointer(str(tmp_path), mgr, state_dict=lambda: dict(state),
                             load_state_dict=lambda s: state.update(s), every=1, tag="g0",
                             async_save=True)
    mgr.step = 1
    path = ck.maybe_save()
    assert path is not None
    state["w"][...] = 999.0  # in-place mutation racing the writer
    state["t"].fill_(999.0)
    ck.close()
    assert os.path.exists(path)

    mgr2 = _ManagerStub()
    got = {}
    ck2 = PD.DiskCheckpointer(str(tmp_path), mgr2, state_dict=dict,
                              load_state_dict=lambda s: got.update(s), tag="g0")
    assert ck2.restore()
    np.testing.assert_array_equal(got["w"], 1.0)  # the snapshot's value
    assert isinstance(got["t"], torch.Tensor) and bool((got["t"] == 2.0).all())
    assert mgr2.step == 1


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_incomplete_proc_set_not_restorable(tmp_path, pkg):
    """A per-process set missing a writer (a host died mid-save) is not
    offered: restore falls back to the older complete step."""
    disk, ser = PACKAGES[pkg]
    with open(tmp_path / "g0_step3.ckpt", "wb") as f:
        ser.save_state({"torchft": {"step": 3, "batches_committed": 6},
                        "user": {"w": np.ones(2, np.float32)}}, f)
    with open(tmp_path / "g0_step5.proc0of2.ckpt", "wb") as f:
        ser.save_state({"torchft": {"step": 5, "batches_committed": 10},
                        "user": {"w": np.zeros(2, np.float32)}}, f)
    mgr = _ManagerStub()
    got = {}
    ck = disk.DiskCheckpointer(str(tmp_path), mgr, state_dict=dict,
                               load_state_dict=lambda s: got.update(s), tag="g0")
    assert ck.restore() is True
    assert mgr.step == 3
    np.testing.assert_array_equal(got["w"], 1.0)


def test_complete_multi_file_proc_set_raises(tmp_path):
    for pidx in (0, 1):
        with open(tmp_path / f"g0_step5.proc{pidx}of2.ckpt", "wb") as f:
            PSer.save_state({"torchft": {"step": 5, "batches_committed": 10},
                             "user": {"w": np.zeros(2, np.float32)}}, f)
    ck = PD.DiskCheckpointer(str(tmp_path), _ManagerStub(), state_dict=dict,
                             load_state_dict=lambda s: None, tag="g0")
    assert ck.latest() == str(tmp_path / "g0_step5.proc0of2.ckpt")
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        ck.restore()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_dense_vs_proc_set_same_step_prefers_newer(tmp_path, pkg):
    """A dense file and a complete set at one step: the newer write wins,
    never a stale merge."""
    disk, ser = PACKAGES[pkg]
    mgr = _ManagerStub()
    mgr.step = 5
    state = {"w": np.zeros(4, dtype=np.float32)}
    ck = disk.DiskCheckpointer(str(tmp_path), mgr, state_dict=lambda: dict(state),
                               load_state_dict=lambda s: state.update(s), tag="g0")

    def write(path, w):
        with open(path, "wb") as f:
            ser.save_state({"torchft": mgr.state_dict(), "user": {"w": w}}, f)

    stale = np.full(4, 1.0, dtype=np.float32)
    fresh = np.full(4, 2.0, dtype=np.float32)
    # older: a complete 2-process set; newer: a dense re-save (shrunk to 1)
    write(ck._proc_path(5, 0, 2), stale)
    write(ck._proc_path(5, 1, 2), stale)
    stale_mtime = os.path.getmtime(ck._proc_path(5, 0, 2))
    write(ck._path(5), fresh)
    os.utime(ck._path(5), (stale_mtime + 2, stale_mtime + 2))
    assert ck.latest() == ck._path(5)
    assert ck.restore()
    np.testing.assert_array_equal(state["w"], fresh)

    # the reverse: the dense file older, a 1-process set newer: the set wins
    for p in [ck._path(5), ck._proc_path(5, 0, 2), ck._proc_path(5, 1, 2)]:
        os.remove(p)
    write(ck._path(5), stale)
    stale_mtime = os.path.getmtime(ck._path(5))
    write(ck._proc_path(5, 0, 1), fresh)
    os.utime(ck._proc_path(5, 0, 1), (stale_mtime + 2, stale_mtime + 2))
    assert ck.latest() == ck._proc_path(5, 0, 1)
    assert ck.restore()
    np.testing.assert_array_equal(state["w"], fresh)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_write_generation_beats_mtime(tmp_path, pkg):
    """A later incarnation's write wins by its generation even when the
    mtimes tie or invert."""
    disk, ser = PACKAGES[pkg]
    mgr = _ManagerStub()
    mgr.step = 5

    def write(path, w):
        with open(path, "wb") as f:
            ser.save_state({"torchft": mgr.state_dict(), "user": {"w": w}}, f)

    stale = np.full(4, 1.0, dtype=np.float32)
    fresh = np.full(4, 2.0, dtype=np.float32)
    ck1 = disk.DiskCheckpointer(str(tmp_path), mgr, state_dict=dict,
                                load_state_dict=lambda s: None, tag="g0")
    assert ck1._gen == 0
    write(ck1._proc_path(5, 0, 2), stale)
    write(ck1._proc_path(5, 1, 2), stale)
    state2 = {}
    ck2 = disk.DiskCheckpointer(str(tmp_path), mgr, state_dict=dict,
                                load_state_dict=lambda s: state2.update(s), tag="g0")
    assert ck2._gen == 1
    write(ck2._path(5), fresh)
    old = os.path.getmtime(ck1._proc_path(5, 0, 2)) - 10
    os.utime(ck2._path(5), (old, old))  # the newer write looks older
    assert ck2.latest() == ck2._path(5)
    assert ck2.restore()
    np.testing.assert_array_equal(state2["w"], fresh)
    ck3 = disk.DiskCheckpointer(str(tmp_path), mgr, state_dict=dict,
                                load_state_dict=lambda s: None, tag="g0")
    assert ck3._gen == 2


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_prune_removes_superseded_generations(tmp_path, pkg):
    """A crash-restart loop re-saving at one step keeps one file there, the
    newest generation's."""
    disk, _ = PACKAGES[pkg]
    state = {"w": np.zeros(2, dtype=np.float32)}
    for incarnation in range(3):
        mgr = _ManagerStub()
        ck = disk.DiskCheckpointer(str(tmp_path), mgr, state_dict=lambda: dict(state),
                                   load_state_dict=lambda s: state.update(s), every=1, keep=3,
                                   tag="g0")
        assert ck._gen == incarnation
        ck.restore()
        mgr.step = 5
        ck.save()
    assert _names(tmp_path) == ["g0_step5.g2.ckpt"]


def test_stale_tmp_files_of_the_tag_only_are_cleaned(tmp_path):
    for name in ("g1_step3.ckpt.tmp", "g10_step3.ckpt.tmp"):
        (tmp_path / name).write_bytes(b"partial")
    PD.DiskCheckpointer(str(tmp_path), _ManagerStub(), state_dict=dict,
                        load_state_dict=lambda s: None, tag="g1")
    assert _names(tmp_path, ".tmp") == ["g10_step3.ckpt.tmp"]


# ---------------------------------------------------------------------------
# the files across the packages
# ---------------------------------------------------------------------------


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((8, 4)).astype(np.float32),
                       "b": rng.standard_normal(4).astype(np.float64)},
            "opt": [np.arange(5, dtype=np.int64), (np.float32(2.5), "adam")],
            "sampler": {"epoch": 3, "replica_group": 1}}


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert a == b


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")],
                         ids=["jax-to-port", "port-to-jax"])
def test_files_cross_read(tmp_path, writer, reader):
    """Two incarnations of the writer save steps 2 and 4 (generations 0
    and 1); a fresh reader of the other package restores the newest with
    equal arrays and manager state, claims the next generation, and its own
    save is read back by the writer's package."""
    wdisk, _ = PACKAGES[writer]
    rdisk, _ = PACKAGES[reader]
    for incarnation, step in enumerate((2, 4)):
        mgr = _ManagerStub()
        mgr.step, mgr.batches = step, 3 * step
        state = _tree(step)
        ck = wdisk.DiskCheckpointer(str(tmp_path), mgr, state_dict=lambda s=state: s,
                                    load_state_dict=lambda s: None, tag="group1")
        assert ck._gen == incarnation
        ck.save()
    assert _names(tmp_path) == ["group1_step2.ckpt", "group1_step4.g1.ckpt"]

    mgr = _ManagerStub()
    got = {}
    ck = rdisk.DiskCheckpointer(str(tmp_path), mgr, state_dict=lambda: got,
                                load_state_dict=lambda s: got.update(s), every=1,
                                tag="group1")
    assert ck._gen == 2
    assert ck.restore()
    assert (mgr.step, mgr.batches) == (4, 12)
    _assert_tree_equal(got, _tree(4))

    mgr.step = 5
    assert ck.maybe_save() == str(tmp_path / "group1_step5.g2.ckpt")
    mgr2 = _ManagerStub()
    back = {}
    assert wdisk.DiskCheckpointer(str(tmp_path), mgr2, state_dict=dict,
                                  load_state_dict=lambda s: back.update(s),
                                  tag="group1").restore()
    assert (mgr2.step, mgr2.batches) == (5, 12)
    _assert_tree_equal(back, _tree(4))


def test_tensor_trees_round_trip(tmp_path):
    """A ManagedOptimizer-shaped state (params and Adam state tensors)
    restores exactly, as host tensors of the same dtypes and shapes."""
    torch.manual_seed(0)
    params = {"w": torch.randn(8, 4), "e": torch.randn(16, 8).to(torch.bfloat16)}
    opt = torch.optim.Adam(list(params.values()), lr=1e-3)
    for p in params.values():
        p.grad = torch.randn_like(p)
    opt.step()
    state = {"opt": {"params": params, "opt_state": opt.state_dict()}}
    mgr = _ManagerStub()
    ck = PD.DiskCheckpointer(str(tmp_path), mgr, state_dict=lambda: state,
                             load_state_dict=lambda s: None, every=1, tag="group0")
    mgr.step = 1
    assert ck.maybe_save()
    got = {}
    assert PD.DiskCheckpointer(str(tmp_path), _ManagerStub(), state_dict=dict,
                               load_state_dict=lambda s: got.update(s),
                               tag="group0").restore()
    for k, t in params.items():
        g = got["opt"]["params"][k]
        assert g.dtype == t.dtype and torch.equal(g, t)
    want = opt.state_dict()["state"]
    for i, s in got["opt"]["opt_state"]["state"].items():
        for k, v in s.items():
            assert torch.equal(v, want[i][k]), (i, k)
    assert got["opt"]["opt_state"]["param_groups"] == opt.state_dict()["param_groups"]
