"""The port's checkpoint manager (`repro_torch.train.checkpoint`), case for
case with tests/test_checkpoint.py: round trip, atomicity, keep-last-k,
the asynchronous save, a given step, a missing directory; here the
reference's elastic restore case restores onto a given device (its
`shardings=` counterpart is tested in tests/test_torch_sharded.py).  Then
parity with
`repro.train.checkpoint`: the same tree gives the same leaf files, in the
same order, and the manifest holds the tree's structure as JSON."""
import json
import os

import numpy as np
import pytest
import torch

from repro.train.checkpoint import CheckpointManager as RefCheckpointManager
from repro_torch.train import CheckpointManager


@pytest.fixture()
def tree():
    gen = torch.Generator().manual_seed(0)
    return {
        "params": {"w": torch.randn((8, 4), generator=gen), "b": torch.zeros(4)},
        "opt": {"m": torch.ones((8, 4)), "step": torch.tensor(7, dtype=torch.int32)},
        "hist": (np.arange(3, dtype=np.float64), [torch.tensor([1.5]), 2]),
    }


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, (tuple, list)):
        return [x for v in t for x in _leaves(v)]
    return [t]


def _assert_tree_equal(a, b):
    assert type(a) is type(b) or not isinstance(a, (dict, tuple, list))
    if isinstance(a, dict):
        assert list(sorted(a)) == list(sorted(b))
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_roundtrip(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(5, tree)
    step, restored = mgr.restore()
    assert step == 5
    _assert_tree_equal(tree, restored)
    assert isinstance(restored["hist"], tuple) and isinstance(restored["hist"][1], list)


def test_async_save(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, tree, blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 1


def test_keep_last_k(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.all_steps() == [3, 4]


def test_atomicity_tmp_dirs_ignored(tmp_path, tree):
    """A crash mid-write (a leftover .tmp directory) is invisible."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, tree)
    crashed = os.path.join(str(tmp_path), "step_00000009.tmp")
    os.makedirs(crashed)
    with open(os.path.join(crashed, "arr_0.npy"), "w") as f:
        f.write("garbage")
    assert mgr.latest_step() == 1
    step, restored = mgr.restore()
    assert step == 1
    _assert_tree_equal(tree, restored)


def test_corrupt_unpublished_manifest_ignored(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(2, tree)
    os.makedirs(os.path.join(str(tmp_path), "step_00000005"))  # no manifest: unreadable
    assert mgr.latest_step() == 2


def test_restore_specific_step(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, tree)
    tree2 = {**tree, "params": {k: v + 1 for k, v in tree["params"].items()}}
    mgr.save(2, tree2)
    step, restored = mgr.restore(step=1)
    assert step == 1
    _assert_tree_equal(tree, restored)


def test_restore_onto_device(tmp_path, tree):
    """The port's counterpart of the reference's elastic restore: every leaf
    comes back as a tensor on the device asked for."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(3, tree)
    step, restored = mgr.restore(device="cpu")
    assert step == 3
    _assert_tree_equal(tree, restored)
    assert all(isinstance(x, torch.Tensor) and x.device == torch.device("cpu")
               for x in _leaves(restored))


def test_missing_dir_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "empty"), keep=1)
    with pytest.raises(FileNotFoundError):
        mgr.restore()


def test_leaf_files_match_reference(tmp_path):
    """The same tree of arrays saved by both packages: the same number of
    leaf files, each the same array (dtype, shape, bytes), in the same
    order (dict entries by sorted key)."""
    rng = np.random.default_rng(0)
    tree = {"facs": (rng.standard_normal((5, 4)).astype(np.float32),
                     rng.standard_normal((3, 4)).astype(np.float32)),
            "fits": np.asarray([0.1, 0.2], np.float64), "lane_ranks": np.asarray([4, 4], np.int64)}
    RefCheckpointManager(str(tmp_path / "ref")).save(3, tree)
    CheckpointManager(str(tmp_path / "port")).save(3, {k: v for k, v in tree.items()})
    ref_dir, port_dir = tmp_path / "ref" / "step_00000003", tmp_path / "port" / "step_00000003"
    ref_files = sorted(p.name for p in ref_dir.iterdir())
    assert ref_files == sorted(p.name for p in port_dir.iterdir())
    for name in ref_files:
        if name.endswith(".npy"):
            a, b = np.load(ref_dir / name), np.load(port_dir / name)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    ref_meta = json.loads((ref_dir / "manifest.json").read_text())
    meta = json.loads((port_dir / "manifest.json").read_text())
    for key in ("step", "nleaves", "dtypes", "shapes"):
        assert meta[key] == ref_meta[key], key
    assert "treedef" not in meta  # the structure is JSON, not a pickle
    assert meta["tree"] == {"dict": [["facs", {"tuple": [None, None]}], ["fits", None],
                                     ["lane_ranks", None]]}


def test_tree_keys_must_be_str_or_int(tmp_path):
    with pytest.raises(TypeError, match="keys"):
        CheckpointManager(str(tmp_path)).save(0, {(1, 2): torch.zeros(1)})
