"""The port's checkpoint manager against the JAX package's.

Both write the same directory, byte for byte: per-leaf ``.npy`` files
named by the leaf's path, a ``manifest.json`` (leaf files, shapes,
dtypes, the tree's structure in JAX's ``PyTreeDef`` notation) and the
tmp-then-rename commit.  A checkpoint that one package wrote restores
bit-exact in the other, ``SnnRegFile`` dtypes included (``uint32``
words, ``int32`` membrane), and a torn ``step_N.tmp`` is ignored and
purged alike.  Every comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.core.rvsnn import snn_regfile as jsnn_regfile
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.checkpointer import treedef_str
from repro_torch.convert import regfile_from_jax
from repro_torch.core.rvsnn import SnnRegFile


def _jregfile(seed=0x22A, n=6, w=3):
    rng = np.random.default_rng(seed)
    return jsnn_regfile(jnp.asarray(rng.integers(0, 2**32, (n, w),
                                                 dtype=np.uint32)),
                        seed=seed)


def _tree(rf):
    """A tree with every node kind: dict, NamedTuple, list, tuple, None,
    tensors or arrays, and scalars."""
    return {"rf": rf, "step": np.int64(7),
            "hist": [np.float64(1.5), None, (np.arange(4, dtype=np.int32),)],
            "acc": np.float64(float("nan"))}


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def test_same_tree_writes_the_same_bytes(tmp_path):
    jrf = _jregfile()
    JManager(tmp_path / "j", async_save=False).save(3, _tree(jrf))
    mgr = CheckpointManager(tmp_path / "t")
    mgr.save(3, _tree(regfile_from_jax(jrf)))     # async, then wait
    mgr.wait()
    jfiles = _files(tmp_path / "j" / "step_3")
    assert _files(tmp_path / "t" / "step_3") == jfiles
    assert set(jfiles) >= {"manifest.json", "rf__weights.proc0.npy",
                           "hist__2__0.proc0.npy"}


@pytest.mark.parametrize("tree", [
    {"weights": 1, "probe_accuracy": 2},
    {"a": [1, 2], "b": (3, {"c": 4}), "d": None},
    [1, (2,), ()],
    7])
def test_treedef_notation_equals_jax(tree):
    assert treedef_str(tree) == str(jax.tree.structure(tree))
    rf = _jregfile()
    assert treedef_str({"x": regfile_from_jax(rf)}) == \
        str(jax.tree.structure({"x": rf}))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_regfile_restores_bit_exact_across_packages(tmp_path, writer):
    jrf = _jregfile(5)
    trf = regfile_from_jax(jrf)
    if writer == "jax":
        JManager(tmp_path, async_save=False).save(1, jrf)
        got, step = CheckpointManager(tmp_path).restore(None, trf)
        assert isinstance(got, SnnRegFile) and step == 1
        for name in SnnRegFile._fields:
            assert torch.equal(getattr(got, name), getattr(trf, name)), name
        assert got.weights.dtype == got.v.dtype == torch.int32
    else:
        mgr = CheckpointManager(tmp_path, async_save=False)
        mgr.save(1, trf)
        got, step = JManager(tmp_path).restore(None, jrf)
        for name in SnnRegFile._fields:
            np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                          np.asarray(getattr(jrf, name)))
        assert np.asarray(got.weights).dtype == np.uint32
        assert np.asarray(got.v).dtype == np.int32
    man = (tmp_path / "step_1" / "manifest.json").read_text()
    assert '"rf' not in man and '"weights": {"file": "weights.proc0.npy"' \
        in man and '"dtype": "uint32"' in man


def test_restore_lands_on_the_callers_side(tmp_path):
    """A leaf whose like is a tensor comes back a tensor on the like's
    device (words as int32 bit patterns); any other leaf as numpy."""
    mgr = CheckpointManager(tmp_path, async_save=False)
    trf = regfile_from_jax(_jregfile())
    mgr.save(2, {"rf": trf, "acc": np.float64(0.25),
                 "t": torch.tensor([1.5, 2.5], dtype=torch.float64)})
    like = {"rf": trf, "acc": np.float64(0), "t": torch.zeros(2,
                                                    dtype=torch.float64)}
    got, _ = mgr.restore(2, like)
    assert isinstance(got["acc"], np.ndarray) and got["acc"] == 0.25
    assert got["rf"].lfsr.device.type == "cpu"
    assert got["rf"].lfsr.dtype == torch.int32
    assert torch.equal(got["t"], like["t"] + torch.tensor([1.5, 2.5],
                                                           dtype=torch.float64))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(None, like)


@pytest.mark.parametrize("with_manifest", [False, True])
def test_torn_tmp_is_ignored_and_purged_like_jax(tmp_path, with_manifest):
    """A crash mid-write leaves ``step_N.tmp``: never listed, never
    restored, purged — in both packages' view of one directory."""
    trf = regfile_from_jax(_jregfile(1))
    mgr = CheckpointManager(tmp_path, keep=4, async_save=False)
    mgr.save(1, trf)
    mgr.save(2, trf._replace(v=trf.v + 1))
    tmp = tmp_path / "step_3.tmp"
    tmp.mkdir()
    (tmp / "weights.proc0.npy").write_bytes(b"\x93NUMPY torn")
    if with_manifest:
        (tmp / "manifest.json").write_text('{"step": 3}')
    jmgr = JManager(tmp_path, keep=4)
    assert mgr.all_steps() == jmgr.all_steps() == [1, 2]
    assert mgr.latest_step() == 2
    got, step = mgr.restore(None, trf)
    assert step == 2 and torch.equal(got.v, trf.v + 1)
    assert mgr.purge_tmp() == ["step_3.tmp"] and mgr.purge_tmp() == []
    assert jmgr.all_steps() == [1, 2]


def test_keep_k_rotation_and_rewrite_of_a_step(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    jmgr = JManager(tmp_path / "j", keep=2, async_save=False)
    for s in range(5):
        tree = {"w": np.full((2, 2), s, np.uint32)}
        mgr.save(s, tree)
        jmgr.save(s, tree)
    mgr.wait()
    assert mgr.all_steps() == jmgr.all_steps() == [3, 4]
    mgr.save(4, {"w": np.full((2, 2), 9, np.uint32)})
    mgr.wait()
    got, _ = mgr.restore(4, {"w": np.zeros((2, 2), np.uint32)})
    assert (got["w"] == 9).all() and got["w"].dtype == np.uint32
