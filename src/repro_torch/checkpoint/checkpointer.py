"""Checkpoint manager: async, atomic, keep-k, per-leaf ``.npy`` files.

The on-disk layout is the JAX package's (``repro.checkpoint``), so a
directory one package wrote restores in the other:

* **Atomicity** — writes land in ``step_N.tmp/`` and are renamed to
  ``step_N/`` only once every file is written; a crash mid-write never
  corrupts the latest checkpoint.  Restore picks the newest *complete*
  step (one with a ``manifest.json``, not ``.tmp``).
* **Async** — ``save`` copies every leaf to host numpy in the caller's
  thread (a tensor on the card is read there, ordered on its stream),
  then hands the file I/O to a background thread that touches only
  those host copies; the caller blocks only on the previous save.
* **Layout** — one ``<leaf>.proc0.npy`` per leaf, the leaf's path
  joined with ``__``, and ``manifest.json`` naming each leaf's file,
  shape and dtype, plus the tree's structure in the JAX package's
  ``PyTreeDef`` notation.
* **keep-k rotation** — old steps are deleted after a successful save.

Trees are dicts (flattened in sorted key order), NamedTuples, lists and
tuples (in order), ``None`` (no leaves), and leaves: tensors, numpy
arrays and scalars.  Packed u32 words, which the port holds as int32
bit patterns, are written as ``uint32`` where the JAX package writes
``uint32``: the ``spike``, ``lfsr`` and ``weights`` fields of an
:class:`~repro_torch.core.rvsnn.SnnRegFile`.  A bfloat16 leaf is written
as numpy writes the JAX package's (2-byte void, manifest dtype
``bfloat16``).  A restore returns each leaf whose ``like`` is a tensor
as a tensor on the like's device (a ``uint32`` file as int32 bit
patterns, a bfloat16 one as bfloat16); any other leaf comes back as a
numpy array.

Sharded state: a DTensor leaf is saved as its full array (gathered on
every rank; every rank calls ``save``, rank 0 writes), so its bytes are
an unsharded save's and checkpoints still cross packages.  A restore
places each leaf as a ``placements_tree`` says (lists of DTensor
placements at the leaves' places, on ``mesh``: the elastic re-layout,
the JAX package's ``sharding_tree``), or, without one, as its DTensor
``like`` is placed; every rank reads the whole file and keeps its shard.
Every rank of the default process group takes part, in the same order:
``wait`` after a sharded save is a barrier that every rank passes only
once rank 0's write (and its keep-k rotation) has landed, and the latest
step of a sharded restore is rank 0's, broadcast, so the ranks never
restore different steps.
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Placement, distribute_tensor

from repro_torch.core.bitpack import as_words
from repro_torch.core.rvsnn import SnnRegFile
from repro_torch.distributed.sharding import is_dtensor as _is_dtensor

# a bfloat16 leaf's file: its 2-byte patterns as numpy void, the layout
# numpy gives the JAX package's bfloat16 arrays (manifest dtype
# "bfloat16")
_BF16_FILE = np.dtype("V2")

# the fields of a tree node type that hold packed u32 words
_WORD_FIELDS = {SnnRegFile: frozenset({"spike", "lfsr", "weights"})}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, path=(), words=False) -> list[tuple[str, object, bool]]:
    """(key, leaf, holds u32 words) for every leaf, in the JAX package's
    ``tree_flatten_with_path`` order and key spelling."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _flatten(tree[k], path + (str(k),))]
    if _is_namedtuple(tree):
        wf = _WORD_FIELDS.get(type(tree), frozenset())
        return [leaf for name in tree._fields
                for leaf in _flatten(getattr(tree, name), path + (name,),
                                     name in wf)]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, x in enumerate(tree)
                for leaf in _flatten(x, path + (str(i),))]
    return [("/".join(path), tree, words)]


def treedef_str(tree) -> str:
    """The tree's structure as ``str(jax.tree.structure(tree))`` spells
    it (the manifest's ``treedef``)."""
    def node(t) -> str:
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {node(t[k])}"
                                   for k in sorted(t)) + "}"
        if _is_namedtuple(t):
            return (f"CustomNode(namedtuple[{type(t).__name__}], ["
                    + ", ".join(node(x) for x in t) + "])")
        if isinstance(t, list):
            return "[" + ", ".join(node(x) for x in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(node(x) for x in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "*"
    return f"PyTreeDef({node(tree)})"


def _unflatten(like, leaves: list):
    """Rebuild ``like``'s structure from its leaves in flatten order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)
    return build(like)


def _to_host(leaf, words: bool) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if _is_dtensor(t):
            t = t.full_tensor()
        host = t.cpu()
        if host.dtype == torch.bfloat16:
            arr = host.view(torch.int16).numpy().view(_BF16_FILE)
        else:
            arr = host.numpy()
        if words and arr.dtype == np.int32:
            arr = arr.view(np.uint32)
        # owned: the thread never sees a view (a card's copy already is)
        return arr if t.device.type != "cpu" else np.array(arr)
    return np.array(np.asarray(leaf))


def _place(arr: np.ndarray, like, placements=None, mesh=None):
    """A restored leaf on the caller's side (see the module docstring)."""
    if not isinstance(like, torch.Tensor):
        return arr
    if arr.dtype == np.uint32:
        t = as_words(arr, like.device)
    elif arr.dtype == _BF16_FILE:
        t = torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(like.device)
    else:
        t = torch.from_numpy(arr).to(like.device)
    if placements is None and _is_dtensor(like):
        placements, mesh = like.placements, like.device_mesh
    if placements is None:
        return t
    return distribute_tensor(t, mesh, list(placements), src_data_rank=None)


def _is_placements(x) -> bool:
    return isinstance(x, (list, tuple)) and bool(x) and all(
        isinstance(p, Placement) for p in x)


def _flatten_placements(tree, path=()) -> dict:
    """key -> placements for a tree shaped as a state tree whose leaves
    are lists of DTensor placements (keys spelled as ``_flatten``'s)."""
    if tree is None:
        return {}
    if _is_placements(tree):
        return {"/".join(path): tree}
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _flatten_placements(tree[key],
                                                path + (str(key),)).items()}
    if _is_namedtuple(tree):
        return {k: v for name in tree._fields
                for k, v in _flatten_placements(getattr(tree, name),
                                                path + (name,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree)
                for k, v in _flatten_placements(x, path + (str(i),)).items()}
    return {}


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _sharded(tree, placements_tree=None) -> bool:
    """Whether ``tree`` (or a placements tree) lays state out over more
    than one rank: its save and restore then take every rank."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return False
    return bool(_flatten_placements(placements_tree)) or any(
        _is_dtensor(leaf) for _, leaf, _ in _flatten(tree))


class CheckpointManager:
    def __init__(self, directory: str | Path, *, keep: int = 3,
                 async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._pending: threading.Thread | None = None
        # a sharded save was made: the next wait() is a barrier
        self._meet = False

    # --- save ------------------------------------------------------------

    def save(self, step: int, tree) -> None:
        """Snapshot ``tree`` at ``step`` (see the module docstring)."""
        self.wait()  # back-pressure: at most one in-flight save
        leaves = _flatten(tree)
        host = {key: _to_host(leaf, words) for key, leaf, words in leaves}
        treedef = treedef_str(tree)
        if _sharded(tree):
            self._meet = True
            if _rank():
                return  # the gather above took every rank; rank 0 writes

        def write():
            tmp = self.dir / f"step_{step}.tmp"
            final = self.dir / f"step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {"step": step, "leaves": {}}
            for key, arr in host.items():
                fname = key.replace("/", "__") + ".proc0.npy"
                np.save(tmp / fname, arr)
                manifest["leaves"][key] = {
                    "file": fname, "shape": list(arr.shape),
                    "dtype": ("bfloat16" if arr.dtype == _BF16_FILE
                              else str(arr.dtype))}
            manifest["treedef"] = treedef
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            self._rotate()

        if self.async_save:
            self._pending = threading.Thread(target=write, daemon=True)
            self._pending.start()
        else:
            write()

    def wait(self) -> None:
        """Block until the save in flight has landed; after a sharded
        save, on every rank (a barrier behind rank 0's write)."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._meet:
            self._meet = False
            dist.barrier()

    def purge_tmp(self) -> list[str]:
        """Remove ``step_N.tmp/`` droppings left by writers that died
        mid-save (a crash before the atomic rename).  Returns the purged
        directory names.  Waits for a save in flight first."""
        self.wait()
        purged = []
        for p in self.dir.glob("step_*.tmp"):
            if p.is_dir():
                shutil.rmtree(p, ignore_errors=True)
                purged.append(p.name)
        return purged

    def _rotate(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # --- restore ---------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            try:
                out.append(int(p.name.split("_")[1]))
            except ValueError:
                continue
        return sorted(out)

    def latest_step(self, like_tree=None, placements_tree=None
                    ) -> int | None:
        """The newest complete step, or None.  For a sharded
        ``like_tree`` or a placements tree (see the module docstring)
        every rank calls it and gets rank 0's answer, read once a save in
        flight has landed."""
        if not _sharded(like_tree, placements_tree):
            steps = self.all_steps()
            return steps[-1] if steps else None
        self.wait()
        got = [self.latest_step() if _rank() == 0 else None]
        dist.broadcast_object_list(got, src=0)
        return got[0]

    def restore(self, step: int | None, like_tree, placements_tree=None,
                mesh=None):
        """Load ``step`` (or the latest): ``(tree, step)``.  ``like_tree``
        gives the structure and where each leaf lands; ``placements_tree``
        (optional, with its ``mesh``: default the ``use_mesh`` context's)
        re-lays-out every leaf it names as a DTensor (see the module
        docstring)."""
        if step is None:
            step = self.latest_step(like_tree, placements_tree)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        placed = _flatten_placements(placements_tree)
        if placed and mesh is None:
            from repro_torch.distributed.sharding import current_mesh
            ctx = current_mesh()
            if ctx is None:
                raise ValueError("a placements tree needs a mesh (mesh= or "
                                 "use_mesh)")
            mesh = ctx[0]
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        leaves = [_place(np.load(d / manifest["leaves"][key]["file"]), like,
                         placed.get(key), mesh)
                  for key, like, _ in _flatten(like_tree)]
        return _unflatten(like_tree, leaves), step
