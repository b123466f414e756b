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
:class:`~repro_torch.core.rvsnn.SnnRegFile`.  A restore returns each
leaf whose ``like`` is a tensor as a tensor on the like's device (a
``uint32`` file as int32 bit patterns); any other leaf comes back as a
numpy array.
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.bitpack import as_words
from repro_torch.core.rvsnn import SnnRegFile

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
        arr = leaf.detach().cpu().numpy()
        if words and arr.dtype == np.int32:
            arr = arr.view(np.uint32)
        return np.array(arr)        # owned: the thread never sees a view
    return np.array(np.asarray(leaf))


def _place(arr: np.ndarray, like):
    """A restored leaf on the caller's side (see the module docstring)."""
    if not isinstance(like, torch.Tensor):
        return arr
    if arr.dtype == np.uint32:
        return as_words(arr, like.device)
    return torch.from_numpy(arr).to(like.device)


class CheckpointManager:
    def __init__(self, directory: str | Path, *, keep: int = 3,
                 async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._pending: threading.Thread | None = None

    # --- save ------------------------------------------------------------

    def save(self, step: int, tree) -> None:
        """Snapshot ``tree`` at ``step`` (see the module docstring)."""
        self.wait()  # back-pressure: at most one in-flight save
        host = {key: _to_host(leaf, words)
                for key, leaf, words in _flatten(tree)}
        treedef = treedef_str(tree)

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
                    "dtype": str(arr.dtype)}
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
        if self._pending is not None:
            self._pending.join()
            self._pending = None

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

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None, like_tree):
        """Load ``step`` (or the latest): ``(tree, step)``.  ``like_tree``
        gives the structure and where each leaf lands."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        leaves = [_place(np.load(d / manifest["leaves"][key]["file"]), like)
                  for key, like, _ in _flatten(like_tree)]
        return _unflatten(like_tree, leaves), step
