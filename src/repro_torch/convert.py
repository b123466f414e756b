"""State carried between the JAX package and the port, as numpy.

Both packages keep a population as packed u32 words ``[n, w]`` and a
class label per neuron, and a register file as (spike, v, LFSR,
weights).  The JAX package stores words as uint32 (checkpoints are
plain per-leaf ``.npy`` files); the port holds them as int32 bit
patterns on its device.  These functions move banks, register files and
trained models across without changing a bit, so both packages can
serve, or go on training, the same state.  Nothing here imports JAX:
the JAX side is read with ``np.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bitpack import as_words, words_to_numpy
from repro_torch.core.rvsnn import SnnRegFile
from repro_torch.core.trainer import SNNModel


def weights_from_jax(weights, neuron_class=None, device=None
                     ) -> tuple[torch.Tensor, np.ndarray | None]:
    """A JAX bank (numpy uint32[n, w], e.g. ``np.asarray`` of the JAX
    array or a checkpoint leaf) -> (int32[n, w] bit patterns on
    ``device``, int32[n] class map or None)."""
    w = np.asarray(weights)
    if w.ndim != 2 or w.dtype != np.uint32:
        raise ValueError(f"weights must be uint32[n, w], got {w.dtype}"
                         f"{list(w.shape)}")
    classes = None
    if neuron_class is not None:
        classes = np.asarray(neuron_class, np.int32)
        if classes.shape != (w.shape[0],):
            raise ValueError(f"neuron_class must be int[{w.shape[0]}], got "
                             f"shape {classes.shape}")
    return as_words(w, device), classes


def weights_to_numpy(weights: torch.Tensor) -> np.ndarray:
    """The port's bank -> numpy uint32[n, w], as the JAX package holds
    it."""
    return words_to_numpy(weights)


def regfile_from_jax(rf, device=None) -> SnnRegFile:
    """A JAX ``SnnRegFile`` (single or batched; any object with numpy-
    convertible ``spike``, ``v``, ``lfsr`` and ``weights``) -> the
    port's, on ``device``."""
    v = np.asarray(rf.v)
    if v.dtype != np.int32:
        raise ValueError(f"v must be int32, got {v.dtype}")
    words = {}
    for name in ("spike", "lfsr", "weights"):
        a = np.asarray(getattr(rf, name))
        if a.dtype != np.uint32:
            raise ValueError(f"{name} must be uint32, got {a.dtype}")
        words[name] = as_words(a, device)
    return SnnRegFile(spike=words["spike"],
                      v=torch.from_numpy(v.copy()).to(device),
                      lfsr=words["lfsr"], weights=words["weights"])


def regfile_to_numpy(rf: SnnRegFile) -> SnnRegFile:
    """The port's register file -> the same fields as numpy, in the JAX
    layout: uint32 spike, LFSR and weights, int32 v."""
    return SnnRegFile(spike=words_to_numpy(rf.spike),
                      v=rf.v.detach().cpu().numpy().astype(np.int32),
                      lfsr=words_to_numpy(rf.lfsr),
                      weights=words_to_numpy(rf.weights))


def model_from_jax(model, cfg=None, device=None) -> SNNModel:
    """A JAX ``SNNModel`` -> the port's, its weights and class map on
    ``device``, with the port's config ``cfg`` (the JAX config class is
    not the port's)."""
    weights, classes = weights_from_jax(np.asarray(model.weights),
                                        np.asarray(model.neuron_class),
                                        device)
    return SNNModel(weights, torch.from_numpy(classes.copy()).to(device),
                    cfg)
