"""Weight banks carried between the JAX package and the port.

Both packages keep a population as packed u32 words ``[n, w]`` and a
class label per neuron.  The JAX package stores the words as uint32
(checkpoints are plain per-leaf ``.npy`` files); the port holds them as
int32 bit patterns on its device.  These functions move a bank across
without changing a bit, so both packages can serve the same weights.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bitpack import as_words, words_to_numpy


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
