"""Bit-packing for 1-bit synapses and spike vectors.

Wenquxing 22A stores one synaptic row per neuron as 1-bit weights; the
SPU ANDs the incoming spike vector against the row and counts survivors.
32 synapses (or spikes) are packed per 32-bit word.

Convention: bit ``j`` of word ``w`` corresponds to flat index
``w * 32 + j`` (little-endian within the word).  Tail bits past ``n`` are
kept at 0 by every op in this module.

Words are ``torch.int32`` tensors holding u32 bit patterns.  Arithmetic
on them widens to ``int64`` values in ``[0, 2**32)`` (:func:`as_u32`)
and narrows back with :func:`as_i32`.
"""

from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32
MASK32 = 0xFFFFFFFF


def n_words(n_bits: int) -> int:
    """Words needed for ``n_bits`` packed bits."""
    return (n_bits + WORD_BITS - 1) // WORD_BITS


def as_u32(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns (or any ints) -> int64 values in [0, 2**32)."""
    return words.to(torch.int64) & MASK32


def as_i32(values: torch.Tensor) -> torch.Tensor:
    """int64 values (taken mod 2**32) -> int32 bit patterns."""
    v = values & MASK32
    return (v - ((v & 0x80000000) << 1)).to(torch.int32)


def as_words(words, device=None) -> torch.Tensor:
    """A u32 word array (numpy uint32/int32, or a torch int32/uint32
    tensor) -> an int32 bit-pattern tensor on ``device``."""
    if isinstance(words, torch.Tensor):
        t = words.view(torch.int32) if words.dtype == torch.uint32 else words
        if t.dtype != torch.int32:
            raise TypeError(f"word tensors are int32 bit patterns, got "
                            f"{words.dtype}")
        return t.to(device) if device is not None else t
    arr = np.ascontiguousarray(words)
    if arr.dtype not in (np.uint32, np.int32):
        arr = arr.astype(np.uint32)
    t = torch.from_numpy(arr.view(np.int32).copy())
    return t.to(device) if device is not None else t


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern tensor -> numpy uint32 (the JAX layout)."""
    return words.detach().cpu().contiguous().numpy().view(np.uint32)


def pack(bits: torch.Tensor) -> torch.Tensor:
    """Pack a {0,1} tensor (..., n) -> int32 words (..., n_words(n))."""
    n = bits.shape[-1]
    pad = n_words(n) * WORD_BITS - n
    b = bits.to(torch.int64)
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    b = b.reshape(b.shape[:-1] + (-1, WORD_BITS))
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=b.device)
    return as_i32((b << shifts).sum(dim=-1))


def unpack(words: torch.Tensor, n: int) -> torch.Tensor:
    """Unpack int32 words (..., w) -> {0,1} int32 (..., n)."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=words.device)
    bits = (as_u32(words)[..., None] >> shifts) & 1
    flat = bits.reshape(words.shape[:-1] + (-1,))
    return flat[..., :n].to(torch.int32)


def tail_mask(n: int, device=None) -> torch.Tensor:
    """int32[n_words(n)] with ones only in valid bit positions."""
    idx = torch.arange(n_words(n) * WORD_BITS, device=device)
    return pack((idx < n).to(torch.int32))


def _popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each word (SWAR on int64 lanes) -> int64, same shape."""
    x = as_u32(words)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def popcount(words: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Total set bits along ``axis`` (int32)."""
    return _popcount_words(words).sum(dim=axis).to(torch.int32)
