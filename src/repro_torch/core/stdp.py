"""Binary stochastic STDP (paper §2.2, SU = LTP unit + LTD unit).

On a post-synaptic spike of neuron ``i`` (and only then), per 32-synapse
word with one 16-bit LFSR lane per (neuron, word), two LFSR draws:

* **LTP**: if the first draw's low 10 bits are ``<= ltp_prob`` (compared
  as u32), the word takes ``w |= pre``.
* **LTD**: the row popcount ``pc`` of the row AFTER LTP gives the
  homeostatic probability ``clip((pc - w_exp) * gain * 1024 // n_syn,
  0, 1023)``, in wrapping int32 arithmetic; if the second draw's low 10
  bits are at or below it, the word takes ``w &= pre``.

The LFSR advances two steps on fired rows only.  Bit-exact with
``repro.core.stdp``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import lfsr as _lfsr
from repro_torch.core.bitpack import MASK32, as_i32, popcount


class STDPParams(NamedTuple):
    """Plain ints, or tensors that broadcast over the leading (stream)
    axes of :func:`stdp_update`'s operands (a per-stream ``ltp_prob``)."""
    w_exp: int     # effective-synapse budget {128, 256, 512}
    gain: int      # homeostatic gain (LTD slope)
    n_syn: int     # synapses per row (for normalization)
    ltp_prob: int  # 10-bit stochastic-LTP probability (compared as u32)


def stdp_params(n_syn: int, w_exp: int, gain: int = 4,
                ltp_prob: int = 1023) -> STDPParams:
    return STDPParams(int(w_exp), int(gain), int(n_syn), int(ltp_prob))


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> the int32 value of their low 32 bits (as int64)."""
    x = x & MASK32
    return x - ((x & 0x80000000) << 1)


def _per_row(x, like: torch.Tensor) -> torch.Tensor:
    """An int, or a tensor over the leading axes of ``like`` (e.g. one
    value per stream), as int64 broadcastable against ``like``."""
    t = torch.as_tensor(x, dtype=torch.int64, device=like.device)
    return t.reshape(t.shape + (1,) * (like.ndim - t.ndim))


def ltd_prob(row_popcount: torch.Tensor, p: STDPParams) -> torch.Tensor:
    """Homeostatic 10-bit LTD probability per row, int64 in [0, 1023].

    ``(pc - w_exp) * gain * 1024`` wraps in int32, as the JAX package's
    int32 arithmetic does; the division rounds toward minus infinity."""
    pc = row_popcount.to(torch.int64)
    d = _wrap32(pc - _per_row(p.w_exp, pc))
    prod = _wrap32(_wrap32(d * _per_row(p.gain, pc)) * 1024)
    excess = torch.div(prod, _per_row(p.n_syn, pc), rounding_mode="floor")
    return excess.clamp(0, 1023)


def ltd_prob_from_wexp(n_syn: int, w_exp: int, popcount: int | None = None,
                       gain: int = 4) -> int:
    """Scalar helper: the LTD probability of a row with ``popcount`` ON
    synapses (default: all ``n_syn``)."""
    pc = n_syn if popcount is None else popcount
    return int(min(1023, max(0, (pc - w_exp) * gain * 1024 // n_syn)))


def stdp_update(weights: torch.Tensor, pre_spikes: torch.Tensor,
                post_fired: torch.Tensor, lfsr_state: torch.Tensor,
                p: STDPParams) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-pass LTP + LTD row update.  Returns (weights', lfsr').

    weights, lfsr_state int32[..., n, w] (u32 bit patterns and 16-bit
    LFSR lanes), pre_spikes int32[..., w], post_fired bool[..., n]; the
    leading axes (streams) broadcast, and so may tensor-valued fields of
    ``p``.  Only rows whose neuron fired change, weights and LFSR both.
    """
    fired = post_fired[..., None]
    s1, x_ltp = _lfsr.draw10(lfsr_state)
    s2, x_ltd = _lfsr.draw10(s1)
    lfsr_out = torch.where(fired, s2, lfsr_state)

    lp = _per_row(p.ltp_prob, weights[..., 0]) & MASK32
    pre = pre_spikes[..., None, :]
    ltp = torch.where(x_ltp.to(torch.int64) <= lp[..., None],
                      weights | pre, weights)
    prob = ltd_prob(popcount(ltp), p)
    ltd = torch.where(x_ltd.to(torch.int64) <= prob[..., None],
                      ltp & pre, ltp)
    return torch.where(fired, ltd, weights), lfsr_out


def init_weights(n_neurons: int, n_words: int, density_seed: int = 0,
                 dense: bool = True, device=None) -> torch.Tensor:
    """Initial synaptic matrix, int32[n_neurons, n_words] bit patterns.

    ``dense=True`` gives the paper's all-ON rows; ``dense=False`` a ~50%
    random bank drawn from the LFSR (bit-exact with the JAX package).
    """
    if dense:
        return torch.full((n_neurons, n_words), -1, dtype=torch.int32,
                          device=device)
    s = _lfsr.seed(density_seed ^ 0xBEEF, n_neurons * n_words, device)
    s = _lfsr.step(_lfsr.step(s)).to(torch.int64)
    lo = s & 0xFFFF
    hi = (_lfsr.step(s) & 0xFFFF) << 16
    return as_i32(hi | lo).reshape(n_neurons, n_words)
