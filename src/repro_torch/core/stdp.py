"""Binary stochastic STDP: the parameters and the initial weight bank.

Only what serving needs is here; the row update (``stdp_update``) comes
with the training kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import lfsr as _lfsr
from repro_torch.core.bitpack import as_i32


class STDPParams(NamedTuple):
    w_exp: int     # effective-synapse budget {128, 256, 512}
    gain: int      # homeostatic gain (LTD slope)
    n_syn: int     # synapses per row (for normalization)
    ltp_prob: int  # 10-bit stochastic-LTP probability


def stdp_params(n_syn: int, w_exp: int, gain: int = 4,
                ltp_prob: int = 1023) -> STDPParams:
    return STDPParams(int(w_exp), int(gain), int(n_syn), int(ltp_prob))


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
