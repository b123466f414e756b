"""Plain PyTorch versions of the serving kernels.

The semantic ground truth of ``kernels/csrc/snn_infer.cu``: the CPU
tests hold these against the JAX package, and ``chip_smoke.py`` holds
the CUDA kernels against these on the card.  They run on any device.
"""

from __future__ import annotations

import torch

from repro_torch.core.bitpack import popcount
from repro_torch.core.encoder import encode_windows_host
from repro_torch.core.lif import LIFParams, lif_step as _lif_step


def spike_process_ref(spikes: torch.Tensor, weights: torch.Tensor
                      ) -> torch.Tensor:
    """SPU: valid-spike counts.  spikes int32[..., w], weights
    int32[n, w] -> int32[..., n]."""
    return popcount(spikes[..., None, :] & weights)


def lif_step_ref(v: torch.Tensor, count: torch.Tensor, threshold: int,
                 leak: int) -> tuple[torch.Tensor, torch.Tensor]:
    """NU: streamlined LIF.  v, count int32 -> (v' int32, fired bool)."""
    return _lif_step(v, count, LIFParams(threshold, leak))


def infer_window_batch_ref(weights: torch.Tensor,
                           spike_trains: torch.Tensor, threshold: int,
                           leak: int) -> torch.Tensor:
    """Serving version: spike counts int32[B, n] for spike_trains
    int32[B, T, w], weights frozen, membrane reset per sample."""
    b, t_steps, _ = spike_trains.shape
    n = weights.shape[0]
    v = torch.zeros((b, n), dtype=torch.int32, device=weights.device)
    acc = torch.zeros_like(v)
    for t in range(t_steps):
        counts = spike_process_ref(spike_trains[:, t], weights)
        v, fired = lif_step_ref(v, counts, threshold, leak)
        acc += fired.to(torch.int32)
    return acc


def infer_window_batch_encode_ref(weights: torch.Tensor,
                                  intensities: torch.Tensor, seeds,
                                  n_steps: int, threshold: int, leak: int,
                                  t_total=None) -> torch.Tensor:
    """Encode-fused serving version (ragged lengths via ``t_total``):
    host-encode with the zero mask, then :func:`infer_window_batch_ref`.
    Equal in counts to the kernel, which stops each sample at its
    ``t_total``, for any ``threshold >= 1``."""
    wins = encode_windows_host(seeds, intensities, n_steps,
                               weights.shape[1], t_total)
    return infer_window_batch_ref(weights, wins, threshold, leak)
