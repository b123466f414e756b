"""Plain PyTorch versions of the SNN kernels (the per-cycle RV-SNN
instructions and the windows built from them), and the dense attention
reference of the LM slice.

The semantic ground truth of ``kernels/csrc/snn_infer.cu``,
``snn_train.cu`` and ``snn_step.cu``: the CPU tests hold these against
the JAX package, and ``chip_smoke.py`` holds the CUDA kernels against
these on the card.  The step versions take an optional leading stream
axis on every per-stream operand, against a bank per stream or one
shared bank; each window version is a Python loop over cycles on
tensors.  They run on any device.  Words are int32 bit patterns.
"""

from __future__ import annotations

import torch

from repro_torch.core.bitpack import popcount
from repro_torch.core.encoder import encode_windows_host
from repro_torch.core.lif import LIFParams, lif_step as _lif_step
from repro_torch.core.stdp import STDPParams, stdp_update as _stdp_update


def spike_process_ref(spikes: torch.Tensor, weights: torch.Tensor
                      ) -> torch.Tensor:
    """SPU: valid-spike counts.  spikes int32[..., w], weights
    int32[n, w] (shared) or [..., n, w] -> int32[..., n]."""
    return popcount(spikes[..., None, :] & weights)


def lif_step_ref(v: torch.Tensor, count: torch.Tensor, threshold: int,
                 leak: int) -> tuple[torch.Tensor, torch.Tensor]:
    """NU: streamlined LIF.  v, count int32 -> (v' int32, fired bool)."""
    return _lif_step(v, count, LIFParams(threshold, leak))


def stdp_update_ref(weights, pre_spikes, post_fired, lfsr_state,
                    w_exp: int, gain: int, n_syn: int, ltp_prob
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """SU: binary stochastic STDP row update (see ``core/stdp.py``).
    Leading stream axes broadcast: weights and LFSR may be [n, w] (one
    bank shared by every stream of pre_spikes int32[..., w] and
    post_fired bool[..., n]) or [..., n, w]; ``ltp_prob`` may be one per
    stream.  Returns [..., n, w] tensors."""
    lead = torch.broadcast_shapes(pre_spikes.shape[:-1],
                                  post_fired.shape[:-1], weights.shape[:-2],
                                  lfsr_state.shape[:-2])
    weights = weights.expand(lead + weights.shape[-2:])
    lfsr_state = lfsr_state.expand(lead + lfsr_state.shape[-2:])
    return _stdp_update(weights, pre_spikes, post_fired, lfsr_state,
                        STDPParams(w_exp, gain, n_syn, ltp_prob))


def fused_snn_step_ref(weights, pre_spikes, v, lfsr_state, teach,
                       threshold: int, leak: int, w_exp: int, gain: int,
                       n_syn: int, ltp_prob, train: bool = True):
    """SNNU: one fused spike -> neuron -> synapse cycle.

    Returns (weights', v', fired bool, lfsr').  ``teach`` may be None;
    ``train=False`` leaves the SU idle (weights and LFSR pass through).
    Operands take a leading stream axis as in :func:`stdp_update_ref`.
    """
    counts = spike_process_ref(pre_spikes, weights)
    if teach is not None:
        counts = counts + teach
    v2, fired = lif_step_ref(v, counts, threshold, leak)
    if not train:
        return weights, v2, fired, lfsr_state
    w2, lf2 = stdp_update_ref(weights, pre_spikes, fired, lfsr_state,
                              w_exp, gain, n_syn, ltp_prob)
    return w2, v2, fired, lf2


def _window_ref(weights, spike_trains, v, lfsr_state, teach, threshold,
                leak, w_exp, gain, n_syn, ltp_prob, train):
    """T fused cycles over B streams (leading axis of every operand)."""
    b, t_steps, _ = spike_trains.shape
    rasters = []
    for t in range(t_steps):
        weights, v, fired, lfsr_state = fused_snn_step_ref(
            weights, spike_trains[:, t], v, lfsr_state, teach, threshold,
            leak, w_exp, gain, n_syn, ltp_prob, train)
        rasters.append(fired)
    fired = (torch.stack(rasters, dim=1) if rasters else
             torch.zeros((b, 0, v.shape[-1]), dtype=torch.bool,
                         device=v.device))
    return weights, v, fired, lfsr_state


def fused_snn_window_ref(weights, spike_train, v, lfsr_state, teach,
                         threshold: int, leak: int, w_exp: int, gain: int,
                         n_syn: int, ltp_prob, train: bool = True):
    """T sequential fused cycles on one stream (the window kernels'
    ground truth).  spike_train int32[T, w].  Returns (weights', v',
    fired bool[T, n], lfsr'); with ``train=False`` weights and LFSR are
    the inputs."""
    w2, v2, fired, lf2 = _window_ref(
        weights[None], spike_train[None], v[None], lfsr_state[None],
        teach[None], threshold, leak, w_exp, gain, n_syn, ltp_prob, train)
    if not train:
        return weights, v2[0], fired[0], lfsr_state
    return w2[0], v2[0], fired[0], lf2[0]


def train_window_batch_ref(weights, spike_trains, v, lfsr_state, teach,
                           threshold: int, leak: int, w_exp: int,
                           gain: int, n_syn: int, ltp_prob):
    """B independent training streams: weights, lfsr int32[B, n, w],
    spike_trains int32[B, T, w], v, teach int32[B, n]; ``ltp_prob`` an
    int or one value per stream.  Stream b is exactly one
    :func:`fused_snn_window_ref` run.  Returns (weights', v', fired
    bool[B, T, n], lfsr')."""
    lp = torch.as_tensor(ltp_prob, dtype=torch.int64,
                         device=weights.device).expand(weights.shape[0])
    return _window_ref(weights, spike_trains, v, lfsr_state, teach,
                       threshold, leak, w_exp, gain, n_syn, lp, True)


def fused_snn_window_encode_ref(weights, intensities, seed, v, lfsr_state,
                                teach, n_steps: int, threshold: int,
                                leak: int, w_exp: int, gain: int,
                                n_syn: int, ltp_prob, train: bool = True):
    """Encode-fused window: host-encode, then :func:`fused_snn_window_ref`.
    intensities uint8[n_in], seed an int or a one-element tensor."""
    win = encode_windows_host(seed, intensities[None], n_steps,
                              weights.shape[1])[0]
    return fused_snn_window_ref(weights, win, v, lfsr_state, teach,
                                threshold, leak, w_exp, gain, n_syn,
                                ltp_prob, train)


def train_window_batch_encode_ref(weights, intensities, seeds, v,
                                  lfsr_state, teach, n_steps: int,
                                  threshold: int, leak: int, w_exp: int,
                                  gain: int, n_syn: int, ltp_prob):
    """Encode-fused batched training: host-encode every stream, then
    :func:`train_window_batch_ref`.  intensities uint8[B, n_in]."""
    wins = encode_windows_host(seeds, intensities, n_steps,
                               weights.shape[2])
    return train_window_batch_ref(weights, wins, v, lfsr_state, teach,
                                  threshold, leak, w_exp, gain, n_syn,
                                  ltp_prob)


def train_stream_batch_encode_ref(weights, intensities, seeds, lfsr_state,
                                  teach, n_steps: int, threshold: int,
                                  leak: int, w_exp: int, gain: int,
                                  n_syn: int, ltp_prob):
    """B training streams of N samples: N :func:`train_window_batch_encode_ref`
    windows, each from v = 0, weights and LFSR carried.  intensities
    uint8[N, B, n_in], seeds int32[N, B], teach int32[N, B, n].  Returns
    (weights', v' of the last sample, counts int32[N, B, n], lfsr')."""
    v = torch.zeros(weights.shape[:2], dtype=torch.int32,
                    device=weights.device)
    counts = []
    for x, sd, tch in zip(intensities, seeds, teach):
        weights, v, fired, lfsr_state = train_window_batch_encode_ref(
            weights, x, sd, torch.zeros_like(v), lfsr_state, tch, n_steps,
            threshold, leak, w_exp, gain, n_syn, ltp_prob)
        counts.append(fired.sum(dim=1, dtype=torch.int32))
    counts = (torch.stack(counts) if counts else
              torch.zeros((0,) + tuple(v.shape), dtype=torch.int32,
                          device=v.device))
    return weights, v, counts, lfsr_state


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


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int | None = None,
                  scale: float | None = None, *,
                  masked_rows_zero: bool = False) -> torch.Tensor:
    """Dense reference attention.

    q: [B, Hq, Tq, D]; k, v: [B, Hkv, Tk, D] (GQA: Hq % Hkv == 0).
    Queries are the last Tq positions of the Tk-long stream; window:
    sliding-window size (keys within [i - window + 1, i]).  Masked scores
    are -inf, so a row masked everywhere gives NaN.  ``masked_rows_zero``
    masks as the flash kernel does instead: scores start at -1e30, p is
    masked again after the exponential, and l == 0 reads as 1, so such a
    row gives zeros.
    """
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qg = (q.float() * scale).reshape(b, hkv, hq // hkv, tq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    qpos = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
    kpos = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    if not masked_rows_zero:
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
        return o.reshape(b, hq, tq, d).to(q.dtype)
    s = s.masked_fill(~mask, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    o = o / torch.where(l == 0.0, 1.0, l)
    return o.reshape(b, hq, tq, d).to(q.dtype)
