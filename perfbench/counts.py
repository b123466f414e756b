"""Operations and bytes that the cells' work needs, and the card's peaks.

The yardstick of the model's utilization and of the kernels' rooflines.
It counts what the inputs need: the experts at top-k (not the capacity
padding the port computes), the (query, key) pairs the masks leave, the
head at the positions whose logits are computed, every weight byte read
once.  Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense bf16.

Hand-worked figures (tests hold the functions to them):

* mixtral-8x22b-8L, per layer: attention 6144 x (48 + 2 x 8) x 128 +
  48 x 128 x 6144 = 88,080,384 parameters; router 6144 x 8 = 49,152;
  two of the eight experts 2 x 3 x 6144 x 16384 = 603,979,776; active
  692,109,312, and 5,536,874,496 over 8 layers.  Head 6144 x 32768 =
  201,326,592.
  - A prefill of 1,024 tokens: 2 x 5,536,874,496 x 1,024 =
    11,339,518,967,808; attention 8 layers x 4 x 48 x 128 x 524,800
    pairs (1024 x 1025 / 2, the window of 4,096 cuts none) =
    103,179,878,400; the head at the last position 2 x 201,326,592 =
    402,653,184; together 11,443,101,499,392 FLOPs.
  - A decode step of 32 live slots attending 1,152 keys each: per slot
    2 x 5,536,874,496 + 8 x 4 x 48 x 128 x 1,152 + 2 x 201,326,592 =
    11,702,894,592; 374,492,626,944 FLOPs.
  - The experts of one decode layer: 8 x 3 x 6144 x 16384 x 2 bytes =
    4,831,838,208 bytes, 1.4423 ms at 3.35 TB/s; 32 tokens x 2 x 3 x 2
    x 6144 x 16384 = 38,654,705,664 FLOPs, 0.0391 ms at 989 TFLOP/s:
    the bound is the bytes'.
* grok-1-314b-4L, per layer: attention 88,080,384; router 49,152; two
  experts 2 x 3 x 6144 x 32768 = 1,207,959,552; active 1,296,089,088,
  and 5,184,356,352 over 4 layers.  Head 6144 x 131072 = 805,306,368.
  - A prefill of 6,144 tokens: 2 x 5,184,356,352 x 6,144 =
    63,705,370,853,376; attention 4 x 4 x 48 x 128 x 18,877,440 pairs =
    1,855,727,861,760; head 1,610,612,736; together
    65,562,709,327,872 FLOPs.
  - A decode step of 4 live slots attending 6,160 keys each: per slot
    10,368,712,704 + 605,552,640 + 1,610,612,736 = 12,584,878,080;
    50,339,512,320 FLOPs.
  - The experts of one decode layer: 9,663,676,416 bytes, 2.8847 ms.
"""

from __future__ import annotations

import numpy as np

PEAK_FLOPS = 989e12          # bf16 dense, tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2


def unmasked_pairs(tq: int, tk: int, causal: bool, window) -> int:
    """(query, key) pairs the masks leave, queries the last tq of tk."""
    pos = np.arange(tq) + (tk - tq)
    hi = np.minimum(pos, tk - 1) if causal else np.full(tq, tk - 1)
    lo = (np.maximum(pos - window + 1, 0) if window
          else np.zeros(tq, np.int64))
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_flops(b, hq, d, tq, tk, causal, window) -> int:
    """4 B Hq D flops per unmasked (query, key) pair: both products."""
    return 4 * b * hq * d * unmasked_pairs(tq, tk, causal, window)


def flash_bound(b, hq, hkv, d, tq, tk, causal, window) -> float:
    """Least time (s) of one bf16 call: its flops at the peak against
    q, k, v and o crossing HBM once."""
    moved = BF16_BYTES * d * (2 * b * hq * tq + 2 * b * hkv * tk)
    return max(flash_flops(b, hq, d, tq, tk, causal, window) / PEAK_FLOPS,
               moved / HBM_BYTES_PER_S)


def active_layer_params(dims) -> int:
    """Parameters one token uses in one layer: attention, the router and
    top-k experts."""
    d, hd = dims.d_model, dims.head_dim
    attn = d * (dims.n_heads + 2 * dims.n_kv_heads) * hd \
        + dims.n_heads * hd * d
    return attn + d * dims.n_experts + dims.top_k * 3 * d * dims.d_ff


def _attn_flops(dims, pairs: int) -> int:
    return dims.n_layers * 4 * dims.n_heads * dims.head_dim * pairs


def _head_flops(dims, positions: int) -> int:
    return 2 * dims.d_model * dims.vocab * positions


def prefill_flops(dims, t: int) -> int:
    """One B=1 prefill of t tokens, logits at the last position."""
    return (2 * active_layer_params(dims) * dims.n_layers * t
            + _attn_flops(dims, unmasked_pairs(t, t, True, dims.window))
            + _head_flops(dims, 1))


def decode_flops(dims, keys) -> int:
    """One decode step of the live slots, ``keys`` the number of keys
    each attends (its cache length after the step's write, the window
    applied)."""
    keys = [min(k, dims.window) if dims.window else k for k in keys]
    return (2 * active_layer_params(dims) * dims.n_layers * len(keys)
            + _attn_flops(dims, sum(keys)) + _head_flops(dims, len(keys)))


def experts_bound(dims, n_tokens: int) -> float:
    """Least time (s) of one layer's expert products over n_tokens: every
    expert's three bf16 matrices read once (a 32-slot decode batch hits
    all eight with probability 1 - 8 (3/4)^32 = 0.9992) against the
    top-k products at the peak."""
    weights = dims.n_experts * 3 * dims.d_model * dims.d_ff * BF16_BYTES
    flops = n_tokens * dims.top_k * 3 * 2 * dims.d_model * dims.d_ff
    return max(weights / HBM_BYTES_PER_S, flops / PEAK_FLOPS)
