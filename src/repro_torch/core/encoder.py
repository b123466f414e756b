"""Rate-based spike encoders (paper §3.1, rate coding).

Each pixel fires as an independent Bernoulli(intensity) per time cycle.
The encoders output packed int32 spike words (the SPU's operand).

``poisson_encode``
    Statistical encode from float intensities in [0, 1] with a
    ``torch.Generator``.  Its bits are not the JAX package's (the two
    PRNGs differ), only their distribution; the trainer's
    ``encode="host"`` path uses it.

``encode_from_counter``
    Deterministic: a spike at (cycle t, input i) fires iff
    ``counter_hash(seed, t, i) & 0xFF < intensity``, i.e. P =
    intensity/256; intensity 0 is silent by construction (serving's
    batch padding relies on it).  The host version of the draw that the
    encode kernels make on the card, bit-exact with them and with the
    JAX package.
"""

from __future__ import annotations

import torch

from repro_torch.core import lfsr
from repro_torch.core.bitpack import as_i32, pack, popcount, unpack


def poisson_encode(generator: torch.Generator | None,
                   intensities: torch.Tensor, n_steps: int
                   ) -> torch.Tensor:
    """Float intensities [n] in [0, 1] -> packed spikes int32[T, w]."""
    return poisson_encode_batch(generator, intensities[None], n_steps)[0]


def poisson_encode_batch(generator: torch.Generator | None,
                         batch: torch.Tensor, n_steps: int
                         ) -> torch.Tensor:
    """[B, n] float intensities -> int32[B, T, w] packed spike trains,
    one uniform draw per (sample, cycle, input) from ``generator`` (on
    the generator's device; None: PyTorch's default generator)."""
    x = torch.as_tensor(batch, dtype=torch.float32)
    dev = generator.device if generator is not None else x.device
    u = torch.rand((x.shape[0], n_steps, x.shape[1]), generator=generator,
                   device=dev)
    return pack(u < x.to(dev)[:, None, :])


def spike_rate(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Population firing rate per time cycle: packed int32[T, w] ->
    float32[T], the fraction of the ``n`` inputs spiking each cycle (tail
    bits past ``n`` are zero by the packing convention)."""
    return popcount(packed).to(torch.float32) / n


def spike_rate_per_input(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Mean firing rate per input across time: float32[n]."""
    return unpack(packed, n).to(torch.float32).mean(dim=0)


def quantize_intensities(x) -> torch.Tensor:
    """Normalized [0, 1] intensities -> the uint8 operand of the counter
    encoder (P = round(x * 255) / 256 per cycle)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    return torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.uint8)


def encode_from_counter(seed, intensities: torch.Tensor, n_steps: int,
                        *, t0: int = 0) -> torch.Tensor:
    """Counter encode: uint8[n] -> packed int32[T, w].

    ``t0`` offsets the cycle counter, so any slice of a window can be
    regenerated in isolation.
    """
    return encode_from_counter_batch(seed, intensities[None], n_steps,
                                     t0=t0)[0]


def encode_from_counter_batch(seeds, intensities: torch.Tensor,
                              n_steps: int, *, t0: int = 0
                              ) -> torch.Tensor:
    """Per-sample-seeded counter encode: uint8[B, n] -> int32[B, T, w].

    ``seeds`` is an i32/u32[B] vector or a scalar broadcast to every
    sample.
    """
    dev = intensities.device
    b, n = intensities.shape
    sd = lfsr.u32(seeds, dev).expand(b)
    cyc = torch.arange(t0, t0 + n_steps, dtype=torch.int64, device=dev)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    h = lfsr.counter_hash(sd[:, None, None], cyc[None, :, None],
                          idx[None, None, :])
    bits = (h & 0xFF) < intensities.to(torch.int64)[:, None, :]
    return pack(bits)


def encode_windows_host(seeds, intensities: torch.Tensor, n_steps: int,
                        words: int, t_total=None) -> torch.Tensor:
    """Host counter encode shaped for the window kernels:
    uint8[B, n_in] -> int32[B, T, words].

    Zero-padded on the word axis to ``words`` and, when ``t_total``
    (i32[B]) is given, zero-masked past each sample's true length (the
    counts equal the encode kernel's for any threshold >= 1: a zero row
    adds no input and the membrane only leaks).
    """
    wins = encode_from_counter_batch(seeds, intensities, n_steps)
    pad = words - wins.shape[-1]
    if pad:
        wins = torch.nn.functional.pad(wins, (0, pad))
    if t_total is not None:
        tt = torch.as_tensor(t_total, dtype=torch.int64, device=wins.device)
        steps = torch.arange(n_steps, device=wins.device)
        mask = steps[None, :, None] < tt[:, None, None]
        wins = torch.where(mask, wins, torch.zeros_like(wins))
    return wins


def sample_seeds(base, n: int, epoch: int = 0, device=None) -> torch.Tensor:
    """Per-sample counter seeds i32[n] derived from ``(base, epoch)``:
    one counter draw per sample index (cycle axis = sample, lane axis =
    epoch), bit-cast to int32."""
    return sample_seeds_at(base, torch.arange(n, device=device), epoch)


def sample_seeds_at(base, idx, epoch: int = 0) -> torch.Tensor:
    """Seeds for explicit sample indices: ``sample_seeds(base, n,
    epoch)[idx]`` without materializing the full range."""
    idx = torch.as_tensor(idx)
    return as_i32(lfsr.counter_hash(base, idx, epoch, device=idx.device))
