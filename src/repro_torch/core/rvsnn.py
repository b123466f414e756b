"""RV-SNN V1.0: the paper's SNN instruction set as PyTorch functions.

Wenquxing 22A adds an SNN unit (SPU, NU, SU) and an SNN special register
file to NutShell's execution stage.  Each instruction here is a function
over an :class:`SnnRegFile`, with the hardware's operand granularity:

  ``snn.ls``    SPU   latch a packed spike vector into the spike register
  ``snn.sp``    SPU   popcount(spike & synapse row) -> valid-spike counts
  ``snn.nu``    NU    streamlined-LIF update of the membrane registers
  ``snn.su``    SU    single-pass LTP + LTD row update (LFSR register)
  ``snn.step``  SNNU  fused sp + nu + su for the whole population

The architectural reference of the window kernels; bit-exact with
``repro.core.rvsnn``.  Words are int32 bit patterns, LFSR lanes 16-bit
values in int32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import lfsr as _lfsr
from repro_torch.core.bitpack import popcount
from repro_torch.core.lif import LIFParams, lif_step
from repro_torch.core.stdp import STDPParams, stdp_update


class SnnRegFile(NamedTuple):
    """The SNN special register file (paper Fig. 2).

    spike:   int32[w]      packed input spike vector (spike register)
    v:       int32[n]      membrane potentials (neuron registers)
    lfsr:    int32[n, w]   PRNG lanes (LFSR register, one per word)
    weights: int32[n, w]   packed 1-bit synapse rows

    A batched register file has a leading stream axis on every field.
    """
    spike: torch.Tensor
    v: torch.Tensor
    lfsr: torch.Tensor
    weights: torch.Tensor


def snn_regfile(weights: torch.Tensor, seed: int = 0x22A) -> SnnRegFile:
    n, w = weights.shape
    dev = weights.device
    return SnnRegFile(
        spike=torch.zeros((w,), dtype=torch.int32, device=dev),
        v=torch.zeros((n,), dtype=torch.int32, device=dev),
        lfsr=_lfsr.seed(seed, n * w, dev).reshape(n, w),
        weights=weights,
    )


def snn_regfile_batch(weights: torch.Tensor, seeds) -> SnnRegFile:
    """B independent register files as one batched :class:`SnnRegFile`.

    weights int32[B, n, w]; seeds: B per-stream LFSR base seeds.  Stream
    b is exactly ``snn_regfile(weights[b], seeds[b])``.
    """
    b, n, w = weights.shape
    if len(seeds) != b:
        raise ValueError(f"need {b} seeds, got {len(seeds)}")
    dev = weights.device
    return SnnRegFile(
        spike=torch.zeros((b, w), dtype=torch.int32, device=dev),
        v=torch.zeros((b, n), dtype=torch.int32, device=dev),
        lfsr=torch.stack([_lfsr.seed(int(s), n * w, dev).reshape(n, w)
                          for s in seeds]),
        weights=weights,
    )


def snn_ls(rf: SnnRegFile, spike_words: torch.Tensor) -> SnnRegFile:
    """``snn.ls``: latch a packed spike vector into the spike register."""
    return rf._replace(spike=spike_words.to(torch.int32))


def snn_sp(rf: SnnRegFile) -> torch.Tensor:
    """``snn.sp``: valid-spike counts, popcount(spike & weights) per row."""
    return popcount(rf.spike[..., None, :] & rf.weights)


def snn_nu(rf: SnnRegFile, counts: torch.Tensor, p: LIFParams
           ) -> tuple[SnnRegFile, torch.Tensor]:
    """``snn.nu``: streamlined-LIF membrane update; returns the fired
    mask."""
    v_next, fired = lif_step(rf.v, counts, p)
    return rf._replace(v=v_next), fired


def snn_su(rf: SnnRegFile, fired: torch.Tensor, p: STDPParams
           ) -> SnnRegFile:
    """``snn.su``: binary stochastic STDP row update on post-spikes."""
    w_out, lf_out = stdp_update(rf.weights, rf.spike, fired, rf.lfsr, p)
    return rf._replace(weights=w_out, lfsr=lf_out)


def snn_step(rf: SnnRegFile, spike_words: torch.Tensor, lif: LIFParams,
             stdp: STDPParams | None,
             teach: torch.Tensor | None = None
             ) -> tuple[SnnRegFile, torch.Tensor]:
    """``snn.step``: one fused SNNU cycle for the whole population.

    spike_words int32[w] this cycle's packed input spikes; ``teach``
    optional int32[n] teacher current added on the NU adder; ``stdp``
    None leaves the SU idle.  Returns (rf', fired bool[n]).
    """
    rf = snn_ls(rf, spike_words)
    counts = snn_sp(rf)
    if teach is not None:
        counts = counts + teach
    rf, fired = snn_nu(rf, counts, lif)
    if stdp is not None:
        rf = snn_su(rf, fired, stdp)
    return rf, fired
