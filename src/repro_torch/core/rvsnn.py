"""RV-SNN V1.0: the paper's SNN instruction set as PyTorch functions.

Wenquxing 22A adds an SNN unit (SPU, NU, SU) and an SNN special register
file to NutShell's execution stage.  Each instruction here is a function
over an :class:`SnnRegFile`, with the hardware's operand granularity:

  ``snn.ls``    SPU   latch a packed spike vector into the spike register
  ``snn.sp``    SPU   popcount(spike & synapse row) -> valid-spike counts
  ``snn.nu``    NU    streamlined-LIF update of the membrane registers
  ``snn.su``    SU    single-pass LTP + LTD row update (LFSR register)
  ``snn.step``  SNNU  fused sp + nu + su for the whole population

Each instruction runs its own kernel (``kernels/ops.py``): ``snn.sp``
the SPU kernel, ``snn.nu`` the NU kernel, ``snn.su`` the SU kernel, and
``snn.step`` ONE launch of the fused SNNU kernel, not the three.  With
``backend="kernel"`` (the default) a register file on a CUDA card
launches the CUDA kernel and one on the CPU runs its plain version;
``backend="ref"`` runs the plain version anywhere.  A register file may
carry a leading stream axis on every field, and the weight bank and
LFSR may lack it (one bank shared by every stream, e.g. B samples
served against one bank): one launch then covers all streams.  Bit-exact
with ``repro.core.rvsnn``.

Every kernel instruction takes ``dependent`` (default False): on a card
it launches as a programmatic dependent of the stream's previous kernel
(``kernels/ops.py``), so a chain of cycles, ``snn.sp -> + teach ->
snn.nu -> snn.su`` each after the first launch, overlaps each launch
with the end of the one before, as a window of ``snn.step`` does.  The
plain versions ignore it.  Words are int32 bit patterns, LFSR lanes
16-bit values in int32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import lfsr as _lfsr
from repro_torch.core.lif import LIFParams
from repro_torch.core.stdp import STDPParams
from repro_torch.kernels import ops

# The SU's operands when it is idle (inference): no kernel reads them.
_SU_IDLE = STDPParams(w_exp=0, gain=0, n_syn=1, ltp_prob=0)


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


def snn_sp(rf: SnnRegFile, backend: str = "kernel",
           dependent: bool = False) -> torch.Tensor:
    """``snn.sp``: valid-spike counts, popcount(spike & weights) per row.
    ``dependent``: the stream's previous kernel may still be running and
    must not write the spike register (``ops.spike_process``)."""
    return ops.spike_process(rf.spike, rf.weights, dependent=dependent,
                             backend=backend)


def snn_nu(rf: SnnRegFile, counts: torch.Tensor, p: LIFParams,
           backend: str = "kernel", dependent: bool = False
           ) -> tuple[SnnRegFile, torch.Tensor]:
    """``snn.nu``: streamlined-LIF membrane update; returns the fired
    mask.  ``dependent`` is right after any kernel: the NU loads nothing
    before its wait.  After the ``+ teach`` add it gains little, as that
    PyTorch kernel lets its dependents start only when it ends."""
    v_next, fired = ops.lif_step(rf.v, counts, p.threshold, p.leak,
                                 dependent=dependent, backend=backend)
    return rf._replace(v=v_next), fired


def snn_su(rf: SnnRegFile, fired: torch.Tensor, p: STDPParams,
           backend: str = "kernel", dependent: bool = False) -> SnnRegFile:
    """``snn.su``: binary stochastic STDP row update on post-spikes
    (``p.ltp_prob`` may be one value per stream; pass it as an int32[B]
    tensor on the card to keep a host copy out of a dependent chain).
    ``dependent`` is right after any kernel: the SU loads nothing before
    its wait."""
    w_out, lf_out = ops.stdp_update(
        rf.weights, rf.spike, fired, rf.lfsr, w_exp=p.w_exp, gain=p.gain,
        n_syn=p.n_syn, ltp_prob=p.ltp_prob, dependent=dependent,
        backend=backend)
    return rf._replace(weights=w_out, lfsr=lf_out)


def snn_step(rf: SnnRegFile, spike_words: torch.Tensor, lif: LIFParams,
             stdp: STDPParams | None,
             teach: torch.Tensor | None = None, backend: str = "kernel",
             dependent: bool = False) -> tuple[SnnRegFile, torch.Tensor]:
    """``snn.step``: one fused SNNU cycle for the whole population, in
    one kernel launch.

    spike_words int32[w] (or [B, w]) this cycle's packed input spikes;
    ``teach`` optional int32[n] (or [B, n]) teacher current added on the
    NU adder; ``stdp`` None leaves the SU idle (weights and LFSR pass
    through).  ``dependent`` launches the step as a programmatic
    dependent of the stream's previous kernel, which must be the step
    that wrote ``rf`` (``ops.fused_snn_step``).  Returns (rf', fired
    bool[n] or [B, n]).
    """
    rf = snn_ls(rf, spike_words)
    su = _SU_IDLE if stdp is None else stdp
    w2, v2, fired, lf2 = ops.fused_snn_step(
        rf.weights, rf.spike, rf.v, rf.lfsr, teach, threshold=lif.threshold,
        leak=lif.leak, w_exp=su.w_exp, gain=su.gain, n_syn=su.n_syn,
        ltp_prob=su.ltp_prob, train=stdp is not None, dependent=dependent,
        backend=backend)
    return rf._replace(weights=w2, v=v2, lfsr=lf2), fired
