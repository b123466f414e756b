"""SNN network execution over the presentation window (paper §3.1).

Shims over the engine (:mod:`repro_torch.engine`), as
``repro.core.network`` is over the JAX package's: each function turns
its LIF/STDP parameters and ``cycle_backend`` / ``kernel_backend`` /
``window_chunk`` into an :class:`~repro_torch.engine.SNNEnginePlan` and
calls one engine verb or stream driver.  New code should build a plan
and speak the engine's verbs (``infer`` / ``train`` / ``train_batch``)
directly.

``cycle_backend="window"`` presents each window in one window-kernel
launch; ``"step"`` runs it cycle by cycle, one fused RV-SNN step launch
per cycle.  ``kernel_backend`` takes the port's values: ``"kernel"``
(the CUDA kernels on a card, their plain versions on the CPU) or
``"ref"`` (the plain versions anywhere).  The shims run where the
weights lie.

The JAX shims keep one more branch: when a caller jits them with traced
LIF/STDP parameters, which cannot lower as kernel literals, they fall
back to their own per-cycle scan.  PyTorch has no traced parameters:
every parameter here is a concrete value, so every call builds a plan,
and the per-cycle path is the engine's own step path.
"""

from __future__ import annotations

import torch

from repro_torch.core.lif import LIFParams
from repro_torch.core.rvsnn import SnnRegFile
from repro_torch.core.stdp import STDPParams
from repro_torch.engine import SNNEngine, SNNEnginePlan, SNNOutput
from repro_torch.engine import engine as _engine
from repro_torch.engine import reset_between_samples  # noqa: F401 (re-export)

__all__ = ["SNNOutput", "run_sample", "reset_between_samples",
           "infer_batch", "train_stream", "train_stream_batch"]


def _engine_for(weights, lif: LIFParams, stdp: STDPParams | None,
                cycle_backend: str, kernel_backend: str,
                window_chunk: int | None) -> SNNEngine:
    """An engine on the weights' device for these parameters (SU idle
    when ``stdp`` is None)."""
    su = {} if stdp is None else dict(
        gain=int(stdp.gain), n_syn=int(stdp.n_syn),
        ltp_prob=int(stdp.ltp_prob))
    plan = SNNEnginePlan(
        threshold=int(lif.threshold), leak=int(lif.leak),
        w_exp=None if stdp is None else int(stdp.w_exp),
        cycle_backend=cycle_backend, kernel_backend=kernel_backend,
        t_chunk=window_chunk, **su)
    device = weights.device if isinstance(weights, torch.Tensor) else "cpu"
    return SNNEngine(plan, device=device)


def run_sample(rf: SnnRegFile, spike_train, lif: LIFParams,
               stdp: STDPParams | None = None, teach=None, *,
               cycle_backend: str = "window", kernel_backend: str = "kernel",
               window_chunk: int | None = None) -> SNNOutput:
    """Present one sample (spike_train u32[T, w]) for T cycles;
    ``stdp=None`` is inference.  Shim over :meth:`SNNEngine.train`."""
    eng = _engine_for(rf.weights, lif, stdp, cycle_backend, kernel_backend,
                      window_chunk)
    return eng.train(rf, spike_train, teach)


def infer_batch(weights, spike_trains, lif: LIFParams, *,
                cycle_backend: str = "window", kernel_backend: str = "kernel",
                window_chunk: int | None = None) -> torch.Tensor:
    """Spike counts int32[B, n] for spike_trains u32[B, T, w], weights
    u32[n, w] frozen.  Shim over :meth:`SNNEngine.infer`: one window
    launch for all B samples, or T step launches for all of them."""
    eng = _engine_for(weights, lif, None, cycle_backend, kernel_backend,
                      window_chunk)
    return eng.infer(weights, spike_trains)


def train_stream(rf: SnnRegFile, spike_trains, teach, lif: LIFParams,
                 stdp: STDPParams, *, cycle_backend: str = "window",
                 kernel_backend: str = "kernel",
                 window_chunk: int | None = None
                 ) -> tuple[SnnRegFile, torch.Tensor]:
    """Online STDP over a stream of samples (spike_trains u32[N, T, w],
    teach int32[N, n]), sequential as in hardware.  Shim over
    :func:`repro_torch.engine.train_stream`.  Returns (rf', spike_counts
    int32[N, n])."""
    eng = _engine_for(rf.weights, lif, stdp, cycle_backend, kernel_backend,
                      window_chunk)
    return _engine.train_stream(eng, rf, spike_trains, teach)


def train_stream_batch(rfs: SnnRegFile, spike_trains, teach,
                       lif: LIFParams, stdp: STDPParams, *,
                       cycle_backend: str = "window",
                       kernel_backend: str = "kernel",
                       window_chunk: int | None = None
                       ) -> tuple[SnnRegFile, torch.Tensor]:
    """Online STDP over B independent streams (a batched register file,
    spike_trains u32[B, N, T, w], teach int32[B, N, n]), one launch per
    presented sample (window) or per cycle (step) for all streams.
    Stream b is bit-exact with ``train_stream`` on regfile b.  Shim over
    :func:`repro_torch.engine.train_stream_batch`.  Returns (rfs',
    spike_counts int32[B, N, n])."""
    eng = _engine_for(rfs.weights, lif, stdp, cycle_backend, kernel_backend,
                      window_chunk)
    return _engine.train_stream_batch(eng, rfs, spike_trains, teach)
