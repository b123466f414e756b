"""The frozen execution plan of the SNN engine.

An :class:`SNNEnginePlan` holds every decision the engine dispatches
on: LIF/STDP parameters, the cycle path (one window kernel per
presentation, or one fused RV-SNN step kernel per cycle), the kernel
backend, where the Poisson encode runs, and the serving batch size.  Plans are frozen dataclasses of
plain Python scalars; the kernels take them as plain ``int``
arguments, while per-stream operands (seeds, ``ltp_prob``, teach) are
tensors.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.lif import LIFParams, lif_params
from repro_torch.core.stdp import STDPParams, stdp_params

_CYCLE_BACKENDS = ("window", "step")
_KERNEL_BACKENDS = ("kernel", "ref")
_ENCODE_BACKENDS = ("host", "kernel")


@dataclasses.dataclass(frozen=True)
class SNNEnginePlan:
    """Everything the engine needs to dispatch SNN work.

    ``w_exp=None`` marks an inference-only plan (SU idle).
    ``cycle_backend="window"`` presents a window in one window-kernel
    launch; ``"step"`` runs it cycle by cycle, one fused ``snn.step``
    launch per cycle (for every stream of the call at once).
    ``kernel_backend="kernel"`` runs the CUDA kernels on a card and their
    plain versions on the CPU; ``"ref"`` runs the plain versions on any
    device (serving takes it only on the CPU).
    """
    # --- LIF / STDP parameters -----------------------------------------
    threshold: int = 192
    leak: int = 16
    w_exp: int | None = 128     # None => SU idle (inference-only plan)
    gain: int = 4
    n_syn: int = 784
    ltp_prob: int = 16
    # --- dispatch -------------------------------------------------------
    cycle_backend: str = "window"    # "window" | "step"
    kernel_backend: str = "kernel"   # "kernel" | "ref"
    t_chunk: int | None = None       # window-length quantum in serving
    # --- encoding -------------------------------------------------------
    # Where intensity-driven verbs run the Poisson encode: "host" builds
    # the packed window with the counter encoder and feeds the
    # pre-packed kernel; "kernel" draws the same (bit-exact) spikes
    # inside the encode kernel, so spike windows never exist in memory.
    encode: str = "host"             # "host" | "kernel"
    encode_seed: int = 0             # base counter seed for the draw
    # --- serving --------------------------------------------------------
    max_batch: int = 8               # serving admission cap per launch

    def __post_init__(self):
        if self.cycle_backend not in _CYCLE_BACKENDS:
            raise ValueError(f"cycle_backend must be one of "
                             f"{_CYCLE_BACKENDS}, got "
                             f"{self.cycle_backend!r}")
        if self.kernel_backend not in _KERNEL_BACKENDS:
            raise ValueError(f"kernel_backend must be one of "
                             f"{_KERNEL_BACKENDS}, got "
                             f"{self.kernel_backend!r}")
        if self.encode not in _ENCODE_BACKENDS:
            raise ValueError(f"encode must be one of {_ENCODE_BACKENDS}, "
                             f"got {self.encode!r}")
        if self.encode == "kernel" and self.cycle_backend != "window":
            raise ValueError("in-kernel encode requires the window "
                             "path; use cycle_backend='window'")
        if self.t_chunk is not None and self.t_chunk < 1:
            raise ValueError(f"t_chunk must be >= 1, got {self.t_chunk}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got "
                             f"{self.max_batch}")

    # --- derived views ---------------------------------------------------

    @property
    def learn(self) -> bool:
        """Whether the train verb runs the SU (STDP) at all."""
        return self.w_exp is not None

    def lif(self) -> LIFParams:
        return lif_params(self.threshold, self.leak)

    def stdp(self) -> STDPParams | None:
        if not self.learn:
            return None
        return stdp_params(self.n_syn, self.w_exp, self.gain,
                           self.ltp_prob)

    def window_kwargs(self) -> dict:
        """The window ops' parameters (``ops.fused_snn_window``
        signature); inference-only plans hand the SU zeroed values and
        ``train=False``."""
        if not self.learn:
            return dict(threshold=self.threshold, leak=self.leak,
                        w_exp=0, gain=0, n_syn=1, ltp_prob=0,
                        train=False)
        return dict(threshold=self.threshold, leak=self.leak,
                    w_exp=self.w_exp, gain=self.gain, n_syn=self.n_syn,
                    ltp_prob=self.ltp_prob, train=True)


def plan_from_config(cfg, block_idx: int = 0) -> SNNEnginePlan:
    """Build a plan from an ``SNNTrainConfig``-shaped object.

    ``block_idx`` selects the LTP schedule (block 0 trains at
    ``ltp_prob``, later active-learning blocks at ``ltp_prob_active``).
    """
    lp = cfg.ltp_prob if block_idx == 0 else cfg.ltp_prob_active
    return SNNEnginePlan(
        threshold=cfg.threshold, leak=cfg.leak, w_exp=cfg.w_exp,
        gain=cfg.gain, n_syn=cfg.n_inputs, ltp_prob=lp,
        cycle_backend=cfg.cycle_backend,
        kernel_backend=cfg.kernel_backend, t_chunk=cfg.window_chunk,
        encode=cfg.encode, encode_seed=cfg.encode_seed)
