"""The SNN engine: the ``infer`` verb over one execution plan.

``infer(weights, windows)`` gives spike counts i32[B, n] for B
presentation windows, weights frozen, membrane reset per sample: the
serving path.  One kernel launch per call.  The ``train`` verbs come
with the training slice.

The engine places its inputs on its device.  On a CUDA device with
``kernel_backend="kernel"`` the kernels are built when the engine is
constructed, so a build failure raises there and not inside a launch.
"""

from __future__ import annotations

import torch

from repro_torch.core.bitpack import as_words
from repro_torch.core.encoder import encode_windows_host
from repro_torch.engine.plan import SNNEnginePlan
from repro_torch.kernels import ops


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    asks for another.  Asking for ``cuda`` without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run the plain versions")
    return dev


def _one_of(windows, intensities, n_steps, what: str) -> None:
    if (windows is None) == (intensities is None):
        raise ValueError(f"{what}: pass exactly one of the packed "
                         "window(s) or intensities")
    if intensities is not None and n_steps is None:
        raise ValueError(f"{what}: n_steps is required with intensities")


class SNNEngine:
    """Dispatches the ``infer`` verb according to one frozen plan."""

    def __init__(self, plan: SNNEnginePlan, device=None):
        self.plan = plan
        self.device = resolve_device(device)
        if self.device.type == "cuda" and plan.kernel_backend == "kernel":
            ops.load_kernels()

    def __repr__(self) -> str:
        return f"SNNEngine({self.plan!r}, device={self.device})"

    # --- encoding --------------------------------------------------------

    def _seeds(self, seeds, b: int, device: torch.device) -> torch.Tensor:
        """Per-sample counter seeds i32[B] on ``device`` (default: plan
        seed + sample index), as :func:`ops.seed_vector` gives them."""
        if seeds is None:
            seeds = self.plan.encode_seed + torch.arange(b)
        return ops.seed_vector(seeds, b, device)

    # --- infer -----------------------------------------------------------

    def infer(self, weights, windows=None, *, intensities=None, seeds=None,
              n_steps: int | None = None, t_total=None) -> torch.Tensor:
        """Spike counts int32[B, n] for B presentation windows.

        Pass EITHER pre-packed ``windows`` u32[B, T, w] (numpy, or int32
        bit patterns) OR uint8 ``intensities`` [B, n_in] with ``n_steps``
        (and optional per-sample ``seeds`` i32[B] / true lengths
        ``t_total`` i32[B]).  The intensity form draws its spikes from
        the counter, inside the kernel when the plan says
        ``encode="kernel"``, on the host otherwise, with equal counts.
        """
        p = self.plan
        w = as_words(weights, self.device)
        if intensities is not None or windows is None:
            _one_of(windows, intensities, n_steps, "infer")
            inten = torch.as_tensor(intensities, dtype=torch.uint8,
                                    device=self.device)
            sd = self._seeds(seeds, inten.shape[0], w.device)
            if p.encode == "kernel":
                return ops.infer_window_batch_encode(
                    w, inten, sd, n_steps=n_steps, threshold=p.threshold,
                    leak=p.leak, t_total=t_total, t_chunk=p.t_chunk,
                    backend=p.kernel_backend)
            windows = encode_windows_host(sd, inten, n_steps, w.shape[1],
                                          t_total)
        return ops.infer_window_batch(
            w, as_words(windows, self.device),
            threshold=p.threshold, leak=p.leak, t_chunk=p.t_chunk,
            backend=p.kernel_backend)
