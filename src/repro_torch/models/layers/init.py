"""Weight draws shared by the layers and the model."""

from __future__ import annotations

import torch


def normal(gen: torch.Generator | None, shape, std: float, dtype,
           device=None) -> torch.Tensor:
    """N(0, std^2) drawn in float32 from ``gen`` and cast to ``dtype``, as
    the JAX package draws its weights; ``gen`` None leaves the tensor
    uninitialized, to be loaded."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)
