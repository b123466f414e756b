"""Feed-forward blocks: SwiGLU (modern LMs) and GELU (whisper).

Plain matrix products in the model's dtype (``torch.matmul``; under a
sequence-parallel mesh ``sharding.matmul``): the JAX package leaves them
to XLA, outside any kernel of its own.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import matmul
from repro_torch.models.layers.init import normal


def swiglu_init(gen: torch.Generator | None, d: int, ff: int,
                dtype=torch.bfloat16, device=None) -> dict:
    return {"wi": normal(gen, (d, ff), d ** -0.5, dtype, device),
            "wg": normal(gen, (d, ff), d ** -0.5, dtype, device),
            "wo": normal(gen, (ff, d), ff ** -0.5, dtype, device)}


def swiglu(params, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(matmul(x, params["wg"])) * matmul(x, params["wi"])
    return matmul(h, params["wo"])


def gelu_mlp_init(gen: torch.Generator | None, d: int, ff: int,
                  dtype=torch.bfloat16, device=None) -> dict:
    return {"wi": normal(gen, (d, ff), d ** -0.5, dtype, device),
            "bi": torch.zeros((ff,), dtype=dtype, device=device),
            "wo": normal(gen, (ff, d), ff ** -0.5, dtype, device),
            "bo": torch.zeros((d,), dtype=dtype, device=device)}


def gelu_mlp(params, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(matmul(x, params["wi"]) + params["bi"], approximate="tanh")
    return matmul(h, params["wo"]) + params["bo"]
