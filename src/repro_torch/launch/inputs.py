"""Input stand-ins for every (arch x shape) cell, on the ``meta`` device.

No allocation: the dry run traces against these.  Also the logical-axis
trees of the batch and decode inputs, which the dry run resolves to
placements.  The JAX package's ``ShapeDtypeStruct``s become meta tensors
of the same shapes and dtypes, and its rng key a generator seed.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeSpec


def _sd(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """The batch of a train or prefill cell."""
    b, t = shape.global_batch, shape.seq_len
    batch = {"tokens": _sd((b, t), torch.int32)}
    if shape.kind == "train":
        batch["labels"] = _sd((b, t), torch.int32)
    if cfg.is_enc_dec:
        batch["frames"] = _sd((b, cfg.frontend_len, cfg.d_model),
                              torch.float32)
    if cfg.frontend == "vision":
        batch["patches"] = _sd((b, cfg.frontend_len, cfg.d_model),
                               torch.float32)
    return batch


def input_logical(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Logical axis names matching :func:`input_specs`."""
    batch = {"tokens": ("batch", "seq")}
    if shape.kind == "train":
        batch["labels"] = ("batch", "seq")
    if cfg.is_enc_dec:
        batch["frames"] = ("batch", None, None)
    if cfg.frontend == "vision":
        batch["patches"] = ("batch", None, None)
    return batch


def decode_token_specs(cfg: ArchConfig, shape: ShapeSpec):
    """(the decode step's tokens [B, 1], their logical names)."""
    b = shape.global_batch
    return _sd((b, 1), torch.int32), ("batch", None)


def rng_spec() -> int:
    """The train step's randomness: a generator seed."""
    return 0
