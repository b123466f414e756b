"""The cells' weights, drawn from the run's seed on the device.

Each tensor has a generator of its own, seeded from (seed, its name), so
the plain reference can draw any layer again, alone, after the program
is gone, and gets the same values.  A tensor is N(0, std^2) drawn by one
``normal_`` in the type it is served in (bf16; the router float32) with
the port's init scales; the norm scales are 1.  Names are the port's
parameter names (``Model.named_parameters()``).
"""

from __future__ import annotations

import zlib

import torch

from perfbench.sizes import Dims
from perfbench.traffic import u64


def layer_specs(d: Dims, i: int) -> dict[str, tuple]:
    """name -> (shape, std or None for ones, dtype) of layer i."""
    qkv = (d.n_heads + 2 * d.n_kv_heads) * d.head_dim
    hd = d.n_heads * d.head_dim
    e, ff, dm = d.n_experts, d.d_ff, d.d_model
    bf = torch.bfloat16
    p = f"layers.{i}."
    return {p + "ln1.scale": ((dm,), None, torch.float32),
            p + "mixer.wqkv": ((dm, qkv), dm ** -0.5, bf),
            p + "mixer.wo": ((hd, dm), hd ** -0.5, bf),
            p + "ln2.scale": ((dm,), None, torch.float32),
            p + "ffn.router": ((dm, e), dm ** -0.5, torch.float32),
            p + "ffn.wi": ((e, dm, ff), dm ** -0.5, bf),
            p + "ffn.wg": ((e, dm, ff), dm ** -0.5, bf),
            p + "ffn.wo": ((e, ff, dm), ff ** -0.5, bf)}


def outer_specs(d: Dims) -> dict[str, tuple]:
    dm, v = d.d_model, d.vocab
    return {"embed": ((v, dm), dm ** -0.5, torch.bfloat16),
            "final_norm.scale": ((dm,), None, torch.float32),
            "lm_head": ((dm, v), dm ** -0.5, torch.bfloat16)}


def fill_(t: torch.Tensor, name: str, std: float | None, seed: int) -> None:
    """Draw ``name``'s values into ``t`` in place."""
    if std is None:
        t.fill_(1.0)
        return
    gen = torch.Generator(device=t.device)
    gen.manual_seed(u64(seed % (1 << 64), 3, zlib.crc32(name.encode())))
    t.normal_(0.0, std, generator=gen)


def draw(name: str, spec: tuple, seed: int, device) -> torch.Tensor:
    shape, std, dtype = spec
    t = torch.empty(shape, dtype=dtype, device=device)
    fill_(t, name, std, seed)
    return t


def load_into(model: torch.nn.Module, d: Dims, seed: int) -> None:
    """Fill every parameter of the port's ``Model`` (built with
    ``seed=None``) from the seed; raises on a parameter it has no draw
    for, or a shape that differs."""
    specs = dict(outer_specs(d))
    for i in range(d.n_layers):
        specs.update(layer_specs(d, i))
    params = dict(model.named_parameters())
    if set(params) != set(specs):
        raise ValueError(f"parameters {sorted(set(params) ^ set(specs))} "
                         f"are not drawn by both sides")
    with torch.no_grad():
        for name, p in params.items():
            shape, std, dtype = specs[name]
            if tuple(p.shape) != shape or p.dtype != dtype:
                raise ValueError(f"{name}: the port holds {tuple(p.shape)} "
                                 f"{p.dtype}, the config {shape} {dtype}")
            fill_(p.data, name, std, seed)
