"""AdamW with low-precision optimizer states and stochastic rounding.

The port of the JAX package's ``optim/adamw.py``, the same arithmetic in
float32 in the same order, on a flat dict of named tensors (the LM's
``dict(model.named_parameters())``):

* global-norm clip over every leaf, bias correction at ``step + 1``,
  weight decay only on leaves with ``ndim >= 2``;
* ``state_dtype=torch.bfloat16`` keeps Adam's m/v in bf16;
* ``stochastic_rounding=True`` with bf16 params drops the fp32 master
  copy: the update is rounded onto the bf16 grid with probability
  proportional to the residual, so tiny LR x grad increments are not
  systematically lost (the paper's binary stochastic STDP, generalized);
* leaves of ``>= 1 << 24`` elements and ``ndim >= 3`` (MoE expert
  stacks) update one axis-0 slice at a time, which bounds the float32
  temporaries to one slice.

``init``/``apply`` are functional: ``apply`` returns new tensors and
leaves its arguments as they were.  The state ``{"m": {...}, "v": {...},
"step": int32 0-d}`` is a tree ``CheckpointManager`` saves and restores,
and ``repro_torch.convert.adamw_state_from_jax`` fills from the JAX
package's.  The stochastic-rounding noise comes from a
``torch.Generator``; ``jax.random``'s bits cannot be drawn in torch, so
only :func:`stochastic_round_bf16` given the same noise equals JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.bitpack import as_i32, as_u32
from repro_torch.distributed.sharding import is_dtensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: Any = torch.float32       # m/v storage dtype
    stochastic_rounding: bool = False      # bf16 params w/o master copy


def stochastic_round_bf16(x: torch.Tensor, noise: torch.Tensor
                          ) -> torch.Tensor:
    """f32 -> bf16, rounding up with probability proportional to the
    residual: ``noise`` holds 16-bit values (any integer dtype, x's
    shape) added below the bf16 mantissa before it is cut.  u32
    arithmetic on int64 values, masked, as the port does it."""
    bits = as_u32(x.to(torch.float32).contiguous().view(torch.int32))
    rounded = (bits + (noise.to(torch.int64) & 0xFFFF)) & 0xFFFF0000
    return as_i32(rounded).view(torch.float32).to(torch.bfloat16)


def _stochastic_round_bf16(x: torch.Tensor, gen: torch.Generator
                           ) -> torch.Tensor:
    """The JAX package's ``_stochastic_round_bf16``, its 16-bit noise
    drawn from ``gen`` instead of a ``jax.random`` key.  A DTensor is
    rounded on each rank's shard, with noise of the shard's shape."""
    if is_dtensor(x):
        return DTensor.from_local(
            _stochastic_round_bf16(x.to_local(), gen), x.device_mesh,
            x.placements, run_check=False)
    noise = torch.randint(0, 1 << 16, x.shape, generator=gen,
                          device=x.device, dtype=torch.int32)
    return stochastic_round_bf16(x, noise)


@dataclasses.dataclass(frozen=True)
class AdamW:
    cfg: AdamWConfig = AdamWConfig()

    # leaves of at least this many elements (and ndim >= 3) update one
    # axis-0 slice at a time
    _SCAN_THRESHOLD = 1 << 24

    def init(self, params: dict) -> dict:
        dt = self.cfg.state_dtype
        dev = next(iter(params.values())).device if params else None
        # zeros_like: a DTensor parameter's states take its placements
        return {"m": {k: torch.zeros_like(p, dtype=dt)
                      for k, p in params.items()},
                "v": {k: torch.zeros_like(p, dtype=dt)
                      for k, p in params.items()},
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        lr = self.cfg.lr
        if callable(lr):
            return lr(step)
        return torch.tensor(lr, dtype=torch.float32, device=step.device)

    @torch.no_grad()
    def apply(self, grads: dict, state: dict, params: dict, *,
              rng: torch.Generator | None = None) -> tuple[dict, dict]:
        """Returns (new_params, new_state).  ``rng`` (a ``torch.Generator``
        on the params' device) is required when stochastic_rounding is
        on."""
        c = self.cfg
        step = state["step"] + 1
        lr = self._lr(step)

        # global-norm clip: each square in the grad's dtype, summed in f32
        gsq = sum(torch.sum(torch.square(grads[k]), dtype=torch.float32)
                  for k in params)
        gnorm = torch.sqrt(gsq)
        scale = torch.clamp(c.grad_clip / (gnorm + 1e-9), max=1.0)

        stepf = step.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(c.b1, dtype=torch.float32,
                                         device=stepf.device), stepf)
        bc2 = 1 - torch.pow(torch.tensor(c.b2, dtype=torch.float32,
                                         device=stepf.device), stepf)
        if c.stochastic_rounding and rng is None:
            raise ValueError("stochastic_rounding requires rng")

        def update_slice(p, g, m, v, decay: bool):
            gf = g.to(torch.float32) * scale
            mf = c.b1 * m.to(torch.float32) + (1 - c.b1) * gf
            vf = c.b2 * v.to(torch.float32) + (1 - c.b2) * gf * gf
            upd = (mf / bc1) / (torch.sqrt(vf / bc2) + c.eps)
            pf = p.to(torch.float32)
            if decay:
                upd = upd + c.weight_decay * pf
            pf = pf - lr * upd
            if c.stochastic_rounding and p.dtype == torch.bfloat16:
                p_new = _stochastic_round_bf16(pf, rng)
            else:
                p_new = pf.to(p.dtype)
            return p_new, mf.to(c.state_dtype), vf.to(c.state_dtype)

        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            p = p.detach()
            g, m, v = grads[k], state["m"][k], state["v"][k]
            decay = p.ndim >= 2  # decay matrices only (standard)
            if p.numel() >= self._SCAN_THRESHOLD and p.ndim >= 3 \
                    and not is_dtensor(p):
                pn, mn, vn = (torch.empty_like(p), torch.empty_like(m),
                              torch.empty_like(v))
                for i in range(p.shape[0]):
                    pn[i], mn[i], vn[i] = update_slice(p[i], g[i], m[i],
                                                       v[i], decay)
            else:
                pn, mn, vn = update_slice(p, g, m, v, decay)
            new_p[k], new_m[k], new_v[k] = pn, mn, vn
        return new_p, {"m": new_m, "v": new_v, "step": step}
