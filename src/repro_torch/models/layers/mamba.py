"""Mamba (selective SSM) mixer — jamba's recurrent layer.

The port of the JAX package's ``models/layers/mamba.py``: in-projection
to (x, z), a short causal depthwise conv, data-dependent (dt, B, C) from
x, a diagonal selective scan over time, a gated out-projection.  The
prefill's scan ``s_t = a_t * s_{t-1} + bx_t`` runs in log2(T) doubling
steps over the whole sequence (PyTorch has no ``associative_scan``; a
loop over T would launch some ten kernels a token a layer).  Its sums
are taken in another order than JAX's scan tree, so the two agree to
float32's rounding, not bit for bit.  Decode carries (conv tail, ssm
state) and writes both in place.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding
from repro_torch.models.layers.init import normal


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int
    d_inner: int          # expansion (2x d_model in jamba)
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 0      # 0 -> ceil(d_model / 16)

    @property
    def rank(self) -> int:
        return self.dt_rank or max(1, self.d_model // 16)


def init(gen: torch.Generator | None, cfg: MambaConfig, dtype=torch.bfloat16,
         device=None) -> dict:
    """The layer's weights (``dt_bias``, ``A_log`` and ``D`` in float32),
    the projections drawn from ``gen`` (None: uninitialized, to be
    loaded)."""
    d, di, ds, r = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.rank
    f32 = dict(dtype=torch.float32, device=device)
    a = torch.arange(1, ds + 1, **f32)[None, :].expand(di, ds)
    return {"in_proj": normal(gen, (d, 2 * di), d ** -0.5, dtype, device),
            "conv_w": normal(gen, (cfg.d_conv, di), 0.1, dtype, device),
            "conv_b": torch.zeros((di,), dtype=dtype, device=device),
            "x_proj": normal(gen, (di, r + 2 * ds), di ** -0.5, dtype,
                             device),
            "dt_proj": normal(gen, (r, di), r ** -0.5, dtype, device),
            "dt_bias": torch.full((di,), -4.6, **f32),  # softplus^-1(0.01)
            "A_log": torch.log(a).contiguous(),          # [di, ds]
            "D": torch.ones((di,), **f32),
            "out_proj": normal(gen, (di, d), di ** -0.5, dtype, device)}


# the dim each weight splits over ``model`` (its ``p_out``: the channels)
_TP_DIM = {"in_proj": 1, "conv_w": 1, "conv_b": 0, "x_proj": 0,
           "dt_proj": 1, "dt_bias": 0, "A_log": 0, "D": 0, "out_proj": 0}


def _local(tp, params) -> dict:
    """Each weight's block on this rank's channels (see
    ``sharding.TensorParallel``)."""
    return {k: tp.weight(v, _TP_DIM[k]) for k, v in params.items()}


def _in_proj(tp, params, x):
    """x: [B, T, d] -> (x, z) [B, T, di] each, this rank's channels of
    both: ``in_proj``'s split is a contiguous block of ``[x | z]``, so
    its product is regrouped over ``model``."""
    xz = tp.regroup_halves(tp.copy(x) @ params["in_proj"])
    return xz.chunk(2, dim=-1)


def _ssm_params(tp, params, xc: torch.Tensor, cfg: MambaConfig):
    """xc: [..., T, di] conv output -> (dt, B, C) data-dependent, f32.
    ``x_proj`` contracts the channels: its sums are reduced over
    ``model``."""
    r, ds = cfg.rank, cfg.d_state
    proj = tp.reduce(xc @ params["x_proj"])
    dt_r, bm, cm = proj.split([r, ds, ds], dim=-1)
    dt = F.softplus((dt_r @ params["dt_proj"]).float() + params["dt_bias"])
    return dt, bm.float(), cm.float()


def scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """s_t = a_t * s_{t-1} + b_t over axis 1 from s_{-1} = 0, in
    ceil(log2 T) doubling steps (Hillis-Steele): after the step of
    offset o, (a_t, b_t) composes the o-longer run ending at t.  Each step
    builds new tensors (autograd keeps every step's inputs); ``a`` and
    ``b`` are left as they were."""
    t = a.shape[1]
    off = 1
    while off < t:
        b = torch.cat([b[:, :off], b[:, :-off] * a[:, off:] + b[:, off:]],
                      dim=1)
        if 2 * off < t:
            a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
        off *= 2
    return b


def forward(params, x: torch.Tensor, cfg: MambaConfig,
            return_state: bool = False):
    """x: [B, T, d] -> [B, T, d] (prefill path).

    return_state=True additionally returns the decode cache (the last
    ``d_conv - 1`` conv inputs, zeros before the first, and the final ssm
    state).  Under a mesh every rank runs its ``model`` slice of the
    channels (``sharding.TensorParallel``); its caches are its shards."""
    tp = sharding.TensorParallel(x)
    p = _local(tp, params)
    x = tp.local(x)
    t = x.shape[1]
    dc = cfg.d_conv
    xi, z = _in_proj(tp, p, x)                          # [B, T, di] each

    # causal depthwise conv (kernel dc), summed in the JAX package's order
    xpad = F.pad(xi, (0, 0, dc - 1, 0))
    xc = 0
    for i in range(dc):
        xc = xc + xpad[:, i:i + t, :] * p["conv_w"][i]
    xc = F.silu(xc + p["conv_b"])

    dt, bm, cm = _ssm_params(tp, p, xc, cfg)
    a_mat = -torch.exp(p["A_log"])                      # [di, ds]
    # discretize: a_t = exp(dt * A), b_t = dt * B_t * x_t
    a = torch.exp(dt[..., None] * a_mat)                # [B, T, di, ds]
    bx = (dt * xc.float())[..., None] * bm[..., None, :]
    s = scan(a, bx)                                     # [B, T, di, ds]

    y = torch.einsum("btds,bts->btd", s, cm)            # [B, T, di]
    y = y + p["D"] * xc.float()
    y = y.to(x.dtype) * F.silu(z)
    out = tp.out(y @ p["out_proj"])
    if return_state:
        return out, {"conv": tp.cache(xpad[:, t:].to(x.dtype).contiguous(),
                                      2),
                     "ssm": tp.cache(s[:, -1].contiguous(), 1)}
    return out


def init_cache(batch: int, cfg: MambaConfig, dtype=torch.bfloat16,
               device=None) -> dict:
    return {"conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, cfg.d_inner, cfg.d_state),
                               dtype=torch.float32, device=device)}


def decode_step(params, x: torch.Tensor, cache: dict, cfg: MambaConfig):
    """x: [B, 1, d] -> (y [B, 1, d], cache), the cache written in
    place."""
    tp = sharding.TensorParallel(x)
    p = _local(tp, params)
    x = tp.local(x)
    conv = tp.cache_local(cache["conv"], 2)
    ssm = tp.cache_local(cache["ssm"], 1)
    xi, z = _in_proj(tp, p, x)                          # [B, 1, di]
    hist = torch.cat([conv, xi.to(conv.dtype)], dim=1)
    xc = torch.einsum("bcd,cd->bd", hist, p["conv_w"]) + p["conv_b"]
    # contiguous: matmul takes a strided operand by another route where
    # the weight requires grad (a parameter) than where it does not (a
    # DTensor's local block), and the two round apart
    xc = F.silu(xc)[:, None, :].contiguous()            # [B, 1, di]

    dt, bm, cm = _ssm_params(tp, p, xc, cfg)
    a = torch.exp(dt[:, 0, :, None] * -torch.exp(p["A_log"]))
    bx = (dt[:, 0] * xc[:, 0].float())[..., None] * bm[:, 0, None, :]
    s = ssm * a + bx                                    # [B, di, ds]

    y = torch.einsum("bds,bs->bd", s, cm[:, 0])
    y = y + p["D"] * xc[:, 0].float()
    y = y[:, None, :].to(x.dtype) * F.silu(z)
    conv.copy_(hist[:, 1:])
    ssm.copy_(s)
    return tp.out(y @ p["out_proj"]), cache
