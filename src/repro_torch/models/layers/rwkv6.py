"""RWKV-6 "Finch" mixer: attention-free, data-dependent per-channel decay.

The port of the JAX package's ``models/layers/rwkv6.py``.  Time-mixing
recurrence (per head, head size N):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with a data-dependent decay w_t = exp(-exp(wf_t)) from a low-rank MLP of
the token-shifted input, and the bonus u for the current token.

``forward`` walks the tokens one at a time (a Python loop: four
launches a token after the products, computed for all tokens at once);
``forward_chunked`` is the blocked form, the state carried only across
chunks.  Decode carries (shift, state) and writes both in place.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding
from repro_torch.models.layers.init import normal


@dataclasses.dataclass(frozen=True)
class RWKV6Config:
    d_model: int
    head_size: int = 64
    decay_rank: int = 64      # low-rank bottleneck for the decay MLP

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_size


def init(gen: torch.Generator | None, cfg: RWKV6Config, dtype=torch.bfloat16,
         device=None) -> dict:
    """The layer's weights (``mu``, ``decay_base``, ``bonus`` and
    ``ln_scale`` in float32), drawn from ``gen`` (None: uninitialized,
    to be loaded)."""
    d, hs, rank = cfg.d_model, cfg.head_size, cfg.decay_rank
    f32 = dict(dtype=torch.float32, device=device)
    std = d ** -0.5
    p = {"mu": torch.full((5, d), 0.5, **f32)}
    for name in ("wr", "wk", "wv", "wg"):
        p[name] = normal(gen, (d, d), std, dtype, device)
    p["wd1"] = normal(gen, (d, rank), std, dtype, device)
    p["wd2"] = normal(gen, (rank, d), rank ** -0.5, dtype, device)
    p["decay_base"] = torch.full((d,), -6.0, **f32)
    p["bonus"] = normal(gen, (cfg.n_heads, hs), 0.1, torch.float32, device)
    p["wo"] = normal(gen, (d, d), std, dtype, device)
    p["ln_scale"] = torch.ones((d,), **f32)
    return p


def _mix(x, x_prev, mu):
    """Token shift: lerp(current, previous, mu)."""
    return x + (x_prev - x) * mu.to(x.dtype)


def _projections(params, x, x_prev, cfg: RWKV6Config):
    """x, x_prev: [..., d] -> r, k, v, g [..., H, N], w decay [..., H, N]
    (f32)."""
    h, n = cfg.n_heads, cfg.head_size
    mu = params["mu"]
    r = _mix(x, x_prev, mu[0]) @ params["wr"]
    k = _mix(x, x_prev, mu[1]) @ params["wk"]
    v = _mix(x, x_prev, mu[2]) @ params["wv"]
    g = _mix(x, x_prev, mu[3]) @ params["wg"]
    wf = torch.tanh(_mix(x, x_prev, mu[4]) @ params["wd1"]) @ params["wd2"]
    w = torch.exp(-torch.exp(wf.float() + params["decay_base"]))
    shp = x.shape[:-1]
    return tuple(a.reshape(*shp, h, n) for a in (r, k, v, g, w))


def _group_norm(params, o, cfg: RWKV6Config):
    """Per-head RMS normalization of the output."""
    var = (o * o).mean(dim=-1, keepdim=True)
    o = o * torch.rsqrt(var + 1e-6)
    return o.reshape(*o.shape[:-2], cfg.d_model) * params["ln_scale"]


def _out(params, o, g, x, cfg: RWKV6Config):
    """Group norm, the SiLU gate and the out-projection: [B, T, d]."""
    b, t, d = x.shape
    o = _group_norm(params, o, cfg).to(x.dtype)
    return (o * F.silu(g.reshape(b, t, d))) @ params["wo"]


def forward(params, x: torch.Tensor, cfg: RWKV6Config,
            return_state: bool = False):
    """x: [B, T, d] -> [B, T, d] (prefill), one token at a time.

    return_state=True additionally returns the decode cache."""
    if sharding.is_dtensor(x):
        return sharding.replicated_call(forward, params, x, cfg,
                                        return_state=return_state)
    b, t, _ = x.shape
    h, n = cfg.n_heads, cfg.head_size
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :t]
    r, k, v, g, w = _projections(params, x, x_prev, cfg)
    rf = r.float()
    kv = k.float()[..., :, None] * v.float()[..., None, :]  # [B,T,H,N,N]
    ukv = params["bonus"][..., None] * kv
    state = x.new_zeros((b, h, n, n), dtype=torch.float32)
    outs = []
    for i in range(t):
        outs.append(torch.einsum("bhn,bhnm->bhm", rf[:, i],
                                 state + ukv[:, i]))
        state = w[:, i, ..., None] * state + kv[:, i]
    out = _out(params, torch.stack(outs, dim=1), g, x, cfg)
    if return_state:
        return out, {"shift": x[:, -1].contiguous(), "state": state}
    return out


def forward_chunked(params, x: torch.Tensor, cfg: RWKV6Config,
                    chunk: int = 32, return_state: bool = False):
    """The blocked RWKV6 recurrence: the state crosses HBM once a chunk,
    not once a token; within a chunk a masked decay-weighted attention
    matrix (the flash-linear-attention chunk form).  Every decay
    exponential is a difference L_a - L_b with a >= b along time, so
    exp() stays in (0, 1]."""
    if sharding.is_dtensor(x):
        return sharding.replicated_call(forward_chunked, params, x, cfg,
                                        chunk=chunk,
                                        return_state=return_state)
    b, t, d = x.shape
    h, n = cfg.n_heads, cfg.head_size
    if t % chunk:
        raise ValueError(f"T {t} is not a multiple of the chunk {chunk}")
    nc = t // chunk
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :t]
    r, k, v, g, w = _projections(params, x, x_prev, cfg)
    u = params["bonus"]                                  # [H, N]

    def resh(a):  # [B, T, H, N] -> [B, nc, C, H, N]
        return a.reshape(b, nc, chunk, h, n)

    rf, kf, vf = (resh(a.float()) for a in (r, k, v))
    logw = torch.log(resh(w).clamp(min=1e-38))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device), diagonal=-1)  # s < t

    s = x.new_zeros((b, h, n, n), dtype=torch.float32)
    outs = []
    for c in range(nc):
        rc, kc, vc, lw = rf[:, c], kf[:, c], vf[:, c], logw[:, c]
        big_l = torch.cumsum(lw, dim=1)        # L_t = sum_{s<=t} log w_s
        l_prev = big_l - lw                    # L_{t-1}
        # cross-chunk: o_t += (r_t * exp(L_{t-1})) @ S
        o_cross = torch.einsum("bthn,bhnm->bthm", rc * torch.exp(l_prev), s)
        # intra-chunk (s < t): D[t,s,n] = exp(L_{t-1,n} - L_{s,n}) <= 1
        diff = l_prev[:, :, None] - big_l[:, None]       # [B,C,C,H,N]
        dmat = torch.exp(diff.clamp(max=0.0))
        att = torch.einsum("bthn,bshn,btshn->btsh", rc, kc, dmat)
        att = att * tri[None, :, :, None]
        o_intra = torch.einsum("btsh,bshn->bthn", att, vc)
        # bonus (current token): (r_t . u k_t) v_t
        o_bonus = (rc * u * kc).sum(dim=-1, keepdim=True) * vc
        # state to the chunk's end: S' = diag(exp L_C) S + sum_t k'_t v_t
        k_dec = kc * torch.exp(big_l[:, -1:] - big_l)
        s = (torch.exp(big_l[:, -1])[..., None] * s
             + torch.einsum("bthn,bthm->bhnm", k_dec, vc))
        outs.append(o_cross + o_intra + o_bonus)
    o = torch.stack(outs, dim=1).reshape(b, t, h, n)
    out = _out(params, o, g, x, cfg)
    if return_state:
        return out, {"shift": x[:, -1].contiguous(), "state": s}
    return out


def init_cache(batch: int, cfg: RWKV6Config, dtype=torch.bfloat16,
               device=None) -> dict:
    return {"shift": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                 device=device),
            "state": torch.zeros((batch, cfg.n_heads, cfg.head_size,
                                  cfg.head_size), dtype=torch.float32,
                                 device=device)}


def decode_step(params, x: torch.Tensor, cache: dict, cfg: RWKV6Config):
    """x: [B, 1, d] -> (y [B, 1, d], cache), the cache written in
    place."""
    if sharding.is_dtensor(x):
        return sharding.replicated_call(decode_step, params, x, cfg,
                                        cache=cache)
    xt = x[:, 0]
    r, k, v, g, w = _projections(params, xt, cache["shift"].to(xt.dtype),
                                 cfg)
    kv = k.float()[..., :, None] * v.float()[..., None, :]
    out = torch.einsum("bhn,bhnm->bhm", r.float(),
                       cache["state"] + params["bonus"][..., None] * kv)
    cache["state"].mul_(w[..., None]).add_(kv)
    cache["shift"].copy_(xt)
    return _out(params, out[:, None], g, x, cfg), cache
