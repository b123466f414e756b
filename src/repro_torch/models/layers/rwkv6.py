"""RWKV-6 "Finch" mixer: attention-free, data-dependent per-channel decay.

The port of the JAX package's ``models/layers/rwkv6.py``.  Time-mixing
recurrence (per head, head size N):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with a data-dependent decay w_t = exp(-exp(wf_t)) from a low-rank MLP of
the token-shifted input, and the bonus u for the current token.

``forward`` walks the tokens one at a time (``scan``, the JAX package's
``lax.scan``: each step forms its own ``k_t^T v_t``, six launches a
token after the products); ``forward_chunked`` is the blocked form, the
state carried only across chunks.  Decode carries (shift, state) and
writes both in place.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding
from repro_torch.models.layers.init import normal
from repro_torch.models.layers.scan import scan


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


# the dim each weight splits over ``model`` (its ``p_out``: the heads);
# ``mu``, ``wd1`` and ``bonus`` are whole on every rank
_TP_DIM = {"wr": 1, "wk": 1, "wv": 1, "wg": 1, "wd2": 1, "decay_base": 0,
           "ln_scale": 0, "wo": 0}


def _local(tp, params) -> dict:
    """Each weight as this rank computes with it (see
    ``sharding.TensorParallel``): the projections, decay and norm on its
    heads, ``bonus`` the rows of its heads."""
    p = {k: tp.weight(v, _TP_DIM.get(k), partial=k not in _TP_DIM)
         for k, v in params.items()}
    p["bonus"] = tp.block(p["bonus"], 0)
    return p


def _mix(x, x_prev, mu):
    """Token shift: lerp(current, previous, mu)."""
    return x + (x_prev - x) * mu.to(x.dtype)


def _projections(params, x, x_prev, cfg: RWKV6Config):
    """x, x_prev: [..., d] -> r, k, v, g [..., H, N], w decay [..., H, N]
    (f32), on the heads of the weights' columns."""
    n = cfg.head_size
    mu = params["mu"]
    r = _mix(x, x_prev, mu[0]) @ params["wr"]
    k = _mix(x, x_prev, mu[1]) @ params["wk"]
    v = _mix(x, x_prev, mu[2]) @ params["wv"]
    g = _mix(x, x_prev, mu[3]) @ params["wg"]
    wf = torch.tanh(_mix(x, x_prev, mu[4]) @ params["wd1"]) @ params["wd2"]
    w = torch.exp(-torch.exp(wf.float() + params["decay_base"]))
    shp = x.shape[:-1]
    return tuple(a.reshape(*shp, -1, n) for a in (r, k, v, g, w))


def _group_norm(params, o):
    """Per-head RMS normalization of the output."""
    var = (o * o).mean(dim=-1, keepdim=True)
    o = o * torch.rsqrt(var + 1e-6)
    return o.flatten(-2) * params["ln_scale"]


def _out(tp, params, o, g, dtype):
    """Group norm, the SiLU gate and the out-projection: [B, T, d]
    (under a mesh partial sums over ``model``)."""
    o = _group_norm(params, o).to(dtype)
    return tp.out((o * F.silu(g.flatten(-2))) @ params["wo"])


def _step(state, x_t, consts):
    """One token: (state [B, H, N, N], (r, k, v, w) [B, H, N]) -> (the
    next state, o [B, H, N]), the JAX package's scan body."""
    r, k, v, w = x_t
    (u,) = consts                                           # [H, N, 1]
    kv = k[..., :, None] * v[..., None, :]                  # [B, H, N, N]
    out = torch.einsum("bhn,bhnm->bhm", r, state + u * kv)
    return w[..., None] * state + kv, out


def recurrence(r, k, v, w, u, state):
    """The time-mixing recurrence one token at a time: r, k, v, w [B, T,
    H, N] f32, u [H, N], state [B, H, N, N] -> (o [B, T, H, N], the
    final state)."""
    state, o = scan(_step, state, (r, k, v, w), (u[..., None],))
    return o, state


def forward(params, x: torch.Tensor, cfg: RWKV6Config,
            return_state: bool = False):
    """x: [B, T, d] -> [B, T, d] (prefill), one token at a time.

    return_state=True additionally returns the decode cache.  Under a
    mesh every rank runs its ``model`` slice of the heads
    (``sharding.TensorParallel``); its ``state`` is its shard."""
    tp = sharding.TensorParallel(x)
    p = _local(tp, params)
    x = tp.copy(tp.local(x))
    b, t, _ = x.shape
    n = cfg.head_size
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :t]
    r, k, v, g, w = _projections(p, x, x_prev, cfg)
    state = x.new_zeros((b, r.shape[2], n, n), dtype=torch.float32)
    o, state = recurrence(r.float(), k.float(), v.float(), w, p["bonus"],
                          state)
    out = _out(tp, p, o, g, x.dtype)
    if return_state:
        return out, {"shift": tp.cache(x[:, -1].contiguous(), None),
                     "state": tp.cache(state, 1)}
    return out


def forward_chunked(params, x: torch.Tensor, cfg: RWKV6Config,
                    chunk: int = 32, return_state: bool = False):
    """The blocked RWKV6 recurrence: the state crosses HBM once a chunk,
    not once a token; within a chunk a masked decay-weighted attention
    matrix (the flash-linear-attention chunk form).  Every decay
    exponential is a difference L_a - L_b with a >= b along time, so
    exp() stays in (0, 1]."""
    tp = sharding.TensorParallel(x)
    p = _local(tp, params)
    x = tp.copy(tp.local(x))
    b, t, _ = x.shape
    n = cfg.head_size
    if t % chunk:
        raise ValueError(f"T {t} is not a multiple of the chunk {chunk}")
    nc = t // chunk
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :t]
    r, k, v, g, w = _projections(p, x, x_prev, cfg)
    h = r.shape[2]
    u = p["bonus"]                                       # [H, N]

    def resh(a):  # [B, T, H, N] -> [B, nc, C, H, N]
        return a.reshape(b, nc, chunk, h, n)
    rf, kf, vf = (resh(a.float()) for a in (r, k, v))
    logw = torch.log(resh(w).clamp(min=1e-38))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device), diagonal=-1)  # s < t

    s = x.new_zeros((b, h, n, n), dtype=torch.float32)
    outs = []
    for rc, kc, vc, lw in zip(*(a.unbind(1) for a in (rf, kf, vf, logw))):
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
    out = _out(tp, p, o, g, x.dtype)
    if return_state:
        return out, {"shift": tp.cache(x[:, -1].contiguous(), None),
                     "state": tp.cache(s, 1)}
    return out


def init_cache(batch: int, cfg: RWKV6Config, dtype=torch.bfloat16,
               device=None) -> dict:
    return {"shift": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                 device=device),
            "state": torch.zeros((batch, cfg.n_heads, cfg.head_size,
                                  cfg.head_size), dtype=torch.float32,
                                 device=device)}


def decode_step(params, x: torch.Tensor, cache: dict, cfg: RWKV6Config):
    """x: [B, 1, d] -> (y [B, 1, d], cache), the cache written in place
    (under a mesh: every rank its heads' ``state``, and the same
    ``shift``)."""
    tp = sharding.TensorParallel(x)
    p = _local(tp, params)
    xt = tp.copy(tp.local(x))[:, 0]
    shift = tp.cache_local(cache["shift"], None)
    state = tp.cache_local(cache["state"], 1)
    r, k, v, g, w = _projections(p, xt, shift.to(xt.dtype), cfg)
    kv = k.float()[..., :, None] * v.float()[..., None, :]
    out = torch.einsum("bhn,bhnm->bhm", r.float(),
                       state + p["bonus"][..., None] * kv)
    state.mul_(w[..., None]).add_(kv)
    shift.copy_(xt)
    return _out(tp, p, out[:, None], g[:, None], xt.dtype), cache
