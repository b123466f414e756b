"""Mixture-of-Experts (top-k routing, capacity-bounded scatter dispatch).

The port of the JAX package's ``models/layers/moe.py``: tokens are
scatter-packed into an [E, C, d] buffer (C = capacity per expert, over
the tokens of the whole batch), the experts run as one batched SwiGLU over E
(``torch.bmm``: the JAX package leaves these products to XLA, outside
any kernel of its own), and the outputs are gathered back and combined
with the gates.  The router is softmax-then-top-k with renormalised
gates, as in Mixtral; ties go to the lower expert index, as
``jax.lax.top_k`` breaks them.  Each (token, slot) takes its place in
its expert's buffer from a cumsum in token-major, slot-minor order;
past the capacity it is dropped.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding
from repro_torch.models.layers.init import normal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int
    n_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25


def init(gen: torch.Generator | None, cfg: MoEConfig, dtype=torch.bfloat16,
         device=None) -> dict:
    """The layer's weights (the router in float32), drawn from ``gen``
    (None: uninitialized, to be loaded)."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"router": normal(gen, (d, e), d ** -0.5, torch.float32, device),
            "wi": normal(gen, (e, d, ff), d ** -0.5, dtype, device),
            "wg": normal(gen, (e, d, ff), d ** -0.5, dtype, device),
            "wo": normal(gen, (e, ff, d), ff ** -0.5, dtype, device)}


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, (c + 7) // 8 * 8)


def route(params, xf: torch.Tensor, cfg: MoEConfig):
    """xf: [N, d] -> (probs f32[N, E], gates f32[N, k] renormalised,
    experts int64[N, k]): the k largest probabilities of each token, in
    descending order, ties to the lower expert index (a stable sort)."""
    probs = torch.softmax(xf.float() @ params["router"], dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :cfg.top_k], idx[:, :cfg.top_k]
    return probs, gate / gate.sum(dim=-1, keepdim=True), idx


def slots(idx: torch.Tensor, n_experts: int):
    """experts int[N, k] -> (one-hot int[N, k, E], each (token, slot)'s
    place in its expert's buffer int[N, k]: a cumsum over the flattened
    [N * k], token-major)."""
    n, k = idx.shape
    onehot = F.one_hot(idx, n_experts)
    pos_flat = torch.cumsum(onehot.reshape(n * k, n_experts), dim=0) - 1
    return onehot, (pos_flat.reshape(n, k, n_experts) * onehot).sum(dim=-1)


def experts(params, buf: torch.Tensor) -> torch.Tensor:
    """The batched expert FFN (SwiGLU), E leading: [E, C, d] -> [E, C, d]."""
    h = F.silu(torch.bmm(buf, params["wg"])) * torch.bmm(buf, params["wi"])
    return torch.bmm(h, params["wo"])


def forward(params, x: torch.Tensor, cfg: MoEConfig):
    """x: [B, T, d] -> (y [B, T, d], aux_loss f32 scalar).

    aux_loss is the standard load-balancing loss (mean_prob * mean_assign
    * E), which the JAX package's training step adds.

    Under a mesh (``sharding.TensorParallel``) each rank routes its own
    tokens (whole over ``model``), gathers the batch's routing decisions
    (N * k ints), and takes its tokens' places from the cumsum over all
    of them: routing, capacity and drops are the whole batch's, as in
    the JAX package.  It scatters its tokens into the [E, C, d] buffer of
    the whole batch's C and runs every expert on its ``model`` slice of
    ``d_ff``; the combined outputs are partial sums over ``model``.
    """
    tp = sharding.TensorParallel(x)
    xl = tp.local(x)
    b, t, d = xl.shape
    n = b * t
    e, k = cfg.n_experts, cfg.top_k
    probs, gate, idx = route({"router": tp.weight(params["router"])},
                             xl.reshape(n, d), cfg)
    idx_all, row0 = tp.gather_rows(idx.reshape(b, t, k))
    n_all = idx_all.shape[0] * t
    cap = capacity(n_all, cfg)
    onehot_all, pos_all = slots(idx_all.reshape(n_all, k), e)
    pos = pos_all[row0 * t:row0 * t + n]
    keep = pos < cap

    # scatter tokens into [E, C, d]; the dropped ones all land in the
    # extra row (E, C), which is cut off
    e_idx = torch.where(keep, idx, e)
    c_idx = torch.where(keep, pos, cap)
    xf = tp.copy(xl.reshape(n, d))
    buf = xf.new_zeros((e + 1, cap + 1, d))
    buf.index_put_((e_idx.reshape(-1), c_idx.reshape(-1)),
                   xf.repeat_interleave(k, dim=0))

    y_e = experts({name: tp.weight(params[name], dim) for name, dim in
                   (("wi", 2), ("wg", 2), ("wo", 1))}, buf[:e, :cap])

    # gather back + weighted combine
    y_tok = y_e[e_idx.clamp(max=e - 1), c_idx.clamp(max=cap - 1)]
    y_tok = torch.where(keep[..., None], y_tok, 0.0)              # [N, k, d]
    y = (y_tok * tp.copy(gate)[..., None].to(y_tok.dtype)).sum(dim=1)

    me = tp.sum_rows(probs.sum(dim=0)) / n_all                    # [E]
    ce = onehot_all.sum(dim=1).float().mean(dim=0)
    aux = (me * ce).sum() * e
    return tp.out(y.reshape(b, t, d)), tp.replicated(aux)
