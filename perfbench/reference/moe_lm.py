"""Plain float32 forward of a decoder-only MoE language model.

The model the MoE cells serve: token embedding; per layer RMSNorm,
grouped-query attention with rotary positions (halves rotated, not
interleaved pairs) under a causal and optional sliding-window mask, its
output projection and the residual; RMSNorm, the MoE feed-forward and the
residual; a final RMSNorm and the output head.  The MoE's router is a
softmax over the experts then the top k in descending order (ties to the
lower expert, a stable sort), the k gates renormalised to sum 1; each
expert is a SwiGLU, silu(x Wg) * (x Wi) then Wo.

Capacity, as the port documents it: one MoE call over N tokens gives
each expert ``Dims.capacity(N)`` slots; the (token, slot) pairs take
their places in token-major, slot-minor order, and those past the
capacity are dropped (add nothing).  ``groups`` names the positions of
a sequence that went through one call together: a B=1 prefill is one
call over the prompt.  A decode step is one call over all the engine's
slots; a sequence decoded in a slot below the step's capacity is never
dropped there (each token has at most one pair in an expert, so a pair's
place is at most its slot's index), so positions outside every group
are never dropped.

Sequences are processed layer by layer, all together, so each layer's
weights are drawn and held once (``layer(i)`` returns them, bf16 as
served; each expert is widened to float32 when it is used).  Matrix
products run in float32 with TF32 off.  ``precision="float8"`` is the
control: the operands of every projection (qkv, the attention output,
the experts' three products, the head) rounded to float8 e4m3 with a
scale a row of activations and a column of weights; the router, the
norms and the attention's scores stay float32.  ``"bfloat16"`` computes
those projections in bf16 (operands and result), the precision the
configurations state: a witness of what rounding alone does.

Imports nothing but torch.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

_E4M3_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale along ``dim``'s slices."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x [N, a] @ w [a, b] -> float32 (w any float type)."""
    if precision == "bfloat16":
        return (x.bfloat16() @ w.bfloat16()).float()
    w = w.float()
    if precision == "float8":
        return _fp8(x, -1) @ _fp8(w, 0)
    return x @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [H, T, D]; pos float[T]."""
    half = x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half)
    ang = pos[:, None] * inv[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, window: int | None, block: int = 1024):
    """Causal (and windowed) attention of one sequence: q [Hq, T, D],
    k, v [Hkv, T, D] -> [T, Hq * D], in query blocks."""
    hq, t, dh = q.shape
    hkv = k.shape[0]
    g = hq // hkv
    out = torch.empty((t, hq * dh), dtype=torch.float32, device=q.device)
    kpos = torch.arange(t, device=q.device)
    for s in range(0, t, block):
        e = min(t, s + block)
        qb = q[:, s:e].reshape(hkv, g, e - s, dh) * dh ** -0.5
        sc = torch.einsum("hgqd,hkd->hgqk", qb, k[:, :e])
        qpos = kpos[s:e, None]
        mask = kpos[None, :e] <= qpos
        if window is not None:
            mask &= kpos[None, :e] > qpos - window
        p = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
        ob = torch.einsum("hgqk,hkd->hgqd", p, v[:, :e])
        out[s:e] = ob.reshape(hq, e - s, dh).permute(1, 0, 2).reshape(
            e - s, hq * dh)
    return out


def route(x: torch.Tensor, router: torch.Tensor, top_k: int):
    """x [N, d] -> (gates [N, k] renormalised, experts [N, k])."""
    probs = torch.softmax(x @ router.float(), dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :top_k], idx[:, :top_k]
    return gate / gate.sum(-1, keepdim=True), idx


def kept(idx: torch.Tensor, groups, n_experts: int, capacity) -> torch.Tensor:
    """bool [N, k]: which (token, slot) pairs survive capacity, each
    group (start, end) one call of ``capacity(end - start)`` slots an
    expert; positions outside every group all survive."""
    keep = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
    for s, e in groups:
        n, k = e - s, idx.shape[1]
        onehot = F.one_hot(idx[s:e].reshape(n * k), n_experts)
        place = ((torch.cumsum(onehot, 0) - 1) * onehot).sum(-1)
        keep[s:e] = (place < capacity(n)).reshape(n, k)
    return keep


def moe(x, w, dims, gate, idx, keep, precision: str):
    """The experts' combined output [N, d] for the kept pairs."""
    y = torch.zeros_like(x)
    for ex in range(dims.n_experts):
        tok, slot = torch.nonzero((idx == ex) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        h = F.silu(_mm(xe, w["ffn.wg"][ex], precision)) \
            * _mm(xe, w["ffn.wi"][ex], precision)
        y.index_add_(0, tok, _mm(h, w["ffn.wo"][ex], precision)
                     * gate[tok, slot][:, None])
    return y


def logits(dims, seqs, groups, layer, outer, served, *,
           precision: str = "float32", routes: list | None = None):
    """Float32 logits of each sequence at its ``served`` positions.

    seqs: int tensors [T_s] on the device; groups: per sequence, a list
    of (start, end) MoE calls; layer(i) -> layer i's weights (names
    without the ``layers.i.`` prefix); outer() -> ``embed``,
    ``final_norm.scale``, ``lm_head``; served: per sequence, the
    positions whose next-token logits are wanted; ``routes``, if a list,
    gets each layer's experts [N, k] of all positions.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hq, hkv, dh = dims.n_heads, dims.n_kv_heads, dims.head_dim
    lens = [int(s.numel()) for s in seqs]
    starts = [0, *itertools.accumulate(lens)]
    ow = outer()
    x = torch.cat([ow["embed"][s].float() for s in seqs])
    pos = [torch.arange(n, dtype=torch.float32, device=x.device)
           for n in lens]
    groups_all = [(a + starts[i], b + starts[i])
                  for i, g in enumerate(groups) for a, b in g]
    for i in range(dims.n_layers):
        w = layer(i)
        h = rmsnorm(x, w["ln1.scale"].float(), dims.norm_eps)
        qkv = _mm(h, w["mixer.wqkv"], precision)
        att = torch.empty((x.shape[0], hq * dh), device=x.device)
        for j, n in enumerate(lens):
            a = starts[j]
            blk = qkv[a:a + n]
            q = blk[:, :hq * dh].reshape(n, hq, dh).transpose(0, 1)
            k = blk[:, hq * dh:(hq + hkv) * dh].reshape(n, hkv, dh
                                                        ).transpose(0, 1)
            v = blk[:, (hq + hkv) * dh:].reshape(n, hkv, dh).transpose(0, 1)
            q = rope(q, pos[j], dims.rope_theta)
            k = rope(k, pos[j], dims.rope_theta)
            att[a:a + n] = attention(q, k, v, dims.window)
        del qkv
        x = x + _mm(att, w["mixer.wo"], precision)
        del att
        h = rmsnorm(x, w["ln2.scale"].float(), dims.norm_eps)
        gate, idx = route(h, w["ffn.router"], dims.top_k)
        if routes is not None:
            routes.append(idx)
        keep = kept(idx, groups_all, dims.n_experts, dims.capacity)
        x = x + moe(h, w, dims, gate, idx, keep, precision)
        del w, h
    out = []
    for j, p in enumerate(served):
        rows = x[starts[j] + torch.as_tensor(p, device=x.device)]
        hn = rmsnorm(rows, ow["final_norm.scale"].float(), dims.norm_eps)
        out.append(_mm(hn, ow["lm_head"], precision))
    return out


def gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below the row's best, float32."""
    best = ref_logits.amax(-1)
    return best - ref_logits.gather(-1, tokens[:, None].long())[:, 0]
