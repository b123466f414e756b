"""GQA attention: prefill through the flash kernel, decode with a cache.

Three execution paths, all matching ``repro_torch.kernels.ref.attention_ref``:

* ``repro_torch.kernels.flash_attention`` — the CUDA kernel
  (``kernels/csrc/flash_attn.cu``), the prefill's path on a card.
* ``chunked_attention`` — online softmax over KV chunks in plain
  PyTorch, the same math; the prefill's path on the CPU, or anywhere
  with ``backend="ref"``.
* ``decode_attention`` — one-token query against a KV cache laid out
  [B, Hkv, S, D]: on a card the decode kernel
  (``repro_torch.kernels.decode_attention``, ``kernels/csrc/decode_attn.cu``),
  which reads each sequence's live positions of the cache in place;
  elsewhere its plain version (the JAX package computes it outside any
  kernel of its own).

Cross-attention (whisper's decoder) takes q from the decoder stream and
k, v from the encoder's output: the same three paths, not causal.

Weights layout: fused qkv projection [d, (Hq + 2*Hkv) * Dh] so one matmul
produces q/k/v.  ``decode_step`` writes the new token's k and v into the
cache in place (no copy of the cache per step) and returns it.

Under a mesh (``repro_torch.distributed.sharding.use_mesh``) q, k and v
are DTensors.  The prefill's attention then runs on each rank's local
tensors (:func:`_sharded_attention`): the flash kernel's ctypes launch
never sees a DTensor.  A DTensor cache is written on the rank that holds
the slot (:func:`_write_slot`).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import is_dtensor as _is_dtensor
from repro_torch.distributed.sharding import matmul
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import \
    decode_attention as kernel_decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers.init import normal
from repro_torch.models.layers.rope import apply_rope, apply_rope_per_batch
from repro_torch.runtime import tracing

_NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    window: int | None = None     # sliding-window size (None = full)
    causal: bool = True           # False for encoder self-attention
    use_bias: bool = False
    chunk_k: int = 1024           # kv block for the chunked path
    use_rope: bool = True


def init(gen: torch.Generator | None, cfg: AttnConfig,
         dtype=torch.bfloat16, device=None) -> dict:
    """The layer's weights, drawn from ``gen`` (None: uninitialized,
    to be loaded)."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wqkv": normal(gen, (d, (hq + 2 * hkv) * hd), d ** -0.5, dtype,
                        device),
         "wo": normal(gen, (hq * hd, d), (hq * hd) ** -0.5, dtype, device)}
    if cfg.use_bias:
        p["bqkv"] = torch.zeros(((hq + 2 * hkv) * hd,), dtype=dtype,
                                device=device)
        p["bo"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def _split_qkv(params, x: torch.Tensor, cfg: AttnConfig):
    """x: [B, T, d] -> q [B, Hq, T, Dh], k/v [B, Hkv, T, Dh] (transposed
    views of one projection)."""
    b, t, _ = x.shape
    qkv = matmul(x, params["wqkv"])
    if cfg.use_bias:
        qkv = qkv + params["bqkv"]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = qkv.split([hq * hd, hkv * hd, hkv * hd], dim=-1)
    q = q.reshape(b, t, hq, hd).transpose(1, 2)
    k = k.reshape(b, t, hkv, hd).transpose(1, 2)
    v = v.reshape(b, t, hkv, hd).transpose(1, 2)
    return q, k, v


def chunked_attention(q, k, v, *, causal=True, window=None, chunk_k=1024,
                      q_offset=0):
    """Online-softmax attention, looping over kv chunks.

    q: [B, Hq, Tq, D]; k, v: [B, Hkv, Tk, D].  ``q_offset``: absolute
    position of q[...,0,:] minus that of k[...,0,:] (prefill: Tk - Tq).
    """
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = d ** -0.5
    chunk_k = min(chunk_k, tk)
    tk_valid = tk
    if tk % chunk_k:
        pad = chunk_k - tk % chunk_k
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        tk = k.shape[2]
    nk = tk // chunk_k

    dev = q.device
    qg = (q.float() * scale).reshape(b, hkv, group, tq, d)
    kf, vf = k.float(), v.float()
    q_pos = torch.arange(tq, device=dev) + q_offset
    acc = torch.zeros((b, hkv, group, tq, d), dtype=torch.float32,
                      device=dev)
    m = torch.full((b, hkv, group, tq, 1), _NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, hkv, group, tq, 1), dtype=torch.float32, device=dev)
    for j in range(nk):
        kj = kf[:, :, j * chunk_k:(j + 1) * chunk_k]
        vj = vf[:, :, j * chunk_k:(j + 1) * chunk_k]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kj)
        k_pos = j * chunk_k + torch.arange(chunk_k, device=dev)
        mask = (k_pos[None, :] < tk_valid).expand(tq, chunk_k)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window is not None:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(mask, s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        p = torch.where(mask, p, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", p, vj)
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    out = (acc / l).reshape(b, hq, tq, d)
    return out.to(q.dtype)


class _DenseGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous gradient: the
    backward of a DTensor's ``to_local`` and ``redistribute`` views the
    gradient in the layout it gets, which a strided one does not fit."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _sharded_attention(q, k, v, *, causal, window, chunk_k, kernel):
    """Attention of DTensors q [B, Hq, Tq, D], k, v [B, Hkv, Tk, D] on
    each rank's local tensors, no collective beyond the placement.

    q takes ("batch", "heads", "mix_seq", None) under the active rules:
    heads-TP splits its heads, sequence-parallel rules its rows; an axis
    that does not divide its dim is dropped, and so is a head split whose
    local heads do not map onto whole KV heads (or share one).  k and v
    are gathered but for the batch, as GSPMD gathers them.  A rank
    attends its q rows over its KV heads, cut after its last row where
    the mask is causal or windowed (its rows are then the last of the
    stream, the kernel's convention); a non-causal windowed mask keeps q
    whole.  ``kernel``: the flash kernel on each rank's plain tensors,
    else ``chunked_attention``.  Returns the output as a DTensor [B, Tq,
    Hq * D] (the layout the output projection reads)."""
    mesh = q.device_mesh
    ctx = sharding.current_mesh()
    rules = ctx[1] if ctx is not None else sharding.DEFAULT_RULES
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    group = hq // hkv
    spec = list(sharding.fit_spec(mesh, sharding.logical_spec(
        ("batch", "heads", "mix_seq", None), mesh, rules), q.shape))
    sizes = sharding.axis_sizes(mesh)
    if spec[1] is not None:
        hq_loc = hq // math.prod(
            sizes[a] for a in sharding.spec_axes(spec[1]))
        if hq_loc % group and group % hq_loc:
            spec[1] = None
    if not causal and window is not None:
        spec[2] = None
    q_pl = sharding.spec_placements(mesh, tuple(spec))
    kv_pl = sharding.spec_placements(mesh, (spec[0],))
    # the ranks along a mesh dim that splits q use k and v for other rows
    # or heads: their gradients are partial sums there
    kv_grad = [Partial() if qp.is_shard() and not kp.is_shard() else kp
               for qp, kp in zip(q_pl, kv_pl)]
    q_l, k_l, v_l = (_DenseGrad.apply(sharding.as_dtensor(t, mesh)
                                      .redistribute(mesh, pl)
                                      .to_local(grad_placements=gp))
                     for t, pl, gp in ((q, q_pl, q_pl), (k, kv_pl, kv_grad),
                                       (v, kv_pl, kv_grad)))
    _, (_, h0, t0, _) = sharding.local_block(q.shape, mesh, q_pl)
    h1 = h0 + q_l.shape[1]
    kv_heads = slice(h0 // group, (h1 - 1) // group + 1)
    k_l, v_l = k_l[:, kv_heads], v_l[:, kv_heads]
    if causal or window is not None:
        end = (tk - tq) + t0 + q_l.shape[2]
        k_l, v_l = k_l[:, :, :end], v_l[:, :, :end]
    if kernel:
        out = flash_attention(q_l, k_l, v_l, causal=causal, window=window)
    else:
        out = chunked_attention(q_l, k_l, v_l, causal=causal, window=window,
                                chunk_k=chunk_k,
                                q_offset=k_l.shape[2] - q_l.shape[2])
    # [B, T, Hq * D] on the rank: heads stay whole blocks of the packed
    # dim, so the placements carry over (batch 0, rows 1, heads 2)
    y_pl = sharding.spec_placements(mesh, (spec[0], spec[2], spec[1]))
    out = out.transpose(1, 2).reshape(out.shape[0], out.shape[2], -1)
    return DTensor.from_local(out, mesh, y_pl, run_check=False)


def _sharded_decode_attention(q, k_cache, v_cache, cache_len, window):
    """:func:`decode_attention` of DTensors on each rank's local tensors:
    q keeps its batch and head splits (a head split that does not map
    onto whole KV heads is dropped), the caches are gathered but for the
    batch, and each rank attends its rows and heads.  Returns a DTensor
    placed as q."""
    mesh = q.device_mesh
    ctx = sharding.current_mesh()
    rules = ctx[1] if ctx is not None else sharding.DEFAULT_RULES
    hq, hkv = q.shape[1], k_cache.shape[1]
    group = hq // hkv
    spec = list(sharding.fit_spec(mesh, sharding.logical_spec(
        ("batch", "heads", None, None), mesh, rules), q.shape))
    if spec[1] is not None:
        hq_loc = hq // math.prod(sharding.axis_sizes(mesh)[a]
                                 for a in sharding.spec_axes(spec[1]))
        if hq_loc % group and group % hq_loc:
            spec[1] = None
    q_pl = sharding.spec_placements(mesh, tuple(spec))
    kv_pl = sharding.spec_placements(mesh, (spec[0],))
    q_l = sharding.as_dtensor(q, mesh).redistribute(mesh, q_pl).to_local()
    k_l, v_l = (sharding.as_dtensor(c, mesh).redistribute(mesh, kv_pl)
                .to_local() for c in (k_cache, v_cache))
    _, (b0, h0, _, _) = sharding.local_block(tuple(q.shape), mesh, q_pl)
    h1 = h0 + q_l.shape[1]
    heads = slice(h0 // group, (h1 - 1) // group + 1)
    cl = cache_len
    if not isinstance(cl, int) and torch.as_tensor(cl).ndim == 1:
        cl = torch.as_tensor(cl)[b0:b0 + q_l.shape[0]]
    out = decode_attention(q_l, k_l[:, heads], v_l[:, heads], cl,
                           window=window)
    return DTensor.from_local(out, mesh, q_pl, run_check=False)


def decode_attention(q, k_cache, v_cache, cache_len, *, window=None):
    """Single-token attention over a cache.

    q: [B, Hq, 1, D]; caches: [B, Hkv, S, D]; cache_len: int OR int[B]
    (per-sequence — continuous batching) number of valid positions (the
    new token's kv must already be written at position cache_len - 1).
    On a CUDA tensor it is the decode kernel
    (``repro_torch.kernels.decode_attention``), which reads each
    sequence's live positions in place; elsewhere its plain version.
    DTensors (under a mesh) attend on each rank's local tensors
    (:func:`_sharded_decode_attention`).
    """
    if _is_dtensor(q) or _is_dtensor(k_cache):
        return _sharded_decode_attention(q, k_cache, v_cache, cache_len,
                                         window)
    return kernel_decode_attention(q, k_cache, v_cache, cache_len,
                                   window=window)


# --- full layer forward passes ------------------------------------------------


def forward(params, x, cfg: AttnConfig, *, positions=None, kv_x=None,
            return_kv: bool = False, backend: str = "kernel"):
    """Prefill self- (or cross-) attention.

    x: [B, T, d].  kv_x: the encoder's output for cross-attention (q
    from x, k and v from kv_x; no rope, no causal mask).  Returns
    [B, T, d], or (y, (k, v)) when ``return_kv`` (k/v post-rope,
    [B, Hkv, Tk, D] — prefill cache fill).  On a CUDA tensor the
    attention is the flash kernel; on the CPU, or with
    ``backend="ref"``, it is :func:`chunked_attention`.
    """
    ops._check_backend(backend)
    b, t, _ = x.shape
    causal, window = cfg.causal, cfg.window
    if kv_x is None:
        q, k, v = _split_qkv(params, x, cfg)
        if positions is None:
            positions = torch.arange(t, device=x.device)
        if cfg.use_rope:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    else:
        q, _, _ = _split_qkv(params, x, cfg)
        _, k, v = _split_qkv(params, kv_x, cfg)
        causal, window = False, None
    kernel = backend == "kernel" and x.device.type == "cuda"
    if _is_dtensor(q):
        out = _sharded_attention(q, k, v, causal=causal, window=window,
                                 chunk_k=cfg.chunk_k, kernel=kernel)
    else:
        if kernel:
            out = flash_attention(q, k, v, causal=causal, window=window)
        else:
            out = chunked_attention(q, k, v, causal=causal, window=window,
                                    chunk_k=cfg.chunk_k, q_offset=0)
        out = out.transpose(1, 2).reshape(b, t, -1)
    y = matmul(out, params["wo"])
    if cfg.use_bias:
        y = y + params["bo"]
    if return_kv:
        return y, (k, v)
    return y


def _write_slot(c, cache_len, new, ring: bool) -> None:
    """Write the new token's k or v ([B, Hkv, 1, D]) into a DTensor cache
    [B, Hkv, S, D] in place: each rank writes the rows it holds, into its
    shard of the slot dim where the slot falls (per sequence for an
    int[B] ``cache_len``; the slot is the JAX package's, clamped)."""
    mesh, pl = c.device_mesh, c.placements
    s_alloc = c.shape[2]
    want = [Replicate() if getattr(p, "dim", None) == 2 else p for p in pl]
    new_l = sharding.as_dtensor(new, mesh).redistribute(
        mesh, want).to_local().to(c.dtype)
    (nb, _, ns, _), (b0, _, s0, _) = sharding.local_block(c.shape, mesh,
                                                          pl)
    c_l = c.to_local()
    lens = cache_len if isinstance(cache_len, int) else \
        torch.as_tensor(cache_len).tolist()
    per_seq = isinstance(lens, list)
    for row in range(nb if per_seq else 1):
        n = lens[b0 + row] if per_seq else lens
        slot = min(max(n % s_alloc if ring else n, 0), s_alloc - 1)
        if s0 <= slot < s0 + ns:
            dst = c_l.narrow(2, slot - s0, 1)
            src = new_l
            if per_seq:
                dst, src = dst[row:row + 1], new_l[row:row + 1]
            dst.copy_(src)


def init_cache(batch: int, cfg: AttnConfig, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Sliding-window layers allocate only ``min(max_len, window)`` slots
    and decode with a ring buffer."""
    alloc = max_len if cfg.window is None else min(max_len, cfg.window)
    shape = (batch, cfg.n_kv_heads, alloc, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_step(params, x, cache, cache_len, cfg: AttnConfig):
    """One decode step.  x: [B, 1, d]; cache_len: int or int[B] tokens
    already in the cache (the new token sits at index cache_len).

    Writes the new k and v into ``cache`` in place; returns
    (y [B, 1, d], cache).
    """
    with tracing.span("attn/decode", device=x.is_cuda):
        b = x.shape[0]
        s_alloc = cache["k"].shape[2]
        ring = cfg.window is not None and s_alloc == cfg.window
        cl = torch.as_tensor(cache_len, device=x.device).to(torch.int64)
        per_seq = cl.ndim == 1  # continuous batching
        q, k, v = _split_qkv(params, x, cfg)
        if cfg.use_rope:
            if per_seq:
                q = apply_rope_per_batch(q, cl, cfg.rope_theta)
                k = apply_rope_per_batch(k, cl, cfg.rope_theta)
            else:
                pos = cl.reshape(1)
                q = apply_rope(q, pos, cfg.rope_theta)
                k = apply_rope(k, pos, cfg.rope_theta)
        # the JAX package's dynamic_update_slice clamps the slot the same way
        slot = (cl % s_alloc if ring else cl).clamp(0, s_alloc - 1)
        for name, new in (("k", k), ("v", v)):
            c = cache[name]
            if _is_dtensor(c):
                _write_slot(c, cache_len, new, ring)
            elif per_seq:
                c[torch.arange(b, device=c.device), :, slot] = \
                    new[:, :, 0].to(c.dtype)
            else:
                c.index_copy_(2, slot.reshape(1), new.to(c.dtype))
        if ring:
            # ring holds exactly the window; mask only during warm-up
            valid = torch.clamp(cl + 1, max=s_alloc)
            out = decode_attention(q, cache["k"], cache["v"], valid,
                                   window=None)
        else:
            out = decode_attention(q, cache["k"], cache["v"], cl + 1,
                                   window=cfg.window)
        y = out.transpose(1, 2).reshape(b, 1, -1) @ params["wo"]
        if cfg.use_bias:
            y = y + params["bo"]
    return y, cache
