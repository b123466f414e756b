"""Config-driven transformer covering every assigned LM architecture.

The port of the JAX package's ``models/transformer.py``: dense / GQA /
sliding-window attention, MoE FFNs, Mamba-hybrid (jamba), RWKV6, the
encoder-decoder (whisper: an encoder stack, cross-attention in every
decoder layer, learned positions) and a vision prefix (internvl2: patch
embeddings before the text), driven by :class:`ArchConfig`.  ``Model``
is an ``nn.Module``; where the JAX model stacks the params of each
position of its repeating super-block and scans over the stack, this
one keeps a ``ModuleList`` of layers
(``repro_torch.convert.lm_params_from_jax`` unstacks).

The prefill runs attention through the flash kernel on a card
(``attn_backend="ref"`` asks for the plain ``chunked_attention``
instead).  ``prefill`` and ``decode_step`` run under ``torch.no_grad()``:
serving never differentiates.  The decode cache is ``{"decoder": [one
dict a layer], "enc_out": [B, F, d] (enc-dec only)}``, each layer's
dict keyed as the JAX package keys it: ``"kv"`` ({"k", "v"} [B, Hkv,
S, D]), ``"mamba"`` ({"conv", "ssm"}), ``"rwkv"`` ({"shift", "state"})
and ``"cross"`` ({"k", "v"} over the encoder's frames).  Decode writes it
in place.

Training: the weights are trainable parameters.  ``loss(batch)`` is the
JAX package's: ``forward_hidden`` (the decoder stack, after the encoder
for enc-dec and with the vision prefix cut off after the final norm; the
MoE aux loss summed over the decoder layers) then a chunked
cross-entropy that holds ``[B, loss_chunk, Vp]`` float32 logits for one
chunk at a time (each chunk recomputed in the backward), plus 0.01 x
aux.  Attention on this path is always ``chunked_attention``
(``backend="ref"``; the flash kernel has no backward).  ``remat`` (on by
default, as in the JAX package) recomputes each layer's forward in the
backward (``torch.utils.checkpoint``); the JAX package remats a repeating
super-block, which computes the same values.
"""

from __future__ import annotations

import functools
import types

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, LayerKind, layer_kinds
from repro_torch.distributed.sharding import (along_whole_dim, constrain,
                                             current_mesh, gathered, lookup,
                                             replicating, scoped,
                                             summed_over_rows)
from repro_torch.engine.engine import resolve_device
from repro_torch.models.layers import attention as attn
from repro_torch.models.layers import mamba as mamba_l
from repro_torch.models.layers import mlp as mlp_l
from repro_torch.models.layers import moe as moe_l
from repro_torch.models.layers import norm as norm_l
from repro_torch.models.layers import rwkv6 as rwkv_l
from repro_torch.models.layers.init import normal
from repro_torch.runtime import tracing


def _under_mesh(fn):
    """``fn`` under ``sharding.replicating()`` (see there); without a
    mesh, ``fn`` itself."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        if current_mesh() is None:
            return fn(*args, **kwargs)
        with replicating():
            return fn(*args, **kwargs)
    return run


def _params(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in tensors.items()})


def _param(tensor: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(tensor)


def _split_last(x) -> bool:
    """Whether ``x`` is a DTensor whose last dim is split over more than
    one rank."""
    return isinstance(x, DTensor) and any(
        p.is_shard(x.ndim - 1) and x.device_mesh.size(i) > 1
        for i, p in enumerate(x.placements))


def _gathered_block(block):
    """Under a mesh, ``block``'s parts with every parameter gathered over
    the data axes (``sharding.gathered``): what a layer computes with.
    Without one, the block itself."""
    if current_mesh() is None:
        return block
    view = types.SimpleNamespace(kind=block.kind)
    for name, part in block.named_children():
        setattr(view, name, {k: gathered(v) for k, v in part.items()})
    return view


class Block(nn.Module):
    """One pre-norm sub-layer: norm, mixer, residual, [norm, cross-
    attention, residual,] norm, FFN, residual.  Its parts (``ln1``,
    ``mixer``, ``ln_cross``, ``cross``, ``ln2``, ``ffn``) are the JAX
    layer's dicts."""

    def __init__(self, kind: LayerKind, params: dict):
        super().__init__()
        self.kind = kind
        for name, tensors in params.items():
            setattr(self, name, _params(tensors))


class Model(nn.Module):
    """The JAX package's ``Model``, its params held as the module's
    parameters.

    ``device``: ``cuda`` unless the caller asks for another (``cuda``
    without a card raises).  ``seed``: the weights are drawn from a
    ``torch.Generator`` on ``device`` seeded with it (None: left
    uninitialized, to be loaded).  ``rwkv_chunk`` > 0: the blocked RWKV6
    prefill where it divides T (and T is longer), as the JAX model
    chooses.  ``loss_chunk``: the loss's sequence chunk; ``remat``:
    recompute each layer in the backward.
    """

    def __init__(self, cfg: ArchConfig, dtype=torch.bfloat16, *,
                 attn_chunk: int = 1024, attn_backend: str = "kernel",
                 rwkv_chunk: int = 0, loss_chunk: int = 512,
                 remat: bool = True, device=None, seed: int | None = 0):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.remat = remat
        self.loss_chunk = loss_chunk
        self.attn_chunk = attn_chunk
        self.attn_backend = attn_backend
        self.rwkv_chunk = rwkv_chunk
        self.kinds = layer_kinds(cfg)
        self.enc_kinds = (layer_kinds(cfg, cfg.encoder_layers, decoder=False)
                          if cfg.is_enc_dec else [])
        self.init_params(seed, resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # --- config plumbing ---------------------------------------------------

    def attn_cfg(self, kind: LayerKind, causal=True) -> attn.AttnConfig:
        c = self.cfg
        return attn.AttnConfig(
            d_model=c.d_model, n_heads=c.n_heads, n_kv_heads=c.n_kv_heads,
            head_dim=c.hd, rope_theta=c.rope_theta,
            window=(c.window if kind.mixer == "attn_window" else None),
            causal=causal, use_bias=c.use_bias, chunk_k=self.attn_chunk,
            use_rope=c.use_rope)

    def mamba_cfg(self) -> mamba_l.MambaConfig:
        c = self.cfg
        return mamba_l.MambaConfig(d_model=c.d_model, d_inner=2 * c.d_model,
                                   d_state=c.d_state)

    def rwkv_cfg(self) -> rwkv_l.RWKV6Config:
        c = self.cfg
        return rwkv_l.RWKV6Config(d_model=c.d_model,
                                  head_size=c.rwkv_head_size)

    def moe_cfg(self) -> moe_l.MoEConfig:
        c = self.cfg
        return moe_l.MoEConfig(d_model=c.d_model, d_ff=c.d_ff,
                               n_experts=c.n_experts, top_k=c.top_k,
                               capacity_factor=c.capacity_factor)

    @property
    def pos_emb(self) -> str:
        c = self.cfg
        if c.use_rope:
            return "rope"
        return "learned" if c.is_enc_dec else "none"

    # --- init ----------------------------------------------------------------

    def _norm_init(self, device) -> dict:
        d = self.cfg.d_model
        return (norm_l.layernorm_init(d, device) if self.cfg.norm == "ln"
                else norm_l.rmsnorm_init(d, device))

    def _norm_apply(self, p, x):
        return (norm_l.layernorm(p, x) if self.cfg.norm == "ln"
                else norm_l.rmsnorm(p, x))

    def _init_block(self, gen, kind: LayerKind, dev, causal=True) -> Block:
        c, dt = self.cfg, self.dtype
        p = {"ln1": self._norm_init(dev)}
        if kind.mixer.startswith("attn"):
            p["mixer"] = attn.init(gen, self.attn_cfg(kind, causal), dt, dev)
        elif kind.mixer == "mamba":
            p["mixer"] = mamba_l.init(gen, self.mamba_cfg(), dt, dev)
        elif kind.mixer == "rwkv":
            p["mixer"] = rwkv_l.init(gen, self.rwkv_cfg(), dt, dev)
        if kind.cross_attn:
            p["ln_cross"] = self._norm_init(dev)
            p["cross"] = attn.init(gen, self.attn_cfg(kind, causal=False),
                                   dt, dev)
        p["ln2"] = self._norm_init(dev)
        if kind.ffn == "moe":
            p["ffn"] = moe_l.init(gen, self.moe_cfg(), dt, dev)
        elif c.act == "gelu":
            p["ffn"] = mlp_l.gelu_mlp_init(gen, c.d_model, c.d_ff, dt, dev)
        else:
            p["ffn"] = mlp_l.swiglu_init(gen, c.d_model, c.d_ff, dt, dev)
        return Block(kind, p)

    def init_params(self, seed: int | None, dev: torch.device) -> None:
        """(Re)create every parameter on ``dev``: the JAX package's
        shapes and scales, drawn in layer order from one generator seeded
        with ``seed`` (its bits differ from ``jax.random``'s)."""
        c = self.cfg
        gen = None
        if seed is not None:
            gen = torch.Generator(device=dev).manual_seed(seed)
        vp, d = c.vocab_padded, c.d_model
        self.embed = _param(normal(gen, (vp, d), d ** -0.5, self.dtype, dev))
        self.final_norm = _params(self._norm_init(dev))
        self.layers = nn.ModuleList(self._init_block(gen, kind, dev)
                                    for kind in self.kinds)
        if not c.tie_embeddings:
            self.lm_head = _param(normal(gen, (d, vp), d ** -0.5, self.dtype,
                                         dev))
        if self.pos_emb == "learned":
            self.pos_embed = _param(normal(gen, (c.max_seq_len, d), 0.02,
                                           self.dtype, dev))
        if c.is_enc_dec:
            self.encoder = nn.ModuleList(
                self._init_block(gen, kind, dev, causal=False)
                for kind in self.enc_kinds)
            self.enc_final_norm = _params(self._norm_init(dev))
            self.enc_pos = _param(normal(gen, (c.frontend_len, d), 0.02,
                                         self.dtype, dev))

    def cast(self, dtype) -> "Model":
        """A copy of this model with the same weight values in ``dtype``
        (the norm scales and the float32 leaves of the MoE, Mamba and
        RWKV layers stay float32)."""
        other = Model(self.cfg, dtype, attn_chunk=self.attn_chunk,
                      attn_backend=self.attn_backend,
                      rwkv_chunk=self.rwkv_chunk, loss_chunk=self.loss_chunk,
                      remat=self.remat, device=self.device, seed=None)
        other.load_state_dict(self.state_dict())
        return other

    # --- forward sub-layer -----------------------------------------------------

    def _ffn(self, block: Block, h):
        """(y, aux): the FFN's output and its MoE aux loss (None for a
        dense FFN)."""
        if block.kind.ffn == "moe":
            return moe_l.forward(block.ffn, h, self.moe_cfg())
        if self.cfg.act == "gelu":
            return mlp_l.gelu_mlp(block.ffn, h), None
        return mlp_l.swiglu(block.ffn, h), None

    @staticmethod
    def _kv_cache(k, v, alloc: int) -> dict:
        """The prefill's k, v [B, Hkv, T, D] as a cache of ``alloc``
        slots: zero-padded, or a ring holding the last ``alloc`` tokens at
        slot pos % alloc."""
        t = k.shape[2]
        if t <= alloc:
            pad = (0, 0, 0, alloc - t)
            return {name: along_whole_dim(
                lambda x: nn.functional.pad(x, pad), full, 2)
                for name, full in (("k", k), ("v", v))}
        # position t - alloc + i goes to slot (t - alloc + i) % alloc: a
        # roll of the last alloc tokens, on each rank's heads and rows
        shift = (t - alloc) % alloc
        return {name: along_whole_dim(
            lambda x: torch.roll(x[:, :, -alloc:], shift, dims=2), full, 2)
            for name, full in (("k", k), ("v", v))}

    def _apply_sublayer(self, block: Block, x, *, causal=True,
                        positions=None, enc_out=None, cache_max_len=None,
                        attn_backend=None):
        """One pre-norm sub-layer.  ``cache_max_len`` not None: prefill
        mode, the layer's decode cache filled.  ``attn_backend``: the
        attention's (default the model's).  Returns (x, aux, cache), aux
        the MoE aux loss (None for a dense FFN)."""
        kind = block.kind
        block = _gathered_block(block)
        backend = attn_backend or self.attn_backend
        collect = cache_max_len is not None
        cache: dict = {}
        h = self._norm_apply(block.ln1, x)
        h = constrain(h, "batch", "mix_seq", "embed")
        if kind.mixer.startswith("attn"):
            acfg = self.attn_cfg(kind, causal)
            out = attn.forward(block.mixer, h, acfg, positions=positions,
                               return_kv=collect, backend=backend)
            if collect:
                h, (k, v) = out
                alloc = (cache_max_len if acfg.window is None
                         else min(cache_max_len, acfg.window))
                cache["kv"] = self._kv_cache(k, v, alloc)
            else:
                h = out
        elif kind.mixer == "mamba":
            out = mamba_l.forward(block.mixer, h, self.mamba_cfg(),
                                  return_state=collect)
            if collect:
                h, cache["mamba"] = out
            else:
                h = out
        elif kind.mixer == "rwkv":
            ck, t = self.rwkv_chunk, h.shape[1]
            if ck and t % ck == 0 and t > ck:
                out = rwkv_l.forward_chunked(block.mixer, h, self.rwkv_cfg(),
                                             chunk=ck, return_state=collect)
            else:
                out = rwkv_l.forward(block.mixer, h, self.rwkv_cfg(),
                                     return_state=collect)
            if collect:
                h, cache["rwkv"] = out
            else:
                h = out
        x = constrain(x + h, "batch", "res_seq", "embed")
        if kind.cross_attn and enc_out is not None:
            h = self._norm_apply(block.ln_cross, x)
            out = attn.forward(block.cross, h, self.attn_cfg(kind, False),
                               kv_x=enc_out, return_kv=collect,
                               backend=backend)
            if collect:
                h, (k, v) = out
                cache["cross"] = {"k": k.contiguous(), "v": v.contiguous()}
            else:
                h = out
            x = x + h
        h = constrain(self._norm_apply(block.ln2, x), "batch", "mix_seq",
                      "embed")
        h, aux = self._ffn(block, h)
        return constrain(x + h, "batch", "res_seq", "embed"), aux, cache

    # --- embedding / heads -----------------------------------------------------

    def _lookup(self, tokens: torch.Tensor) -> torch.Tensor:
        """The embedding rows of ``tokens`` in the model's dtype.  Under a
        mesh the tokens are placed as ("batch", "seq") first and the
        lookup is an ``embedding`` (DTensor shards its table)."""
        tokens = tokens.to(self.device, torch.int64)
        if current_mesh() is None:
            return self.embed[tokens].to(self.dtype)
        tokens = constrain(tokens, "batch", "seq")
        return lookup(self.embed, tokens).to(self.dtype)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self._lookup(tokens)
        if self.pos_emb == "learned":
            x = x + self.pos_embed[:x.shape[1]]
        return constrain(x, "batch", "res_seq", "embed")

    def _encode(self, frames: torch.Tensor, train: bool = False
                ) -> torch.Tensor:
        """The encoder over stub front-end embeddings [B, F, d] (its MoE
        aux dropped, as the JAX package drops it)."""
        # placed before the first norm: the table is split on d, and
        # DTensor's backward cannot turn a norm's partial sums over a
        # split d into partial means
        x = constrain(frames.to(self.device, self.dtype) + self.enc_pos[None],
                      "batch", "res_seq", "embed")
        for block in self.encoder:
            x, _ = self._layer(block, x, train, causal=False)
        return self._norm_apply(self.enc_final_norm, x)

    def _layer(self, block: Block, x, train: bool, **kw):
        """One sub-layer without a cache: (x, aux).  ``train``: attention
        through ``chunked_attention``, the layer recomputed in the backward
        when ``remat`` is on and grad mode records."""
        if not train:
            return self._apply_sublayer(block, x, **kw)[:2]

        @scoped
        def run(x):
            return self._apply_sublayer(block, x, attn_backend="ref",
                                        **kw)[:2]

        if self.remat and torch.is_grad_enabled():
            return checkpoint(run, x, use_reentrant=False)
        return run(x)

    def _head_matrix(self) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            # the table is sharded (vocab -> data, d -> model) for the
            # lookup; the head wants (d -> data, vocab -> model)
            return gathered(constrain(self.embed.T, "p_in", "vocab"))
        return gathered(self.lm_head)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """h: [B, T, d] -> logits f32[B, T, Vp] (small T only)."""
        logits = (h @ self._head_matrix()).float()
        vp, v = self.cfg.vocab_padded, self.cfg.vocab_size
        if vp != v:
            logits = logits.masked_fill(
                torch.arange(vp, device=logits.device) >= v, -1e30)
        return constrain(logits, "batch", None, "vocab")

    def _inputs(self, tokens, frames=None, patches=None, train=False):
        """(decoder input x [B, P + T, d], the encoder's output or None):
        the tokens' embeddings, after the ``patches`` [B, P, d] (vision),
        and the encoder over the ``frames`` [B, F, d] (enc-dec)."""
        c = self.cfg
        enc_out = None
        if c.is_enc_dec:
            if frames is None:
                raise ValueError(f"{c.name} is an encoder-decoder: it "
                                 f"needs frames=")
            enc_out = self._encode(torch.as_tensor(frames), train)
        x = self._embed(torch.as_tensor(tokens))
        if c.frontend == "vision":
            if patches is None:
                raise ValueError(f"{c.name} takes a vision prefix: it "
                                 f"needs patches=")
            x = torch.cat([torch.as_tensor(patches).to(self.device,
                                                        self.dtype), x],
                          dim=1)
            x = constrain(x, "batch", "res_seq", "embed")
        return x, enc_out

    # --- training ----------------------------------------------------------------

    @_under_mesh
    def forward_hidden(self, batch: dict):
        """The decoder stack -> (hidden states [B, T, d] after the final
        norm, MoE aux loss summed over the decoder layers, f32 0-d)."""
        x, enc_out = self._inputs(batch["tokens"], batch.get("frames"),
                                  batch.get("patches"), train=True)
        n_prefix = x.shape[1] - batch["tokens"].shape[1]
        positions = torch.arange(x.shape[1], device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for block in self.layers:
            x, a = self._layer(block, x, True, positions=positions,
                               enc_out=enc_out)
            if a is not None:
                aux = aux + a
        x = self._norm_apply(self.final_norm, x)
        return x[:, n_prefix:], aux

    def _chunked_loss(self, h, labels, mask=None) -> torch.Tensor:
        """Mean cross-entropy without materializing [B, T, Vp] logits:
        ``loss_chunk`` positions at a time, each chunk's logits recomputed
        in the backward; the padded vocabulary columns masked to
        -1e30."""
        b, t, _ = h.shape
        chunk = min(self.loss_chunk, t)
        assert t % chunk == 0, (t, chunk)
        w = self._head_matrix()
        v, vp = self.cfg.vocab_size, self.cfg.vocab_padded
        labels = torch.as_tensor(labels).to(h.device, torch.int64)
        mask = (torch.ones(labels.shape, dtype=torch.float32,
                           device=h.device) if mask is None
                else torch.as_tensor(mask).to(h.device, torch.float32))
        pad = torch.arange(vp, device=h.device) >= v
        if current_mesh() is not None:
            h = constrain(h, "batch", None, "embed")
            labels = constrain(labels, "batch", None)
            mask = constrain(mask, "batch", None)
            pad = constrain(pad, "vocab")

        ids = None
        if current_mesh() is not None:
            ids = constrain(torch.arange(vp, device=h.device), "vocab")

        def sums(logits, y_c, m_c):
            lse = torch.logsumexp(logits, dim=-1, keepdim=True)
            gold = logits.gather(-1, y_c.unsqueeze(-1))
            return torch.sum((lse - gold).squeeze(-1) * m_c), torch.sum(m_c)

        @scoped
        def one(h_c, y_c, m_c):
            logits = constrain((h_c @ w).float(), "batch", None, "vocab")
            if vp != v:
                logits = logits.masked_fill(pad, -1e30)
            if not _split_last(logits):
                # each rank's rows whole (under a mesh: sums partial over
                # the batch's split)
                return summed_over_rows(sums, logits, y_c, m_c)
            # vocab-parallel: each rank's columns, the max and the sums
            # reduced across; the gold logit picked by a mask
            mx = logits.detach().amax(dim=-1, keepdim=True)
            lse = torch.log(torch.exp(logits - mx).sum(
                dim=-1, keepdim=True)) + mx
            gold = (logits * (ids == y_c.unsqueeze(-1))).sum(
                dim=-1, keepdim=True)
            return torch.sum((lse - gold).squeeze(-1) * m_c), torch.sum(m_c)

        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        cnt = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(0, t, chunk):
            args = (h[:, i:i + chunk], labels[:, i:i + chunk],
                    mask[:, i:i + chunk])
            s, n = (checkpoint(one, *args, use_reentrant=False)
                    if torch.is_grad_enabled() else one(*args))
            tot, cnt = tot + s, cnt + n
        # under a mesh both are partial sums: reduce them before dividing
        tot, cnt = constrain(tot), constrain(cnt)
        return tot / torch.clamp(cnt, min=1.0)

    @_under_mesh
    def loss(self, batch: dict) -> torch.Tensor:
        """Mean next-token cross-entropy + 0.01 x the MoE aux loss.
        batch: ``tokens`` and ``labels`` int[B, T], optional ``loss_mask``
        [B, T], and ``frames`` / ``patches`` where the config takes
        them."""
        h, aux = self.forward_hidden(batch)
        ce = self._chunked_loss(h, batch["labels"], batch.get("loss_mask"))
        return ce + 0.01 * aux

    # --- decode ------------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int) -> dict:
        c, dt, dev = self.cfg, self.dtype, self.device
        layers = []
        for kind in self.kinds:
            cache: dict = {}
            if kind.mixer.startswith("attn"):
                cache["kv"] = attn.init_cache(batch, self.attn_cfg(kind),
                                              max_len, dt, dev)
            elif kind.mixer == "mamba":
                cache["mamba"] = mamba_l.init_cache(batch, self.mamba_cfg(),
                                                    dt, dev)
            elif kind.mixer == "rwkv":
                cache["rwkv"] = rwkv_l.init_cache(batch, self.rwkv_cfg(), dt,
                                                  dev)
            if kind.cross_attn:
                cache["cross"] = attn.init_cache(batch, self.attn_cfg(kind),
                                                 c.frontend_len, dt, dev)
            layers.append(cache)
        out = {"decoder": layers}
        if c.is_enc_dec:
            out["enc_out"] = torch.zeros((batch, c.frontend_len, c.d_model),
                                         dtype=dt, device=dev)
        return out

    def _decode_sublayer(self, block: Block, x, cache: dict, cache_len):
        kind = block.kind
        block = _gathered_block(block)
        h = self._norm_apply(block.ln1, x)
        if kind.mixer.startswith("attn"):
            h, _ = attn.decode_step(block.mixer, h, cache["kv"], cache_len,
                                    self.attn_cfg(kind))
        elif kind.mixer == "mamba":
            h, _ = mamba_l.decode_step(block.mixer, h, cache["mamba"],
                                       self.mamba_cfg())
        elif kind.mixer == "rwkv":
            h, _ = rwkv_l.decode_step(block.mixer, h, cache["rwkv"],
                                      self.rwkv_cfg())
        x = x + h
        if kind.cross_attn:
            h = self._norm_apply(block.ln_cross, x)
            acfg = self.attn_cfg(kind, causal=False)
            q, _, _ = attn._split_qkv(block.cross, h, acfg)
            out = attn.decode_attention(q, cache["cross"]["k"],
                                        cache["cross"]["v"],
                                        self.cfg.frontend_len)
            h = out.transpose(1, 2).reshape(x.shape[0], 1, -1) \
                @ block.cross["wo"]
            if acfg.use_bias:
                h = h + block.cross["bo"]
            x = x + h
        return x + self._ffn(block, self._norm_apply(block.ln2, x))[0]

    @torch.no_grad()
    @_under_mesh
    def decode_step(self, tokens, cache: dict, cache_len):
        """One serving step.  tokens: int[B, 1]; cache_len: int or int[B]
        (per-sequence lengths).  Returns (logits f32[B, Vp], cache), the
        cache written in place."""
        with tracing.span("model/decode"):
            x = self._lookup(tokens)
            if self.pos_emb == "learned":
                if isinstance(cache_len, int):
                    x = x + self.pos_embed[
                        min(max(cache_len, 0), self.cfg.max_seq_len - 1)]
                else:
                    cl = torch.as_tensor(cache_len, device=self.device)
                    cl = cl.to(torch.int64).clamp(0, self.cfg.max_seq_len - 1)
                    pos = self.pos_embed[cl]
                    x = x + (pos[:, None, :] if cl.ndim == 1 else pos)
            for block, layer_cache in zip(self.layers, cache["decoder"]):
                x = self._decode_sublayer(block, x, layer_cache, cache_len)
            x = self._norm_apply(self.final_norm, x)
            return self._logits(x)[:, 0], cache

    @torch.no_grad()
    @_under_mesh
    def prefill(self, tokens, max_len: int, lengths=None, *, frames=None,
                patches=None):
        """Process a prompt, build the decode cache.

        tokens: int[B, T]; ``frames`` [B, F, d] (enc-dec: the audio
        front end's stub embeddings) and ``patches`` [B, P, d] (vision:
        put before the text, counted in the cache length).  ``lengths``
        (int[B], optional) = true lengths, the prefix included, when T is
        a padded bucket; last-token logits are gathered per sequence.
        Returns (logits f32[B, Vp] for the last valid position, cache,
        cache_len).
        """
        x, enc_out = self._inputs(tokens, frames, patches)
        t_total = x.shape[1]
        if t_total > max_len:
            raise ValueError(f"a prompt of {t_total} tokens does not fit a "
                             f"cache of max_len {max_len}")
        positions = torch.arange(t_total, device=x.device)
        layers = []
        for block in self.layers:
            x, _, layer_cache = self._apply_sublayer(
                block, x, positions=positions, enc_out=enc_out,
                cache_max_len=max_len)
            layers.append(layer_cache)
        cache = {"decoder": layers}
        if enc_out is not None:
            cache["enc_out"] = enc_out
        x = self._norm_apply(self.final_norm, x)
        if lengths is not None:
            lengths = torch.as_tensor(lengths, device=x.device)
            idx = (lengths.to(torch.int64) - 1).clamp(min=0)
            last = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
            return self._logits(last)[:, 0], cache, lengths
        return self._logits(x[:, -1:])[:, 0], cache, t_total
