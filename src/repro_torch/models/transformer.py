"""Config-driven decoder-only transformer (attention mixers, dense FFNs).

The port of the JAX package's ``models/transformer.py`` for the configs
whose layers the port has: dense / GQA / sliding-window attention with a
SwiGLU or GELU FFN.  ``Model`` is an ``nn.Module``; where the JAX model
stacks the params of each position of its repeating super-block and
scans over the stack, this one keeps a ``ModuleList`` of layers
(``repro_torch.convert.lm_params_from_jax`` unstacks).  Mamba, RWKV, MoE,
encoder-decoder and vision-prefix configs raise ``NotImplementedError``.

The prefill runs attention through the flash kernel on a card
(``attn_backend="ref"`` asks for the plain ``chunked_attention``
instead); decode runs ``attention.decode_step`` over a cache that is a
list of per-layer ``{"k", "v"}`` tensors [B, Hkv, S, D], written in
place.  The weights are frozen (``requires_grad=False``): the port
serves this model and does not train it.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, LayerKind, layer_kinds
from repro_torch.engine.engine import resolve_device
from repro_torch.models.layers import attention as attn
from repro_torch.models.layers import mlp as mlp_l
from repro_torch.models.layers import norm as norm_l
from repro_torch.models.layers.init import normal

_NOT_PORTED = "not ported yet (ROADMAP.md §1, item 6)"


def _frozen(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tensors.items()})


def _check_ported(cfg: ArchConfig) -> None:
    if cfg.is_enc_dec:
        raise NotImplementedError(f"{cfg.name}: the encoder-decoder path is "
                                  f"{_NOT_PORTED}")
    if cfg.frontend is not None:
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend} prefix "
                                  f"is {_NOT_PORTED}")
    for kind in layer_kinds(cfg):
        if not kind.mixer.startswith("attn"):
            raise NotImplementedError(f"{cfg.name}: the {kind.mixer} mixer "
                                      f"is {_NOT_PORTED}")
        if kind.ffn != "mlp":
            raise NotImplementedError(f"{cfg.name}: the {kind.ffn} FFN is "
                                      f"{_NOT_PORTED}")


class Block(nn.Module):
    """One pre-norm sub-layer: norm, attention, residual, norm, FFN,
    residual."""

    def __init__(self, kind: LayerKind, params: dict):
        super().__init__()
        self.kind = kind
        for name, tensors in params.items():
            setattr(self, name, _frozen(tensors))


class Model(nn.Module):
    """The JAX package's ``Model``, its params held as the module's
    parameters.

    ``device``: ``cuda`` unless the caller asks for another (``cuda``
    without a card raises).  ``seed``: the weights are drawn from a
    ``torch.Generator`` on ``device`` seeded with it (None: left
    uninitialized, to be loaded).
    """

    def __init__(self, cfg: ArchConfig, dtype=torch.bfloat16, *,
                 attn_chunk: int = 1024, attn_backend: str = "kernel",
                 device=None, seed: int | None = 0):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        self.dtype = dtype
        self.attn_chunk = attn_chunk
        self.attn_backend = attn_backend
        self.kinds = layer_kinds(cfg)
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

    # --- init ----------------------------------------------------------------

    def _norm_init(self, device) -> dict:
        d = self.cfg.d_model
        return (norm_l.layernorm_init(d, device) if self.cfg.norm == "ln"
                else norm_l.rmsnorm_init(d, device))

    def _norm_apply(self, p, x):
        return (norm_l.layernorm(p, x) if self.cfg.norm == "ln"
                else norm_l.rmsnorm(p, x))

    def init_params(self, seed: int | None, dev: torch.device) -> None:
        """(Re)create every parameter on ``dev``: the JAX package's
        shapes and scales, drawn in layer order from one generator seeded
        with ``seed`` (its bits differ from ``jax.random``'s)."""
        c = self.cfg
        gen = None
        if seed is not None:
            gen = torch.Generator(device=dev).manual_seed(seed)
        vp = c.vocab_padded
        self.embed = nn.Parameter(
            normal(gen, (vp, c.d_model), c.d_model ** -0.5, self.dtype, dev),
            requires_grad=False)
        self.final_norm = _frozen(self._norm_init(dev))
        blocks = []
        for kind in self.kinds:
            ffn_init = (mlp_l.gelu_mlp_init if c.act == "gelu"
                        else mlp_l.swiglu_init)
            blocks.append(Block(kind, {
                "ln1": self._norm_init(dev),
                "mixer": attn.init(gen, self.attn_cfg(kind), self.dtype,
                                   dev),
                "ln2": self._norm_init(dev),
                "ffn": ffn_init(gen, c.d_model, c.d_ff, self.dtype, dev)}))
        self.layers = nn.ModuleList(blocks)
        if not c.tie_embeddings:
            self.lm_head = nn.Parameter(
                normal(gen, (c.d_model, vp), c.d_model ** -0.5, self.dtype,
                       dev),
                requires_grad=False)

    def cast(self, dtype) -> "Model":
        """A copy of this model with the same weight values in ``dtype``
        (the norm scales stay float32)."""
        other = Model(self.cfg, dtype, attn_chunk=self.attn_chunk,
                      attn_backend=self.attn_backend, device=self.device,
                      seed=None)
        other.load_state_dict(self.state_dict())
        return other

    # --- forward sub-layer -----------------------------------------------------

    def _ffn(self, block: Block, h):
        if self.cfg.act == "gelu":
            return mlp_l.gelu_mlp(block.ffn, h)
        return mlp_l.swiglu(block.ffn, h)

    def _apply_sublayer(self, block: Block, x, *, positions,
                        cache_max_len: int):
        """One pre-norm sub-layer in prefill mode; returns (x, the layer's
        decode cache)."""
        acfg = self.attn_cfg(block.kind)
        h = self._norm_apply(block.ln1, x)
        h, (k, v) = attn.forward(block.mixer, h, acfg, positions=positions,
                                 return_kv=True, backend=self.attn_backend)
        alloc = (cache_max_len if acfg.window is None
                 else min(cache_max_len, acfg.window))
        t = k.shape[2]
        if t <= alloc:
            pad = (0, 0, 0, alloc - t)
            cache = {"k": nn.functional.pad(k, pad),
                     "v": nn.functional.pad(v, pad)}
        else:
            # ring buffer: last `alloc` tokens at slot pos % alloc
            dest = (torch.arange(alloc, device=k.device) + (t - alloc)) \
                % alloc
            cache = {}
            for name, full in (("k", k), ("v", v)):
                ring = torch.empty_like(full[:, :, :alloc])
                ring[:, :, dest] = full[:, :, -alloc:]
                cache[name] = ring
        x = x + h
        x = x + self._ffn(block, self._norm_apply(block.ln2, x))
        return x, cache

    # --- embedding / heads -----------------------------------------------------

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed[tokens.to(self.device, torch.int64)].to(self.dtype)

    def _head_matrix(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """h: [B, T, d] -> logits f32[B, T, Vp] (small T only)."""
        logits = (h @ self._head_matrix()).float()
        vp, v = self.cfg.vocab_padded, self.cfg.vocab_size
        if vp != v:
            logits[..., v:] = -1e30
        return logits

    # --- decode ------------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int) -> list[dict]:
        return [attn.init_cache(batch, self.attn_cfg(kind), max_len,
                                self.dtype, self.device)
                for kind in self.kinds]

    def decode_step(self, tokens, cache: list[dict], cache_len):
        """One serving step.  tokens: int[B, 1]; cache_len: int or int[B]
        (per-sequence lengths).  Returns (logits f32[B, Vp], cache), the
        cache written in place."""
        x = self._embed(tokens)
        for block, layer_cache in zip(self.layers, cache):
            h = self._norm_apply(block.ln1, x)
            h, _ = attn.decode_step(block.mixer, h, layer_cache, cache_len,
                                    self.attn_cfg(block.kind))
            x = x + h
            x = x + self._ffn(block, self._norm_apply(block.ln2, x))
        x = self._norm_apply(self.final_norm, x)
        return self._logits(x)[:, 0], cache

    def prefill(self, tokens, max_len: int, lengths=None):
        """Process a prompt, build the decode cache.

        tokens: int[B, T].  ``lengths`` (int[B], optional) = true prompt
        lengths when T is a padded bucket; last-token logits are gathered
        per sequence.  Returns (logits f32[B, Vp] for the last valid
        position, cache, cache_len).
        """
        x = self._embed(tokens)
        t_total = x.shape[1]
        if t_total > max_len:
            raise ValueError(f"a prompt of {t_total} tokens does not fit a "
                             f"cache of max_len {max_len}")
        positions = torch.arange(t_total, device=x.device)
        cache = []
        for block in self.layers:
            x, layer_cache = self._apply_sublayer(
                block, x, positions=positions, cache_max_len=max_len)
            cache.append(layer_cache)
        x = self._norm_apply(self.final_norm, x)
        if lengths is not None:
            lengths = torch.as_tensor(lengths, device=x.device)
            idx = (lengths.to(torch.int64) - 1).clamp(min=0)
            last = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
            return self._logits(last)[:, 0], cache, lengths
        return self._logits(x[:, -1:])[:, 0], cache, t_total
