"""ArchConfig — one dataclass drives every assigned architecture.

The port's copy of the JAX package's ``configs/base.py``: the same
fields, layer pattern, parameter count and registry.

Layer pattern encoding (see ``layer_kinds``):
  mixer:       "attn" everywhere, "rwkv" (attn-free), or "hybrid"
               (1 attention layer per ``attn_period``, mamba elsewhere)
  swa_period:  k > 0 -> every k-th layer is GLOBAL attention, the others
               use ``window`` sliding-window attention (gemma3 5:1).
               k == 0 and window set -> ALL layers windowed (mixtral).
  moe_period:  k > 0 -> every k-th layer's FFN is MoE (mixtral/grok: 1 =
               every layer; jamba: 2).  0 -> dense FFN everywhere.
  encoder_layers > 0 -> encoder-decoder (whisper).
  frontend:    modality stub — ``input_specs`` provides precomputed
               frame/patch embeddings of length ``frontend_len``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

Mixer = Literal["attn", "rwkv", "hybrid"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    use_rope: bool = True
    # attention pattern
    window: int | None = None
    swa_period: int = 0
    # MoE
    n_experts: int = 0
    top_k: int = 2
    moe_period: int = 0
    capacity_factor: float = 1.25
    # hybrid / attn-free
    mixer: Mixer = "attn"
    attn_period: int = 0            # hybrid: 1 attn layer per k
    d_state: int = 16               # mamba
    rwkv_head_size: int = 64
    # encoder-decoder / frontends
    encoder_layers: int = 0
    frontend: str | None = None     # None|audio|vision
    frontend_len: int = 0
    # misc
    norm: str = "rms"               # rms|ln
    act: str = "swiglu"             # swiglu|gelu
    use_bias: bool = False
    tie_embeddings: bool = False
    max_seq_len: int = 131072
    source: str = ""                # provenance tag

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return (self.vocab_size + 127) // 128 * 128

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    def n_params(self) -> int:
        """Total parameter count (all experts; embeddings included)."""
        return _count_params(self, active_only=False)

    def n_params_active(self) -> int:
        """Active params per token (top-k experts only) — for 6ND."""
        return _count_params(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class LayerKind:
    mixer: str            # attn_full | attn_window | mamba | rwkv
    ffn: str              # mlp | moe | none
    cross_attn: bool = False


def layer_kinds(cfg: ArchConfig, n_layers: int | None = None,
                decoder: bool = True) -> list[LayerKind]:
    """The per-layer pattern for the (decoder) stack."""
    n = cfg.n_layers if n_layers is None else n_layers
    kinds = []
    for i in range(n):
        if cfg.mixer == "rwkv":
            mixer = "rwkv"
        elif cfg.mixer == "hybrid":
            mixer = ("attn_full" if i % cfg.attn_period ==
                     cfg.attn_period // 2 else "mamba")
        else:
            if cfg.swa_period > 0:
                mixer = ("attn_full" if (i + 1) % cfg.swa_period == 0
                         else "attn_window")
            elif cfg.window is not None:
                mixer = "attn_window"
            else:
                mixer = "attn_full"
        if cfg.moe_period > 0 and (i % cfg.moe_period ==
                                   cfg.moe_period - 1):
            ffn = "moe"
        else:
            ffn = "mlp"
        kinds.append(LayerKind(mixer, ffn,
                               cross_attn=decoder and cfg.is_enc_dec))
    return kinds


def scan_grouping(kinds: list[LayerKind]) -> tuple[int, int, int]:
    """(period, n_scanned_superblocks, n_remainder_layers).

    Finds the smallest repeating pattern period: the JAX package stacks
    its layer params by this grouping (and scans over the stack), so
    :func:`repro_torch.convert.lm_params_from_jax` unstacks by it.
    """
    n = len(kinds)
    for p in range(1, n + 1):
        if all(kinds[i] == kinds[i % p] for i in range(n)):
            return p, n // p, n % p
    return n, 1, 0


def _count_params(cfg: ArchConfig, active_only: bool) -> int:
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    total = v * d  # embedding
    if not cfg.tie_embeddings:
        total += d * v
    kinds = layer_kinds(cfg)
    if cfg.is_enc_dec:
        kinds = kinds + layer_kinds(cfg, cfg.encoder_layers, decoder=False)
    for kd in kinds:
        if kd.mixer.startswith("attn"):
            total += d * (hq + 2 * hkv) * hd + hq * hd * d
        elif kd.mixer == "mamba":
            di = 2 * d
            r = max(1, d // 16)
            total += d * 2 * di + 5 * di \
                + di * (r + 2 * cfg.d_state) + r * di + di * d \
                + 2 * di * cfg.d_state
        elif kd.mixer == "rwkv":
            total += 5 * d * d + 2 * d * 64
        if kd.cross_attn:
            total += d * (hq + 2 * hkv) * hd + hq * hd * d
        if kd.ffn == "moe":
            e = cfg.top_k if active_only else cfg.n_experts
            total += d * cfg.n_experts  # router
            total += e * 3 * d * ff
        elif kd.ffn == "mlp":
            total += (3 if cfg.act == "swiglu" else 2) * d * ff
    return total


# --- registry ----------------------------------------------------------------

_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (ensures registration ran)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests.

    Preserves the structural pattern (SWA period, MoE period, hybrid
    ratio, enc-dec) while shrinking width/depth/vocab.
    """
    period = 1
    if cfg.swa_period:
        period = cfg.swa_period
    if cfg.attn_period:
        period = cfg.attn_period
    if cfg.moe_period:
        period = max(period, cfg.moe_period)
    n_layers = max(2, period)
    kv = max(1, min(cfg.n_kv_heads, 2))
    heads = max(2, (4 // kv) * kv)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=128,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        window=min(cfg.window, 16) if cfg.window else None,
        encoder_layers=2 if cfg.is_enc_dec else 0,
        frontend_len=8 if cfg.frontend else 0,
        rwkv_head_size=32,
        max_seq_len=256,
    )
