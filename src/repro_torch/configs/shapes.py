"""The four assigned input-shape presets + per-arch applicability.

LM transformer shapes are seq_len x global_batch.  ``decode_*`` /
``long_*`` lower ``serve_step`` (one new token against a KV cache of
seq_len), not ``train_step``.  ``long_500k`` needs sub-quadratic
attention: skipped for pure full-attention archs (recorded with reasons),
run for SSM / hybrid / SWA archs.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# Archs whose long-context state stays sub-quadratic: SSM (rwkv6),
# hybrid (jamba: O(1) Mamba state + 9 attn layers), SWA-bounded
# (gemma3 5:1 local:global, mixtral all-window).
_LONG_OK = {"rwkv6-7b", "jamba-1.5-large-398b", "gemma3-1b",
            "mixtral-8x22b"}

LONG_SKIP_REASONS: dict[str, str] = {
    "whisper-small": "enc-dec full attention; architecture capped at "
                     "1500 frames / short decoder — no 500k mode",
    "grok-1-314b": "pure full attention (no SWA/SSM path)",
    "starcoder2-3b": "pure full attention",
    "command-r-35b": "pure full attention",
    "llama3-405b": "pure full attention",
    "internvl2-26b": "pure full attention",
}


def applicable_shapes(cfg: ArchConfig) -> list[ShapeSpec]:
    """Shape cells that run for this arch (others recorded as skips)."""
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and cfg.name not in _LONG_OK:
            continue
        out.append(s)
    return out
