"""Token samplers for the LM serving engine.

``temperature`` draws from an explicit ``torch.Generator``; its bits
differ from ``jax.random``'s, so only ``greedy`` matches the JAX package
token for token.
"""

from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """logits [B, V] -> tokens int32[B]."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def temperature(gen: torch.Generator, logits: torch.Tensor,
                temp: float = 1.0, top_k: int = 0) -> torch.Tensor:
    """Temperature (+ optional top-k) sampling.  logits [B, V] -> [B]."""
    l = logits.float() / max(temp, 1e-6)
    if top_k > 0:
        cutoff = torch.topk(l, top_k, dim=-1).values[:, -1:]
        l = torch.where(l < cutoff, float("-inf"), l)
    probs = torch.softmax(l, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)
