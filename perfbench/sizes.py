"""A configuration file's sizes, under one set of names.

``configs/<config>.json`` holds the configuration under its source's
own key names and values, the depth cut; its ``keys`` map the names
below onto them.  Where the port runs a key otherwise than published,
``departures`` gives the value it runs (``{"run": v, "why": ...}``), and
:class:`Dims` takes that one: the plain reference computes what the
port runs.  The ``port`` block says how the port is told to run it (the
registered architecture, the depth, the attention window and the MoE
capacity factor).  The harness, the counts and the plain reference all
read :class:`Dims`.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path


@dataclasses.dataclass(frozen=True)
class Dims:
    d_model: int
    d_ff: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    n_experts: int
    top_k: int
    vocab: int
    rope_theta: float
    norm_eps: float
    window: int | None
    capacity_factor: float

    def capacity(self, n_tokens: int) -> int:
        """Slots per expert for one call over ``n_tokens`` tokens: the
        port's documented rule, at least 8, a multiple of 8."""
        c = int(n_tokens * self.top_k * self.capacity_factor
                / self.n_experts)
        return max(8, (c + 7) // 8 * 8)


def load(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def dims(cfg: dict) -> Dims:
    keys = cfg["keys"]
    port = cfg["port"]
    run = {k: v["run"] for k, v in cfg.get("departures", {}).items()}
    return Dims(**{name: run.get(key, cfg[key]) for name, key in keys.items()},
                window=port["window"],
                capacity_factor=port["capacity_factor"])
