"""grok-1-314b [moe] — 8 experts top-2.

64L, d_model=6144, 48H (GQA kv=8), d_ff=32768, vocab=131072, MoE 8e
top-2.  [hf:xai-org/grok-1; unverified]  Full attention.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    head_dim=128,
    n_experts=8,
    top_k=2,
    moe_period=1,
    max_seq_len=32768,
    source="hf:xai-org/grok-1; unverified",
))
