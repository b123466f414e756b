"""mixtral-8x22b [moe] — 8 experts top-2, SWA.

56L, d_model=6144, 48H (GQA kv=8), d_ff=16384, vocab=32768, MoE 8e top-2.
[arXiv:2401.04088; hf]  Sliding window 4096 on all layers (Mistral-style).
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    head_dim=128,
    rope_theta=1e6,
    window=4096,
    n_experts=8,
    top_k=2,
    moe_period=1,
    max_seq_len=65536,
    source="arXiv:2401.04088; hf",
))
