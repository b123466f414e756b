"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7, MoE 16e top-2.

72L, d_model=8192, 64H (GQA kv=8), d_ff=24576, vocab=65536; one
attention layer per 8 (rest Mamba), MoE every 2nd layer.
[arXiv:2403.19887; hf]  O(1) state on Mamba layers -> runs long_500k.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    use_rope=False,            # jamba: no positional encoding
    mixer="hybrid",
    attn_period=8,
    d_state=16,
    n_experts=16,
    top_k=2,
    moe_period=2,
    max_seq_len=1 << 19,
    source="arXiv:2403.19887; hf",
))
