"""starcoder2-3b [dense] — GQA, RoPE.

30L, d_model=3072, 24H (GQA kv=2), d_ff=12288, vocab=49152.
[arXiv:2402.19173; hf]
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    head_dim=128,
    rope_theta=1e5,
    use_bias=True,
    max_seq_len=16384,
    source="arXiv:2402.19173; hf",
))
