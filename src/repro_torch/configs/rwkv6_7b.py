"""rwkv6-7b [ssm] — Finch, attention-free, data-dependent decay.

32L, d_model=4096 (attn-free), d_ff=14336, vocab=65536.
[arXiv:2404.05892; hf]  State is O(1) in T -> runs long_500k.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,           # d_model / rwkv_head_size
    n_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    mixer="rwkv",
    rwkv_head_size=64,
    use_rope=False,
    max_seq_len=1 << 20,
    source="arXiv:2404.05892; hf",
))
