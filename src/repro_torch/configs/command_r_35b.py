"""command-r-35b [dense] — GQA, no-bias.

40L, d_model=8192, 64H (GQA kv=8), d_ff=22528, vocab=256000.
[hf:CohereForAI/c4ai-command-r-v01; unverified]
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    head_dim=128,
    rope_theta=8e6,
    use_bias=False,
    max_seq_len=131072,
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
))
