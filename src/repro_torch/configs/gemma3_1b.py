"""gemma3-1b [dense] — 5:1 local:global attention, 128k-class context.

26L, d_model=1152, 4H (GQA kv=1), d_ff=6912, vocab=262144, head_dim=256,
sliding window 512 on local layers, every 6th layer global, tied
embeddings.  [hf:google/gemma-3-1b-pt; unverified]
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_ff=6912,
    vocab_size=262144,
    head_dim=256,
    rope_theta=1e6,
    window=512,
    swa_period=6,
    tie_embeddings=True,
    max_seq_len=1 << 19,
    source="hf:google/gemma-3-1b-pt; unverified",
))
