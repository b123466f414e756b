"""internvl2-26b [vlm] — InternViT frontend (stub) + InternLM2 backbone.

48L, d_model=6144, 48H (GQA kv=8), d_ff=16384, vocab=92553.
[arXiv:2404.16821; hf]  The ViT is a STUB: ``input_specs`` provides
precomputed patch embeddings [B, 256, d_model] prepended to the text.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    head_dim=128,
    rope_theta=1e6,
    frontend="vision",
    frontend_len=256,
    max_seq_len=32768,
    source="arXiv:2404.16821; hf",
))
