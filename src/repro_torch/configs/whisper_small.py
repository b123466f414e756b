"""whisper-small [audio] — enc-dec, conv frontend stub.

12L (enc) + 12L (dec), d_model=768, 12H (GQA kv=12 -> MHA), d_ff=3072,
vocab=51865.  [arXiv:2212.04356; unverified]

The audio frontend (2x conv + GELU over 80-mel spectrograms) is a STUB:
``input_specs`` provides precomputed frame embeddings [B, 1500, 768].
Whisper uses learned positional embeddings and LayerNorm (not RoPE/RMS).
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    encoder_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    head_dim=64,
    use_rope=False,
    norm="ln",
    act="gelu",
    use_bias=True,
    frontend="audio",
    frontend_len=1500,
    max_seq_len=32768,
    source="arXiv:2212.04356; unverified",
))
