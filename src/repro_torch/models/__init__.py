"""repro_torch.models — the LM model of the port.

``transformer.Model`` is an ``nn.Module`` for every assigned LM config
(dense, MoE, Mamba hybrid, RWKV6, encoder-decoder, vision prefix); the
layers are plain functions on tensors in ``models/layers/``.
"""

from repro_torch.models.transformer import Model

__all__ = ["Model"]
