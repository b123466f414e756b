"""repro_torch.models — the LM model of the port.

``transformer.Model`` is an ``nn.Module`` for the decoder-only configs
whose layers the port has (attention mixers, dense FFNs); the layers are
plain functions on tensors in ``models/layers/``.
"""

from repro_torch.models.transformer import Model

__all__ = ["Model"]
