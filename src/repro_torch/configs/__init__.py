"""repro_torch.configs — the ported architecture configs + the paper's
own SNN.

Every module registers its config(s) on import; ``get_config(name)``
and ``list_configs()`` are the public API.  The configs whose layers the
port lacks (and ``SHAPES``) come with those layers.
"""

from repro_torch.configs.base import (ArchConfig, LayerKind, get_config,
                                      layer_kinds, list_configs, reduced,
                                      register, scan_grouping)

# Register the ported architectures (import side effects).
from repro_torch.configs import (command_r_35b, gemma3_1b,  # noqa: F401
                                 llama3_405b, starcoder2_3b)
from repro_torch.configs.wenquxing_snn import (  # noqa: F401
    WENQUXING_22A, WENQUXING_22A_MESH2D)

__all__ = ["ArchConfig", "LayerKind", "get_config", "layer_kinds",
           "list_configs", "reduced", "register", "scan_grouping",
           "WENQUXING_22A", "WENQUXING_22A_MESH2D"]
