"""repro_torch.configs — assigned architecture configs + the paper's own
SNN.

Every module registers its config(s) on import; ``get_config(name)``
and ``list_configs()`` are the public API.
"""

from repro_torch.configs.base import (ArchConfig, LayerKind, get_config,
                                      layer_kinds, list_configs, reduced,
                                      register, scan_grouping)

# Register all assigned architectures (import side effects).
from repro_torch.configs import (command_r_35b, gemma3_1b,  # noqa: F401
                                 grok1_314b, internvl2_26b,
                                 jamba_1_5_large_398b, llama3_405b,
                                 mixtral_8x22b, rwkv6_7b, starcoder2_3b,
                                 whisper_small)
from repro_torch.configs.shapes import (SHAPES, ShapeSpec,  # noqa: F401
                                        applicable_shapes)
from repro_torch.configs.wenquxing_snn import (  # noqa: F401
    WENQUXING_22A, WENQUXING_22A_MESH2D)

__all__ = ["ArchConfig", "LayerKind", "get_config", "layer_kinds",
           "list_configs", "reduced", "register", "scan_grouping",
           "SHAPES", "ShapeSpec", "applicable_shapes", "WENQUXING_22A",
           "WENQUXING_22A_MESH2D"]
