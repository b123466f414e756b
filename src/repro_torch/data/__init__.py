"""repro_torch.data — data pipelines.

digits:    procedural 28x28 digit dataset (offline MNIST substitute)
synthetic: token streams for LM training/serving
loader:    sharded, step-indexed host loader with prefetch + resume
"""

from repro_torch.data.digits import make_digits
from repro_torch.data.loader import ShardedLoader
from repro_torch.data.synthetic import SyntheticTokens

__all__ = ["make_digits", "ShardedLoader", "SyntheticTokens"]
