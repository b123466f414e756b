"""repro_torch.data — data pipelines.

digits: procedural 28x28 digit dataset (offline MNIST substitute)
"""

from repro_torch.data.digits import make_digits

__all__ = ["make_digits"]
