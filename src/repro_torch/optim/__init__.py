"""repro_torch.optim — optimizers, schedules, gradient compression."""

from repro_torch.optim.adamw import AdamW, AdamWConfig
from repro_torch.optim.compression import onebit_compress, onebit_decompress
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["AdamW", "AdamWConfig", "cosine_schedule", "onebit_compress",
           "onebit_decompress"]
