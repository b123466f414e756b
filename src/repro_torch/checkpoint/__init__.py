"""repro_torch.checkpoint — atomic, async, keep-k checkpoints in the
JAX package's on-disk layout."""

from repro_torch.checkpoint.checkpointer import CheckpointManager

__all__ = ["CheckpointManager"]
