"""repro_torch.engine — the SNN execution plan and its engine."""

from repro_torch.engine.engine import (SNNEngine, SNNOutput, refresh_weights,
                                       reset_between_samples, resolve_device,
                                       train_stream, train_stream_batch)
from repro_torch.engine.plan import SNNEnginePlan, plan_from_config

__all__ = ["SNNEngine", "SNNEnginePlan", "SNNOutput", "plan_from_config",
           "refresh_weights", "reset_between_samples", "resolve_device",
           "train_stream", "train_stream_batch"]
