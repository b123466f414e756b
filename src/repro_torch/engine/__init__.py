"""repro_torch.engine — the SNN execution plan and its engine."""

from repro_torch.engine.engine import SNNEngine, resolve_device
from repro_torch.engine.plan import SNNEnginePlan, plan_from_config

__all__ = ["SNNEngine", "SNNEnginePlan", "plan_from_config",
           "resolve_device"]
