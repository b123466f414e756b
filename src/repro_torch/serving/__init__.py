"""repro_torch.serving — SNN request serving on the port's engine, and
the LM's continuous-batching engine."""

from repro_torch.serving.engine import Request, ServingEngine

from repro_torch.serving.snn import (EXPIRED, FAILED, QUEUED, REJECTED,
                                     SERVED, TERMINAL_STATUSES,
                                     SNNRequest,
                                     SNNServingEngine, SNNServingPolicy,
                                     degradation_ladder)
from repro_torch.serving.weights import (VersionedWeightStore,
                                         WeightVersion, weight_fingerprint)

__all__ = ["EXPIRED", "FAILED", "QUEUED", "REJECTED", "SERVED",
           "TERMINAL_STATUSES", "Request", "SNNRequest", "ServingEngine",
           "SNNServingEngine", "SNNServingPolicy", "VersionedWeightStore",
           "WeightVersion", "degradation_ladder", "weight_fingerprint"]
