"""repro_torch.serving — SNN request serving on the port's engine."""

from repro_torch.serving.snn import (EXPIRED, FAILED, QUEUED, REJECTED,
                                     SERVED, TERMINAL_STATUSES,
                                     SNNRequest,
                                     SNNServingEngine, SNNServingPolicy,
                                     degradation_ladder)
from repro_torch.serving.weights import (VersionedWeightStore,
                                         WeightVersion, weight_fingerprint)

__all__ = ["EXPIRED", "FAILED", "QUEUED", "REJECTED", "SERVED",
           "TERMINAL_STATUSES", "SNNRequest",
           "SNNServingEngine", "SNNServingPolicy", "VersionedWeightStore",
           "WeightVersion", "degradation_ladder", "weight_fingerprint"]
