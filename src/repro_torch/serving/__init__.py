"""repro_torch.serving — batched serving engines on the port.

LM path: continuous-batching :class:`ServingEngine` over KV cache slots.
SNN path: :class:`SNNServingEngine`, dynamic window batching over the
port's SNN engine with a fault-tolerant request lifecycle
(:class:`SNNServingPolicy`), versioned train-while-serving weights
(:mod:`repro_torch.serving.weights` — double-buffered swap, probe-gated
promotion, checkpointed rollback), a deterministic fault injection
harness (:mod:`repro_torch.serving.faults`), a crash-consistency layer
(:mod:`repro_torch.serving.journal` — fsync'd CRC-framed request WAL,
engine-state snapshots, exactly-once terminal ledger, snapshot+tail
recovery on construction), and adaptive overload control
(:mod:`repro_torch.serving.overload` — CoDel sojourn management, AIMD
admission, priority-aware shedding, a global retry budget, and per-rung
circuit breakers over the degradation ladder).  Journal and checkpoint
directories are the JAX package's formats, byte for byte.
"""

from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.faults import (CRASH_EXIT_CODE, FaultInjectedError,
                                        FaultInjector, FaultSpec)
from repro_torch.serving.journal import (JournalError, RequestJournal,
                                         RingLog, replay)
from repro_torch.serving.overload import (LadderBreakers, OverloadController,
                                          OverloadPolicy, storm_policy)
from repro_torch.serving.snn import (EXPIRED, FAILED, QUEUED, REJECTED,
                                     SERVED, TERMINAL_STATUSES, ServingClock,
                                     SNNRequest, SNNServingEngine,
                                     SNNServingPolicy, degradation_ladder)
from repro_torch.serving.weights import (SNNRefreshPolicy,
                                         SNNWeightRefresher,
                                         VersionedWeightStore, WeightVersion,
                                         weight_fingerprint)

__all__ = [
    "Request", "ServingEngine",
    "SNNRequest", "SNNServingEngine", "SNNServingPolicy",
    "TERMINAL_STATUSES", "degradation_ladder",
    "CRASH_EXIT_CODE", "FaultInjectedError", "FaultInjector", "FaultSpec",
    "JournalError", "RequestJournal", "RingLog", "replay",
    "LadderBreakers", "OverloadController", "OverloadPolicy",
    "storm_policy",
    "SNNRefreshPolicy", "SNNWeightRefresher", "VersionedWeightStore",
    "WeightVersion", "weight_fingerprint",
    "EXPIRED", "FAILED", "QUEUED", "REJECTED", "SERVED", "ServingClock",
]
