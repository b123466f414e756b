"""repro_torch.runtime — fault-tolerant training loop, straggler watchdog;
spans (``runtime.tracing``)."""

from repro_torch.runtime.train_loop import (SimulatedFailure, TrainLoop,
                                            TrainLoopConfig)

__all__ = ["SimulatedFailure", "TrainLoop", "TrainLoopConfig"]
