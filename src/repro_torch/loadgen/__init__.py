"""repro_torch.loadgen — open-loop load generation for the SNN serving stack.

The measurement substrate the serving/training work is judged by:
seeded arrival processes (:mod:`~repro_torch.loadgen.arrivals`),
reproducible request-mix specs (:mod:`~repro_torch.loadgen.workload`),
bit-identically replayable traces (:mod:`~repro_torch.loadgen.trace`),
mergeable log-bucketed latency histograms
(:mod:`~repro_torch.loadgen.histogram`), and a coordinated-omission-correct
virtual-clock runner with SLO attainment and a sustainable-rate sweep
(:mod:`~repro_torch.loadgen.runner`).

``runner`` imports :mod:`repro_torch.serving` (which itself uses
``loadgen.histogram`` for the engine's latency accounting), so its
symbols load lazily here — ``from repro_torch.loadgen import run_rows``
works, but importing :mod:`repro_torch.serving` never recurses back through
it.
"""

from repro_torch.loadgen.arrivals import ArrivalSpec, timestamps, u01, u64
from repro_torch.loadgen.histogram import LatencyHistogram
from repro_torch.loadgen.trace import (TraceError, generate_rows, read_trace,
                                 scale_rows, stream_sha, verify_payloads,
                                 write_trace)
from repro_torch.loadgen.workload import WorkloadSpec, u64_stream

_RUNNER_SYMBOLS = ("LoadReport", "PacedWallClock", "ServiceModel",
                   "VirtualClock", "make_clock", "rate_sweep", "run_rows")

__all__ = [
    "ArrivalSpec", "timestamps", "u01", "u64",
    "LatencyHistogram",
    "TraceError", "generate_rows", "read_trace", "scale_rows",
    "stream_sha", "verify_payloads", "write_trace",
    "WorkloadSpec", "u64_stream",
    *_RUNNER_SYMBOLS,
]


def __getattr__(name: str):
    if name in _RUNNER_SYMBOLS:
        from repro_torch.loadgen import runner
        return getattr(runner, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
