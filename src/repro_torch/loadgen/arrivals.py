"""Seeded open-loop arrival processes on a virtual clock.

An *open-loop* load generator decides request arrival times from the
offered-rate process alone — never from how fast the server is
draining — which is what makes the measured latencies immune to
coordinated omission: a backed-up server cannot slow the arrival
stream down and thereby hide its own queueing delay.  Every process
here emits a deterministic, seed-reproducible, nondecreasing stream of
**virtual-clock timestamps in milliseconds** (rounded to 1 us so the
stream serializes exactly in traces).

Randomness comes from a stateless splitmix64-style counter hash
(:func:`u64`) rather than a stateful library RNG: any (seed, counter)
pair can be drawn in isolation, the stream is identical on every
platform and library version, and a replayed trace can re-derive any
request's draw without regenerating its predecessors — the same
argument :func:`repro_torch.core.lfsr.counter_hash` makes for the in-kernel
spike draw.

Processes
---------

``uniform``
    Constant inter-arrival gap ``1000 / rate_rps`` ms.
``poisson``
    Exponential i.i.d. gaps with mean ``1000 / rate_rps`` ms (the
    memoryless process heavy-traffic queueing results assume).
``onoff``
    Bursty modulated Poisson: a square wave of period ``period_ms``
    spends ``duty`` of each period in the ON phase at
    ``burst_factor x`` the mean rate and the rest in the OFF phase at
    the complementary rate, so the long-run offered rate is still
    ``rate_rps`` — the arrival pattern tail-latency percentiles are
    most sensitive to.
"""

from __future__ import annotations

import dataclasses
import math

_M64 = (1 << 64) - 1
_P1 = 0x9E3779B97F4A7C15      # golden-ratio increment (splitmix64)
_P2 = 0xBF58476D1CE4E5B9
_P3 = 0x94D049BB133111EB

ARRIVAL_PROCESSES = ("uniform", "poisson", "onoff")


def u64(seed: int, *counters: int) -> int:
    """Stateless 64-bit draw for (seed, counters...): a Weyl-style
    combination of the counters finalized with the splitmix64 mixer.
    Pure integer arithmetic — bit-identical on every platform."""
    z = (seed * _P1) & _M64
    for i, c in enumerate(counters):
        z = (z + (c + 1) * ((_P2 + 2 * i) & _M64)) & _M64
    z ^= z >> 30
    z = (z * _P2) & _M64
    z ^= z >> 27
    z = (z * _P3) & _M64
    return z ^ (z >> 31)


def u01(seed: int, *counters: int) -> float:
    """Uniform in [0, 1) with 53 random bits (never exactly 1.0)."""
    return (u64(seed, *counters) >> 11) / float(1 << 53)


@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """One seeded arrival process: ``n_requests`` virtual timestamps."""
    process: str = "poisson"      # uniform | poisson | onoff
    rate_rps: float = 1000.0      # long-run offered rate (requests/s)
    n_requests: int = 1000
    seed: int = 0
    # --- onoff modulation only ------------------------------------
    burst_factor: float = 4.0     # ON-phase rate multiplier (> 1)
    duty: float = 0.2             # fraction of each period spent ON
    period_ms: float = 100.0

    def __post_init__(self):
        if self.process not in ARRIVAL_PROCESSES:
            raise ValueError(f"process must be one of "
                             f"{ARRIVAL_PROCESSES}, got {self.process!r}")
        if self.rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {self.rate_rps}")
        if self.n_requests < 1:
            raise ValueError(f"n_requests must be >= 1, got "
                             f"{self.n_requests}")
        if self.process == "onoff":
            if not 0.0 < self.duty < 1.0:
                raise ValueError(f"duty must be in (0, 1), got "
                                 f"{self.duty}")
            if self.burst_factor * self.duty >= 1.0:
                raise ValueError(
                    f"burst_factor * duty must be < 1 so the OFF-phase "
                    f"rate stays positive, got "
                    f"{self.burst_factor} * {self.duty}")
            if self.period_ms <= 0:
                raise ValueError(f"period_ms must be > 0, got "
                                 f"{self.period_ms}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ArrivalSpec":
        return cls(**d)


def _onoff_rate(spec: ArrivalSpec, t_ms: float) -> float:
    """Instantaneous rate (requests/ms) of the on-off square wave."""
    on = (t_ms % spec.period_ms) < spec.duty * spec.period_ms
    if on:
        return spec.rate_rps * spec.burst_factor / 1e3
    rate_off = (spec.rate_rps * (1.0 - spec.burst_factor * spec.duty)
                / (1.0 - spec.duty))
    return rate_off / 1e3


def timestamps(spec: ArrivalSpec) -> list[float]:
    """The spec's full virtual-clock arrival stream (ms, nondecreasing,
    rounded to 1 us).  Same spec -> bit-identical stream."""
    n = spec.n_requests
    gap_ms = 1e3 / spec.rate_rps
    out: list[float] = []
    if spec.process == "uniform":
        for i in range(n):
            out.append(round(i * gap_ms, 3))
        return out
    t = 0.0
    for i in range(n):
        u = u01(spec.seed, i)
        if spec.process == "poisson":
            t += -gap_ms * math.log(1.0 - u)
        else:   # onoff: exponential gap at the instantaneous phase rate
            t += -math.log(1.0 - u) / _onoff_rate(spec, t)
        out.append(round(t, 3))
    return out
