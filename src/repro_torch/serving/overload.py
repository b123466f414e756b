"""Adaptive overload control for the SNN serving engine.

Static defenses (a bounded queue, per-request deadlines, a per-request
retry budget) keep a server *correct* under overload but not
*productive*: once sustained offered load exceeds capacity the queue
pins at ``max_queue``, every admitted request ages toward its deadline
while being served, and goodput collapses into expiry/retry churn —
the metastable failure mode.  :class:`OverloadController` is the
adaptive layer that keeps the pipeline productive through sustained
overload, built from four cooperating mechanisms plus an explicit
circuit-breaker view of the degradation ladder:

**CoDel-style sojourn control (drop-at-dequeue).**  At every batch
formation the controller observes the *standing-queue sojourn* — the
age of the oldest queued request, the requests a priority queue lets
linger — and, CoDel-style, reacts only to its minimum over a sliding
``interval_ms`` window (a transient burst that drains within the
interval resets the state).  When the sojourn stays above
``target_sojourn_ms`` for a full interval the controller enters the
*dropping* state:
batch formation sheds queued requests instead of serving them into
certain SLO misses, at a rate that ramps with the classic
``interval / sqrt(drop_count)`` control law, and — while dropping —
any request already older than the sojourn ceiling
(``max_sojourn_ms``, default ``0.8 * slo_ms``) is shed outright:
serving it would burn capacity on a response that can no longer meet
its SLO.  The state exits as soon as a dequeue minimum falls back
under target.

**AIMD admission (front-door rate limit).**  ``submit()`` consults a
token bucket refilled at ``admit_rate`` requests/s.  Every
``interval_ms`` the rate adapts: multiplicative decrease
(``md_factor``) when the interval saw congestion (CoDel dropping, or
a served request breaching ``slo_ms``), additive increase
(``additive_rps``) otherwise.  Bucket exhaustion alone is *not*
congestion — that is exactly how AIMD probes upward until the latency
signal pushes back, converging on the sustainable rate.  Rejecting at
the front door is the cheap place to say no: the request never
occupies queue memory or a batch slot.

**Priority-aware shedding.**  The rate limiter governs the *low*
class.  High-priority requests (``priority >= high_priority``) bypass
the bucket — they are protected by strict-priority dequeue, CoDel
exemption, and the low class's shedding, and bounded only by the
engine's ``max_queue`` backpressure (plus their own deadlines under a
pure high-priority storm).  They still consume a token when one is
available, and a low-priority admit must leave ``high_reserve``
tokens behind, so the low class yields admission capacity to the high
class first.  Low-priority requests additionally shed
probabilistically at the front door as the queue fills (a RED-style
ramp from ``low_shed_start`` to ``low_shed_full`` occupancy).  Under
5x overload the shed mass concentrates on the low class, which is
what holds high-priority SLO attainment.

**Global retry-token budget.**  Per-request retry budgets multiply
under correlated fault bursts: every batch retries independently and
the retry traffic itself becomes the overload (a retry storm).
:meth:`grant_retry` draws from one global bucket (``retry_budget``
tokens, refilled at ``retry_refill_per_s``) so the *aggregate* retry
rate is bounded no matter how many batches are failing concurrently.

**Determinism.**  The controller owns no clock and no stateful RNG:
every method takes ``now_ms`` from the engine's pluggable clock, and
the only probabilistic decision (the RED shed) hashes a decision
counter through the stateless splitmix64 draw
(:func:`repro_torch.loadgen.arrivals.u01`).  A virtual-clock overload run is
therefore a pure function of (trace, specs, seeds) and replays
bit-identically — the property ``launch/loadgen.py --check`` and
``serve --overload-storm`` assert.

:class:`LadderBreakers` formalizes the degradation ladder as one
circuit breaker per rung: ``closed`` (serving normally), ``open``
(tripped by retry exhaustion / integrity violation at that rung), and
``half_open`` (the deterministic reprobe after ``reprobe_after``
healthy steps readmits trial traffic; the first healthy step closes
the trial, a fault re-opens it).  The states are pure observability
over the engine's existing level/healthy-step mechanics — bit-compatible
with pre-breaker replays — surfaced in ``stats()`` and persisted in
journal snapshots.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.loadgen.arrivals import u01

# breaker states (one per degradation rung)
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# shed-attribution tags (journaled on TERMINAL records, so recovery
# re-derives the shed counters exactly)
SHED_ADMISSION = "adm"       # AIMD token bucket said no at submit()
SHED_LOW_PRIORITY = "lowprio"  # RED occupancy ramp shed a low-prio submit
SHED_CODEL = "codel"         # dropped at dequeue by sojourn control


@dataclasses.dataclass(frozen=True)
class OverloadPolicy:
    """One engine's overload-control law.  Frozen, like the serving
    policy: the controller's runtime state lives in
    :class:`OverloadController`."""
    slo_ms: float = 50.0            # latency target the AIMD loop tracks
    # --- CoDel sojourn control -----------------------------------------
    target_sojourn_ms: float = 5.0  # acceptable standing-queue sojourn
    interval_ms: float = 100.0      # sliding window / AIMD epoch
    max_sojourn_ms: float | None = None  # dequeue age ceiling while
    #                                 dropping (None = 0.8 * slo_ms)
    # --- AIMD admission-rate limiter ------------------------------------
    admit_rps_min: float = 50.0
    admit_rps_max: float = 1e6
    admit_rps_init: float | None = None   # None = start at admit_rps_max
    additive_rps: float = 500.0     # +per clean interval
    md_factor: float = 0.7          # x per congested interval
    burst: float = 64.0             # token-bucket depth
    # --- priority-aware shedding ----------------------------------------
    high_priority: int = 1          # priority >= this is the high class
    high_reserve: float = 8.0       # tokens a low-prio admit must leave
    low_shed_start: float = 0.5     # RED ramp start (queue occupancy)
    low_shed_full: float = 0.9      # occupancy where low class sheds 100%
    # --- global retry budget --------------------------------------------
    retry_budget: float = 32.0      # bucket depth (tokens)
    retry_refill_per_s: float = 8.0
    seed: int = 0xC0DE1             # RED-shed counter-hash seed

    def __post_init__(self):
        for name in ("slo_ms", "target_sojourn_ms", "interval_ms",
                     "admit_rps_min", "admit_rps_max", "additive_rps",
                     "burst", "retry_budget"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be > 0, got "
                                 f"{getattr(self, name)}")
        if self.max_sojourn_ms is not None and self.max_sojourn_ms <= 0:
            raise ValueError(f"max_sojourn_ms must be > 0 or None, got "
                             f"{self.max_sojourn_ms}")
        if not 0.0 < self.md_factor < 1.0:
            raise ValueError(f"md_factor must be in (0, 1), got "
                             f"{self.md_factor}")
        if self.admit_rps_min > self.admit_rps_max:
            raise ValueError("admit_rps_min must be <= admit_rps_max")
        if self.admit_rps_init is not None and not (
                self.admit_rps_min <= self.admit_rps_init
                <= self.admit_rps_max):
            raise ValueError("admit_rps_init must lie in "
                             "[admit_rps_min, admit_rps_max]")
        if not 0.0 <= self.low_shed_start < self.low_shed_full <= 1.0:
            raise ValueError("need 0 <= low_shed_start < low_shed_full "
                             "<= 1")
        if self.high_reserve < 0 or self.retry_refill_per_s < 0:
            raise ValueError("high_reserve and retry_refill_per_s must "
                             "be >= 0")

    @property
    def sojourn_limit_ms(self) -> float:
        """The dequeue age ceiling enforced while dropping."""
        return (self.max_sojourn_ms if self.max_sojourn_ms is not None
                else 0.8 * self.slo_ms)


def storm_policy(base_rps: float) -> OverloadPolicy:
    """The overload-storm policy, scaled to a known
    ~sustainable rate (the committed trace's recorded 1x rate).  Tuned
    for the virtual-clock service model: a ~20 ms control interval is
    ~15-20 serving steps, the limiter starts at 2x base (so the 5x
    storm exercises a real AIMD descent), and the sojourn ceiling sits
    under the 50 ms run SLO so CoDel sheds zombies instead of serving
    them.  Shared by ``launch/loadgen.py --overload`` and
    ``serve --overload-storm`` so both run the identical control law
    (the JAX package's, constant for constant)."""
    return OverloadPolicy(
        slo_ms=50.0, target_sojourn_ms=8.0, interval_ms=20.0,
        max_sojourn_ms=30.0, admit_rps_min=base_rps / 4.0,
        admit_rps_max=base_rps * 8.0, admit_rps_init=base_rps * 2.0,
        additive_rps=base_rps / 8.0, md_factor=0.7, burst=64.0,
        high_priority=1, high_reserve=8.0, low_shed_start=0.1,
        low_shed_full=0.5, retry_budget=32.0, retry_refill_per_s=8.0)


class OverloadController:
    """Runtime state of one engine's overload control (see the module
    docstring).  Every method takes ``now_ms`` explicitly — the
    controller never reads a clock — and all state serializes through
    :meth:`state_dict` for journal snapshots."""

    def __init__(self, policy: OverloadPolicy | None = None):
        self.policy = p = (policy if policy is not None
                           else OverloadPolicy())
        self.admit_rate = (p.admit_rps_init if p.admit_rps_init
                           is not None else p.admit_rps_max)
        self._tokens = p.burst
        self._t_tokens_ms: float | None = None
        self._interval_start_ms: float | None = None
        self._congested = False
        # CoDel state
        self._first_above_ms: float | None = None
        self.dropping = False
        self._drop_next_ms = 0.0
        self._drop_count = 0
        # retry budget
        self.retry_tokens = p.retry_budget
        self._t_retry_ms: float | None = None
        # counters (decisions doubles as the stateless RED-draw counter)
        self.decisions = 0
        self.md_events = 0
        self.ai_events = 0
        self.codel_entries = 0

    # --- AIMD epoch ------------------------------------------------------

    def _tick(self, now_ms: float) -> None:
        """Roll the AIMD interval if it elapsed: one rate adjustment per
        epoch, congestion-flag reset."""
        if self._interval_start_ms is None:
            self._interval_start_ms = now_ms
            return
        if now_ms - self._interval_start_ms < self.policy.interval_ms:
            return
        if self._congested or self.dropping:
            self.admit_rate = max(self.policy.admit_rps_min,
                                  self.admit_rate * self.policy.md_factor)
            self.md_events += 1
        else:
            self.admit_rate = min(self.policy.admit_rps_max,
                                  self.admit_rate
                                  + self.policy.additive_rps)
            self.ai_events += 1
        self._congested = False
        self._interval_start_ms = now_ms

    def _refill(self, now_ms: float) -> None:
        if self._t_tokens_ms is None:
            self._t_tokens_ms = now_ms
        dt = max(0.0, now_ms - self._t_tokens_ms)
        self._tokens = min(self.policy.burst,
                           self._tokens + dt * self.admit_rate / 1e3)
        self._t_tokens_ms = now_ms

    # --- front door ------------------------------------------------------

    def admit(self, priority: int, queue_len: int,
              max_queue: int | None, now_ms: float
              ) -> tuple[bool, str | None]:
        """One admission decision.  Returns ``(admitted, shed_tag)`` —
        the tag (:data:`SHED_ADMISSION` / :data:`SHED_LOW_PRIORITY`)
        attributes a rejection for counters and the journal.  The high
        class bypasses the limiter (consuming a token when one exists,
        so the low class yields first); the low class pays the RED
        occupancy ramp and must leave ``high_reserve`` tokens."""
        p = self.policy
        self._tick(now_ms)
        self._refill(now_ms)
        self.decisions += 1
        if priority >= p.high_priority:
            self._tokens = max(0.0, self._tokens - 1.0)
            return True, None
        if max_queue:
            occ = queue_len / max_queue
            if occ >= p.low_shed_start:
                frac = ((occ - p.low_shed_start)
                        / (p.low_shed_full - p.low_shed_start))
                if u01(p.seed, 1, self.decisions) < min(1.0, frac):
                    return False, SHED_LOW_PRIORITY
        if self._tokens < 1.0 + p.high_reserve:
            # NOT a congestion signal: the limiter binding is how AIMD
            # probes upward; only latency pushes the rate back down
            return False, SHED_ADMISSION
        self._tokens -= 1.0
        return True, None

    # --- dequeue (CoDel) -------------------------------------------------

    def on_dequeue(self, sojourn_ms: float, now_ms: float,
                   backlog: int) -> int:
        """Observe one batch formation's standing-queue sojourn (age of
        the oldest queued request); returns how many requests the sqrt
        control law says to shed now (the engine additionally sheds
        anything older than ``sojourn_limit_ms`` while
        :attr:`dropping`).  The CoDel interval filter is internal: a
        single below-target observation resets the state, so only a
        sojourn persistently above target — the interval *minimum* —
        triggers dropping."""
        p = self.policy
        self._tick(now_ms)
        if sojourn_ms < p.target_sojourn_ms:
            self._first_above_ms = None
            self.dropping = False
            self._drop_count = 0
            return 0
        if self._first_above_ms is None:
            self._first_above_ms = now_ms + p.interval_ms
            return 0
        if not self.dropping:
            if now_ms < self._first_above_ms:
                return 0
            self.dropping = True
            self.codel_entries += 1
            self._congested = True
            self._drop_count = 0
            self._drop_next_ms = now_ms
        self._congested = True
        n = 0
        while self._drop_next_ms <= now_ms and n < backlog:
            n += 1
            self._drop_count += 1
            self._drop_next_ms += (p.interval_ms
                                   / math.sqrt(self._drop_count))
        return n

    # --- serve feedback --------------------------------------------------

    def note_served(self, service_ms: float) -> None:
        """A served request's end-to-end latency: breaching the SLO
        marks the current AIMD interval congested."""
        if service_ms > self.policy.slo_ms:
            self._congested = True

    # --- global retry budget ---------------------------------------------

    def grant_retry(self, now_ms: float) -> bool:
        """Spend one global retry token (refilled at
        ``retry_refill_per_s``); False = the retry storm budget is
        exhausted and the caller must fail fast instead."""
        p = self.policy
        if self._t_retry_ms is None:
            self._t_retry_ms = now_ms
        dt = max(0.0, now_ms - self._t_retry_ms)
        self.retry_tokens = min(p.retry_budget,
                                self.retry_tokens
                                + dt * p.retry_refill_per_s / 1e3)
        self._t_retry_ms = now_ms
        if self.retry_tokens >= 1.0:
            self.retry_tokens -= 1.0
            return True
        return False

    # --- persistence -----------------------------------------------------

    def state_dict(self) -> dict:
        """JSON-ready controller state for journal snapshots."""
        return {"admit_rate": self.admit_rate, "tokens": self._tokens,
                "t_tokens_ms": self._t_tokens_ms,
                "interval_start_ms": self._interval_start_ms,
                "congested": self._congested,
                "first_above_ms": self._first_above_ms,
                "dropping": self.dropping,
                "drop_next_ms": self._drop_next_ms,
                "drop_count": self._drop_count,
                "retry_tokens": self.retry_tokens,
                "t_retry_ms": self._t_retry_ms,
                "decisions": self.decisions,
                "md_events": self.md_events,
                "ai_events": self.ai_events,
                "codel_entries": self.codel_entries}

    def load_state(self, d: dict) -> None:
        """Adopt a snapshot's controller state (tolerant: unknown keys
        ignored, missing keys keep their fresh-construction values —
        an old snapshot restores a younger controller, never fails)."""
        for attr, key in (("admit_rate", "admit_rate"),
                          ("_tokens", "tokens"),
                          ("_t_tokens_ms", "t_tokens_ms"),
                          ("_interval_start_ms", "interval_start_ms"),
                          ("_congested", "congested"),
                          ("_first_above_ms", "first_above_ms"),
                          ("dropping", "dropping"),
                          ("_drop_next_ms", "drop_next_ms"),
                          ("_drop_count", "drop_count"),
                          ("retry_tokens", "retry_tokens"),
                          ("_t_retry_ms", "t_retry_ms"),
                          ("decisions", "decisions"),
                          ("md_events", "md_events"),
                          ("ai_events", "ai_events"),
                          ("codel_entries", "codel_entries")):
            if key in d:
                setattr(self, attr, d[key])


class LadderBreakers:
    """Explicit closed/open/half-open circuit-breaker state, one per
    degradation-ladder rung.  Pure observability over the engine's
    level / healthy-step mechanics (which stay the source of truth, so
    pre-breaker replays are bit-identical): retry exhaustion or an
    integrity violation at rung R *opens* R, the deterministic reprobe
    (``policy.reprobe_after`` healthy steps) *half-opens* every open
    rung while the engine trials rung 0, and the next healthy step
    *closes* the trial; a fault during the trial re-opens its rung."""

    def __init__(self, n_rungs: int, states: list[str] | None = None):
        if n_rungs < 1:
            raise ValueError(f"n_rungs must be >= 1, got {n_rungs}")
        self.n_rungs = n_rungs
        self._states = [CLOSED] * n_rungs
        self.trips = 0
        self.reprobes = 0
        if states:
            for i, s in enumerate(states[:n_rungs]):
                if s in (CLOSED, OPEN, HALF_OPEN):
                    self._states[i] = s

    def open_rung(self, rung: int) -> None:
        """The ladder stepped down off ``rung``: trip its breaker."""
        if 0 <= rung < self.n_rungs and self._states[rung] != OPEN:
            self._states[rung] = OPEN
            self.trips += 1

    def half_open_all(self) -> None:
        """Deterministic reprobe: every tripped rung admits trial
        traffic (the engine resets to rung 0)."""
        changed = False
        for i, s in enumerate(self._states):
            if s == OPEN:
                self._states[i] = HALF_OPEN
                changed = True
        if changed:
            self.reprobes += 1

    def close_trials(self) -> None:
        """A healthy step landed: the half-open trials passed."""
        for i, s in enumerate(self._states):
            if s == HALF_OPEN:
                self._states[i] = CLOSED

    def states(self) -> list[str]:
        return list(self._states)

    def __repr__(self) -> str:
        return (f"LadderBreakers({'/'.join(self._states)}, "
                f"trips={self.trips})")
