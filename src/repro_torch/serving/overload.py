"""Circuit-breaker view of the serving degradation ladder.

Only :class:`LadderBreakers` is here; the adaptive overload controller
(AIMD admission, CoDel, priority shedding, the retry budget) comes with
a later slice.
"""

from __future__ import annotations

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class LadderBreakers:
    """Explicit closed/open/half-open circuit-breaker state, one per
    degradation-ladder rung.  Pure observability over the engine's
    level / healthy-step mechanics (which stay the source of truth):
    retry exhaustion or an integrity violation at rung R *opens* R, the
    deterministic reprobe (``policy.reprobe_after`` healthy steps)
    *half-opens* every open rung while the engine trials rung 0, and the
    next healthy step *closes* the trial; a fault during the trial
    re-opens its rung."""

    def __init__(self, n_rungs: int):
        if n_rungs < 1:
            raise ValueError(f"n_rungs must be >= 1, got {n_rungs}")
        self.n_rungs = n_rungs
        self._states = [CLOSED] * n_rungs
        self.trips = 0
        self.reprobes = 0

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
