"""Serving telemetry shared with the request journal.

Only what the bare serving engine needs is here: the bounded event log
and the schema of the engine counters that a journal snapshot records.
The journal itself (write-ahead log, snapshots, replay) comes with a
later slice.
"""

from __future__ import annotations

import collections.abc


class RingLog(collections.abc.Sequence):
    """Fixed-capacity append-only event log: keeps the most recent
    ``cap`` entries and counts the rest in ``dropped``, so long serving
    runs carry bounded telemetry instead of an unbounded list.
    Supports the list operations the telemetry consumers use (len,
    indexing incl. negative, iteration, ``append``)."""

    def __init__(self, cap: int = 256, items=None):
        if cap < 1:
            raise ValueError(f"cap must be >= 1, got {cap}")
        self.cap = int(cap)
        self.dropped = 0
        self._items: list = []
        for it in (items or []):
            self.append(it)

    def append(self, item) -> None:
        self._items.append(item)
        if len(self._items) > self.cap:
            del self._items[0]
            self.dropped += 1

    def __len__(self) -> int:
        return len(self._items)

    def __getitem__(self, i):
        return self._items[i]

    def __iter__(self):
        return iter(self._items)

    def to_list(self) -> list:
        return list(self._items)

    def __repr__(self) -> str:
        return (f"RingLog(cap={self.cap}, kept={len(self._items)}, "
                f"dropped={self.dropped})")


# The integer counters of the serving engine, as a journal snapshot
# records them.  The refresh and overload counters join this schema
# when those layers are ported.
_COUNTER_KEYS = (
    "steps", "batches", "windows_served", "slots_offered",
    "slots_padded", "submitted", "rejected", "expired", "failed",
    "retried", "degraded", "integrity_failures", "canary_checks",
    "canary_failures", "healthy_steps", "version_violations",
)
