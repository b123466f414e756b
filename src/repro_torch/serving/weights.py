"""Versioned weight bank for SNN serving (memory only).

:class:`VersionedWeightStore` is an immutable, monotonically numbered
weight bank with double-buffered swap semantics: the *serving* version
is the only one traffic can see, candidates are staged under fresh
version numbers that are never visible, and a promotion only queues a
swap — :meth:`VersionedWeightStore.swap_if_pending` applies it at the
caller's step boundary, so every batch pins the version it started
with.  Rollback re-serves the previous promoted version from the
in-memory history.  Persistence (``state_dir``) comes with the
checkpoint slice.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading

import numpy as np

from repro_torch.core.bitpack import as_words, words_to_numpy
from repro_torch.serving.journal import RingLog


def weight_fingerprint(weights) -> str:
    """Content hash (shape + bytes) of a packed u32 weight bank; equal
    to the JAX package's fingerprint of the same bank."""
    arr = np.ascontiguousarray(words_to_numpy(as_words(weights)))
    h = hashlib.sha256()
    h.update(repr(arr.shape).encode())
    h.update(arr.tobytes())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class WeightVersion:
    """One immutable numbered weight bank.

    ``origin`` records how the version came to be: ``seed`` (the
    constructor bank), ``refresh`` (a trained candidate) or
    ``rollback``.  ``fingerprint`` is taken when the bank is produced;
    :meth:`verify` recomputes it, so corruption anywhere between
    production and promotion is detectable.
    """
    version: int
    weights: object                    # torch.int32[n, w] bit patterns
    fingerprint: str
    origin: str = "seed"               # seed|refresh|rollback
    probe_accuracy: float | None = None

    def verify(self) -> bool:
        return weight_fingerprint(self.weights) == self.fingerprint


class VersionedWeightStore:
    """Immutable, monotonically numbered weight bank with
    double-buffered swap semantics, held in memory on ``device``."""

    def __init__(self, seed_weights, *, state_dir=None, keep: int = 4,
                 device=None):
        if state_dir is not None:
            raise NotImplementedError("persisted weight versions "
                                      "(state_dir) are not ported yet")
        self._lock = threading.Lock()
        self.keep = keep
        self.device = device
        # --- counters / audit trail ------------------------------------
        self.staged = 0
        self.promotions = 0            # refresh promotions (not seed)
        self.rejected = 0
        self.rollbacks = 0
        self.events = RingLog(cap=256)   # bounded audit trail
        self.promoted_order: list[int] = []   # every live-able version
        self.demoted: set[int] = set()        # rolled-back versions
        self._history: dict[int, WeightVersion] = {}
        self._pending: WeightVersion | None = None

        seed_w = as_words(seed_weights, device)
        self._serving = WeightVersion(0, seed_w, weight_fingerprint(seed_w),
                                      origin="seed")
        self.promoted_order.append(0)
        self._history[0] = self._serving
        self._next = 1

    # --- lifecycle -----------------------------------------------------

    @property
    def serving(self) -> WeightVersion:
        """The promoted version traffic sees (pin it per batch step)."""
        return self._serving

    def stage(self, weights, *, origin: str = "refresh"
              ) -> WeightVersion:
        """Number a candidate bank.  Staged versions are invisible to
        traffic until promoted; the fingerprint is taken here, so any
        later mutation of the bank is detectable by ``verify()``."""
        with self._lock:
            v = self._next
            self._next += 1
            self.staged += 1
        w = as_words(weights, self.device)
        return WeightVersion(v, w, weight_fingerprint(w), origin=origin)

    def reject(self, cand: WeightVersion, reason: str) -> None:
        """Drop a candidate (never visible to traffic)."""
        with self._lock:
            self.rejected += 1
            self.events.append({"event": "rejected",
                                "version": cand.version,
                                "reason": reason})

    def promote(self, cand: WeightVersion) -> bool:
        """Queue a verified candidate for the next between-steps swap."""
        if not cand.verify():
            raise ValueError(f"refusing to promote version "
                             f"{cand.version}: fingerprint mismatch "
                             "(corrupt candidate)")
        with self._lock:
            self._history[cand.version] = cand
            self.promoted_order.append(cand.version)
            self.promotions += 1
            self._pending = cand
            self.events.append({"event": "promoted",
                                "version": cand.version,
                                "probe_accuracy": cand.probe_accuracy})
            for v in sorted(self._history)[:-max(self.keep, 1)]:
                if v != self._serving.version:
                    del self._history[v]
        return True

    def swap_if_pending(self) -> bool:
        """Apply a queued promotion/rollback.  This is the ONLY place
        ``serving`` changes — call it between serving steps, never
        while a batch is in flight."""
        with self._lock:
            if self._pending is None:
                return False
            self._serving = self._pending
            self._pending = None
            return True

    # --- rollback ------------------------------------------------------

    def _rollback_target(self) -> int | None:
        cur = (self._pending or self._serving).version
        for v in reversed(self.promoted_order):
            if v != cur and v not in self.demoted and v in self._history:
                return v
        return None

    def can_rollback(self) -> bool:
        return self._rollback_target() is not None

    def is_live(self, version: int) -> bool:
        """Whether a version is currently serveable: promoted at some
        point and never rolled back."""
        return (version in self.promoted_order
                and version not in self.demoted)

    def get(self, version: int) -> WeightVersion | None:
        """A promoted version still in the in-memory history."""
        return self._history.get(version)

    def rollback(self, reason: str = "") -> WeightVersion | None:
        """Demote the serving version and queue the newest older
        promoted version still in memory for the next between-steps
        swap.  Returns it (None when there is nothing to roll back to;
        the serving bank then stays live)."""
        with self._lock:
            cur = self._pending or self._serving
            tgt_v = self._rollback_target()
            if tgt_v is None:
                return None
            tgt = dataclasses.replace(self._history[tgt_v],
                                      origin="rollback")
            self.demoted.add(cur.version)
            self._pending = tgt
            self.rollbacks += 1
            self.events.append({"event": "rollback",
                                "from": cur.version, "to": tgt.version,
                                "reason": reason})
            return tgt

    # --- stats ---------------------------------------------------------

    def stats(self) -> dict:
        s = self._serving
        return {
            "weight_version": s.version,
            "weight_origin": s.origin,
            "versions_staged": self.staged,
            "versions_promoted": self.promotions,
            "versions_rejected": self.rejected,
            "rollbacks": self.rollbacks,
        }
