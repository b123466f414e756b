"""Mergeable log-bucketed latency histogram (HDR-style).

A copy of ``repro.loadgen.histogram`` (the JAX package's module is
reached only through imports of JAX).  Latency is kept in a
fixed-resolution log-linear bucket array, not a list of samples:

* values are quantized to integer ``unit_ms`` ticks (default 1 us);
* ticks below ``2**sub_bits`` get one bucket each (exact);
* every octave above that is split into ``2**(sub_bits-1)`` linear
  sub-buckets, so relative bucket width — and therefore worst-case
  percentile error — stays below ``2**(1 - sub_bits)`` (~1.6% at the
  default ``sub_bits=7``) at any magnitude.

Bucket indices are pure integer arithmetic on the tick count (no
float ``log``), so two histograms built from the same samples are
bit-identical.  Two histograms with the same parameters **merge** by
adding bucket counts, exactly.  Percentiles are nearest-rank over
bucket midpoints.  Serialization (:meth:`to_dict` / :meth:`from_dict`)
is plain JSON.
"""

from __future__ import annotations

import math


class LatencyHistogram:
    """Fixed-parameter log-bucketed histogram over millisecond values."""

    def __init__(self, unit_ms: float = 1e-3, sub_bits: int = 7):
        if unit_ms <= 0:
            raise ValueError(f"unit_ms must be > 0, got {unit_ms}")
        if not 1 <= sub_bits <= 16:
            raise ValueError(f"sub_bits must be in [1, 16], got "
                             f"{sub_bits}")
        self.unit_ms = float(unit_ms)
        self.sub_bits = int(sub_bits)
        self._sub = 1 << self.sub_bits       # one-per-tick region size
        self._half = self._sub >> 1          # sub-buckets per octave
        self.counts: dict[int, int] = {}
        self.total = 0
        self.min_ms: float | None = None
        self.max_ms: float | None = None

    # --- bucket arithmetic (integers only, so runs are bit-identical) ---

    def _index(self, ticks: int) -> int:
        if ticks < self._sub:
            return ticks
        k = ticks.bit_length() - 1           # octave: ticks in [2^k, 2^k+1)
        off = (ticks - (1 << k)) >> (k - self.sub_bits + 1)
        return self._sub + (k - self.sub_bits) * self._half + off

    def _bounds(self, index: int) -> tuple[float, float]:
        """[lo, hi) of a bucket in ticks."""
        if index < self._sub:
            return float(index), float(index + 1)
        j = index - self._sub
        k = self.sub_bits + j // self._half
        off = j % self._half
        width = 1 << (k - self.sub_bits + 1)
        lo = (1 << k) + off * width
        return float(lo), float(lo + width)

    def _midpoint_ms(self, index: int) -> float:
        lo, hi = self._bounds(index)
        return (lo + hi) / 2.0 * self.unit_ms

    # --- recording ------------------------------------------------------

    def record(self, value_ms: float, count: int = 1) -> None:
        """Record ``count`` observations of ``value_ms`` (clamped >= 0)."""
        if count <= 0:
            return
        v = max(float(value_ms), 0.0)
        idx = self._index(int(v / self.unit_ms))
        self.counts[idx] = self.counts.get(idx, 0) + count
        self.total += count
        self.min_ms = v if self.min_ms is None else min(self.min_ms, v)
        self.max_ms = v if self.max_ms is None else max(self.max_ms, v)

    def record_many(self, values_ms) -> None:
        for v in values_ms:
            self.record(float(v))

    def reset(self) -> None:
        self.counts = {}
        self.total = 0
        self.min_ms = None
        self.max_ms = None

    # --- queries --------------------------------------------------------

    @property
    def count(self) -> int:
        return self.total

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile over bucket midpoints (0.0 when
        empty, matching the list-backed predecessor)."""
        if self.total == 0:
            return 0.0
        rank = min(max(int(math.ceil(p / 100.0 * self.total)), 1),
                   self.total)
        seen = 0
        for idx in sorted(self.counts):
            seen += self.counts[idx]
            if seen >= rank:
                return self._midpoint_ms(idx)
        return self._midpoint_ms(max(self.counts))   # unreachable

    def mean_ms(self) -> float:
        """Approximate mean over bucket midpoints."""
        if self.total == 0:
            return 0.0
        return sum(self._midpoint_ms(i) * c
                   for i, c in self.counts.items()) / self.total

    # --- merge / serialization -----------------------------------------

    def _compatible(self, other: "LatencyHistogram") -> bool:
        return (self.unit_ms == other.unit_ms
                and self.sub_bits == other.sub_bits)

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Add ``other``'s buckets into this histogram (exact: equal to
        the histogram of the concatenated samples)."""
        if not self._compatible(other):
            raise ValueError(
                f"cannot merge histograms with different parameters: "
                f"(unit_ms={self.unit_ms}, sub_bits={self.sub_bits}) vs "
                f"(unit_ms={other.unit_ms}, sub_bits={other.sub_bits})")
        for idx, c in other.counts.items():
            self.counts[idx] = self.counts.get(idx, 0) + c
        self.total += other.total
        for attr, pick in (("min_ms", min), ("max_ms", max)):
            ov = getattr(other, attr)
            if ov is not None:
                sv = getattr(self, attr)
                setattr(self, attr, ov if sv is None else pick(sv, ov))
        return self

    def to_dict(self) -> dict:
        return {
            "unit_ms": self.unit_ms,
            "sub_bits": self.sub_bits,
            "total": self.total,
            "min_ms": self.min_ms,
            "max_ms": self.max_ms,
            "counts": {str(i): self.counts[i]
                       for i in sorted(self.counts)},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "LatencyHistogram":
        h = cls(unit_ms=d["unit_ms"], sub_bits=d["sub_bits"])
        h.counts = {int(i): int(c) for i, c in d["counts"].items()}
        h.total = int(d["total"])
        h.min_ms = d.get("min_ms")
        h.max_ms = d.get("max_ms")
        return h

    def __eq__(self, other) -> bool:
        if not isinstance(other, LatencyHistogram):
            return NotImplemented
        return (self._compatible(other) and self.total == other.total
                and self.counts == other.counts)

    def __repr__(self) -> str:
        return (f"LatencyHistogram(n={self.total}, "
                f"p50={self.percentile(50):.3f}ms, "
                f"p99={self.percentile(99):.3f}ms)")
