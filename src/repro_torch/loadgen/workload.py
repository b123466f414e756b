"""Reproducible request-mix specifications for the SNN load generator.

A :class:`WorkloadSpec` describes the *shape* of serving traffic — the
pre-packed vs intensity request mix, the window-length (T-bucket)
distribution, and the priority / deadline mix — and samples a concrete
request stream from a seed.  Sampling is per-request stateless (every
field of request ``rid`` is a counter-hash draw keyed on
``(seed, rid)``), so a trace row can be re-materialized in isolation,
in any order, on any platform, bit-identically.

A sampled request is represented twice:

* a **row** — the small JSON-serializable dict that goes into a trace
  (ids, seeds, field choices, and a payload content hash, never the
  payload bytes themselves);
* the **materialized** :class:`repro_torch.serving.snn.SNNRequest`, whose
  payload (uint8 intensities or a packed uint32 spike window) is
  regenerated from the row's ``seed`` by the same counter hash and
  verified against the recorded ``sha`` — so traces stay small while
  replay remains bit-exact.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from repro_torch.loadgen.arrivals import u64

_M64 = (1 << 64) - 1
_P1 = 0x9E3779B97F4A7C15
_P2 = 0xBF58476D1CE4E5B9
_P3 = 0x94D049BB133111EB

KIND_INTENSITY = "I"
KIND_WINDOW = "W"

# field tags for the per-request draws (keyed so adding a field never
# perturbs the existing ones)
_TAG_KIND, _TAG_T, _TAG_PRIO, _TAG_DDL, _TAG_SEED = 11, 12, 13, 14, 15


def u64_stream(seed: int, n: int, tag: int = 0) -> np.ndarray:
    """Vectorized counter-mode stream: element ``i`` equals
    ``arrivals.u64(seed, i, tag)`` (tested) — splitmix64 finalizer over
    a two-counter Weyl combination, wrapping uint64 arithmetic."""
    z0 = np.uint64((seed * _P1) & _M64)
    idx = np.arange(1, n + 1, dtype=np.uint64)
    z = (z0 + idx * np.uint64(_P2)
         + np.uint64(((tag + 1) * ((_P2 + 2) & _M64)) & _M64))
    z ^= z >> np.uint64(30)
    z *= np.uint64(_P2)
    z ^= z >> np.uint64(27)
    z *= np.uint64(_P3)
    return z ^ (z >> np.uint64(31))


def _payload_bytes(seed: int, n_bytes: int, tag: int = 0) -> np.ndarray:
    words = u64_stream(seed, (n_bytes + 7) // 8, tag=tag)
    return words.view(np.uint8)[:n_bytes]


def _choice(options: tuple, weights: tuple, draw: int):
    """Integer-weighted choice from a 64-bit draw."""
    total = sum(weights)
    r = draw % total
    for opt, wgt in zip(options, weights):
        r -= wgt
        if r < 0:
            return opt
    return options[-1]


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Seeded request-mix distribution over the serving request space.

    ``p_intensity`` picks intensity requests (uint8[n_inputs] + a
    counter seed — the production shape) vs pre-packed uint32[T, w]
    spike windows; ``t_choices``/``t_weights`` give the presentation
    window-length mix (the serving engine compiles one launch per
    T-quantum bucket, so this distribution is what exercises ragged
    batching); ``priority_*`` and ``deadline_*`` draw the admission
    policy inputs (a deadline of ``None`` defers to the engine
    policy's default).

    ``n_inputs`` need not be a multiple of 32 (the paper's 784 pixels
    fill 25 words): the JAX package's spec refuses such a width, so
    where it is one, rows carry it as ``n_in`` and window payloads
    leave the lanes past it silent; every other row, payload and stream
    digest is the JAX package's, bit for bit."""
    n_inputs: int = 256               # synapse lanes (<= 32 * words)
    p_intensity: float = 1.0
    t_choices: tuple = (8, 12, 16)
    t_weights: tuple = (1, 1, 1)
    priority_choices: tuple = (0,)
    priority_weights: tuple = (1,)
    deadline_choices: tuple = (None,)  # ms | None
    deadline_weights: tuple = (1,)
    seed: int = 0

    def __post_init__(self):
        if self.n_inputs < 1:
            raise ValueError(f"n_inputs must be >= 1, got "
                             f"{self.n_inputs}")
        if not 0.0 <= self.p_intensity <= 1.0:
            raise ValueError(f"p_intensity must be in [0, 1], got "
                             f"{self.p_intensity}")
        for name in ("t", "priority", "deadline"):
            opts = getattr(self, f"{name}_choices")
            wgts = getattr(self, f"{name}_weights")
            if len(opts) != len(wgts) or not opts:
                raise ValueError(f"{name}_choices/{name}_weights must be "
                                 f"equal-length and nonempty")
            if any(w < 0 for w in wgts) or sum(wgts) <= 0:
                raise ValueError(f"{name}_weights must be nonnegative "
                                 f"with a positive sum")
        if any(t < 1 for t in self.t_choices):
            raise ValueError(f"t_choices must be >= 1, got "
                             f"{self.t_choices}")

    @property
    def words(self) -> int:
        return -(-self.n_inputs // 32)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for k in ("t_choices", "t_weights", "priority_choices",
                  "priority_weights", "deadline_choices",
                  "deadline_weights"):
            d[k] = list(d[k])
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "WorkloadSpec":
        d = dict(d)
        for k in ("t_choices", "t_weights", "priority_choices",
                  "priority_weights", "deadline_choices",
                  "deadline_weights"):
            if k in d:
                d[k] = tuple(d[k])
        return cls(**d)

    # --- sampling -------------------------------------------------------

    def sample_row(self, rid: int, ts_ms: float) -> dict:
        """The trace row for request ``rid`` arriving at ``ts_ms``."""
        kind = (KIND_INTENSITY
                if (u64(self.seed, rid, _TAG_KIND) >> 11) / float(1 << 53)
                < self.p_intensity else KIND_WINDOW)
        t = _choice(self.t_choices, self.t_weights,
                    u64(self.seed, rid, _TAG_T))
        prio = _choice(self.priority_choices, self.priority_weights,
                       u64(self.seed, rid, _TAG_PRIO))
        ddl = _choice(self.deadline_choices, self.deadline_weights,
                      u64(self.seed, rid, _TAG_DDL))
        seed = int(u64(self.seed, rid, _TAG_SEED) & 0x7FFFFFFF)
        row = {"rid": int(rid), "ts": float(ts_ms), "kind": kind,
               "t": int(t), "prio": int(prio),
               "ddl": None if ddl is None else float(ddl),
               "seed": seed}
        if self.n_inputs % 32:
            row["n_in"] = self.n_inputs     # recovery re-materializes it
        row["sha"] = self.payload_sha(row)
        return row

    def payload(self, row: dict) -> np.ndarray:
        """Regenerate the request payload from its row (bit-exact)."""
        if row["kind"] == KIND_INTENSITY:
            return np.array(
                _payload_bytes(row["seed"], self.n_inputs), np.uint8)
        raw = _payload_bytes(row["seed"], row["t"] * self.words * 4,
                             tag=1)
        win = raw.view(np.uint32).reshape(row["t"], self.words).copy()
        if self.n_inputs % 32:      # no spikes on lanes past n_inputs
            win[:, -1] &= np.uint32((1 << (self.n_inputs % 32)) - 1)
        return win

    def payload_sha(self, row: dict) -> str:
        """Content hash binding the row's fields to its payload bytes."""
        head = (f"{row['rid']}|{row['kind']}|{row['t']}|{row['prio']}|"
                f"{row['ddl']}|{row['seed']}|").encode()
        return hashlib.sha256(
            head + self.payload(row).tobytes()).hexdigest()[:16]

    def materialize(self, row: dict, *, verify: bool = False):
        """Build the :class:`SNNRequest` a trace row describes.  With
        ``verify=True`` the regenerated payload's content hash must
        match the recorded one (raises ``ValueError`` otherwise)."""
        # local import: repro_torch.serving imports loadgen.histogram, so a
        # module-level import here would be circular
        from repro_torch.serving.snn import SNNRequest

        if verify and row.get("sha") != self.payload_sha(row):
            raise ValueError(
                f"trace row {row['rid']}: payload hash mismatch "
                f"(recorded {row.get('sha')}, regenerated "
                f"{self.payload_sha(row)})")
        payload = self.payload(row)
        # the row rides along so a journaled engine can ADMIT-log the
        # tiny descriptor (and re-materialize after a crash) instead of
        # the payload bytes; content_sha is the exactly-once audit key
        if row["kind"] == KIND_INTENSITY:
            return SNNRequest(rid=row["rid"], intensities=payload,
                              n_steps=row["t"], seed=row["seed"],
                              priority=row["prio"],
                              deadline_ms=row["ddl"],
                              trace_row=dict(row),
                              content_sha=row.get("sha"))
        return SNNRequest(rid=row["rid"], window=payload,
                          priority=row["prio"], deadline_ms=row["ddl"],
                          trace_row=dict(row), content_sha=row.get("sha"))
