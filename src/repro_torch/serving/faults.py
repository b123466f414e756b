"""Deterministic fault injection for the SNN serving robustness layer.

:class:`FaultInjector` is the test substrate behind
:class:`~repro_torch.serving.snn.SNNServingEngine`'s optional ``on_launch``
hook: when no hook is installed the production serve path runs exactly
as before (the hook is never consulted), and when one is, every serve /
canary launch first passes through the injector, which — from one
seeded ``numpy`` generator, so storms replay bit-identically — may

* raise :class:`FaultInjectedError` (a failed kernel launch; an
  ``error_burst`` of consecutive failures per trigger lets a single
  draw push the engine past its retry budget and down the degradation
  ladder),
* sleep ``stall_ms`` (an injected stall, visible in the latency
  percentiles), or
* return a corruption callable the engine applies to the launch's
  count matrix.  Corruptions are always *detectable*: they drive a
  slot negative or past its ``t_total`` cycle budget, which the
  engine's output integrity guard (``0 <= counts <= t_total``) is
  specified to catch — in-range corruption is the canary's job, not
  the guard's.

The engine never hooks its ``kind="fallback"`` oracle re-serves, so an
injector can never corrupt the path that repairs its own damage.

Overload storms add a *slowdown* channel, consulted through the
separate :meth:`FaultInjector.service_inflation` method once per
serving step: with ``p_slowdown`` a seeded burst of ``slowdown_steps``
consecutive steps each cost ``slowdown_factor``x modeled service time
(the virtual clock multiplies its step charge), sagging capacity
without any launch failing — the load shape the adaptive admission
controller exists to absorb.  The method draws from the same generator
but only when ``p_slowdown > 0``, so legacy storm recipes replay
bit-identically.

Versioned train-while-serving adds two hooked call kinds with their own
fault families (drawn from the same generator, but only when those
calls happen — a storm with no refresher replays bit-identically with
older injectors):

* ``kind="refresh"`` — consulted once per refresh cycle, before the
  candidate is trained.  May stall (``p_refresh_stall`` ×
  ``refresh_stall_ms`` — trips the refresher's stalled-refresh
  timeout) or return a *weight*-corruption callable
  (``p_refresh_corrupt``) the engine applies to the candidate bank
  after its content fingerprint was taken — exactly a torn/corrupted
  candidate, which the store's fingerprint verification at the probe
  gate is specified to catch deterministically.
* ``kind="save"`` — consulted by the store right before persisting a
  promoted version.  With ``p_save_crash`` it raises, modeling a
  process crash mid-checkpoint: the store leaves a torn ``step_N.tmp``
  dropping and aborts the promotion, exactly what a restarted process
  would find on disk.

Crash-consistent serving adds *whole-process* crash points,
consulted by the engine only when a :class:`~repro_torch.serving.journal.
RequestJournal` is attached (a journal-less engine never sends these
kinds, so legacy storms replay bit-identically):

* ``kind="crash_before_dispatch"`` — after the batch's ADMIT+DISPATCH
  records are fsync'd, before the serve launch.
* ``kind="crash_after_serve"`` — after counts are computed, before any
  TERMINAL record is journaled (``p_crash_after_serve_before_journal``).
* ``kind="crash_mid_snapshot"`` — after ``snapshot_N.json.tmp`` is
  written, before the atomic rename.

A firing crash point calls ``crash_hook(kind)`` — by default
``os._exit(73)``, the real ``kill -9`` model: user-space journal
buffers die, fsync'd records survive, and the kill–restart harness
recognizes exit code 73 as an induced crash.  Tests substitute a hook
that raises, then ``journal.abandon()`` to drop the buffers the dead
process would have lost.  Crash draws happen only when the matching
probability is nonzero, so a chaos child running "clean" (all crash
probabilities 0) is bit-identical to a journal-less run.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

import numpy as np

CRASH_EXIT_CODE = 73   # the kill–restart harness's "induced crash" code


class FaultInjectedError(RuntimeError):
    """An injected kernel-launch failure (never raised in production)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Seeded storm recipe: per-launch fault probabilities."""
    p_launch_error: float = 0.0   # P[launch raises] per hooked launch
    p_corrupt: float = 0.0        # P[count matrix corrupted]
    p_stall: float = 0.0          # P[injected stall before the launch]
    stall_ms: float = 0.0         # stall duration when one fires
    error_burst: int = 1          # consecutive failures per error trigger
    seed: int = 0                 # numpy generator seed (replayable)
    # --- refresh-path faults (kind="refresh" / kind="save" calls) -------
    p_refresh_corrupt: float = 0.0  # P[candidate weights corrupted]
    p_refresh_stall: float = 0.0    # P[refresh stalls before training]
    refresh_stall_ms: float = 0.0   # refresh stall duration
    p_save_crash: float = 0.0       # P[crash mid-checkpoint-save]
    # --- whole-process crash points (journaled engines only) ------------
    p_crash_before_dispatch: float = 0.0        # post-WAL-sync, pre-launch
    p_crash_after_serve_before_journal: float = 0.0  # pre-TERMINAL write
    p_crash_mid_snapshot: float = 0.0           # tmp written, pre-rename
    # --- service-time inflation (overload storms) -----------------------
    p_slowdown: float = 0.0       # P[a serving step starts a slow burst]
    slowdown_factor: float = 4.0  # modeled service-cost multiplier
    slowdown_steps: int = 1       # consecutive inflated steps per burst

    def __post_init__(self):
        for name in ("p_launch_error", "p_corrupt", "p_stall",
                     "p_refresh_corrupt", "p_refresh_stall",
                     "p_save_crash", "p_crash_before_dispatch",
                     "p_crash_after_serve_before_journal",
                     "p_crash_mid_snapshot", "p_slowdown"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        if self.error_burst < 1:
            raise ValueError(f"error_burst must be >= 1, got "
                             f"{self.error_burst}")
        if self.stall_ms < 0:
            raise ValueError(f"stall_ms must be >= 0, got {self.stall_ms}")
        if self.refresh_stall_ms < 0:
            raise ValueError(f"refresh_stall_ms must be >= 0, got "
                             f"{self.refresh_stall_ms}")
        if self.slowdown_factor < 1.0:
            raise ValueError(f"slowdown_factor must be >= 1, got "
                             f"{self.slowdown_factor}")
        if self.slowdown_steps < 1:
            raise ValueError(f"slowdown_steps must be >= 1, got "
                             f"{self.slowdown_steps}")


class FaultInjector:
    """Callable ``on_launch`` hook: ctx dict in, corruption fn (or
    None) out, :class:`FaultInjectedError` raised for launch failures.

    ``ctx`` carries ``step`` / ``attempt`` / ``level`` / ``kind`` /
    ``batch_size`` / ``t_lens`` from the engine; all randomness comes
    from one ``default_rng(spec.seed)``, so a storm is a pure function
    of (spec, launch sequence).
    """

    def __init__(self, spec: FaultSpec | None = None,
                 crash_hook: Callable[[str], None] | None = None,
                 **kwargs):
        self.spec = spec if spec is not None else FaultSpec(**kwargs)
        self.rng = np.random.default_rng(self.spec.seed)
        self.crash_hook = (crash_hook if crash_hook is not None
                           else lambda kind: os._exit(CRASH_EXIT_CODE))
        self.launches = 0
        self.errors = 0
        self.corruptions = 0
        self.stalls = 0
        self.refresh_corruptions = 0
        self.refresh_stalls = 0
        self.save_crashes = 0
        self.crashes = 0
        self._burst_left = 0
        self.slowdowns = 0
        self._slow_left = 0

    _CRASH_P = {
        "crash_before_dispatch": "p_crash_before_dispatch",
        "crash_after_serve": "p_crash_after_serve_before_journal",
        "crash_mid_snapshot": "p_crash_mid_snapshot",
    }

    def __call__(self, ctx: dict):
        self.launches += 1
        sp = self.spec
        kind = ctx.get("kind", "serve")
        if kind in self._CRASH_P:
            # draw only when armed, so a clean chaos child replays
            # bit-identically with a journal-less storm
            p = getattr(sp, self._CRASH_P[kind])
            if p > 0.0 and self.rng.random() < p:
                self.crashes += 1
                self.crash_hook(kind)   # default: os._exit(73), no return
            return None
        if kind == "refresh":
            draw = self.rng.random(2)
            if draw[0] < sp.p_refresh_stall and sp.refresh_stall_ms > 0:
                self.refresh_stalls += 1
                time.sleep(sp.refresh_stall_ms / 1e3)
            if draw[1] < sp.p_refresh_corrupt:
                self.refresh_corruptions += 1

                def corrupt_weights(w):
                    out = np.array(w)        # torn-buffer bit rot
                    out ^= np.uint32(0xA5A5A5A5)
                    return out

                return corrupt_weights
            return None
        if kind == "save":
            if self.rng.random() < sp.p_save_crash:
                self.save_crashes += 1
                raise FaultInjectedError(
                    f"injected crash during checkpoint save "
                    f"(version={ctx.get('version')})")
            return None
        draw = self.rng.random(3)
        if self._burst_left > 0 or draw[0] < sp.p_launch_error:
            if self._burst_left == 0:
                self._burst_left = sp.error_burst
            self._burst_left -= 1
            self.errors += 1
            raise FaultInjectedError(
                f"injected launch failure (step={ctx.get('step')}, "
                f"level={ctx.get('level')}, kind={ctx.get('kind')})")
        if draw[1] < sp.p_stall and sp.stall_ms > 0:
            self.stalls += 1
            time.sleep(sp.stall_ms / 1e3)
        if draw[2] < sp.p_corrupt and ctx.get("batch_size", 0) > 0:
            slot = int(self.rng.integers(ctx["batch_size"]))
            t_len = int(ctx["t_lens"][slot])
            mode = int(self.rng.integers(2))
            self.corruptions += 1

            def corrupt(counts, slot=slot, t_len=t_len, mode=mode):
                out = np.array(counts)
                if mode == 0:
                    out[slot, 0] = -1            # violates counts >= 0
                else:
                    out[slot, :] = t_len + 1     # violates counts <= t_total
                return out

            return corrupt
        return None

    def service_inflation(self, ctx: dict) -> float:
        """Service-time multiplier for one serving step (the overload
        storm's slowdown channel): with ``p_slowdown`` a burst of
        ``slowdown_steps`` consecutive steps each cost
        ``slowdown_factor``x modeled time — capacity sags without any
        launch failing, exactly the overload the admission controller
        must absorb.  Draws only when armed (``p_slowdown > 0``), so
        legacy storms replay bit-identically."""
        sp = self.spec
        if sp.p_slowdown <= 0.0:
            return 1.0
        if self._slow_left > 0:
            self._slow_left -= 1
            return sp.slowdown_factor
        if self.rng.random() < sp.p_slowdown:
            self.slowdowns += 1
            self._slow_left = sp.slowdown_steps - 1
            return sp.slowdown_factor
        return 1.0

    def stats(self) -> dict:
        """Injection counters (for bench reports and storm tests)."""
        return {"fault_launches": self.launches,
                "fault_errors": self.errors,
                "fault_corruptions": self.corruptions,
                "fault_stalls": self.stalls,
                "fault_refresh_corruptions": self.refresh_corruptions,
                "fault_refresh_stalls": self.refresh_stalls,
                "fault_save_crashes": self.save_crashes,
                "fault_crashes": self.crashes,
                "fault_slowdowns": self.slowdowns}
