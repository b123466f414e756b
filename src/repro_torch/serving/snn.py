"""SNN request serving: queue + dynamic window batching over the engine.

:class:`SNNServingEngine` keeps a request queue and, per engine step,
admits up to ``plan.max_batch`` requests, pads their (possibly ragged)
windows into one batch, and serves them with a single
:meth:`SNNEngine.infer` launch.

Requests come in two shapes:

* **pre-packed**: a ``uint32[T, w]`` spike window;
* **intensity**: ``uint8[n_in]`` pixel intensities + ``n_steps`` (+ an
  optional counter ``seed``, default derived from the request id).  When
  the plan says ``encode="kernel"`` the spike window never exists: the
  encode kernel draws it from the counter hash.  Both placements are
  bit-exact with ``encoder.encode_from_counter``, so mixed batches
  (host-encoded on admission) return identical counts.

Ragged batching is bit-exact by construction: windows are zero-padded on
the time axis, and a zero spike row adds no input counts while the
membrane only leaks — with ``threshold >= 1`` a neuron that did not fire
in the true window cannot fire in a padded cycle.  The batch axis is
likewise padded (zero windows / zero intensities, silent by the same
argument), which pins the launch shape to ``(max_batch, T_q, ...)`` with
``T_q`` rounded up to the time quantum.  The intensity path carries each
sample's true length as a runtime operand of the kernel.

Failure semantics
-----------------

No exception escapes ``step()`` or ``run()``, and every submitted
request terminates in exactly one terminal status.

**Status machine.**  A fresh request is ``NEW``; ``submit()`` moves it
to ``QUEUED`` or — structurally, without raising — ``REJECTED``
(malformed request, or backpressure when the queue is at
``policy.max_queue``).  Batch formation drops queued requests whose
``deadline_ms`` has elapsed as ``EXPIRED`` and pulls the survivors
highest-priority-first (FIFO within a priority).  A serve launch then
ends each batched request as ``SERVED`` (counts attached) or, when every
retry and degradation rung is exhausted, ``FAILED`` with the last error
recorded.

**Degradation ladder.**  Every rung is bit-exact with the others, so
degradation is free of result drift: on repeated launch failure the
engine steps down ``plan → encode="host"`` (deduplicated; each rung
re-runs the full retry budget), and on the CPU further to
``kernel_backend="ref"``.  On a CUDA device every rung launches the
kernels: the plain versions never stand in for a kernel there, so a
kernel that fails on every rung ends its batch ``FAILED``.  Rung changes
are recorded in ``degradation_events``; after ``policy.reprobe_after``
consecutive healthy steps the engine re-probes the fast path from rung
0.  The kernels are built when the engine is constructed, outside the
ladder, so a kernel that does not build raises there.

**Integrity guard.**  A served count vector must satisfy
``0 <= counts <= t_total`` per slot.  Violating slots are re-served on
the most-degraded rung with the ``on_launch`` hook bypassed.  A periodic
known-answer canary (every ``policy.canary_every`` steps) re-serves a
fixed window through the *current* rung and compares it against golden
counts from the plain version on the CPU, computed when the engine is
built and again whenever the serving weight version changes.

The request journal, the overload controller and train-while-serving
refresh come with later slices; passing ``journal_dir``, ``overload``
or ``refresher`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core.bitpack import as_words, words_to_numpy
from repro_torch.core.encoder import encode_from_counter
from repro_torch.engine import SNNEngine, SNNEnginePlan, resolve_device
from repro_torch.kernels import ops
from repro_torch.loadgen.histogram import LatencyHistogram
from repro_torch.serving.journal import RingLog
from repro_torch.serving.overload import LadderBreakers
from repro_torch.serving.weights import VersionedWeightStore

_T_QUANTUM = 8   # window lengths bucket to multiples of this (or t_chunk)
_ERR_MAX = 256   # per-request error strings are capped at this length
_EVENT_RING = 256  # degradation telemetry kept in memory

# --- request lifecycle -------------------------------------------------------

QUEUED = "QUEUED"
SERVED = "SERVED"
REJECTED = "REJECTED"
EXPIRED = "EXPIRED"
FAILED = "FAILED"
TERMINAL_STATUSES = frozenset({SERVED, REJECTED, EXPIRED, FAILED})

_CANARY_SEED = 0xC0FFEE


def _now_ms() -> float:
    return time.perf_counter() * 1e3


def _cap_error(error: str | None) -> str | None:
    """Bound per-request error strings."""
    if error is not None and len(error) > _ERR_MAX:
        return error[:_ERR_MAX] + "...[truncated]"
    return error


@dataclasses.dataclass
class SNNRequest:
    """One classification request: spikes (or intensities) in, counts out."""
    rid: int
    window: np.ndarray | None = None   # uint32[T, w] packed spike window
    intensities: np.ndarray | None = None  # uint8[n_in] (with n_steps)
    n_steps: int | None = None         # presentation length (intensity form)
    seed: int | None = None            # counter seed (default: from rid)
    priority: int = 0                  # higher pulled into batches first
    deadline_ms: float | None = None   # queue-relative deadline (None = policy's)
    # --- lifecycle (written by the serving engine) ----------------------
    status: str = "NEW"                # NEW -> QUEUED -> terminal
    error: str | None = None           # rejection / failure detail
    retries: int = 0                   # launch re-attempts this request rode
    counts: np.ndarray | None = None   # int32[n] spike counts (result)
    pred: int | None = None            # argmax class (if classes known)
    done: bool = False                 # terminal-status flag
    queue_wait_ms: float | None = None  # submit -> batch formation
    service_ms: float | None = None     # submit -> terminal
    t_submit_ms: float | None = None    # wall-clock stamp (ms) at admission
    served_version: int | None = None   # weight version the counts came from

    @property
    def terminal(self) -> bool:
        return self.status in TERMINAL_STATUSES


@dataclasses.dataclass(frozen=True)
class SNNServingPolicy:
    """Admission + recovery policy consulted at submit, batch-formation
    and launch time.  Frozen, like the plan: one policy per engine."""
    max_queue: int | None = None       # backpressure bound (None = unbounded)
    deadline_ms: float | None = None   # default deadline for requests without one
    max_retries: int = 2               # re-launches per degradation rung
    degrade_on_failure: bool = True    # step down the ladder on retry exhaustion
    degrade_on_integrity: bool = True  # ... and on guard / canary violations
    reprobe_after: int | None = None   # healthy steps before re-probing rung 0
    canary_every: int = 0              # steps between known-answer checks (0 = off)
    canary_steps: int = 8              # canary window length

    def __post_init__(self):
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1 or None, got "
                             f"{self.max_queue}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got "
                             f"{self.max_retries}")
        if self.reprobe_after is not None and self.reprobe_after < 1:
            raise ValueError(f"reprobe_after must be >= 1 or None, got "
                             f"{self.reprobe_after}")
        if self.canary_every < 0:
            raise ValueError(f"canary_every must be >= 0, got "
                             f"{self.canary_every}")
        if self.canary_steps < 1:
            raise ValueError(f"canary_steps must be >= 1, got "
                             f"{self.canary_steps}")


def degradation_ladder(plan: SNNEnginePlan, device
                       ) -> list[SNNEnginePlan]:
    """The graceful-degradation rungs for a plan on ``device``, fastest
    first: the plan itself, then host encode, and on the CPU the plain
    (ref) backend last — each bit-exact with the previous, adjacent
    duplicates removed.  On a CUDA device every rung runs the kernels,
    so a plan with ``kernel_backend="ref"`` is refused there."""
    on_card = torch.device(device).type == "cuda"
    if on_card and plan.kernel_backend != "kernel":
        raise ValueError("serving on a CUDA device runs the kernels; "
                         "kernel_backend='ref' serves only on the CPU")
    ladder = [plan]
    host = dataclasses.replace(plan, encode="host")
    if host != ladder[-1]:
        ladder.append(host)
    ref = dataclasses.replace(ladder[-1], kernel_backend="ref")
    if not on_card and ref != ladder[-1]:
        ladder.append(ref)
    return ladder


class SNNServingEngine:
    """Dynamic window batching over :meth:`SNNEngine.infer`.

    weights: u32[n, w] frozen population weights (numpy uint32, or an
    int32 bit-pattern tensor); ``neuron_class`` (int[n], optional) maps
    the maximally-firing neuron to a class label for ``req.pred``.
    Admission, padding, encode placement and launch shape come from the
    plan; failure handling from the ``policy``.  ``on_launch``, when
    given, is consulted before every serve/canary launch (the fault
    injection hook).  The engine runs on ``device`` (``cuda`` unless the
    caller asks for another).
    """

    def __init__(self, weights, plan: SNNEnginePlan, *,
                 neuron_class=None, policy: SNNServingPolicy | None = None,
                 on_launch: Callable[[dict], object] | None = None,
                 refresher=None, state_dir=None, keep_versions: int = 4,
                 journal_dir=None, overload=None, device=None):
        for name, value in (("refresher", refresher),
                            ("journal_dir", journal_dir),
                            ("overload", overload)):
            if value is not None:
                raise NotImplementedError(f"{name} is not ported yet")
        if plan.cycle_backend != "window":
            raise NotImplementedError("serving a step plan is not ported "
                                      "yet; use cycle_backend='window'")
        if plan.threshold < 1:
            raise ValueError("SNN serving requires threshold >= 1 "
                             "(zero-padded cycles must stay silent)")
        self.plan = plan
        self.device = resolve_device(device)
        self.policy = policy if policy is not None else SNNServingPolicy()
        self.on_launch = on_launch
        self._plans = degradation_ladder(plan, self.device)
        self._engines: dict[int, SNNEngine] = {
            0: SNNEngine(plan, self.device)}
        self.engine = self._engines[0]
        self._store = VersionedWeightStore(weights, state_dir=state_dir,
                                           keep=keep_versions,
                                           device=self.device)
        self._pinned = self._store.serving
        self.words = int(self.weights.shape[1])
        self.n_inputs = self.words * 32
        if neuron_class is None:
            self.neuron_class = None
        else:
            nc = np.asarray(neuron_class)
            n = int(self.weights.shape[0])
            if nc.ndim != 1 or nc.shape[0] != n:
                raise ValueError(f"neuron_class must be a 1-D array of "
                                 f"length n={n} (one label per neuron), "
                                 f"got shape {nc.shape}")
            self.neuron_class = nc
        self.queue: list[SNNRequest] = []
        # --- throughput counters ---------------------------------------
        self.steps = 0
        self.batches = 0
        self.windows_served = 0
        self.slots_offered = 0      # max_batch per launch
        self.slots_padded = 0       # offered - admitted (batch-pad waste)
        self.step_seconds = 0.0     # total serve wall-clock
        self.last_step_seconds = 0.0
        # --- robustness counters ---------------------------------------
        self.submitted = 0          # every submit() call, admitted or not
        self.rejected = 0
        self.expired = 0
        self.failed = 0
        self.retried = 0            # launch re-attempts (all rungs)
        self.degraded = 0           # ladder steps taken
        self.integrity_failures = 0
        self.canary_checks = 0
        self.canary_failures = 0
        self.version_violations = 0  # served from a non-live version
        self.level = 0              # current degradation rung
        self.healthy_steps = 0      # fault-free steps at this rung
        self.degradation_events = RingLog(cap=_EVENT_RING)
        self.breakers = LadderBreakers(len(self._plans))
        self.queue_wait_hist = LatencyHistogram()
        self.service_hist = LatencyHistogram()
        self._t_first_ms: float | None = None   # first submit
        self._t_last_ms: float | None = None    # last completed step
        self._step_faults = 0
        self._last_error: str | None = None
        self._canary_window: np.ndarray | None = None
        self._canary_golden: np.ndarray | None = None
        self._canary_version: int | None = None
        if self.policy.canary_every:
            self._canary_golden_for(self._pinned)

    @property
    def weights(self) -> torch.Tensor:
        """The serving weight bank (the store's promoted version)."""
        return self._store.serving.weights

    @property
    def store(self) -> VersionedWeightStore:
        return self._store

    # --- admission -----------------------------------------------------

    def _validate(self, req: SNNRequest) -> str | None:
        """Normalize the request's payload in place; return the
        rejection reason (None = admissible)."""
        if (req.window is None) == (req.intensities is None):
            return (f"request {req.rid}: provide exactly one of "
                    "window / intensities")
        if req.window is not None:
            window = np.asarray(req.window, np.uint32)
            if window.ndim != 2 or window.shape[1] != self.words:
                return (f"request {req.rid}: window must be "
                        f"uint32[T, {self.words}], got {window.shape}")
            req.window = window
            return None
        inten = np.asarray(req.intensities, np.uint8)
        if inten.ndim != 1 or inten.shape[0] > self.n_inputs:
            return (f"request {req.rid}: intensities must be "
                    f"uint8[<= {self.n_inputs}], got {inten.shape}")
        if req.n_steps is None or req.n_steps < 1:
            return (f"request {req.rid}: intensity requests need "
                    "n_steps >= 1")
        req.intensities = inten
        if req.seed is None:
            req.seed = self.plan.encode_seed + req.rid
        return None

    def submit(self, req: SNNRequest) -> bool:
        """Admit a request, or reject it *structurally*: a malformed or
        backpressured request ends as ``REJECTED`` with ``error`` set —
        nothing raises.  Returns whether the request was admitted."""
        self.submitted += 1
        if self._t_first_ms is None:
            self._t_first_ms = (req.t_submit_ms
                                if req.t_submit_ms is not None
                                else _now_ms())
        error = self._validate(req)
        if error is None and self.policy.max_queue is not None \
                and len(self.queue) >= self.policy.max_queue:
            error = (f"request {req.rid}: queue full "
                     f"(max_queue={self.policy.max_queue}), "
                     "backpressure reject")
        if error is not None:
            req.status, req.error, req.done = REJECTED, _cap_error(error), \
                True
            self.rejected += 1
            return False
        if req.deadline_ms is None:
            req.deadline_ms = self.policy.deadline_ms
        if req.t_submit_ms is None:    # a load generator pre-stamps arrival
            req.t_submit_ms = _now_ms()
        req.status = QUEUED
        self.queue.append(req)
        return True

    def _t_quantum(self) -> int:
        tc = self.plan.t_chunk
        return tc if tc is not None else _T_QUANTUM

    @staticmethod
    def _t_len(req: SNNRequest) -> int:
        return (req.window.shape[0] if req.window is not None
                else req.n_steps)

    def _form_batch(self) -> tuple[list[SNNRequest], int]:
        """Expire overdue queued requests, then pull up to ``max_batch``
        highest-priority-first (stable, so FIFO within a priority).
        Returns (batch, n_finished_here)."""
        now = _now_ms()
        live: list[SNNRequest] = []
        n_expired = 0
        for r in self.queue:
            if (r.deadline_ms is not None
                    and now - r.t_submit_ms > r.deadline_ms):
                r.service_ms = now - r.t_submit_ms
                self._finish(r, EXPIRED,
                             f"request {r.rid}: deadline "
                             f"{r.deadline_ms}ms exceeded in queue")
                n_expired += 1
            else:
                live.append(r)
        live.sort(key=lambda r: -r.priority)
        batch, self.queue = live[:self.plan.max_batch], \
            live[self.plan.max_batch:]
        return batch, n_expired

    def _finish(self, req: SNNRequest, status: str,
                error: str | None = None) -> None:
        req.status, req.error, req.done = status, _cap_error(error), True
        if status == EXPIRED:
            self.expired += 1
        elif status == FAILED:
            self.failed += 1

    # --- serve ---------------------------------------------------------

    def _engine_for(self, level: int) -> SNNEngine:
        if level not in self._engines:
            self._engines[level] = SNNEngine(self._plans[level],
                                             self.device)
        return self._engines[level]

    def _serve_intensities(self, eng: SNNEngine, batch,
                           t_pad: int) -> np.ndarray:
        """One in-kernel-encode launch: uint8 intensities + ragged
        lengths in, counts out; the batch tail pads with zero intensity
        (silent) and t_total=0."""
        plan = eng.plan
        inten = np.zeros((plan.max_batch, self.n_inputs), np.uint8)
        seeds = np.zeros((plan.max_batch,), np.int64)
        t_total = np.zeros((plan.max_batch,), np.int32)
        for i, r in enumerate(batch):
            inten[i, :r.intensities.shape[0]] = r.intensities
            seeds[i] = r.seed
            t_total[i] = r.n_steps
        counts = eng.infer(self._pinned.weights,
                           intensities=torch.from_numpy(inten),
                           seeds=torch.from_numpy(seeds), n_steps=t_pad,
                           t_total=torch.from_numpy(t_total))
        return counts.cpu().numpy()

    def _serve_windows(self, eng: SNNEngine, batch,
                       t_pad: int) -> np.ndarray:
        """One pre-packed launch; intensity requests in a mixed batch
        are host-encoded here (bit-exact with the kernel draw)."""
        plan = eng.plan
        stacked = np.zeros((plan.max_batch, t_pad, self.words),
                           np.uint32)
        for i, r in enumerate(batch):
            win = r.window
            if win is None:
                win = words_to_numpy(encode_from_counter(
                    r.seed, torch.from_numpy(r.intensities), r.n_steps))
            stacked[i, :win.shape[0], :win.shape[1]] = win
        return eng.infer(self._pinned.weights, stacked).cpu().numpy()

    def _launch_counts(self, batch, t_pad: int, level: int, *,
                       hooked: bool = True, attempt: int = 0,
                       kind: str = "serve") -> np.ndarray:
        """One serve launch at one degradation rung.  The ``on_launch``
        hook runs first (fault injection: may raise, stall, or return a
        count-corruption callable) — except on ``kind="fallback"``
        re-serves, which are never hooked."""
        eng = self._engine_for(level)
        corrupt = None
        if hooked and self.on_launch is not None:
            corrupt = self.on_launch({
                "step": self.steps, "attempt": attempt, "level": level,
                "kind": kind, "batch_size": len(batch), "t_pad": t_pad,
                "t_lens": [self._t_len(r) for r in batch]})
        intensity_only = all(r.window is None for r in batch)
        if intensity_only and eng.plan.encode == "kernel":
            counts = self._serve_intensities(eng, batch, t_pad)
        else:
            counts = self._serve_windows(eng, batch, t_pad)
        if corrupt is not None:
            counts = np.asarray(corrupt(counts))
        return counts

    def _degrade(self, reason: str) -> None:
        frm = self.level
        self.level += 1
        self.degraded += 1
        self.healthy_steps = 0
        self.breakers.open_rung(frm)
        plan = self._plans[self.level]
        self.degradation_events.append({
            "step": self.steps, "from": frm, "to": self.level,
            "encode": plan.encode, "kernel_backend": plan.kernel_backend,
            "reason": reason})

    def _launch_with_recovery(self, batch, t_pad: int
                              ) -> np.ndarray | None:
        """Bounded-retry launch with graceful degradation: re-attempt at
        the current rung up to ``max_retries`` times, then step down the
        ladder and re-run the budget; None once every rung is spent
        (the batch fails)."""
        pol = self.policy
        max_level = len(self._plans) - 1
        while True:
            attempts = 0
            while True:
                try:
                    return self._launch_counts(batch, t_pad, self.level,
                                               attempt=attempts)
                except Exception as e:  # noqa: BLE001 — contain faults
                    self._step_faults += 1
                    self._last_error = f"{type(e).__name__}: {e}"
                    if attempts >= pol.max_retries:
                        break
                    attempts += 1
                    self.retried += 1
                    for r in batch:
                        r.retries += 1
            if pol.degrade_on_failure and self.level < max_level:
                self._degrade(f"launch failed after {attempts + 1} "
                              f"attempts: {self._last_error}")
                continue
            return None

    def _integrity_guard(self, batch, counts: np.ndarray, t_pad: int
                         ) -> tuple[np.ndarray, set[int]]:
        """Enforce ``0 <= counts <= t_total`` per slot; violating slots
        are re-served on the most-degraded rung with the launch hook
        bypassed.  Returns (repaired counts, slots that could not be
        repaired)."""
        bad = [i for i, r in enumerate(batch)
               if (counts[i] < 0).any()
               or (counts[i] > self._t_len(r)).any()]
        if not bad:
            return counts, set()
        self.integrity_failures += len(bad)
        self._step_faults += len(bad)
        counts = np.array(counts)
        unrepaired: set[int] = set()
        try:
            good = self._launch_counts([batch[i] for i in bad], t_pad,
                                       len(self._plans) - 1,
                                       hooked=False, kind="fallback")
            for j, i in enumerate(bad):
                counts[i] = good[j]
        except Exception as e:  # noqa: BLE001 — re-serve failed
            self._last_error = f"{type(e).__name__}: {e}"
            unrepaired = set(bad)
        if (self.policy.degrade_on_integrity
                and self.level < len(self._plans) - 1):
            self._degrade(f"integrity violation in {len(bad)} slot(s)")
        return counts, unrepaired

    def _canary_golden_for(self, pinned) -> np.ndarray:
        """Golden counts of the canary window under ``pinned``'s weights,
        from the plain version on the CPU.  They are a function of the
        weights, so they are re-derived whenever the version changes."""
        if self._canary_window is None:
            inten = torch.full((self.n_inputs,), 128, dtype=torch.uint8)
            self._canary_window = words_to_numpy(encode_from_counter(
                _CANARY_SEED, inten, self.policy.canary_steps))
        if self._canary_version != pinned.version:
            self._canary_golden = ops.infer_window_batch(
                pinned.weights.cpu(), as_words(self._canary_window[None]),
                threshold=self.plan.threshold,
                leak=self.plan.leak)[0].numpy()
            self._canary_version = pinned.version
        return self._canary_golden

    def _canary_check(self) -> None:
        """Known-answer probe: serve a fixed window through the current
        rung (hook included) and compare with the golden counts."""
        golden = self._canary_golden_for(self._pinned)
        req = SNNRequest(rid=-1, window=self._canary_window)
        q = self._t_quantum()
        t_pad = -(-self.policy.canary_steps // q) * q
        self.canary_checks += 1
        try:
            got = self._launch_counts([req], t_pad, self.level,
                                      kind="canary")[0]
            ok = bool(np.array_equal(got, golden))
        except Exception as e:  # noqa: BLE001 — canary launch died
            self._last_error = f"{type(e).__name__}: {e}"
            ok = False
        if not ok:
            self.canary_failures += 1
            self._step_faults += 1
            if (self.policy.degrade_on_integrity
                    and self.level < len(self._plans) - 1):
                self._degrade("canary mismatch vs golden counts")

    def step(self) -> int:
        """Admit + serve one batch.  Returns the number of requests
        reaching a terminal status this step; never raises — launch
        faults retry, degrade, and at worst end the batch ``FAILED``.

        Step top is the version boundary: apply any queued swap, then
        *pin* the serving version — every launch this step (serve,
        retry, re-serve, canary) reads the pinned bank."""
        pol = self.policy
        self._store.swap_if_pending()
        self._pinned = self._store.serving
        batch, finished = self._form_batch()
        if not batch:
            return finished
        t0 = time.perf_counter()
        t_start_ms = _now_ms()
        self._step_faults = 0
        q = self._t_quantum()
        t_pad = -(-max(self._t_len(r) for r in batch) // q) * q
        counts = self._launch_with_recovery(batch, t_pad)
        unrepaired: set[int] = set()
        if counts is not None:
            counts, unrepaired = self._integrity_guard(batch, counts,
                                                       t_pad)
        now_ms = _now_ms()
        self._t_last_ms = now_ms
        for i, r in enumerate(batch):
            r.queue_wait_ms = t_start_ms - r.t_submit_ms
            r.service_ms = now_ms - r.t_submit_ms
            if counts is None or i in unrepaired:
                self._finish(r, FAILED, f"request {r.rid}: "
                             f"{self._last_error}")
                continue
            r.counts = counts[i]
            r.served_version = self._pinned.version
            if not self._store.is_live(self._pinned.version):
                self.version_violations += 1
            if self.neuron_class is not None:
                r.pred = int(self.neuron_class[int(np.argmax(counts[i]))])
            self.queue_wait_hist.record(r.queue_wait_ms)
            self.service_hist.record(r.service_ms)
            self._finish(r, SERVED)
            self.windows_served += 1
        finished += len(batch)
        self.steps += 1
        self.batches += 1
        self.slots_offered += self.plan.max_batch
        self.slots_padded += self.plan.max_batch - len(batch)
        if pol.canary_every and self.steps % pol.canary_every == 0:
            self._canary_check()
        if self._step_faults == 0:
            self.healthy_steps += 1
            if (self.level > 0 and pol.reprobe_after is not None
                    and self.healthy_steps >= pol.reprobe_after):
                self.degradation_events.append({
                    "step": self.steps, "from": self.level, "to": 0,
                    "encode": self.plan.encode,
                    "kernel_backend": self.plan.kernel_backend,
                    "reason": f"re-probe after {self.healthy_steps} "
                              "healthy steps"})
                self.breakers.half_open_all()   # trial traffic admitted
                self.level = 0
                self.healthy_steps = 0
            else:
                self.breakers.close_trials()    # half-open trial passed
        else:
            self.healthy_steps = 0
        dt = time.perf_counter() - t0
        self.step_seconds += dt
        self.last_step_seconds = dt
        return finished

    def run(self, requests: list[SNNRequest], max_steps: int = 10_000
            ) -> list[SNNRequest]:
        """Submit everything through the structured-rejection path, then
        step until every request is terminal."""
        for r in requests:
            if r.status == "NEW":
                self.submit(r)
        steps = 0
        while any(not r.terminal for r in requests) and steps < max_steps:
            if self.step() == 0 and not self.queue:
                break
            steps += 1
        return requests

    # --- stats ---------------------------------------------------------

    @property
    def padded_slot_waste(self) -> float:
        """Fraction of offered batch slots burned on zero padding."""
        if self.slots_offered == 0:
            return 0.0
        return self.slots_padded / self.slots_offered

    @property
    def offered_rps(self) -> float:
        """Submitted requests per second of wall time spent serving."""
        return self._rate(self.submitted)

    @property
    def achieved_rps(self) -> float:
        """SERVED requests per second of wall time spent serving."""
        return self._rate(self.windows_served)

    def _rate(self, count: int) -> float:
        if self._t_first_ms is None or self._t_last_ms is None:
            return 0.0
        span_ms = self._t_last_ms - self._t_first_ms
        return count / span_ms * 1e3 if span_ms > 0 else 0.0

    def stats(self) -> dict:
        """Serving counters for the ``--bench`` report."""
        return {
            "submitted": self.submitted,
            "windows_served": self.windows_served,
            "offered_rps": round(self.offered_rps, 3),
            "achieved_rps": round(self.achieved_rps, 3),
            "batches": self.batches,
            "padded_slot_waste": self.padded_slot_waste,
            "mean_step_ms": round(
                1e3 * self.step_seconds / max(self.batches, 1), 3),
            "last_step_ms": round(1e3 * self.last_step_seconds, 3),
            # --- robustness ------------------------------------------
            "rejected": self.rejected,
            "expired": self.expired,
            "failed": self.failed,
            "retried": self.retried,
            "degraded": self.degraded,
            "integrity_failures": self.integrity_failures,
            "canary_checks": self.canary_checks,
            "canary_failures": self.canary_failures,
            "level": self.level,
            "breaker_states": self.breakers.states(),
            "breaker_trips": self.breakers.trips,
            **self._store.stats(),
            "version_violations": self.version_violations,
            "queue_wait_ms_p50": round(
                self.queue_wait_hist.percentile(50), 3),
            "queue_wait_ms_p99": round(
                self.queue_wait_hist.percentile(99), 3),
            "service_ms_p50": round(self.service_hist.percentile(50), 3),
            "service_ms_p99": round(self.service_hist.percentile(99), 3),
        }
