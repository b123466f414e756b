"""SNN request serving: queue + dynamic window batching over the engine.

:class:`SNNServingEngine` keeps a request queue and, per engine step,
admits up to ``plan.max_batch`` requests, pads their (possibly ragged)
windows into one batch, and serves them with a single
:meth:`SNNEngine.infer` call: one launch, or one launch per shard of
the plan's device grid when it holds one (``mesh``/``mesh_shape``), so
population-split serving and request batching compose.

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

**Version lifecycle (train-while-serving).**  With a
:class:`repro_torch.serving.weights.SNNWeightRefresher` attached, weights
live in a :class:`repro_torch.serving.weights.VersionedWeightStore` and move
through ``candidate -> probed -> promoted -> (rolled-back)``:

* **candidate** — every ``refresh_every`` serving steps the refresher
  trains a new bank from the serving weights (STDP over the next
  refresh-stream slice, epoch-keyed counter seeds) and *stages* it
  under a fresh monotonic version number.  Staged versions are never
  visible to traffic.
* **probed** — the candidate must first re-verify the content
  fingerprint taken at production time (a corrupted or torn candidate
  is rejected deterministically, before any accuracy math), then beat
  the serving bank on the fixed held-out probe set within the policy's
  ``max_regression``.  Rejections only increment counters.
* **promoted** — a passing candidate is persisted through the atomic
  :class:`repro_torch.checkpoint.CheckpointManager` (tmp-dir + rename; a
  crash mid-save leaves a ``.tmp`` dropping and aborts the promotion)
  and *queued* for swap.  The swap itself happens only between serving
  steps: each ``step()`` pins the serving version before forming its
  batch, so in-flight windows always finish on the bank they launched
  with — a half-written or mid-swap bank is unobservable by
  construction.  Every ``SERVED`` request records ``served_version``.
* **rolled-back** — if the probe later shows the *serving* bank
  regressed, or the known-answer canary fails right after a refresh
  promotion, the store demotes it and re-reads the previous promoted
  version from disk (bit-exact with its checkpoint).  On a card the
  refresh trains through the stream kernel, and the probe and the
  canary's serve run the serving kernels; the canary's golden counts
  stay the plain version on the CPU.  Demoted versions
  are never served again; a process restart restores the newest
  *complete* on-disk version instead of the seed weights.

Load model
----------

The engine is **closed-loop-agnostic**: it serves whatever its queue
holds, and the *submitter* defines the load model.  The legacy
``run()`` loop is closed-loop — it feeds the queue as fast as
``step()`` drains it, so it can say nothing about behavior at a given
offered rate.  :mod:`repro_torch.loadgen` drives the same engine
**open-loop**: request arrival times come from a seeded arrival
process fixed before the run, independent of how fast the server
drains — the regime in which offered-load vs latency curves and
maximum-sustainable-throughput numbers are meaningful.

**Coordinated omission.**  All latency is measured from the request's
*intended* arrival time, not from when the submitter got around to
calling ``submit()``: ``submit()`` honors a pre-stamped
``t_submit_ms`` (the loadgen runner sets it to the arrival-process
timestamp), so a backed-up server accrues the queueing delay it
caused instead of silently re-timing the arrival stream.  Time itself
is read through the engine's pluggable ``clock``
(:class:`ServingClock` — wall by default; loadgen substitutes a
deterministic virtual clock whose serving steps cost a modeled
duration, making per-status totals and histogram buckets bit-identical
across replays of the same trace).

**SLO.**  A request meets its SLO when it ends ``SERVED`` within its
own ``deadline_ms`` (or the run-level SLO target for requests
without one), end-to-end from intended arrival.  Attainment is
reported over *offered* requests: rejects, expiries and failures all
count against it.

**Latency accounting.**  Queue-wait (submit → batch formation) and
service (submit → terminal) latencies live in fixed-size mergeable
log-bucketed histograms (:class:`repro_torch.loadgen.histogram.LatencyHistogram`,
~1.6% worst-case bucket error), not per-request lists — memory stays
flat at millions of requests and ``stats()`` percentiles are O(buckets),
nearest-rank over bucket midpoints.

Overload model
--------------

The static defenses above (bounded queue, deadlines, per-request
retries) keep overload *correct* but not *productive*: sustained
offered load past capacity pins the queue at ``max_queue`` and every
admitted request ages toward its deadline while being served — goodput
collapses into expiry churn (the metastable failure mode).  Passing
``overload=OverloadPolicy(...)`` attaches an
:class:`repro_torch.serving.overload.OverloadController` that keeps the
pipeline productive through sustained overload.  Its state machine and
shedding order, in pipeline position:

1. **AIMD admission** (``submit()``): a token bucket refilled at an
   adaptive ``admit_rate`` sheds excess arrivals at the front door
   (status ``REJECTED``, tagged ``shed="adm"``) — the cheapest place
   to say no.  Every ``interval_ms`` the rate multiplicatively
   decreases if the interval saw congestion (CoDel dropping or a
   served latency over ``slo_ms``) and additively increases otherwise;
   bucket exhaustion alone never counts as congestion, which is how
   the rate probes up to capacity.
2. **Priority-aware shed** (``submit()``): low-priority requests
   (``priority < high_priority``) additionally shed probabilistically
   as queue occupancy rises (RED-style ramp, tagged ``"lowprio"``, a
   stateless counter-hash draw) and must leave ``high_reserve``
   admission tokens for the high class.  Under overload the shed mass
   concentrates on the low class, holding high-priority SLO
   attainment.
3. **CoDel drop-at-dequeue** (``_form_batch``): the controller tracks
   the *standing-queue* sojourn — the age of the oldest queued
   request, which in a priority queue is the lingering low-priority
   tail; when it stays above ``target_sojourn_ms`` for a full
   ``interval_ms`` the controller
   enters its *dropping* state and batch formation sheds queued
   low-priority requests (status ``EXPIRED``, tagged ``"codel"``) —
   the ``interval/sqrt(n)`` control law plus everything older than the
   sojourn ceiling — instead of serving requests into certain SLO
   misses.  High-priority requests are never CoDel-shed.
4. **Global retry budget** (``_launch_with_recovery``): retries draw
   from one bucket (``retry_budget`` tokens at ``retry_refill_per_s``)
   so correlated fault bursts cannot amplify into retry storms;
   denials count ``retries_denied`` and fail the batch fast.

The degradation ladder doubles as explicit **circuit breakers**
(:class:`repro_torch.serving.overload.LadderBreakers`): rung R's breaker
*opens* when the engine degrades off R, every open breaker goes
*half-open* at the deterministic reprobe (trial traffic at rung 0),
and the next fault-free step *closes* the trials.  Breaker states ride
in ``stats()`` and journal snapshots; the level/healthy-step counters
remain the behavioral source of truth, so pre-breaker replays are
bit-identical.

All controller decisions read the engine clock and a stateless
splitmix64 counter hash — no wall time, no stateful RNG — so
virtual-clock overload runs replay bit-identically (asserted by
``launch/loadgen.py --check`` and ``serve --overload-storm``).

Crash consistency
-----------------

With ``journal_dir`` set, the engine writes every request lifecycle
transition through a :class:`repro_torch.serving.journal.RequestJournal` —
an append-only, CRC-framed write-ahead log with periodic engine-state
snapshots — so process death (kill -9, power loss, an injected
``os._exit``) never loses admitted work or breaks the "every request
reaches a terminal, attributable status" invariant.

**Journal format.**  Three WAL event kinds: ``ADMIT`` (rid, intended
arrival, priority, effective deadline, payload content hash, and the
payload *descriptor* — the loadgen trace row when one rides on the
request, else the inline payload), ``DISPATCH`` (one batch's rids +
pinned weight version + pad waste), ``TERMINAL`` (status,
served_version, queue-wait/service latency, content hash).  Snapshots
capture the full engine state — queue contents as ADMIT records,
robustness counters, latency histograms via their JSON round-trip, the
degradation rung, and the live weight version — then rotate the WAL
(old segment deleted), bounding recovery work.  A separate append-only
``ledger.log`` records one entry per terminal request and is never
truncated: it is the cross-restart exactly-once audit substrate.

**Durability points (group commit).**  ADMIT records buffer at
``submit()`` and are fsync'd together with the DISPATCH record before
the serve launch; TERMINAL records are fsync'd at step end.  A ledger
entry is appended only *after* its WAL terminal is durable, so the
ledger never runs ahead of the WAL.

**Recovery invariants.**  Constructing an engine over an existing
``journal_dir`` replays snapshot + WAL tail: a torn *final* record is
physically truncated (it was never acknowledged), a CRC-corrupt
*mid-log* record fails loudly (acknowledged state rotted), and a
``snapshot_N.json.tmp`` dropping from a crash mid-snapshot is ignored
(the previous snapshot + full log win).  Counters and histograms
resume from the replayed state; every ADMIT without a TERMINAL is
re-queued idempotently — trace-backed payloads re-materialize from the
row's seeds and are verified against the recorded content hash — and
the virtual clock resumes from the journal's time high-water mark.
The live weight version is reconciled against
:class:`~repro_torch.serving.weights.VersionedWeightStore`'s own restart
path (newest complete checkpoint wins; a disagreement only counts
``version_reconciliations``).  ``journal_resume_offset`` (one past the
highest journaled rid) lets a replayed trace run continue where the
dead process stopped instead of re-offering from row 0.

**Exactly-once argument.**  A rid is re-queued only when its WAL
TERMINAL is missing; a ledger entry exists only when that WAL terminal
was durable first.  Therefore a crashed-then-recovered request can
never acquire two ledger entries: either its terminal was durable (it
is *not* re-queued) or it was not (no ledger entry exists, and the
re-serve writes the only one).  Replayed requests keep their original
rids and content hashes, so the kill–restart chaos harness
(``serve --chaos``) can audit zero lost ADMITs and zero duplicate
SERVEs by content hash across any number of crashes.

**Observability.**  ``stats()`` reports rejected / expired / failed /
retried / degraded / integrity-failure / canary counters plus
per-request queue-wait and service latency p50/p99 — surfaced by
``repro_torch.launch.serve --arch wenquxing-snn --bench``.  Versioned
serving adds the store counters (weight_version, versions promoted /
rejected, rollbacks, save_crashes) and refresh-path counters
(refresh_runs / refresh_rejected / refresh_corrupt / refresh_timeouts
/ refresh_failed, probe_accuracy, version_violations — the latter must
stay 0: every served response is attributable to a version that was
promoted and live at serve time).
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
from repro_torch.serving.journal import (_COUNTER_KEYS, RequestJournal,
                                         RingLog, replay)
from repro_torch.serving.overload import (SHED_CODEL, LadderBreakers,
                                          OverloadController, OverloadPolicy)
from repro_torch.serving.weights import (SNNWeightRefresher,
                                         VersionedWeightStore)

_T_QUANTUM = 8   # window lengths bucket to multiples of this (or t_chunk)
_ERR_MAX = 256   # per-request error strings are capped at this length
_EVENT_RING = 256  # degradation/refresh telemetry kept in memory

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
    """Bound per-request error strings (millions of FAILED requests
    must not grow memory — or the journal — unboundedly)."""
    if error is not None and len(error) > _ERR_MAX:
        return error[:_ERR_MAX] + "...[truncated]"
    return error


class ServingClock:
    """The engine's time source (milliseconds).  The default is the
    wall clock; :mod:`repro_torch.loadgen.runner` substitutes virtual
    clocks that skip idle gaps and (in deterministic mode) charge
    serving steps a modeled cost via :meth:`advance_service_ms` — a
    no-op here because wall time advances by itself during the
    launch."""

    def now_ms(self) -> float:
        return _now_ms()

    def advance_service_ms(self, batch_size: int, t_pad: int,
                           inflation: float = 1.0) -> None:
        pass

    def advance_ms(self, ms: float) -> None:
        """Charge a non-launch delay (retry backoff).  A no-op on the
        wall clock on purpose: the serving loop never sleeps; virtual
        clocks charge the delay to modeled time instead."""


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
    t_submit_ms: float | None = None    # clock stamp (ms) at admission
    served_version: int | None = None   # weight version the counts came from
    trace_row: dict | None = None       # loadgen row (journal descriptor)
    content_sha: str | None = None      # payload content hash (audit key)
    shed: str | None = None             # overload shed tag (adm/lowprio/codel)

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
    retry_backoff_ms: float = 0.0      # base delay between retries (doubles)
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
        if self.retry_backoff_ms < 0:
            raise ValueError(f"retry_backoff_ms must be >= 0, got "
                             f"{self.retry_backoff_ms}")
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
    plan (``max_batch``, ``t_chunk``, ``encode``, ``cycle_backend``);
    failure handling from the ``policy`` (see the module docstring's
    failure-semantics section).  ``on_launch``, when given, is consulted
    before every serve/canary launch (the fault injection hook —
    :mod:`repro_torch.serving.faults`).  The engine runs on ``device``
    (``cuda`` unless the caller asks for another).

    ``refresher`` (optional) turns on train-while-serving: every
    ``refresher.policy.refresh_every`` steps the engine runs one
    probe-gated refresh cycle between batches.  ``state_dir``
    (optional, independent of the refresher) persists promoted versions
    through the atomic checkpoint manager; constructing an engine over
    an existing ``state_dir`` restores the newest complete version
    instead of ``weights``.  ``clock`` is the time source (wall by
    default), ``journal_dir`` turns on the crash-consistency journal
    (with a snapshot every ``snapshot_every`` steps) and ``overload``
    attaches the adaptive overload controller.
    """

    def __init__(self, weights, plan: SNNEnginePlan, *,
                 neuron_class=None, policy: SNNServingPolicy | None = None,
                 on_launch: Callable[[dict], object] | None = None,
                 refresher: SNNWeightRefresher | None = None,
                 state_dir=None, keep_versions: int = 4,
                 clock: ServingClock | None = None,
                 journal_dir=None, snapshot_every: int = 256,
                 overload: OverloadPolicy | None = None, device=None):
        if plan.threshold < 1:
            raise ValueError("SNN serving requires threshold >= 1 "
                             "(zero-padded cycles must stay silent)")
        self.plan = plan
        self.device = resolve_device(device)
        self.policy = policy if policy is not None else SNNServingPolicy()
        self.on_launch = on_launch
        self.refresher = refresher
        self.clock = clock if clock is not None else ServingClock()
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
        self.rejected = 0
        self.expired = 0
        self.failed = 0
        self.retried = 0            # launch re-attempts (all rungs)
        self.degraded = 0           # ladder steps taken
        self.integrity_failures = 0
        self.canary_checks = 0
        self.canary_failures = 0
        self.level = 0              # current degradation rung
        self.healthy_steps = 0      # fault-free steps at this rung
        self.degradation_events = RingLog(cap=_EVENT_RING)
        # --- overload control (None = static defenses only) -------------
        self.overload = (OverloadController(overload)
                         if overload is not None else None)
        self.breakers = LadderBreakers(len(self._plans))
        self.shed_admission = 0     # AIMD front-door sheds
        self.shed_low_priority = 0  # RED occupancy-ramp sheds
        self.shed_codel = 0         # sojourn-control dequeue drops
        self.retries_denied = 0     # global retry-budget denials
        self._foreign_counters: dict[str, int] = {}  # newer-schema keys
        self.queue_wait_hist = LatencyHistogram()
        self.service_hist = LatencyHistogram()
        self.submitted = 0          # every submit() call, admitted or not
        self._t_first_ms: float | None = None   # first submit, clock time
        self._t_last_ms: float | None = None    # last completed step
        self._step_faults = 0
        self._last_error: str | None = None
        self._canary_window: np.ndarray | None = None
        self._canary_golden: np.ndarray | None = None
        self._canary_version: int | None = None
        # --- versioned-refresh counters --------------------------------
        self.refresh_runs = 0
        self.refresh_rejected = 0     # probe-gate accuracy rejections
        self.refresh_corrupt = 0      # fingerprint-mismatch rejections
        self.refresh_timeouts = 0     # stalled refreshes aborted
        self.refresh_failed = 0       # candidate production / probe died
        self.version_violations = 0   # served from a non-live version
        self.last_probe_accuracy: float | None = None
        self.refresh_events = RingLog(cap=_EVENT_RING)
        self._last_refresh_step = 0
        # --- crash-consistency journal ---------------------------------
        self.journal: RequestJournal | None = None
        self.snapshot_every = int(snapshot_every)
        self.journal_recovered = 0      # requests re-queued at recovery
        self.journal_resume_offset = 0  # trace offset a resumed run uses
        self.version_reconciliations = 0
        self._journal_last_rid = -1
        self._admit_records: dict[int, dict] = {}
        self._pending_ledger: list[dict] = []
        if journal_dir is not None:
            self._recover_from_journal(journal_dir)
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
        """Admit a request, or reject it *structurally*: a malformed,
        shed or backpressured request ends as ``REJECTED`` with
        ``error`` set — nothing raises, so one bad request can never
        strand the queue.  Returns whether the request was admitted."""
        self.submitted += 1
        if self._t_first_ms is None:
            self._t_first_ms = (req.t_submit_ms
                                if req.t_submit_ms is not None
                                else self.clock.now_ms())
        error = self._validate(req)
        if error is None and self.overload is not None:
            ok, tag = self.overload.admit(req.priority, len(self.queue),
                                          self.policy.max_queue,
                                          self.clock.now_ms())
            if not ok:
                req.shed = tag
                if tag == "lowprio":
                    self.shed_low_priority += 1
                    error = (f"request {req.rid}: low-priority shed at "
                             "queue occupancy (overload)")
                else:
                    self.shed_admission += 1
                    error = (f"request {req.rid}: admission rate limit "
                             f"({self.overload.admit_rate:.0f} rps), "
                             "overload shed")
        if error is None and self.policy.max_queue is not None \
                and len(self.queue) >= self.policy.max_queue:
            error = (f"request {req.rid}: queue full "
                     f"(max_queue={self.policy.max_queue}), "
                     "backpressure reject")
        if error is not None:
            req.status, req.error, req.done = REJECTED, _cap_error(error), \
                True
            self.rejected += 1
            if self.journal is not None:
                self._journal_terminal(req, noadmit=True)
            return False
        if req.deadline_ms is None:
            req.deadline_ms = self.policy.deadline_ms
        if req.t_submit_ms is None:    # a load generator pre-stamps arrival
            req.t_submit_ms = self.clock.now_ms()
        req.status = QUEUED
        self.queue.append(req)
        if self.journal is not None:
            self._journal_admit(req)
        return True

    def _t_quantum(self) -> int:
        tc = self.plan.t_chunk
        return tc if tc is not None else _T_QUANTUM

    @staticmethod
    def _t_len(req: SNNRequest) -> int:
        return (req.window.shape[0] if req.window is not None
                else req.n_steps)

    def _form_batch(self) -> tuple[list[SNNRequest], int]:
        """Expire overdue queued requests, consult the overload
        controller's sojourn law (drop-at-dequeue), then pull up to
        ``max_batch`` highest-priority-first (stable, so FIFO within a
        priority).  Returns (batch, n_finished_here)."""
        now = self.clock.now_ms()
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
        ov = self.overload
        if ov is not None and live:
            sojourn = max(now - r.t_submit_ms for r in live)
            n_drop = ov.on_dequeue(sojourn, now, len(live))
            if ov.dropping:
                # shed low-priority only: everything past the sojourn
                # ceiling (serving it cannot meet the SLO), oldest
                # first, plus what the sqrt control law asks for
                limit = ov.policy.sojourn_limit_ms
                low = sorted((r for r in live
                              if r.priority < ov.policy.high_priority),
                             key=lambda r: r.t_submit_ms)
                aged = [r for r in low if now - r.t_submit_ms > limit]
                fresh = [r for r in low if now - r.t_submit_ms <= limit]
                for r in aged + fresh[:max(0, n_drop - len(aged))]:
                    r.service_ms = now - r.t_submit_ms
                    r.shed = SHED_CODEL
                    self.shed_codel += 1
                    self._finish(r, EXPIRED,
                                 f"request {r.rid}: shed at dequeue by "
                                 "sojourn control (overload)")
                    n_expired += 1
                live = [r for r in live if not r.done]
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
        if self.journal is not None:
            self._journal_terminal(req)

    # --- crash-consistency journal -------------------------------------

    def _journal_admit(self, req: SNNRequest) -> None:
        """Buffered ADMIT record (durable at the next dispatch sync).
        Trace-backed requests journal the tiny row descriptor — the
        payload re-materializes from its seeds on recovery — while ad
        hoc requests journal the payload inline."""
        rec = {"ev": "A", "rid": req.rid, "ts": req.t_submit_ms,
               "prio": req.priority, "ddl": req.deadline_ms}
        if req.content_sha is not None:
            rec["sha"] = req.content_sha
        if req.trace_row is not None:
            rec["row"] = req.trace_row
        elif req.intensities is not None:
            rec["payload"] = {"kind": "I",
                              "inten": req.intensities.tolist(),
                              "n_steps": int(req.n_steps),
                              "seed": req.seed}
        else:
            rec["payload"] = {"kind": "W", "t": int(req.window.shape[0]),
                              "win": req.window.reshape(-1).tolist()}
        self.journal.append(rec)
        self._admit_records[req.rid] = rec
        self._journal_last_rid = max(self._journal_last_rid, req.rid)

    def _journal_terminal(self, req: SNNRequest, *,
                          noadmit: bool = False) -> None:
        """Buffered TERMINAL record + (post-sync) ledger entry.
        ``noadmit`` marks a structural reject at submit time — the rid
        never had an ADMIT, but it was offered, so replay still counts
        it toward ``submitted`` and the resume offset."""
        rec = {"ev": "T", "rid": req.rid, "st": req.status,
               "at": self.clock.now_ms()}
        if noadmit:
            rec["noadmit"] = 1
        if req.served_version is not None:
            rec["ver"] = req.served_version
        if req.queue_wait_ms is not None:
            rec["qw"] = req.queue_wait_ms
        if req.service_ms is not None:
            rec["sv"] = req.service_ms
        if req.content_sha is not None:
            rec["sha"] = req.content_sha
        if req.shed is not None:
            rec["shed"] = req.shed
        if req.error:
            rec["err"] = req.error
        self.journal.append(rec)
        self._admit_records.pop(req.rid, None)
        self._journal_last_rid = max(self._journal_last_rid, req.rid)
        self._pending_ledger.append(
            {"rid": req.rid, "st": req.status, "sha": req.content_sha,
             "ver": req.served_version})

    def _journal_sync(self) -> None:
        """Group commit: make buffered WAL records durable, THEN flush
        the terminal-ledger entries they cover (ledger ⊆ durable WAL —
        the exactly-once ordering)."""
        self.journal.sync()
        if self._pending_ledger:
            for rec in self._pending_ledger:
                self.journal.ledger_append(rec)
            self._pending_ledger.clear()
            self.journal.ledger_sync()

    def _consult_crash(self, kind: str) -> None:
        """Injected whole-process crash point (journaled engines only;
        the default hook calls ``os._exit`` and never returns)."""
        if self.on_launch is not None:
            self.on_launch({"kind": kind, "step": self.steps,
                            "level": self.level, "batch_size": 0,
                            "t_lens": []})

    def _snapshot_state(self) -> dict:
        state = {
            "counters": {**{k: int(getattr(self, k))
                            for k in _COUNTER_KEYS},
                         # keys from a newer schema ride along untouched
                         **self._foreign_counters},
            "qw_hist": self.queue_wait_hist.to_dict(),
            "sv_hist": self.service_hist.to_dict(),
            "queue": [self._admit_records[r.rid] for r in self.queue
                      if r.rid in self._admit_records],
            "last_rid": self._journal_last_rid,
            "weight_version": self._store.serving.version,
            "clock_ms": self.clock.now_ms(),
            "t_first_ms": self._t_first_ms,
            "t_last_ms": self._t_last_ms,
            "deg_events": self.degradation_events.to_list(),
            "deg_dropped": self.degradation_events.dropped,
            "level": self.level,
            "breakers": self.breakers.states(),
            "breaker_trips": self.breakers.trips,
        }
        if self.overload is not None:
            state["overload"] = self.overload.state_dict()
        return state

    def _requeue_record(self, rec: dict) -> None:
        """Re-materialize one recovered ADMIT record into the queue,
        bypassing ``submit()`` (its counters were already replayed).
        Trace rows regenerate their payload from the row's seeds and
        are verified against the recorded content hash — a mismatch
        fails loudly rather than serving the wrong bytes."""
        row = rec.get("row")
        if row is not None:
            # local import: repro_torch.loadgen.__init__ imports the
            # runner, which imports this module
            from repro_torch.loadgen.workload import WorkloadSpec

            req = WorkloadSpec(n_inputs=row.get("n_in", self.n_inputs)
                               ).materialize(row, verify=True)
        else:
            p = rec["payload"]
            if p["kind"] == "I":
                req = SNNRequest(rid=rec["rid"],
                                 intensities=np.array(p["inten"],
                                                      np.uint8),
                                 n_steps=p["n_steps"], seed=p.get("seed"))
            else:
                req = SNNRequest(rid=rec["rid"],
                                 window=np.array(p["win"], np.uint32)
                                 .reshape(p["t"], self.words))
        req.priority = rec.get("prio", 0)
        req.deadline_ms = rec.get("ddl")
        req.t_submit_ms = rec["ts"]
        req.content_sha = rec.get("sha")
        req.status = QUEUED
        self.queue.append(req)
        self._admit_records[req.rid] = rec

    def _recover_from_journal(self, journal_dir) -> None:
        """Adopt the journal's replayed state: counters, histograms,
        degradation rung, clock high-water mark, and the re-queue set
        (see the module docstring's crash-consistency section)."""
        if self.snapshot_every < 0:
            raise ValueError(f"snapshot_every must be >= 0, got "
                             f"{self.snapshot_every}")
        self.journal = j = RequestJournal(journal_dir)
        snapshot, tail = j.recover()
        rec = replay(snapshot, tail)
        if rec.last_rid < 0 and not rec.snapshotted:
            return      # fresh journal directory: nothing to adopt
        for k, v in rec.counters.items():
            if k in _COUNTER_KEYS:
                setattr(self, k, v)
            else:
                # a newer engine's counter: preserve through our own
                # snapshots rather than break (forward compatibility)
                self._foreign_counters[k] = v
        if rec.overload is not None and self.overload is not None:
            self.overload.load_state(rec.overload)
        if rec.breakers is not None:
            self.breakers = LadderBreakers(len(self._plans),
                                           states=rec.breakers)
        if rec.qw_hist:
            self.queue_wait_hist = LatencyHistogram.from_dict(rec.qw_hist)
        if rec.sv_hist:
            self.service_hist = LatencyHistogram.from_dict(rec.sv_hist)
        self.level = min(rec.level, len(self._plans) - 1)
        self.degradation_events = RingLog(cap=_EVENT_RING,
                                          items=rec.deg_events)
        self.degradation_events.dropped += rec.deg_dropped
        self._t_first_ms = rec.t_first_ms
        self._t_last_ms = rec.t_last_ms
        self._journal_last_rid = rec.last_rid
        self.journal_resume_offset = rec.resume_offset
        skip = getattr(self.clock, "skip_to", None)
        if skip is not None:
            skip(rec.clock_ms)
        for adm in rec.pending:
            self._requeue_record(adm)
        self.journal_recovered = len(rec.pending)
        # the store's restart path (newest complete checkpoint) is the
        # source of truth for weights; a journal/store disagreement is
        # counted, never fought
        if (rec.weight_version is not None
                and rec.weight_version != self._store.serving.version):
            self.version_reconciliations += 1
            self._store.events.append({
                "event": "journal_version_reconciled",
                "journal": rec.weight_version,
                "store": self._store.serving.version})
        # ledger reconciliation: a crash between the WAL terminal sync
        # and the ledger flush leaves durable terminals the ledger
        # missed — append them now, before the compacting snapshot
        # folds the tail away
        ledger_rids = {r["rid"] for r in j.read_ledger()}
        missing = [ev for ev in tail if ev.get("ev") == "T"
                   and int(ev["rid"]) not in ledger_rids]
        for ev in missing:
            j.ledger_append({"rid": int(ev["rid"]), "st": ev["st"],
                             "sha": ev.get("sha"), "ver": ev.get("ver")})
        if missing:
            j.ledger_sync()
        j.snapshot(self._snapshot_state())   # compact: tail -> snapshot

    def close(self) -> None:
        """Flush and close the journal (final compacting snapshot).
        A crash *instead of* close loses nothing durable — this only
        tightens the next recovery."""
        if self.journal is not None:
            self._journal_sync()
            self.journal.snapshot(self._snapshot_state())
            self.journal.close()

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
        """One pre-packed launch (window plan) or one window of step
        launches (step plan); intensity requests are host-encoded here
        (bit-exact with the kernel draw)."""
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
        plan = eng.plan
        intensity_only = all(r.window is None for r in batch)
        if (intensity_only and plan.encode == "kernel"
                and plan.cycle_backend == "window"):
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
        the current rung up to ``max_retries`` times (each retry drawn
        from the overload controller's global budget when one is
        attached), then step down the ladder and re-run the budget;
        None once every rung is spent (the batch fails)."""
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
                    if (self.overload is not None
                            and not self.overload.grant_retry(
                                self.clock.now_ms())):
                        # global retry budget spent: fail fast instead
                        # of amplifying a correlated fault burst into a
                        # retry storm
                        self.retries_denied += 1
                        break
                    attempts += 1
                    self.retried += 1
                    for r in batch:
                        r.retries += 1
                    if pol.retry_backoff_ms:
                        self.clock.advance_ms(pol.retry_backoff_ms
                                              * 2 ** (attempts - 1))
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
        rung (hook included) and compare with the golden counts —
        catches in-range corruption the range guard cannot.  A mismatch
        while serving a freshly *refreshed* version is treated as
        post-promotion regression and rolls the store back (path
        corruption on a seed/rollback bank only degrades)."""
        pinned = self._pinned
        golden = self._canary_golden_for(pinned)
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
            if pinned.origin == "refresh" and self._store.can_rollback():
                tgt = self._store.rollback(
                    reason=f"canary mismatch on refreshed version "
                           f"{pinned.version}")
                self.refresh_events.append({
                    "event": "rollback", "step": self.steps,
                    "from": pinned.version, "to": tgt.version,
                    "reason": "canary mismatch"})

    # --- versioned refresh ----------------------------------------------

    def _refresh_event(self, event: str, **fields) -> None:
        self.refresh_events.append({"event": event, "step": self.steps,
                                    **fields})

    def _maybe_refresh(self) -> None:
        rf = self.refresher
        if rf is None or rf.policy.refresh_every <= 0 or self.steps == 0:
            return
        if self.steps - self._last_refresh_step < rf.policy.refresh_every:
            return
        self._last_refresh_step = self.steps
        self._refresh_cycle()

    def _refresh_cycle(self) -> None:
        """One probe-gated refresh, run BETWEEN serving steps (the
        double-buffered swap point).  Train a candidate from the serving
        bank, verify its content fingerprint, probe it on the held-out
        set, then promote / reject / roll back.  Never raises; every
        outcome lands in a counter and ``refresh_events``."""
        rf = self.refresher
        pol = rf.policy
        serving = self._store.serving
        self.refresh_runs += 1
        t0 = time.perf_counter()
        corrupt = None
        try:
            if self.on_launch is not None:
                # refresh-path fault hook: may stall, raise, or return a
                # weight-corruption callable (applied post-fingerprint,
                # exactly the torn-candidate failure mode)
                corrupt = self.on_launch({
                    "kind": "refresh", "step": self.steps,
                    "epoch": rf.epochs_run, "level": self.level,
                    "batch_size": 0, "t_lens": []})
            cand_w, epoch = rf.next_candidate(serving.weights)
        except Exception as e:  # noqa: BLE001 — contain refresh faults
            self._last_error = f"{type(e).__name__}: {e}"
            self.refresh_failed += 1
            self._refresh_event("refresh_failed", error=self._last_error)
            return
        cand = self._store.stage(cand_w, origin="refresh")
        if corrupt is not None:
            cand = dataclasses.replace(cand, weights=as_words(
                corrupt(words_to_numpy(cand.weights)), self.device))
        elapsed_ms = (time.perf_counter() - t0) * 1e3
        if (pol.refresh_timeout_ms is not None
                and elapsed_ms > pol.refresh_timeout_ms):
            self.refresh_timeouts += 1
            self._store.reject(cand, f"stalled refresh: "
                               f"{elapsed_ms:.1f}ms > "
                               f"{pol.refresh_timeout_ms}ms")
            self._refresh_event("refresh_stalled", version=cand.version,
                                elapsed_ms=round(elapsed_ms, 1))
            return
        if not cand.verify():
            self.refresh_corrupt += 1
            self._store.reject(cand, "candidate fingerprint mismatch "
                               "(corrupt weights)")
            self._refresh_event("refresh_corrupt", version=cand.version)
            return
        try:
            acc_cand = rf.probe(cand.weights)
            acc_cur = rf.probe(serving.weights)
        except Exception as e:  # noqa: BLE001 — probe died
            self._last_error = f"{type(e).__name__}: {e}"
            self.refresh_failed += 1
            self._store.reject(cand, f"probe failed: {self._last_error}")
            self._refresh_event("refresh_failed", version=cand.version,
                                error=self._last_error)
            return
        self.last_probe_accuracy = acc_cur
        if (serving.probe_accuracy is not None
                and acc_cur < serving.probe_accuracy - pol.max_regression
                and self._store.can_rollback()):
            # the SERVING bank itself regressed vs its promotion-time
            # probe — post-promotion rollback, candidate dropped too
            self._store.reject(cand, "serving bank regressed; "
                               "rolling back first")
            tgt = self._store.rollback(
                reason=f"probe regression: {acc_cur:.3f} < promoted "
                       f"{serving.probe_accuracy:.3f}")
            self._refresh_event("rollback", **{
                "from": serving.version, "to": tgt.version,
                "probe_accuracy": acc_cur})
            return
        if acc_cand < acc_cur - pol.max_regression:
            self.refresh_rejected += 1
            self._store.reject(cand, f"probe gate: candidate "
                               f"{acc_cand:.3f} < serving "
                               f"{acc_cur:.3f} - {pol.max_regression}")
            self._refresh_event("refresh_rejected", version=cand.version,
                                candidate=acc_cand, serving=acc_cur)
            return
        cand = dataclasses.replace(cand, probe_accuracy=acc_cand)
        if self._store.promote(cand, on_save=self.on_launch):
            self.last_probe_accuracy = acc_cand
            self._refresh_event("promoted", version=cand.version,
                                probe_accuracy=acc_cand, epoch=epoch)
        else:
            self._refresh_event("save_crash", version=cand.version)

    def step(self) -> int:
        """Admit + serve one batch.  Returns the number of requests
        reaching a terminal status this step; never raises — launch
        faults retry, degrade, and at worst end the batch ``FAILED``.

        Step top is the version boundary: run a due refresh cycle,
        apply any queued promotion/rollback swap, then *pin* the
        serving version — every launch this step (serve, retry,
        re-serve, canary) reads the pinned bank, so a swap can never
        tear a batch."""
        pol = self.policy
        self._maybe_refresh()
        self._store.swap_if_pending()
        self._pinned = self._store.serving
        batch, finished = self._form_batch()
        if not batch:
            if self.journal is not None:
                self._journal_sync()     # expiries found this step
            return finished
        t0 = time.perf_counter()
        t_start_ms = self.clock.now_ms()
        self._step_faults = 0
        q = self._t_quantum()
        t_pad = -(-max(self._t_len(r) for r in batch) // q) * q
        if self.journal is not None:
            # group commit: buffered ADMITs + this DISPATCH become
            # durable together, before the launch can observe them
            self.journal.append({
                "ev": "D", "step": self.steps, "n": len(batch),
                "pad": self.plan.max_batch - len(batch),
                "ver": self._pinned.version,
                "rids": [r.rid for r in batch], "at": t_start_ms})
            self._journal_sync()
            self._consult_crash("crash_before_dispatch")
        counts = self._launch_with_recovery(batch, t_pad)
        unrepaired: set[int] = set()
        if counts is not None:
            counts, unrepaired = self._integrity_guard(batch, counts,
                                                       t_pad)
        if self.journal is not None:
            self._consult_crash("crash_after_serve")
        infl_fn = getattr(self.on_launch, "service_inflation", None)
        infl = 1.0 if infl_fn is None else infl_fn(
            {"step": self.steps, "batch_size": len(batch),
             "t_pad": t_pad})
        self.clock.advance_service_ms(len(batch), t_pad, inflation=infl)
        now_ms = self.clock.now_ms()
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
            if self.overload is not None:
                self.overload.note_served(r.service_ms)
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
        if self.journal is not None:
            self._journal_sync()         # TERMINALs durable at step end
            if self.snapshot_every and \
                    self.steps % self.snapshot_every == 0:
                self.journal.snapshot(
                    self._snapshot_state(),
                    crash_point=lambda: self._consult_crash(
                        "crash_mid_snapshot"))
        dt = time.perf_counter() - t0
        self.step_seconds += dt
        self.last_step_seconds = dt
        return finished

    def run(self, requests: list[SNNRequest], max_steps: int = 10_000
            ) -> list[SNNRequest]:
        """Submit everything through the structured-rejection path, then
        step until every request is terminal (a rejected request never
        strands the rest)."""
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
        """Submitted requests per second of clock time spent serving."""
        return self._rate(self.submitted)

    @property
    def achieved_rps(self) -> float:
        """SERVED requests per second of clock time spent serving."""
        return self._rate(self.windows_served)

    def _rate(self, count: int) -> float:
        if self._t_first_ms is None or self._t_last_ms is None:
            return 0.0
        span_ms = self._t_last_ms - self._t_first_ms
        return count / span_ms * 1e3 if span_ms > 0 else 0.0

    def per_status(self) -> dict:
        """Terminal-status totals (the loadgen replay invariant)."""
        return {SERVED: self.windows_served, REJECTED: self.rejected,
                EXPIRED: self.expired, FAILED: self.failed}

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
            # --- overload control ------------------------------------
            "breaker_states": self.breakers.states(),
            "breaker_trips": self.breakers.trips,
            **({"admit_rate_rps": round(self.overload.admit_rate, 1),
                "shed_admission": self.shed_admission,
                "shed_low_priority": self.shed_low_priority,
                "shed_codel": self.shed_codel,
                "retries_denied": self.retries_denied,
                "codel_dropping": self.overload.dropping,
                "codel_entries": self.overload.codel_entries,
                "aimd_md_events": self.overload.md_events,
                "aimd_ai_events": self.overload.ai_events,
                "retry_tokens": round(self.overload.retry_tokens, 2)}
               if self.overload is not None else {}),
            # --- versioned refresh -----------------------------------
            **self._store.stats(),
            "refresh_runs": self.refresh_runs,
            "refresh_rejected": self.refresh_rejected,
            "refresh_corrupt": self.refresh_corrupt,
            "refresh_timeouts": self.refresh_timeouts,
            "refresh_failed": self.refresh_failed,
            "version_violations": self.version_violations,
            "probe_accuracy": (None if self.last_probe_accuracy is None
                               else round(self.last_probe_accuracy, 4)),
            # --- crash-consistency journal ---------------------------
            **({"journal_records": self.journal.records_appended,
                "journal_syncs": self.journal.syncs,
                "journal_snapshots": self.journal.snapshots_taken,
                "journal_recovered": self.journal_recovered,
                "journal_resume_offset": self.journal_resume_offset,
                "version_reconciliations": self.version_reconciliations,
                "telemetry_dropped": self.degradation_events.dropped
                + self.refresh_events.dropped}
               if self.journal is not None else {}),
            "queue_wait_ms_p50": round(
                self.queue_wait_hist.percentile(50), 3),
            "queue_wait_ms_p99": round(
                self.queue_wait_hist.percentile(99), 3),
            "service_ms_p50": round(self.service_hist.percentile(50), 3),
            "service_ms_p99": round(self.service_hist.percentile(99), 3),
        }
