"""Virtual-clock load runner: open-loop arrivals through the serving
engine, coordinated-omission-correct latency, SLO attainment, and a
max-sustainable-rate sweep.

**Coordinated omission.**  A closed-loop harness that submits request
``i+1`` only after request ``i`` returns silently re-times the arrival
process to the server's convenience: every stall pushes the remaining
arrivals later, so queueing delay never shows up in the numbers.  This
runner is open-loop: every request carries an *intended* arrival
timestamp drawn by :mod:`repro_torch.loadgen.arrivals` before the run
starts, requests are injected into the admission queue as the clock
passes their timestamp, and every latency (queue-wait, service,
end-to-end) is measured **from the intended arrival time** — a backed
up server accrues the backlog it actually caused.

**Clocks.**  The engine reads time through its pluggable clock, so one
runner serves two measurement modes:

* :class:`VirtualClock` — fully deterministic.  Serving a batch
  advances the clock by a :class:`ServiceModel` cost (pure arithmetic
  in batch size and padded window length); idle gaps skip instantly.
  Two runs of the same trace produce bit-identical per-status totals
  and histogram buckets on any host, and equal to the JAX package's
  replay of the same trace — the replay/regression mode.
* :class:`PacedWallClock` — measured.  The virtual timeline advances
  with real ``perf_counter`` time while work is in flight and skips
  idle gaps (no sleeping), so a full wall-clock run of an
  hour-of-traffic trace takes only as long as its busy time.  Latency
  is real, but still charged from intended arrival — the
  throughput-vs-latency mode; on a card the serving kernels' time is
  what the latency holds.

**SLO.**  A request meets its SLO when it is SERVED and its
end-to-end latency (terminal time minus intended arrival) is within
its own ``deadline_ms`` — or the run-level ``slo_ms`` for requests
without one.  Attainment is the fraction of *offered* requests meeting
the SLO, so rejects, expiries, and failures all count against it.

:func:`rate_sweep` bisects the offered rate for the largest one whose
run still clears the attainment floor — the "maximum sustainable
throughput" number heavy-traffic serving work is judged by.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

from repro_torch.loadgen.workload import WorkloadSpec
from repro_torch.serving.snn import SERVED, SNNServingEngine


@dataclasses.dataclass(frozen=True)
class ServiceModel:
    """Deterministic virtual service cost of one serving step: an
    affine model in batch size and padded window length (the two
    launch-shape terms the real kernels scale with)."""
    base_ms: float = 0.25         # fixed dispatch overhead
    per_slot_ms: float = 0.02     # per admitted request
    per_cycle_ms: float = 0.01    # per padded presentation cycle

    def cost_ms(self, batch_size: int, t_pad: int) -> float:
        return (self.base_ms + self.per_slot_ms * batch_size
                + self.per_cycle_ms * t_pad)


class VirtualClock:
    """Deterministic virtual time (ms): advances only via recorded
    service costs and explicit idle skips."""

    def __init__(self, model: ServiceModel | None = None):
        self.model = model if model is not None else ServiceModel()
        self._now = 0.0

    def now_ms(self) -> float:
        return self._now

    def skip_to(self, ts_ms: float) -> None:
        self._now = max(self._now, ts_ms)

    def advance_service_ms(self, batch_size: int, t_pad: int,
                           inflation: float = 1.0) -> None:
        # `inflation` is the fault injector's slowdown multiplier — an
        # overload storm sags modeled capacity without failing launches
        self._now += self.model.cost_ms(batch_size, t_pad) * inflation

    def advance_ms(self, ms: float) -> None:
        """Charge a non-launch delay (retry backoff) to virtual time."""
        self._now += max(0.0, ms)


class PacedWallClock:
    """Wall-measured time on a skippable virtual axis: ``now_ms`` runs
    with ``perf_counter`` while serving, and idle gaps between the last
    completion and the next arrival are skipped, not slept."""

    def __init__(self):
        self._offset = -time.perf_counter() * 1e3   # start at 0 ms

    def now_ms(self) -> float:
        return self._offset + time.perf_counter() * 1e3

    def skip_to(self, ts_ms: float) -> None:
        gap = ts_ms - self.now_ms()
        if gap > 0:
            self._offset += gap

    def advance_service_ms(self, batch_size: int, t_pad: int,
                           inflation: float = 1.0) -> None:
        pass    # wall time advanced by itself during the launch

    def advance_ms(self, ms: float) -> None:
        """Charge a retry-backoff delay to the virtual axis instead of
        sleeping through it — the backoff shows up in latency without
        stalling the harness."""
        self._offset += max(0.0, ms)


def make_clock(mode: str, model: ServiceModel | None = None):
    if mode == "virtual":
        return VirtualClock(model)
    if mode == "wall":
        return PacedWallClock()
    raise ValueError(f"clock mode must be 'virtual' or 'wall', got "
                     f"{mode!r}")


@dataclasses.dataclass
class LoadReport:
    """One load run, summarized.  ``to_dict()`` is JSON-ready; the
    histograms serialize in full so per-commit artifacts can be merged
    or re-quantiled later."""
    n_offered: int
    per_status: dict
    non_terminal: int
    steps: int
    duration_ms: float            # first arrival -> last completion
    offered_rps: float            # arrival-stream rate
    achieved_rps: float           # served / duration
    slo_ms: float
    slo_attainment: float
    goodput_rps: float            # SLO-meeting serves / duration
    slo_attainment_by_priority: dict  # str(priority) -> attainment
    e2e_ms_p50: float
    e2e_ms_p99: float
    e2e_ms_p999: float
    queue_wait_ms_p50: float
    queue_wait_ms_p99: float
    service_hist: dict
    queue_wait_hist: dict

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def summary(self) -> str:
        scalars = {k: v for k, v in self.to_dict().items()
                   if not isinstance(v, dict)}
        status = " ".join(f"{k}={v}" for k, v in
                          sorted(self.per_status.items()))
        return (" ".join(f"{k}={v}" for k, v in sorted(scalars.items()))
                + " " + status)


def _round3(x: float) -> float:
    return round(float(x), 3)


def run_rows(engine: SNNServingEngine, workload: WorkloadSpec,
             rows: list[dict], *, slo_ms: float = 50.0,
             verify_payloads: bool = False, keep_payloads: bool = False,
             max_steps: int = 50_000_000,
             resume_offset: int = 0) -> LoadReport:
    """Drive one engine through one recorded request stream.

    The engine must have been constructed with a loadgen clock
    (:func:`make_clock`).  Its queue is normally empty, but a
    journal-recovered engine may start with re-queued requests (and a
    restored clock) — the loop drains them before the next arrival.
    ``resume_offset`` skips rows a previous (crashed) run already made
    durable: pass ``engine.journal_resume_offset`` so a restarted
    replay continues from the last journaled offset instead of
    re-offering from row 0.  Rows are injected strictly by intended
    timestamp, each request's ``t_submit_ms`` is pre-stamped to that
    timestamp (the coordinated-omission guarantee), and payloads are
    freed as requests terminate unless ``keep_payloads`` — memory stays
    flat at millions of requests.
    """
    clock = engine.clock
    if resume_offset:
        rows = rows[resume_offset:]
    reqs: list = []
    inflight: list = []     # admitted, not yet freed — stays ~queue-sized
    i, n, steps = 0, len(rows), 0
    first_ts = rows[0]["ts"] if rows else 0.0

    def _free(r) -> None:
        r.window = r.intensities = r.counts = None

    while True:
        now = clock.now_ms()
        while i < n and rows[i]["ts"] <= now:
            req = workload.materialize(rows[i], verify=verify_payloads)
            req.t_submit_ms = rows[i]["ts"]
            engine.submit(req)
            reqs.append(req)
            if not keep_payloads:
                if req.terminal:        # structural reject at submit
                    _free(req)
                else:
                    inflight.append(req)
            i += 1
        if engine.queue:
            if steps >= max_steps:
                break
            engine.step()
            steps += 1
            if not keep_payloads:
                live = []
                for r in inflight:
                    if r.terminal:
                        _free(r)
                    else:
                        live.append(r)
                inflight = live
            continue
        if i >= n:
            break
        clock.skip_to(rows[i]["ts"])
    end_ms = clock.now_ms()

    per_status: dict[str, int] = {}
    non_terminal = 0
    slo_met = 0
    prio_offered: dict[str, int] = {}
    prio_met: dict[str, int] = {}
    for r in reqs:
        per_status[r.status] = per_status.get(r.status, 0) + 1
        if not r.terminal:
            non_terminal += 1
        target = r.deadline_ms if r.deadline_ms is not None else slo_ms
        pk = str(r.priority)
        prio_offered[pk] = prio_offered.get(pk, 0) + 1
        if (r.status == SERVED and r.service_ms is not None
                and r.service_ms <= target):
            slo_met += 1
            prio_met[pk] = prio_met.get(pk, 0) + 1
    span_ms = max((rows[-1]["ts"] - first_ts) if n > 1 else 0.0, 1e-6)
    duration_ms = max(end_ms - first_ts, 1e-6)
    served = per_status.get(SERVED, 0)
    return LoadReport(
        n_offered=n,
        per_status=per_status,
        non_terminal=non_terminal,
        steps=steps,
        duration_ms=_round3(duration_ms),
        offered_rps=_round3(n / span_ms * 1e3),
        achieved_rps=_round3(served / duration_ms * 1e3),
        slo_ms=slo_ms,
        slo_attainment=round(slo_met / max(n, 1), 4),
        goodput_rps=_round3(slo_met / duration_ms * 1e3),
        slo_attainment_by_priority={
            pk: round(prio_met.get(pk, 0) / cnt, 4)
            for pk, cnt in sorted(prio_offered.items())},
        e2e_ms_p50=_round3(engine.service_hist.percentile(50)),
        e2e_ms_p99=_round3(engine.service_hist.percentile(99)),
        e2e_ms_p999=_round3(engine.service_hist.percentile(99.9)),
        queue_wait_ms_p50=_round3(engine.queue_wait_hist.percentile(50)),
        queue_wait_ms_p99=_round3(engine.queue_wait_hist.percentile(99)),
        service_hist=engine.service_hist.to_dict(),
        queue_wait_hist=engine.queue_wait_hist.to_dict(),
    )


def rate_sweep(run_at: Callable[[float], LoadReport],
               lo_rps: float, hi_rps: float, *,
               slo_floor: float = 0.95, iters: int = 7
               ) -> tuple[float, LoadReport]:
    """Bisect the largest offered rate whose run clears ``slo_floor``.

    ``run_at(rate)`` must run a fresh engine over a stream offered at
    ``rate`` and return its report.  If even ``lo_rps`` fails the
    floor, returns ``(0.0, that report)``; if ``hi_rps`` passes,
    returns it (the search range was the binding constraint).  The
    returned report is the one measured at the returned rate."""
    rep_lo = run_at(lo_rps)
    if rep_lo.slo_attainment < slo_floor:
        return 0.0, rep_lo
    rep_hi = run_at(hi_rps)
    if rep_hi.slo_attainment >= slo_floor:
        return hi_rps, rep_hi
    best, best_rep = lo_rps, rep_lo
    lo, hi = lo_rps, hi_rps
    for _ in range(iters):
        mid = (lo + hi) / 2.0
        rep = run_at(mid)
        if rep.slo_attainment >= slo_floor:
            best, best_rep, lo = mid, rep, mid
        else:
            hi = mid
    return best, best_rep
