"""Open-loop load-generator CLI for the port's SNN serving engine.

Three verbs over one runner (:func:`repro_torch.loadgen.runner.run_rows`):

* **record** — sample a request stream from seeded arrival + workload
  specs and write it as a replayable trace (``--record PATH``;
  ``--compact`` commits a 50k-request stream as a few hundred bytes,
  pinned by its SHA-256 stream digest).
* **replay** — load a trace (``--trace PATH``) or generate the stream
  in memory, drive the engine open-loop, and report offered vs
  achieved rate, per-status totals, SLO attainment, and
  coordinated-omission-correct latency percentiles.  ``--check`` runs
  the stream twice and exits nonzero unless the per-status totals and
  histogram buckets are bit-identical — the CI replay invariant.
* **sweep** — bisect the maximum offered rate whose run still clears
  ``--slo-floor`` attainment (``--sweep LO HI``).

``--mode virtual`` (default) is fully deterministic: the engine reads
a virtual clock whose serving steps cost a modeled
``base + per_slot*B + per_cycle*T`` ms, so runs are bit-identical on
any host, and equal to the JAX package's ``repro.launch.loadgen`` over
the same stream.  ``--mode wall`` measures real serving time (on a
card: the serving kernels and the host around them) on the same
virtual arrival axis (idle gaps skipped, never slept).  The engine
runs on ``--device`` (``cuda`` unless ``cpu`` asks for the plain
versions).

``--overload`` attaches the adaptive overload controller
(:func:`repro_torch.serving.overload.storm_policy` scaled to the stream's
recorded 1x rate), ``--scale F`` time-compresses a recorded trace to
``F``x its offered rate, and ``--slowdown-p/-factor/-steps`` arm a
seeded service-time-inflation storm — together the replayable overload
experiment.

    python -m repro_torch.launch.loadgen --rate 20000 --n 50000 --check
    python -m repro_torch.launch.loadgen --record traces/smoke.json --compact
    python -m repro_torch.launch.loadgen --trace traces/smoke.json \
        --slo-floor 0.9 --hist-out hist.json
    python -m repro_torch.launch.loadgen --mode wall --sweep 1000 64000
    python -m repro_torch.launch.loadgen \
        --trace benchmarks/traces/overload_50k.json \
        --scale 5 --overload --slowdown-p 0.02 --check --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys


def build_specs(args):
    from repro_torch.loadgen import ArrivalSpec, WorkloadSpec

    arrivals = ArrivalSpec(process=args.process, rate_rps=args.rate,
                           n_requests=args.n, seed=args.seed,
                           burst_factor=args.burst_factor,
                           duty=args.duty, period_ms=args.period_ms)
    deadline_choices = (None,) if args.deadline_mix <= 0.0 \
        else (None, args.deadline_ms)
    deadline_weights = (1,) if args.deadline_mix <= 0.0 else (
        max(1, round(100 * (1 - args.deadline_mix))),
        max(1, round(100 * args.deadline_mix)))
    workload = WorkloadSpec(n_inputs=args.inputs,
                            p_intensity=args.p_intensity,
                            t_choices=tuple(args.t_choices),
                            # one weight per choice: equal to the JAX
                            # CLI's (1, 1, 1) for its three defaults,
                            # and any count of choices is taken
                            t_weights=(1,) * len(args.t_choices),
                            priority_choices=tuple(args.priority_choices),
                            priority_weights=tuple(args.priority_weights),
                            deadline_choices=deadline_choices,
                            deadline_weights=deadline_weights,
                            seed=args.workload_seed)
    return arrivals, workload


def make_engine(args, workload, mode: str):
    from repro_torch.core.stdp import init_weights
    from repro_torch.engine.plan import SNNEnginePlan
    from repro_torch.loadgen.runner import ServiceModel, make_clock
    from repro_torch.serving.snn import SNNServingEngine, SNNServingPolicy

    plan = SNNEnginePlan(threshold=args.threshold, leak=args.leak,
                         n_syn=workload.n_inputs, encode="kernel",
                         cycle_backend="window",
                         max_batch=args.max_batch, t_chunk=args.t_chunk)
    weights = init_weights(args.neurons, workload.words, density_seed=0)
    policy = SNNServingPolicy(max_queue=args.max_queue,
                              deadline_ms=args.queue_deadline_ms)
    clock = make_clock(mode, ServiceModel(
        base_ms=args.model_base_ms, per_slot_ms=args.model_slot_ms,
        per_cycle_ms=args.model_cycle_ms))
    injector = _make_injector(args)
    overload = None
    if getattr(args, "overload", False):
        from repro_torch.serving.overload import storm_policy

        overload = storm_policy(args.overload_base_rps)
    return SNNServingEngine(weights, plan, policy=policy, clock=clock,
                            on_launch=injector, device=args.device,
                            journal_dir=getattr(args, "journal_dir", None),
                            snapshot_every=getattr(args, "snapshot_every",
                                                   256),
                            overload=overload)


def _make_injector(args):
    """A fault injector when a crash point or a slowdown storm is
    armed, else None — a clean run never consults a hook."""
    point = getattr(args, "crash_point", None)
    crash = bool(point) and point != "none"
    slowdown = getattr(args, "slowdown_p", 0.0) > 0.0
    if not crash and not slowdown:
        return None
    from repro_torch.serving.faults import FaultInjector, FaultSpec

    fields = {}
    if crash:
        fields[{"before_dispatch": "p_crash_before_dispatch",
                "after_serve": "p_crash_after_serve_before_journal",
                "mid_snapshot": "p_crash_mid_snapshot"}[point]] = \
            args.crash_p
    if slowdown:
        fields.update(p_slowdown=args.slowdown_p,
                      slowdown_factor=args.slowdown_factor,
                      slowdown_steps=args.slowdown_steps)
    seed = args.crash_seed if crash else getattr(args, "fault_seed", 0)
    return FaultInjector(FaultSpec(seed=seed, **fields))


def run_once(args, workload, rows):
    from repro_torch.loadgen.runner import run_rows

    eng = make_engine(args, workload, args.mode)
    resume = (eng.journal_resume_offset
              if getattr(args, "resume_from_journal", False) else 0)
    if resume:
        print(f"loadgen: resuming from journaled offset {resume} "
              f"({eng.journal_recovered} requests re-queued)")
    rep = run_rows(eng, workload, rows, slo_ms=args.slo_ms,
                   verify_payloads=args.verify_payloads,
                   resume_offset=resume)
    eng.close()
    # cumulative (recovered + this run) engine truth for the chaos
    # harness's cross-restart audit; per-run LoadReport fields only
    # cover the rows offered by this process
    rep.engine_totals = {
        "per_status": eng.per_status(), "submitted": eng.submitted,
        "steps": eng.steps,
        "e2e_ms_p50": round(eng.service_hist.percentile(50), 3),
        "e2e_ms_p99": round(eng.service_hist.percentile(99), 3),
        "e2e_ms_p999": round(eng.service_hist.percentile(99.9), 3),
        "queue_wait_ms_p50": round(eng.queue_wait_hist.percentile(50), 3),
        "queue_wait_ms_p99": round(eng.queue_wait_hist.percentile(99), 3),
    }
    return rep


def build_parser() -> argparse.ArgumentParser:
    """The CLI's arguments (also read by callers that drive
    :func:`make_engine` and :func:`run_once` themselves)."""
    ap = argparse.ArgumentParser(
        description="open-loop load generation against the SNN serving "
                    "engine")
    # stream source
    ap.add_argument("--trace", default=None,
                    help="replay this recorded trace (digest-verified)")
    ap.add_argument("--record", default=None,
                    help="write the generated stream as a trace here "
                         "and exit (no run)")
    ap.add_argument("--compact", action="store_true",
                    help="with --record: header-only generative trace")
    # arrival process (used when no --trace)
    ap.add_argument("--process", default="poisson",
                    choices=["poisson", "uniform", "onoff"])
    ap.add_argument("--rate", type=float, default=20000.0,
                    help="offered rate, requests/s (virtual clock)")
    ap.add_argument("--n", type=int, default=50_000,
                    help="number of requests in the stream")
    ap.add_argument("--seed", type=int, default=42,
                    help="arrival-process seed")
    ap.add_argument("--burst-factor", type=float, default=4.0)
    ap.add_argument("--duty", type=float, default=0.2)
    ap.add_argument("--period-ms", type=float, default=100.0)
    # workload mix (used when no --trace)
    ap.add_argument("--inputs", type=int, default=256)
    ap.add_argument("--p-intensity", type=float, default=1.0)
    ap.add_argument("--t-choices", type=int, nargs="+",
                    default=[8, 12, 16])
    ap.add_argument("--deadline-mix", type=float, default=0.25,
                    help="fraction of requests carrying an explicit "
                         "deadline")
    ap.add_argument("--deadline-ms", type=float, default=40.0)
    ap.add_argument("--priority-choices", type=int, nargs="+",
                    default=[0],
                    help="priority levels in the request mix")
    ap.add_argument("--priority-weights", type=int, nargs="+",
                    default=[1],
                    help="integer weights matching --priority-choices")
    ap.add_argument("--workload-seed", type=int, default=9)
    # engine shape
    ap.add_argument("--neurons", type=int, default=64)
    ap.add_argument("--threshold", type=int, default=192)
    ap.add_argument("--leak", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--t-chunk", type=int, default=8)
    ap.add_argument("--max-queue", type=int, default=4096)
    ap.add_argument("--queue-deadline-ms", type=float, default=200.0,
                    help="engine default deadline for requests without "
                         "one")
    # measurement
    ap.add_argument("--mode", default="virtual",
                    choices=["virtual", "wall"])
    ap.add_argument("--model-base-ms", type=float, default=0.25)
    ap.add_argument("--model-slot-ms", type=float, default=0.02)
    ap.add_argument("--model-cycle-ms", type=float, default=0.01)
    ap.add_argument("--slo-ms", type=float, default=50.0)
    ap.add_argument("--slo-floor", type=float, default=None,
                    help="exit nonzero if SLO attainment falls below "
                         "this")
    ap.add_argument("--check", action="store_true",
                    help="run twice; exit nonzero unless per-status "
                         "totals and histogram buckets are "
                         "bit-identical")
    ap.add_argument("--verify-payloads", action="store_true",
                    help="re-hash every payload during materialization")
    ap.add_argument("--sweep", type=float, nargs=2, default=None,
                    metavar=("LO_RPS", "HI_RPS"),
                    help="bisect max sustainable rate in [LO, HI]")
    ap.add_argument("--sweep-iters", type=int, default=7)
    ap.add_argument("--hist-out", default=None,
                    help="write the run's latency histograms (JSON) "
                         "here")
    # crash-consistency journal
    ap.add_argument("--journal-dir", default=None,
                    help="journal request lifecycle + engine snapshots "
                         "here; construction over an existing dir "
                         "recovers the crashed engine state")
    ap.add_argument("--resume-from-journal", action="store_true",
                    help="continue the trace from the last journaled "
                         "offset instead of re-offering from row 0")
    ap.add_argument("--snapshot-every", type=int, default=256,
                    help="serving steps between journal snapshots "
                         "(0 = only the final close() snapshot)")
    ap.add_argument("--crash-point", default="none",
                    choices=["none", "before_dispatch", "after_serve",
                             "mid_snapshot"],
                    help="arm one seeded whole-process crash point "
                         "(the kill-restart chaos harness's knob)")
    ap.add_argument("--crash-p", type=float, default=0.01,
                    help="per-consult crash probability when armed")
    ap.add_argument("--crash-seed", type=int, default=0,
                    help="crash-draw seed (distinct per restart)")
    ap.add_argument("--report-out", default=None,
                    help="write the full run report (incl. cumulative "
                         "engine totals) as JSON here")
    # overload control + storms
    ap.add_argument("--overload", action="store_true",
                    help="attach the adaptive overload controller "
                         "(storm_policy scaled to --overload-base-rps)")
    ap.add_argument("--overload-base-rps", type=float, default=None,
                    help="the ~sustainable 1x rate the controller is "
                         "scaled to (default: the trace's recorded "
                         "rate, else --rate)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="time-compress the stream: divide every "
                         "arrival timestamp by this factor (5 = the "
                         "same requests at 5x the offered rate)")
    ap.add_argument("--slowdown-p", type=float, default=0.0,
                    help="P[a serving step starts a seeded slowdown "
                         "burst] (service-time inflation storm)")
    ap.add_argument("--slowdown-factor", type=float, default=4.0)
    ap.add_argument("--slowdown-steps", type=int, default=1)
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="fault-injector seed when no crash point is "
                         "armed")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda needs a card; cpu runs the "
                         "plain versions)")
    return ap


def main(argv=None) -> int:
    """Run the CLI; returns the exit status."""
    ap = build_parser()
    args = ap.parse_args(argv)

    from repro_torch.loadgen import generate_rows, read_trace, write_trace
    from repro_torch.loadgen.runner import rate_sweep

    if args.trace is not None:
        header, rows = read_trace(args.trace)
        from repro_torch.loadgen import ArrivalSpec, WorkloadSpec
        arrivals = ArrivalSpec.from_dict(header["arrivals"])
        workload = WorkloadSpec.from_dict(header["workload"])
        print(f"loadgen: trace {args.trace} verified "
              f"({header['n_requests']} requests, "
              f"sha {header['stream_sha256'][:12]}…)")
    else:
        arrivals, workload = build_specs(args)
        rows = None

    if args.record is not None:
        header = write_trace(args.record, arrivals, workload, rows,
                             compact=args.compact)
        print(f"loadgen: recorded {header['n_requests']} requests "
              f"({header['kind']}) -> {args.record} "
              f"sha {header['stream_sha256'][:12]}…")
        return 0

    if rows is None:
        rows = generate_rows(arrivals, workload)
    if args.scale != 1.0:
        from repro_torch.loadgen import scale_rows

        rows = scale_rows(rows, args.scale)
        print(f"loadgen: stream time-compressed {args.scale}x "
              f"(offered rate scaled accordingly)")
    if args.overload and args.overload_base_rps is None:
        # the controller is scaled to the stream's *recorded* 1x rate,
        # not the post---scale offered rate: a 5x storm must descend
        # toward the sustainable rate, not adopt the storm as baseline
        args.overload_base_rps = float(arrivals.rate_rps)

    if args.sweep is not None:
        if args.trace is not None:
            ap.error("--sweep regenerates streams per rate; it cannot "
                     "be combined with --trace")
        import dataclasses

        floor = args.slo_floor if args.slo_floor is not None else 0.95

        def run_at(rate):
            asp = dataclasses.replace(arrivals, rate_rps=rate)
            return run_once(args, workload, generate_rows(asp, workload))

        rate, rep = rate_sweep(run_at, args.sweep[0], args.sweep[1],
                               slo_floor=floor, iters=args.sweep_iters)
        print(f"loadgen-sweep: sustainable_rps={rate:.1f} "
              f"(floor={floor}) " + rep.summary())
        if args.hist_out:
            _dump_hists(args.hist_out, rep)
        return 0 if rate > 0.0 else 1

    rep = run_once(args, workload, rows)
    print("loadgen: " + rep.summary())
    status = 0
    if args.report_out:
        with open(args.report_out, "w") as fh:
            json.dump({**rep.to_dict(),
                       "engine_totals": rep.engine_totals}, fh)
    if args.check:
        rep2 = run_once(args, workload, rows)
        same = (rep.per_status == rep2.per_status
                and rep.service_hist == rep2.service_hist
                and rep.queue_wait_hist == rep2.queue_wait_hist)
        print(f"loadgen-check: replay "
              f"{'bit-identical' if same else 'DIVERGED'}")
        if not same:
            status = 1
    if rep.non_terminal:
        print(f"loadgen: {rep.non_terminal} requests never reached a "
              f"terminal status")
        status = 1
    if args.slo_floor is not None and rep.slo_attainment < args.slo_floor:
        print(f"loadgen: SLO attainment {rep.slo_attainment} below "
              f"floor {args.slo_floor}")
        status = 1
    if args.hist_out:
        _dump_hists(args.hist_out, rep)
    return status


def _dump_hists(path: str, rep) -> None:
    with open(path, "w") as fh:
        json.dump({"service_hist": rep.service_hist,
                   "queue_wait_hist": rep.queue_wait_hist,
                   "slo_attainment": rep.slo_attainment,
                   "offered_rps": rep.offered_rps,
                   "achieved_rps": rep.achieved_rps}, fh)
    print(f"loadgen: histograms -> {path}")


if __name__ == "__main__":
    sys.exit(main())
