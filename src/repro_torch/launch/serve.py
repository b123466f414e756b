"""Serving demos and harnesses on the port's engines.

    python -m repro_torch.launch.serve --arch wenquxing-snn [--device cpu]
    python -m repro_torch.launch.serve --arch wenquxing-snn --inject-faults
    python -m repro_torch.launch.serve --arch wenquxing-snn \\
        --refresh-every 2 --state-dir DIR
    python -m repro_torch.launch.serve --arch wenquxing-snn --chaos
    python -m repro_torch.launch.serve --arch wenquxing-snn --overload-storm
    python -m repro_torch.launch.serve --arch gemma3-1b [--device cpu]
    python -m repro_torch.launch.serve --arch gemma3-1b --no-reduced
    python -m repro_torch.launch.serve --arch mixtral-8x22b --device cpu

wenquxing-snn: intensity-resident digit requests with ragged window
lengths go through the dynamic-window-batching :class:`SNNServingEngine`;
every SERVED count vector is then checked against the plain version of
the pre-packed path on the host-encoded window, under the weights of
the version that served it.  ``--inject-faults`` serves the same traffic
under a seeded fault storm, ``--refresh-every`` turns on probe-gated
train-while-serving (with ``--state-dir``, checkpointed versions),
``--chaos`` runs the kill-restart harness over a load trace and
``--overload-storm`` the replayable overload smoke.  Exits nonzero if a
request did not terminate, a count diverged, or a harness found a
violation.

An LM config (any of ``list_configs()``): a few short prompts through
the continuous-batching :class:`ServingEngine`, greedy, with random
weights from a seed; whisper's encoder-decoder and internvl2's vision
prefix go through ``Model.prefill``/``decode_step``, one prompt at a
time, with stub frames or patches drawn from a seed.
``--reduced`` (the default) serves the config's reduced form in float32
(``attn_chunk=16``, ``max_len=128``), as the JAX launcher does;
``--no-reduced`` serves the full width in bfloat16.  Exits nonzero if a
request did not finish.

Everything runs on ``--device`` (``cuda`` unless ``cpu`` asks for the
plain versions).

``make_serve_step`` / ``make_prefill_step`` build the decode and prefill
steps the dry run traces (``repro_torch.launch.dryrun``), as the JAX
package's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.base import get_config, list_configs, reduced
from repro_torch.configs.wenquxing_snn import WENQUXING_22A
from repro_torch.core.encoder import encode_windows_host, quantize_intensities
from repro_torch.core.stdp import init_weights
from repro_torch.data.digits import make_digits
from repro_torch.engine import plan_from_config
from repro_torch.engine.plan import SNNEnginePlan
from repro_torch.kernels import ops
from repro_torch.loadgen import WorkloadSpec, read_trace, scale_rows
from repro_torch.loadgen.runner import ServiceModel, VirtualClock, run_rows
from repro_torch.models.transformer import Model
from repro_torch.serving import (CRASH_EXIT_CODE, FaultInjector, FaultSpec,
                                 Request, RequestJournal, ServingEngine,
                                 SNNRefreshPolicy, SNNRequest,
                                 SNNServingEngine, SNNServingPolicy,
                                 SNNWeightRefresher)
from repro_torch.serving.overload import storm_policy

SRC = Path(__file__).resolve().parents[2]
TRACES = SRC.parent / "benchmarks" / "traces"


def make_serve_step(model: Model):
    """decode: ``serve_step(params, tokens [B, 1], cache, cache_len) ->
    (logits [B, Vp], cache')``, the JAX package's signature: ``params``
    (a flat dict of named tensors, plain or DTensors) are bound to the
    model first (``launch.train.bind_params``), the cache written in
    place."""
    from repro_torch.launch.train import bind_params

    def serve_step(params, tokens, cache, cache_len):
        bind_params(model, params)
        return model.decode_step(tokens, cache, cache_len)

    return serve_step


def make_prefill_step(model: Model, max_len: int):
    """prefill: ``prefill_step(params, batch) -> (last logits, cache,
    cache_len)``; ``batch`` holds ``tokens`` and, where the config takes
    them, ``frames`` / ``patches``."""
    from repro_torch.launch.train import bind_params

    def prefill_step(params, batch):
        bind_params(model, params)
        return model.prefill(batch["tokens"], max_len,
                             frames=batch.get("frames"),
                             patches=batch.get("patches"))

    return prefill_step


def _serve_snn(args) -> int:
    """Serve ``--requests`` digits and check them; returns the exit code.

    ``--inject-faults`` runs the same traffic under a seeded fault storm
    (launch failures, corrupted counts, zero-deadline requests; with a
    refresher also corrupt and stalled refreshes and crashes mid-save):
    every request must still terminate and every SERVED count stay
    bit-exact with the plain version.  ``--refresh-every N`` runs a
    probe-gated STDP refresh every N serving steps; a version audit then
    fails the run if any request was served from a version that was
    never promoted, and a clean (fault-free) refresh run must end with a
    probe accuracy above the seed bank's."""
    cfg = dataclasses.replace(WENQUXING_22A, n_steps=24,
                              encode=args.encode)
    plan = dataclasses.replace(plan_from_config(cfg),
                               max_batch=args.slots)
    weights = init_weights(cfg.n_neurons, cfg.words, dense=True)
    neuron_class = np.tile(np.arange(cfg.n_classes), cfg.n_blocks)
    imgs, _ = make_digits(args.requests, seed=0)
    inten = quantize_intensities(imgs).numpy()
    policy = SNNServingPolicy(max_retries=2, canary_every=2,
                              reprobe_after=4)
    refresher = None
    if args.refresh_every > 0:
        # labeled refresh stream + held-out probe set, disjoint from
        # the request traffic (different render seeds)
        ref_imgs, ref_labels = make_digits(
            max(args.refresh_samples * 4, args.refresh_samples), seed=1)
        probe_imgs, probe_labels = make_digits(args.probe_size, seed=2)
        refresher = SNNWeightRefresher(
            plan, quantize_intensities(ref_imgs).numpy(), ref_labels,
            n_classes=cfg.n_classes,
            probe_intensities=quantize_intensities(probe_imgs).numpy(),
            probe_labels=probe_labels, neuron_class=neuron_class,
            n_steps=cfg.n_steps, teach_pos=cfg.teach_pos,
            teach_neg=cfg.teach_neg,
            policy=SNNRefreshPolicy(
                refresh_every=args.refresh_every,
                probe_size=args.probe_size,
                refresh_samples=args.refresh_samples),
            device=args.device)
    injector = None
    if args.inject_faults:
        refresh_faults = {}
        if refresher is not None:
            refresh_faults = dict(p_refresh_corrupt=0.4,
                                  p_refresh_stall=0.2,
                                  refresh_stall_ms=1.0,
                                  p_save_crash=0.3)
        injector = FaultInjector(FaultSpec(
            p_launch_error=0.4, p_corrupt=0.4,
            error_burst=policy.max_retries + 2, seed=args.fault_seed,
            **refresh_faults))
    reqs = []
    for i in range(args.requests):
        # under a fault storm, every 5th request carries an already-
        # elapsed deadline so the EXPIRED path is exercised too
        ddl = 0.0 if (args.inject_faults and i % 5 == 4) else None
        reqs.append(SNNRequest(rid=i, intensities=inten[i],
                               n_steps=cfg.n_steps - 4 * (i % 3),
                               deadline_ms=ddl))
    eng = SNNServingEngine(weights, plan, neuron_class=neuron_class,
                           policy=policy, on_launch=injector,
                           refresher=refresher, state_dir=args.state_dir,
                           keep_versions=64, device=args.device)
    eng.run(reqs)
    print(f"wenquxing-snn: {sum(r.done for r in reqs)}/{len(reqs)} done, "
          f"{eng.windows_served} windows in {eng.batches} batches "
          f"(max_batch={plan.max_batch}, encode={plan.encode}, "
          f"device={eng.device})")
    by_status = Counter(r.status for r in reqs)
    non_terminal = sum(not r.terminal for r in reqs)
    print("statuses: " + " ".join(f"{k}={v}"
                                  for k, v in sorted(by_status.items()))
          + f" non-terminal={non_terminal}")
    print(f"throughput: offered_rps={eng.offered_rps:.1f} "
          f"achieved_rps={eng.achieved_rps:.1f} "
          f"(submitted={eng.submitted} served={eng.windows_served})")
    served = [r for r in reqs if r.status == "SERVED"]
    mismatches = 0
    for r in served:
        # the oracle uses the weights of the version that served the
        # request — frozen serving pins everything to version 0
        ver = eng.store.get(r.served_version)
        if ver is None:
            mismatches += 1     # unattributable response
            continue
        win = encode_windows_host(r.seed,
                                  torch.from_numpy(r.intensities)[None],
                                  r.n_steps, eng.words)
        want = ops.infer_window_batch(ver.weights.cpu(), win,
                                      threshold=plan.threshold,
                                      leak=plan.leak, backend="ref")[0]
        mismatches += int(not np.array_equal(r.counts, want.numpy()))
    print(f"oracle-check: {'ok' if mismatches == 0 else 'MISMATCH'} "
          f"({len(served)} served, {mismatches} diverged)")
    # version audit: every served response attributable to a version
    # promoted at serve time
    stats = eng.stats()
    version_bad = stats["version_violations"] + sum(
        r.served_version not in eng.store.promoted_order for r in served)
    gain_bad = 0
    if refresher is not None:
        acc_seed = refresher.probe(weights)
        acc_final = refresher.probe(eng.weights)
        print(f"refresh-gain: probe_seed={acc_seed:.4f} "
              f"probe_final={acc_final:.4f} "
              f"version={stats['weight_version']} "
              f"promoted={stats['versions_promoted']} "
              f"rejected={stats['versions_rejected']} "
              f"rollbacks={stats['rollbacks']} "
              f"version-audit={'ok' if version_bad == 0 else 'VIOLATION'}")
        if not args.inject_faults:
            gain_bad = int(acc_final <= acc_seed)
    if args.bench:
        stats["padded_slot_waste"] = round(stats["padded_slot_waste"], 4)
        if injector is not None:
            stats.update(injector.stats())
        print("serve-bench: " + " ".join(
            # list-valued stats (breaker states) join without spaces so
            # the k=v line stays whitespace-splittable
            f"{k}={'/'.join(map(str, v)) if isinstance(v, list) else v}"
            for k, v in sorted(stats.items())))
    return int(bool(non_terminal or mismatches or version_bad or gain_bad))


def _chaos_snn(args) -> int:
    """Seeded kill–restart chaos harness for the crash-consistent SNN
    serving engine.

    Drives the committed loadgen trace through a journaled engine in a
    *subprocess*, arming one whole-process crash point per restart
    (rotating ``before_dispatch`` → ``after_serve`` → ``mid_snapshot``,
    so every injection site is exercised).  A crashing child dies via
    ``os._exit(73)`` — user-space journal buffers lost, fsync'd records
    kept — and the harness restarts it with ``--resume-from-journal``
    until, after ``--chaos-crashes`` induced crashes, a clean child
    completes the trace.  A crash-free journal-less reference run over
    the same trace (same virtual clock, same seeds) then defines
    ground truth, and the audit asserts:

    * every offered request has exactly one terminal-ledger entry
      (zero lost ADMITs, zero duplicates — rids cover 0..n-1 once);
    * zero duplicate SERVEs by payload content hash;
    * every SERVED entry is attributable to a weight version;
    * the recovered engine's cumulative per-status totals and latency
      histogram percentiles are bit-identical to the crash-free
      replay.  (``steps`` may legitimately exceed the reference by up
      to one re-dispatched batch per crash and is not compared.)

    Every child runs on ``--device``.  Returns nonzero on any
    violation.
    """

    trace = args.trace or str(TRACES / "smoke_50k.json")
    header, _ = read_trace(trace)
    n = header["n_requests"]
    workdir = args.state_dir or tempfile.mkdtemp(prefix="snn-chaos-")
    jdir = os.path.join(workdir, "journal")
    report = os.path.join(workdir, "report.json")
    ref_report = os.path.join(workdir, "reference.json")
    base = [sys.executable, "-m", "repro_torch.launch.loadgen",
            "--trace", trace, "--mode", "virtual", "--device", args.device]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(SRC), os.environ.get("PYTHONPATH")) if p))
    # per-consult crash probabilities: dispatch/serve points are
    # consulted every step, mid_snapshot only once per snapshot — its
    # p must be much higher to fire before the trace drains
    points = [("before_dispatch", 0.02), ("after_serve", 0.02),
              ("mid_snapshot", 0.5)]
    crashes, restart = 0, 0
    max_restarts = args.chaos_crashes + 10
    while True:
        point, crash_p = (points[restart % len(points)]
                          if crashes < args.chaos_crashes
                          else ("none", 0.0))
        cmd = base + ["--journal-dir", jdir, "--resume-from-journal",
                      "--snapshot-every", "16", "--report-out", report]
        if point != "none":
            cmd += ["--crash-point", point, "--crash-p", str(crash_p),
                    "--crash-seed",
                    str(args.chaos_seed * 1000 + restart)]
        rc = subprocess.run(cmd, env=env).returncode
        if rc == CRASH_EXIT_CODE:
            crashes += 1
            restart += 1
            print(f"chaos: induced crash #{crashes} at point "
                  f"'{point}' (restart {restart})")
            if restart > max_restarts:
                print("chaos: FAIL — restart budget exhausted")
                return 1
            continue
        if rc != 0:
            print(f"chaos: FAIL — child exited {rc} (not a crash)")
            return 1
        break
    print(f"chaos: trace complete after {crashes} induced crashes / "
          f"{restart} restarts")
    subprocess.run(base + ["--report-out", ref_report], check=True,
                   stdout=subprocess.DEVNULL, env=env)

    # --- audit ----------------------------------------------------------
    violations = []
    ledger = RequestJournal(jdir).read_ledger()
    rids = [r["rid"] for r in ledger]
    if len(rids) != len(set(rids)):
        violations.append(f"duplicate terminal-ledger entries: "
                          f"{len(rids) - len(set(rids))}")
    if set(rids) != set(range(n)):
        lost = sorted(set(range(n)) - set(rids))[:10]
        extra = sorted(set(rids) - set(range(n)))[:10]
        violations.append(f"ledger does not cover 0..{n - 1} exactly "
                          f"(lost={lost} extra={extra})")
    served = [r for r in ledger if r["st"] == "SERVED"]
    shas = [r["sha"] for r in served if r.get("sha")]
    if len(shas) != len(set(shas)):
        violations.append("duplicate SERVEs by content hash")
    unattributed = sum(r.get("ver") is None for r in served)
    if unattributed:
        violations.append(f"{unattributed} SERVEs not attributable to "
                          f"a weight version")
    ledger_status: dict = {}
    for r in ledger:
        ledger_status[r["st"]] = ledger_status.get(r["st"], 0) + 1
    with open(report) as fh:
        chaos_totals = json.load(fh)["engine_totals"]
    with open(ref_report) as fh:
        ref_totals = json.load(fh)["engine_totals"]

    def _nonzero(d):
        return {k: v for k, v in d.items() if v}

    if ledger_status != _nonzero(ref_totals["per_status"]):
        violations.append(f"ledger per-status {ledger_status} != "
                          f"crash-free {ref_totals['per_status']}")
    for key in ("per_status", "submitted", "e2e_ms_p50", "e2e_ms_p99",
                "e2e_ms_p999", "queue_wait_ms_p50", "queue_wait_ms_p99"):
        if chaos_totals[key] != ref_totals[key]:
            violations.append(f"recovered {key}={chaos_totals[key]} != "
                              f"crash-free {ref_totals[key]}")
    if crashes < args.chaos_crashes:
        violations.append(f"only {crashes} crashes induced "
                          f"(wanted {args.chaos_crashes})")
    print(f"chaos-audit: n={n} ledger={len(ledger)} "
          f"served={len(served)} statuses="
          + " ".join(f"{k}={v}" for k, v in sorted(ledger_status.items())))
    if violations:
        for v in violations:
            print(f"chaos-audit: VIOLATION — {v}")
        return 1
    print("chaos-audit: ok — every request terminal exactly once, "
          "zero lost admits, zero duplicate serves, counters match "
          "crash-free replay")
    return 0


def _overload_storm_snn(args) -> int:
    """Replayable overload-storm smoke for the adaptive overload
    controller.

    Replays the committed priority-mixed trace
    (``benchmarks/traces/overload_50k.json``) three times on the
    virtual clock, every run with :func:`storm_policy` attached and a
    seeded service-time-inflation storm (``--overload-seed``): once at
    the recorded 1x rate (the capacity-sagged goodput anchor) and
    twice time-compressed to ``--overload-scale`` x (the storm, run
    twice to prove bit-identical replay).  Exits nonzero when any of
    the robustness contract fails:

    * any request non-terminal in any run;
    * storm goodput below 80% of the 1x anchor (metastable collapse);
    * high-priority SLO attainment below 0.95 under the storm
      (shedding leaked onto the protected class);
    * the two same-seed storm runs diverge anywhere in the report or
      the overload counters (lost determinism).

    Every run serves on ``--device``.  Returns nonzero on a violation.
    """

    trace = args.trace or str(TRACES / "overload_50k.json")
    header, rows = read_trace(trace)
    workload = WorkloadSpec.from_dict(header["workload"])
    base_rps = float(header["arrivals"]["rate_rps"])

    def run_once(scale: float):
        plan = SNNEnginePlan(threshold=192, leak=16,
                             n_syn=workload.n_inputs, encode="kernel",
                             cycle_backend="window", max_batch=32,
                             t_chunk=8)
        weights = init_weights(64, workload.words, density_seed=0)
        eng = SNNServingEngine(
            weights, plan,
            policy=SNNServingPolicy(max_queue=4096, deadline_ms=200.0),
            clock=VirtualClock(ServiceModel()),
            on_launch=FaultInjector(FaultSpec(
                p_slowdown=0.02, slowdown_factor=3.0, slowdown_steps=6,
                seed=args.overload_seed)),
            overload=storm_policy(base_rps), device=args.device)
        r = rows if scale == 1.0 else scale_rows(rows, scale)
        rep = run_rows(eng, workload, r, slo_ms=50.0)
        keys = ("shed_admission", "shed_low_priority", "shed_codel",
                "retries_denied", "admit_rate_rps", "codel_entries",
                "aimd_md_events", "aimd_ai_events", "breaker_trips")
        return rep, {k: eng.stats()[k] for k in keys}

    rep1, _ = run_once(1.0)
    rep5a, st5a = run_once(args.overload_scale)
    rep5b, st5b = run_once(args.overload_scale)
    high = rep5a.slo_attainment_by_priority.get("1", 0.0)
    retention = (rep5a.goodput_rps / rep1.goodput_rps
                 if rep1.goodput_rps else 0.0)
    print(f"overload-storm: seed={args.overload_seed} "
          f"scale={args.overload_scale:g}x base={base_rps:.0f}rps")
    print(f"  1x anchor: goodput={rep1.goodput_rps:.0f}rps "
          f"high_slo={rep1.slo_attainment_by_priority.get('1', 0.0)}")
    print(f"  storm:     goodput={rep5a.goodput_rps:.0f}rps "
          f"(retention {retention:.3f}) high_slo={high} "
          f"shed={st5a['shed_admission']}+{st5a['shed_low_priority']}"
          f"+{st5a['shed_codel']}")
    violations = []
    for label, rep in (("1x", rep1), ("storm-a", rep5a),
                       ("storm-b", rep5b)):
        if rep.non_terminal:
            violations.append(f"{label}: {rep.non_terminal} "
                              f"non-terminal requests")
    if retention < 0.8:
        violations.append(f"goodput collapsed: storm retains "
                          f"{retention:.3f} of the 1x anchor (< 0.8)")
    if high < 0.95:
        violations.append(f"high-priority SLO attainment {high} "
                          f"under the storm (< 0.95)")
    if rep5a.to_dict() != rep5b.to_dict() or st5a != st5b:
        violations.append("same-seed storm runs diverged "
                          "(determinism lost)")
    if violations:
        for v in violations:
            print(f"overload-storm: VIOLATION — {v}")
        return 1
    print("overload-storm: ok — every request terminal, goodput held, "
          "high-priority SLO protected, replay bit-identical")
    return 0


def _serve_with_frontend(model: Model, prompts: list[list[int]],
                         max_new: int, max_len: int) -> tuple[int, int]:
    """Greedy decoding of each prompt through ``Model.prefill`` and
    ``decode_step`` (the engine serves decoder-only archs), with stub
    front-end embeddings drawn from a seed: whisper's frames, internvl2's
    patches.  Returns (requests done, tokens made)."""
    cfg = model.cfg
    gen = torch.Generator(device=model.device).manual_seed(0)
    key = "frames" if cfg.is_enc_dec else "patches"
    done = tokens = 0
    with torch.inference_mode():
        for prompt in prompts:
            front = torch.randn((1, cfg.frontend_len, cfg.d_model),
                                generator=gen, device=model.device)
            logits, cache, clen = model.prefill(
                torch.tensor([prompt]), max_len, **{key: front})
            out = [int(logits.argmax())]
            while len(out) < max_new:
                logits, cache = model.decode_step(
                    torch.tensor([[out[-1]]]), cache, clen)
                clen += 1
                out.append(int(logits.argmax()))
            done += len(out) == max_new
            tokens += len(out)
    return done, tokens


def _serve_lm(args) -> int:
    """Serve ``--requests`` short prompts; returns the exit code."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
        model = Model(cfg, torch.float32, attn_chunk=16, device=args.device)
    else:
        model = Model(cfg, device=args.device)
    ops.reset_launch_counts()
    prompts = [[1 + i, 2, 3] for i in range(args.requests)]
    if cfg.frontend is None:
        eng = ServingEngine(model, n_slots=args.slots, max_len=128)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=args.max_new)
                for i, p in enumerate(prompts)]
        eng.run(reqs, max_steps=2000)
        done, tokens = sum(r.done for r in reqs), eng.tokens_out
    else:
        prefix = cfg.frontend_len if cfg.frontend == "vision" else 0
        done, tokens = _serve_with_frontend(model, prompts, args.max_new,
                                            128 + prefix)
    print(f"{cfg.name}: {done}/{len(prompts)} done, {tokens} tokens "
          f"(device={model.device}, dtype={model.dtype}, flash_attention "
          f"launches {ops.launch_counts()['flash_attention']})")
    return int(done != len(prompts))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True,
                    choices=["wenquxing-snn"] + list_configs())
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=8,
                    help="tokens generated per LM request")
    ap.add_argument("--encode", default="kernel", choices=["host", "kernel"],
                    help="where the Poisson encode runs (wenquxing-snn)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda needs a card; cpu runs the "
                         "plain versions)")
    ap.add_argument("--bench", action="store_true",
                    help="print the serving stats after the run "
                         "(wenquxing-snn)")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the LM config's reduced form in float32 "
                         "(--no-reduced: full width in bfloat16)")
    ap.add_argument("--inject-faults", action="store_true",
                    help="run the SNN serve under a seeded fault storm "
                         "(launch failures, corrupted counts, expired "
                         "deadlines) to exercise retry/degradation")
    ap.add_argument("--fault-seed", type=int, default=7,
                    help="FaultInjector seed (storms replay exactly)")
    ap.add_argument("--refresh-every", type=int, default=0,
                    help="SNN train-while-serving: run one probe-gated "
                         "STDP refresh every N serving steps (0 = "
                         "frozen weights)")
    ap.add_argument("--probe-size", type=int, default=32,
                    help="held-out probe samples gating each refresh "
                         "promotion")
    ap.add_argument("--refresh-samples", type=int, default=32,
                    help="labeled samples trained per refresh cycle")
    ap.add_argument("--state-dir", default=None,
                    help="persist promoted weight versions here "
                         "(atomic checkpoints; restart restores the "
                         "newest complete version)")
    ap.add_argument("--chaos", action="store_true",
                    help="kill-restart chaos harness: drive --trace "
                         "through a journaled subprocess engine with "
                         "seeded induced crashes, restart-resume it, "
                         "and audit exactly-once terminal accounting "
                         "(wenquxing-snn only)")
    ap.add_argument("--chaos-seed", type=int, default=1,
                    help="seed for the induced-crash draws")
    ap.add_argument("--chaos-crashes", type=int, default=3,
                    help="induced crashes before the clean final run "
                         "(rotates through the 3 injection points)")
    ap.add_argument("--trace", default=None,
                    help="loadgen trace the chaos/overload harnesses "
                         "replay (defaults: smoke_50k.json for chaos, "
                         "overload_50k.json for the overload storm)")
    ap.add_argument("--overload-storm", action="store_true",
                    help="replayable overload smoke: storm_policy + "
                         "seeded service-time inflation over the "
                         "committed trace at 1x and --overload-scale x, "
                         "run twice for bit-identical replay; exits "
                         "nonzero on goodput collapse, high-priority "
                         "SLO loss, non-terminal requests, or "
                         "divergence (wenquxing-snn only)")
    ap.add_argument("--overload-seed", type=int, default=5,
                    help="seed for the overload storm's service-time "
                         "inflation draws")
    ap.add_argument("--overload-scale", type=float, default=5.0,
                    help="time-compression factor for the storm runs")
    args = ap.parse_args(argv)
    if args.arch == "wenquxing-snn":
        if args.overload_storm:
            sys.exit(_overload_storm_snn(args))
        if args.chaos:
            sys.exit(_chaos_snn(args))
        sys.exit(_serve_snn(args))
    sys.exit(_serve_lm(args))


if __name__ == "__main__":
    main()
