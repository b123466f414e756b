"""The port's load harness against the JAX package's.

Arrivals, workload rows, traces and the virtual-clock runner are held
equal to the JAX package's (every comparison exact): the same specs give
the same timestamps, rows, payload bytes and stream digests, a trace
that one package wrote reads in the other, and the first 400 rows of
each committed trace replay through both serving engines (the JAX one on
its ``ref`` ops, the port's plain versions on the CPU) to equal
``LoadReport``s, per-status totals, histogram buckets and ``stats()``
(less the two wall-time keys)."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.stdp import init_weights as jinit_weights
from repro.engine import SNNEnginePlan as JPlan
from repro.loadgen import ArrivalSpec as JArrivals
from repro.loadgen import WorkloadSpec as JWorkload
from repro.loadgen import generate_rows as jgenerate_rows
from repro.loadgen import read_trace as jread_trace
from repro.loadgen import timestamps as jtimestamps
from repro.loadgen import write_trace as jwrite_trace
from repro.loadgen.runner import make_clock as jmake_clock
from repro.loadgen.runner import rate_sweep as jrate_sweep
from repro.loadgen.runner import run_rows as jrun_rows
from repro.serving import FaultInjector as JInjector
from repro.serving import FaultSpec as JSpec
from repro.serving import SNNServingEngine as JServing
from repro.serving import SNNServingPolicy as JPolicy
from repro.serving.overload import storm_policy as jstorm_policy
from repro_torch.core.stdp import init_weights
from repro_torch.engine import SNNEnginePlan
from repro_torch.loadgen import (ArrivalSpec, TraceError, WorkloadSpec,
                                 generate_rows, read_trace, scale_rows,
                                 stream_sha, timestamps, u01, u64, u64_stream,
                                 verify_payloads, write_trace)
from repro_torch.loadgen.runner import (PacedWallClock, VirtualClock,
                                        make_clock, rate_sweep, run_rows)
from repro_torch.serving import (FaultInjector, FaultSpec, SNNRequest,
                                 SNNServingEngine, SNNServingPolicy,
                                 storm_policy)

REPO = Path(__file__).resolve().parents[1]
TRACES = REPO / "benchmarks" / "traces"
WALL_KEYS = ("mean_step_ms", "last_step_ms")
ENV = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")


def _plans(words, port_backend="ref", **kw):
    base = dict(threshold=192, leak=16, n_syn=words * 32, encode="kernel",
                max_batch=32, t_chunk=8, **kw)
    return JPlan(**base), SNNEnginePlan(kernel_backend=port_backend, **base)


def _engines(workload, *, port_backend="ref", overload_rps=None,
             slowdown=False, policy=None):
    """A JAX and a port engine as ``launch/loadgen.py`` builds them."""
    jplan, plan = _plans(workload.words, port_backend)
    pol = policy or dict(max_queue=4096, deadline_ms=200.0)
    spec = dict(p_slowdown=0.02, slowdown_factor=3.0, slowdown_steps=6,
                seed=5)
    jeng = JServing(jinit_weights(64, workload.words, density_seed=0), jplan,
                    policy=JPolicy(**pol), clock=jmake_clock("virtual"),
                    on_launch=JInjector(JSpec(**spec)) if slowdown else None,
                    overload=(jstorm_policy(overload_rps)
                              if overload_rps else None))
    teng = SNNServingEngine(
        init_weights(64, workload.words, density_seed=0), plan,
        policy=SNNServingPolicy(**pol), clock=make_clock("virtual"),
        on_launch=FaultInjector(FaultSpec(**spec)) if slowdown else None,
        overload=storm_policy(overload_rps) if overload_rps else None,
        device="cpu")
    return jeng, teng


def assert_same_engines(jeng, teng):
    """Per-status totals, histogram buckets and every ``stats()`` key
    and value (less the wall-time keys) equal; a port ladder one rung
    longer (the CPU's ``ref`` rung) adds one closed breaker."""
    assert teng.per_status() == jeng.per_status()
    assert teng.service_hist.to_dict() == jeng.service_hist.to_dict()
    assert teng.queue_wait_hist.to_dict() == jeng.queue_wait_hist.to_dict()
    js, ts = jeng.stats(), teng.stats()
    extra = len(ts["breaker_states"]) - len(js["breaker_states"])
    assert extra in (0, 1)
    if extra:
        assert ts["breaker_states"][-1] == "closed"
        ts["breaker_states"] = ts["breaker_states"][:-1]
    for k in WALL_KEYS:
        js.pop(k)
        ts.pop(k)
    assert ts == js


# --- arrivals, rows, traces ------------------------------------------------

def test_counter_hash_and_stream_equal_jax():
    from repro.loadgen import u01 as ju01
    from repro.loadgen import u64 as ju64
    from repro.loadgen import u64_stream as ju64_stream
    for seed, ctr in ((0, (0,)), (123, (5, 7)), (2**40 + 3, (1, 2, 3))):
        assert u64(seed, *ctr) == ju64(seed, *ctr)
        assert u01(seed, *ctr) == ju01(seed, *ctr)
    np.testing.assert_array_equal(u64_stream(99, 257, tag=3),
                                  ju64_stream(99, 257, tag=3))
    assert [int(x) for x in u64_stream(123, 16, 5)] == \
        [u64(123, i, 5) for i in range(16)]


@pytest.mark.parametrize("process", ["poisson", "uniform", "onoff"])
def test_arrivals_and_rows_equal_jax(process):
    kw = dict(process=process, rate_rps=2500.0, n_requests=300, seed=7,
              burst_factor=3.0, duty=0.25)
    wk = dict(n_inputs=96, p_intensity=0.7, t_choices=(5, 9, 16),
              t_weights=(2, 1, 1), priority_choices=(0, 1, 2),
              priority_weights=(5, 3, 1), deadline_choices=(None, 12.5),
              deadline_weights=(3, 1), seed=4)
    assert timestamps(ArrivalSpec(**kw)) == jtimestamps(JArrivals(**kw))
    rows = generate_rows(ArrivalSpec(**kw), WorkloadSpec(**wk))
    assert rows == jgenerate_rows(JArrivals(**kw), JWorkload(**wk))
    for row in rows[:40]:
        np.testing.assert_array_equal(WorkloadSpec(**wk).payload(row),
                                      JWorkload(**wk).payload(row))
    assert {r["kind"] for r in rows} == {"I", "W"}
    assert verify_payloads(WorkloadSpec(**wk), rows) == 300


@pytest.mark.parametrize("name", ["smoke_50k", "overload_50k"])
def test_committed_traces_load_and_verify(name):
    header, rows = read_trace(str(TRACES / f"{name}.json"))
    jheader, jrows = jread_trace(str(TRACES / f"{name}.json"))
    assert header == jheader and rows == jrows
    assert len(rows) == 50_000 and stream_sha(rows) == \
        header["stream_sha256"]
    wl = WorkloadSpec.from_dict(header["workload"])
    assert verify_payloads(wl, rows[:200]) == 200
    req = wl.materialize(rows[3], verify=True)
    assert isinstance(req, SNNRequest) and req.trace_row == rows[3]
    assert req.content_sha == rows[3]["sha"]


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_trace_written_by_one_package_reads_in_the_other(tmp_path, writer,
                                                         compact):
    arr = dict(process="onoff", rate_rps=800.0, n_requests=120, seed=3)
    wk = dict(n_inputs=64, p_intensity=0.5, seed=2)
    jpath, tpath = tmp_path / "j.json", tmp_path / "t.json"
    jwrite_trace(str(jpath), JArrivals(**arr), JWorkload(**wk),
                 compact=compact)
    write_trace(str(tpath), ArrivalSpec(**arr), WorkloadSpec(**wk),
                compact=compact)
    assert jpath.read_bytes() == tpath.read_bytes()
    path = jpath if writer == "jax" else tpath
    read = read_trace if writer == "jax" else jread_trace
    header, rows = read(str(path))
    assert header["kind"] == ("compact" if compact else "full")
    assert rows == generate_rows(ArrivalSpec(**arr), WorkloadSpec(**wk))
    # a tampered trace fails in both packages
    lines = path.read_text().splitlines()
    if compact:
        lines[0] = lines[0].replace('"seed":3', '"seed":4', 1)
    else:
        lines[5] = lines[5].replace('"t":', '"t":1', 1)
    path.write_text("\n".join(lines) + "\n")
    for reader in (read_trace, jread_trace):
        with pytest.raises(ValueError):
            reader(str(path))
    assert issubclass(TraceError, ValueError)


# --- the runner --------------------------------------------------------------

@pytest.mark.parametrize("port_backend", ["ref", "kernel"])
@pytest.mark.parametrize("name,scale,overload", [
    ("smoke_50k", 1.0, False), ("overload_50k", 5.0, True)])
def test_virtual_replay_equals_jax(name, scale, overload, port_backend):
    """The first 400 rows of each committed trace; the overload one at
    5x with the controller and a slowdown storm, as ``--overload
    --scale 5 --slowdown-p 0.02`` runs it."""
    header, rows = read_trace(str(TRACES / f"{name}.json"))
    rows = rows[:400]
    if scale != 1.0:
        rows = scale_rows(rows, scale)
    wl = WorkloadSpec.from_dict(header["workload"])
    base = float(header["arrivals"]["rate_rps"])
    jeng, teng = _engines(wl, port_backend=port_backend,
                          overload_rps=base if overload else None,
                          slowdown=overload)
    jrep = jrun_rows(jeng, JWorkload.from_dict(header["workload"]), rows,
                     slo_ms=50.0)
    trep = run_rows(teng, wl, rows, slo_ms=50.0)
    assert trep.to_dict() == jrep.to_dict()
    assert trep.non_terminal == 0 and trep.per_status.get("SERVED", 0) > 0
    if overload:
        assert trep.per_status.get("REJECTED", 0) > 0
        assert teng.on_launch.slowdowns > 0
    assert_same_engines(jeng, teng)


def test_rate_sweep_equals_jax():
    wl = dict(n_inputs=64, t_choices=(8, 16), t_weights=(1, 1), seed=1)
    pol = dict(max_queue=4096)     # no default deadline: the SLO decides

    def runner(pkg):
        def run_at(rate):
            arr = dict(rate_rps=rate, n_requests=150, seed=2)
            if pkg == "jax":
                rows = jgenerate_rows(JArrivals(**arr), JWorkload(**wl))
                jeng, _ = _engines(JWorkload(**wl), policy=pol)
                return jrun_rows(jeng, JWorkload(**wl), rows, slo_ms=1.0)
            rows = generate_rows(ArrivalSpec(**arr), WorkloadSpec(**wl))
            _, teng = _engines(WorkloadSpec(**wl), policy=pol)
            return run_rows(teng, WorkloadSpec(**wl), rows, slo_ms=1.0)
        return run_at

    jrate, jrep = jrate_sweep(runner("jax"), 1000.0, 200000.0,
                              slo_floor=0.9, iters=4)
    rate, rep = rate_sweep(runner("port"), 1000.0, 200000.0,
                           slo_floor=0.9, iters=4)
    assert rate == jrate and rep.to_dict() == jrep.to_dict()
    assert 1000.0 <= rate < 200000.0


def test_latency_is_charged_from_the_intended_arrival():
    """A request stamped at its arrival behind a backlog accrues the
    queueing it met (coordinated omission), on the virtual clock."""
    _, eng = _engines(WorkloadSpec(n_inputs=64))
    inten = np.full(64, 200, np.uint8)
    for rid in range(40):
        eng.submit(SNNRequest(rid=rid, intensities=inten, n_steps=8,
                              t_submit_ms=0.0))
    while eng.queue:
        eng.step()
    # two batches of 32 and 8, each 0.25 + 0.02 B + 0.01 * 8 ms
    assert eng.clock.now_ms() == pytest.approx(0.97 + 0.49, abs=1e-9)
    assert eng.service_hist.max_ms == pytest.approx(1.46, abs=2e-3)
    assert eng.per_status()["SERVED"] == 40


def test_clocks():
    vc = VirtualClock()
    vc.advance_service_ms(4, 8)
    assert vc.now_ms() == pytest.approx(0.25 + 0.08 + 0.08)
    vc.skip_to(10.0)
    vc.advance_ms(-3.0)
    assert vc.now_ms() == 10.0
    wc = PacedWallClock()
    t0 = wc.now_ms()
    wc.skip_to(t0 + 5_000.0)
    assert wc.now_ms() >= t0 + 5_000.0
    with pytest.raises(ValueError):
        make_clock("sundial")


# --- the CLI -------------------------------------------------------------------

def _cli(module, *args):
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, env=ENV,
                          timeout=300, cwd=REPO)


def test_loadgen_cli_replays_like_jax_on_the_cpu(tmp_path):
    """Record a trace with the port's CLI, then replay it (``--check``,
    with the controller, 3x compressed, a slowdown storm) through both
    CLIs: the printed reports must be equal."""
    trace = tmp_path / "t.json"
    gen = ("--n", "300", "--rate", "15000", "--inputs", "64",
           "--priority-choices", "0", "1", "--priority-weights", "4", "1")
    rec = _cli("repro_torch.launch.loadgen", *gen, "--record", str(trace),
               "--compact", "--device", "cpu")
    assert rec.returncode == 0, rec.stdout + rec.stderr
    replay = ("--trace", str(trace), "--check", "--overload", "--scale",
              "3", "--slowdown-p", "0.05", "--neurons", "20")
    port = _cli("repro_torch.launch.loadgen", *replay, "--device", "cpu")
    jax_run = _cli("repro.launch.loadgen", *replay)
    assert port.returncode == jax_run.returncode == 0, port.stdout
    lines = [ln for ln in port.stdout.splitlines()
             if ln.startswith("loadgen")]
    assert lines == [ln for ln in jax_run.stdout.splitlines()
                     if ln.startswith("loadgen")]
    assert "loadgen-check: replay bit-identical" in lines


def test_entry_points_default_to_cuda():
    """Without ``--device`` both new launchers ask for the card, and
    without one they stop at once rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    for module, args in (
            ("repro_torch.launch.loadgen", ("--n", "10", "--inputs", "64")),
            ("repro_torch.launch.serve", ("--arch", "wenquxing-snn",
                                          "--requests", "2"))):
        proc = _cli(module, *args)
        assert proc.returncode != 0
        assert "no CUDA device" in proc.stderr, proc.stderr
        assert "Traceback" in proc.stderr and "loadgen: " not in proc.stdout


def test_engine_clock_reads_offered_and_achieved_rates():
    _, eng = _engines(WorkloadSpec(n_inputs=64))
    assert eng.offered_rps == eng.achieved_rps == 0.0
    inten = np.full(64, 10, np.uint8)
    for rid in range(10):
        eng.clock.skip_to(rid * 0.5)
        eng.submit(SNNRequest(rid=rid, intensities=inten, n_steps=8,
                              t_submit_ms=rid * 0.5))
        eng.step()
    span = eng._t_last_ms - eng._t_first_ms
    assert eng.offered_rps == pytest.approx(10 / span * 1e3)
    assert eng.achieved_rps == eng.offered_rps
    assert dataclasses.asdict(eng.policy)["retry_backoff_ms"] == 0.0


def test_paper_width_workload_rows_and_recovery(tmp_path):
    """784 inputs (25 words, the last 16 lanes silent), which the JAX
    package's spec refuses: rows carry the width as ``n_in``, window
    payloads keep the tail lanes at 0, the payloads serve, and a
    journaled engine recovers such a row from its seeds."""
    wl = WorkloadSpec(n_inputs=784, p_intensity=0.5, t_choices=(8,),
                      t_weights=(1,), seed=6)
    rows = generate_rows(ArrivalSpec(rate_rps=5000.0, n_requests=40,
                                     seed=1), wl)
    assert wl.words == 25 and all(r["n_in"] == 784 for r in rows)
    assert verify_payloads(wl, rows) == 40
    for r in rows:
        p = wl.payload(r)
        if r["kind"] == "W":
            assert p.shape == (8, 25) and not (p[:, -1] >> 16).any()
        else:
            assert p.shape == (784,)
    with pytest.raises(ValueError):
        JWorkload(n_inputs=784)
    jdir = str(tmp_path / "j")
    plan = SNNEnginePlan(threshold=192, leak=16, w_exp=None, n_syn=784,
                         encode="kernel", max_batch=8)

    class Killed(Exception):
        pass

    def die(kind):
        raise Killed(kind)
    eng = SNNServingEngine(
        init_weights(40, 25, density_seed=0), plan,
        clock=make_clock("virtual"), journal_dir=jdir, device="cpu",
        on_launch=FaultInjector(FaultSpec(
            p_crash_after_serve_before_journal=1.0), crash_hook=die))
    with pytest.raises(Killed):
        run_rows(eng, wl, rows, verify_payloads=True)
    eng.journal.abandon()           # killed with its first batch served
    eng2 = SNNServingEngine(init_weights(40, 25, density_seed=0), plan,
                            clock=make_clock("virtual"), journal_dir=jdir,
                            device="cpu")
    assert eng2.journal_recovered == len(eng2.queue) > 0
    for r in eng2.queue:            # re-materialized at 784 lanes
        assert r.trace_row["n_in"] == 784
        assert r.window is not None or r.intensities.shape == (784,)
    rep = run_rows(eng2, wl, rows, resume_offset=eng2.journal_resume_offset)
    eng2.close()
    assert rep.non_terminal == 0
    assert eng2.per_status()["SERVED"] == 40
