"""The port's overload control against the JAX package's.

The controller is driven call for call beside the JAX one (every float
that decides admission — the token bucket, AIMD, the RED draw, CoDel's
``interval / sqrt(n)`` law, the retry bucket — must come out equal, so
the whole state dict is compared after every call), then both serving
engines run the same priority-mixed overload stream on the virtual
clock with the controller attached: ``LoadReport``s, statuses, shed tags,
``per_status()``, histogram buckets and every ``stats()`` key and value
(less the two wall-time keys) must be equal.  Every comparison is
exact."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core.stdp import init_weights as jinit_weights
from repro.engine import SNNEnginePlan as JPlan
from repro.loadgen import ArrivalSpec as JArrivals
from repro.loadgen import WorkloadSpec as JWorkload
from repro.loadgen import generate_rows as jgenerate_rows
from repro.loadgen.runner import ServiceModel as JModel
from repro.loadgen.runner import VirtualClock as JClock
from repro.loadgen.runner import run_rows as jrun_rows
from repro.serving import FaultInjector as JInjector
from repro.serving import FaultSpec as JSpec
from repro.serving import SNNRequest as JRequest
from repro.serving import SNNServingEngine as JServing
from repro.serving import SNNServingPolicy as JPolicy
from repro.serving.overload import LadderBreakers as JBreakers
from repro.serving.overload import OverloadController as JController
from repro.serving.overload import OverloadPolicy as JOverload
from repro.serving.overload import storm_policy as jstorm_policy
from repro_torch.core.stdp import init_weights
from repro_torch.engine import SNNEnginePlan
from repro_torch.loadgen import (ArrivalSpec, WorkloadSpec, generate_rows,
                                 scale_rows)
from repro_torch.loadgen.runner import ServiceModel, VirtualClock, run_rows
from repro_torch.serving import (FaultInjector, FaultSpec, LadderBreakers,
                                 OverloadController, OverloadPolicy,
                                 SNNRequest, SNNServingEngine,
                                 SNNServingPolicy, storm_policy)
from repro_torch.serving.overload import CLOSED, HALF_OPEN, OPEN

REPO = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
N_NEURONS, N_INPUTS = 32, 256
WALL_KEYS = ("mean_step_ms", "last_step_ms")


# --- the controller alone ----------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_controller_decides_like_jax_call_for_call(seed):
    pol = dict(slo_ms=20.0, target_sojourn_ms=3.0, interval_ms=7.0,
               admit_rps_init=3000.0, admit_rps_min=200.0,
               admit_rps_max=9000.0, additive_rps=700.0, burst=12.0,
               high_reserve=2.0, low_shed_start=0.2, low_shed_full=0.7,
               retry_budget=3.0, retry_refill_per_s=90.0, seed=seed + 5)
    jc, tc = JController(JOverload(**pol)), OverloadController(
        OverloadPolicy(**pol))
    rng = np.random.default_rng(seed)
    now = 0.0
    for _ in range(3000):
        now += float(rng.exponential(0.3))
        op = rng.integers(4)
        if op == 0:
            args = (int(rng.integers(3)), int(rng.integers(40)), 40, now)
            assert tc.admit(*args) == jc.admit(*args)
        elif op == 1:
            args = (float(rng.exponential(4.0)), now, int(rng.integers(30)))
            assert tc.on_dequeue(*args) == jc.on_dequeue(*args)
        elif op == 2:
            lat = float(rng.exponential(15.0))
            tc.note_served(lat)
            jc.note_served(lat)
        else:
            assert tc.grant_retry(now) == jc.grant_retry(now)
        assert tc.state_dict() == jc.state_dict()
    for i in range(40):         # a standing queue: CoDel's sqrt law
        now += 0.5
        args = (10.0 + i, now, 50)
        assert tc.on_dequeue(*args) == jc.on_dequeue(*args)
        assert tc.state_dict() == jc.state_dict()
    st = tc.state_dict()
    assert st["md_events"] and st["ai_events"] and st["codel_entries"]
    assert st["drop_count"] > 1 and st["dropping"]


def test_controller_state_crosses_packages():
    jc = JController(JOverload(admit_rps_init=5000.0))
    jc.admit(0, 10, 100, now_ms=3.0)
    jc.on_dequeue(50.0, 4.0, 10)
    jc.grant_retry(5.0)
    tc = OverloadController(OverloadPolicy(admit_rps_init=5000.0))
    tc.load_state(json.loads(json.dumps(jc.state_dict())))
    assert tc.state_dict() == jc.state_dict()
    tc.load_state({"unknown_future_key": 1})
    assert tc.state_dict() == jc.state_dict()


@pytest.mark.parametrize("bad", [
    dict(slo_ms=0), dict(md_factor=1.0), dict(admit_rps_min=10.0,
                                              admit_rps_max=5.0),
    dict(low_shed_start=0.9, low_shed_full=0.5), dict(max_sojourn_ms=-1),
    dict(admit_rps_init=1e9)])
def test_policy_validates_like_jax(bad):
    with pytest.raises(ValueError):
        OverloadPolicy(**bad)
    with pytest.raises(ValueError):
        JOverload(**bad)


def test_storm_policy_and_defaults_equal_jax():
    for base in (20000.0, 30000.0, 123.5):
        assert dataclasses.asdict(storm_policy(base)) == \
            dataclasses.asdict(jstorm_policy(base))
    assert dataclasses.asdict(OverloadPolicy()) == \
        dataclasses.asdict(JOverload())
    assert OverloadPolicy(slo_ms=40.0).sojourn_limit_ms == 32.0


def test_breakers_walk_like_jax():
    tb, jb = LadderBreakers(3), JBreakers(3)
    for op, arg in (("open_rung", 0), ("open_rung", 1), ("open_rung", 1),
                    ("half_open_all", None), ("close_trials", None),
                    ("open_rung", 2), ("open_rung", 99),
                    ("half_open_all", None)):
        for b in (tb, jb):
            getattr(b, op)(*(() if arg is None else (arg,)))
        assert (tb.states(), tb.trips, tb.reprobes) == \
            (jb.states(), jb.trips, jb.reprobes)
    b = LadderBreakers(3, states=[OPEN, HALF_OPEN, "bogus"])
    assert b.states() == [OPEN, HALF_OPEN, CLOSED]


# --- the engines --------------------------------------------------------------

def _pair(overload=None, spec=None, max_queue=512, deadline_ms=200.0,
          port_backend="ref"):
    kw = dict(threshold=192, leak=16, n_syn=N_INPUTS, encode="kernel",
              max_batch=16, t_chunk=8)
    pol = dict(max_queue=max_queue, deadline_ms=deadline_ms)
    jeng = JServing(jinit_weights(N_NEURONS, N_INPUTS // 32, density_seed=0),
                    JPlan(**kw), policy=JPolicy(**pol),
                    clock=JClock(JModel()),
                    on_launch=JInjector(JSpec(**spec)) if spec else None,
                    overload=JOverload(**overload) if overload else None)
    teng = SNNServingEngine(
        init_weights(N_NEURONS, N_INPUTS // 32, density_seed=0),
        SNNEnginePlan(kernel_backend=port_backend, **kw),
        policy=SNNServingPolicy(**pol), clock=VirtualClock(ServiceModel()),
        on_launch=FaultInjector(FaultSpec(**spec)) if spec else None,
        overload=OverloadPolicy(**overload) if overload else None,
        device="cpu")
    return jeng, teng


def _rows(n, rate, scale=1.0, high_frac=0.1):
    arr = dict(process="poisson", rate_rps=rate, n_requests=n, seed=9)
    wl = dict(n_inputs=N_INPUTS, seed=4, priority_choices=(0, 1),
              priority_weights=(round(10 * (1 - high_frac)),
                                round(10 * high_frac)))
    rows = generate_rows(ArrivalSpec(**arr), WorkloadSpec(**wl))
    assert rows == jgenerate_rows(JArrivals(**arr), JWorkload(**wl))
    return (scale_rows(rows, scale) if scale != 1.0 else rows,
            WorkloadSpec(**wl), JWorkload(**wl))


def _assert_same(jeng, teng, jrep, trep):
    assert trep.to_dict() == jrep.to_dict()
    assert teng.per_status() == jeng.per_status()
    assert teng.service_hist.to_dict() == jeng.service_hist.to_dict()
    js, ts = jeng.stats(), teng.stats()
    for k in WALL_KEYS:
        js.pop(k), ts.pop(k)
    assert ts == js
    assert teng.overload.state_dict() == jeng.overload.state_dict()


@pytest.mark.parametrize("scale", [3.0, 5.0])
def test_overload_stream_equals_jax(scale):
    """A priority-mixed stream at 3x and 5x its sustainable rate with
    :func:`storm_policy` and a seeded slowdown storm."""
    rows, wl, jwl = _rows(400, 15000.0, scale)
    spec = dict(p_slowdown=0.05, slowdown_factor=3.0, slowdown_steps=4,
                seed=3)
    pol = dataclasses.asdict(storm_policy(15000.0))
    jeng, teng = _pair(overload=pol, spec=spec)
    jrep = jrun_rows(jeng, jwl, rows, slo_ms=50.0)
    trep = run_rows(teng, wl, rows, slo_ms=50.0)
    _assert_same(jeng, teng, jrep, trep)
    st = teng.stats()
    assert trep.non_terminal == 0
    assert st["shed_admission"] + st["shed_low_priority"] \
        + st["shed_codel"] > 0
    assert trep.slo_attainment_by_priority["1"] >= \
        trep.slo_attainment_by_priority["0"]


def test_codel_sheds_the_same_requests_as_jax():
    """A tight sojourn target and a backlog the batch cannot drain:
    CoDel enters its dropping state and sheds the same low-priority
    requests, tagged ``codel``, in both engines."""
    pol = dict(slo_ms=10.0, target_sojourn_ms=0.5, interval_ms=1.0,
               max_sojourn_ms=4.0, admit_rps_max=1e6, burst=4096.0)
    rows, wl, jwl = _rows(300, 60000.0, high_frac=0.3)
    jeng, teng = _pair(overload=pol, max_queue=4096)
    jrep = jrun_rows(jeng, jwl, rows, slo_ms=10.0)
    trep = run_rows(teng, wl, rows, slo_ms=10.0)
    _assert_same(jeng, teng, jrep, trep)
    assert teng.shed_codel > 0 and teng.overload.codel_entries > 0


def test_retry_denial_under_a_fault_burst_equals_jax():
    """A correlated launch-fault burst hits the global retry budget and
    fails fast in both engines."""
    pol = dict(retry_budget=1.0, retry_refill_per_s=0.0)
    spec = dict(p_launch_error=0.9, error_burst=64, seed=11)
    jeng, teng = _pair(overload=pol, spec=spec)
    rng = np.random.default_rng(1)
    inten = rng.integers(0, 256, (24, N_INPUTS), dtype=np.uint8)
    jreqs = jeng.run([JRequest(rid=i, intensities=inten[i], n_steps=8)
                      for i in range(24)])
    treqs = teng.run([SNNRequest(rid=i, intensities=inten[i], n_steps=8)
                      for i in range(24)])
    assert [r.status for r in treqs] == [r.status for r in jreqs]
    assert [r.error for r in treqs] == [r.error for r in jreqs]
    js, ts = jeng.stats(), teng.stats()
    for k in WALL_KEYS:
        js.pop(k), ts.pop(k)
    assert ts == js
    assert teng.retries_denied > 0 and teng.retried <= 1


def test_expired_high_priority_leaves_before_live_low():
    _, eng = _pair()
    inten = np.random.default_rng(0).integers(0, 256, (N_INPUTS,),
                                              dtype=np.uint8)
    dead = SNNRequest(rid=0, intensities=inten, n_steps=8, priority=1,
                      deadline_ms=0.0)
    live = SNNRequest(rid=1, intensities=inten, n_steps=8, priority=0)
    eng.submit(dead)
    eng.submit(live)
    eng.clock.skip_to(eng.clock.now_ms() + 1.0)
    eng.step()
    assert (dead.status, live.status, dead.shed) == ("EXPIRED", "SERVED",
                                                     None)


def test_stats_under_zero_traffic_equal_jax():
    jeng, teng = _pair(overload=dict(admit_rps_init=1234.0))
    js, ts = jeng.stats(), teng.stats()
    for k in WALL_KEYS:
        js.pop(k), ts.pop(k)
    assert ts == js and ts["admit_rate_rps"] == 1234.0
    assert "admit_rate_rps" not in _pair()[1].stats()


def test_overload_storm_cli_matches_jax_on_a_small_trace(tmp_path):
    """``serve --overload-storm`` over a 3,000-request priority-mixed
    trace through both launchers: the same printed report and exit
    status (the storm is replayed twice in each, bit-identically)."""
    trace = tmp_path / "storm.json"
    rec = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.loadgen", "--record",
         str(trace), "--compact", "--n", "3000", "--rate", "30000",
         "--seed", "43", "--workload-seed", "11", "--priority-choices",
         "0", "1", "--priority-weights", "9", "1", "--device", "cpu"],
        capture_output=True, text=True, env=ENV, timeout=120, cwd=REPO)
    assert rec.returncode == 0, rec.stderr
    args = ["--arch", "wenquxing-snn", "--overload-storm", "--trace",
            str(trace)]
    port = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *args, "--device", "cpu"], capture_output=True,
                          text=True, env=ENV, timeout=300, cwd=REPO)
    jax_run = subprocess.run([sys.executable, "-m", "repro.launch.serve",
                              *args], capture_output=True, text=True,
                             env=ENV, timeout=300, cwd=REPO)
    assert port.returncode == jax_run.returncode, port.stdout + port.stderr
    assert port.stdout.splitlines() == jax_run.stdout.splitlines()
    assert "overload-storm: seed=5 scale=5x" in port.stdout
