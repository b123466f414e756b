"""Fault injection and the step-plan branch of the port's serving
engine, against the JAX package's.

The same seeded ``FaultInjector`` storm (launch failures, corrupted
counts, stalls, already-dead deadlines) drives a JAX engine on its
``ref`` ops and a port engine on its plain versions, both on the virtual
clock: statuses, counts, ``per_status()``, every ``stats()`` key and
value (less the two wall-time keys), histogram buckets, degradation
events, breaker states and the injector's own counters must be equal,
and every SERVED count must equal the plain oracle.  Every comparison is
exact."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core  # noqa: F401  (the JAX package loads core before engine)
from repro.engine import SNNEnginePlan as JPlan
from repro.loadgen.runner import make_clock as jmake_clock
from repro.serving import FaultInjectedError as JFaultError
from repro.serving import FaultInjector as JInjector
from repro.serving import FaultSpec as JSpec
from repro.serving import SNNRequest as JRequest
from repro.serving import SNNServingEngine as JServing
from repro.serving import SNNServingPolicy as JPolicy
from repro_torch.core.bitpack import as_words
from repro_torch.core.encoder import encode_windows_host
from repro_torch.engine import SNNEnginePlan
from repro_torch.kernels import ops
from repro_torch.loadgen.runner import make_clock
from repro_torch.serving import (CRASH_EXIT_CODE, FaultInjectedError,
                                 FaultInjector, FaultSpec, SNNRequest,
                                 SNNServingEngine, SNNServingPolicy)

REPO = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
N, W, N_IN = 20, 4, 100
PARAMS = dict(threshold=40, leak=3, w_exp=None, max_batch=3)
WALL_KEYS = ("mean_step_ms", "last_step_ms")


def _bank(seed=0):
    return np.random.default_rng(seed).integers(0, 2**32, (N, W),
                                                dtype=np.uint32)


def _rows(n=24, seed=1, dead_every=6):
    """(rid, kind, payload, T, priority, deadline) rows: ragged windows
    and intensity requests, priorities 0-2, some already-dead deadlines,
    one malformed window."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        t = (5, 9, 12, 16)[i % 4]
        ddl = 0.0 if dead_every and i % dead_every == dead_every - 1 \
            else None
        if i % 3 == 1:
            win = (rng.integers(0, 2**32, (t, W), dtype=np.uint32)
                   & rng.integers(0, 2**32, (t, W), dtype=np.uint32))
            rows.append((i, "window", win, t, i % 3, ddl))
        else:
            rows.append((i, "inten", rng.integers(0, 256, (N_IN,),
                                                  dtype=np.uint8),
                         t, i % 3, ddl))
    rows.append((n, "window", np.zeros((8, W + 1), np.uint32), 8, 0, None))
    return rows


def _requests(cls, rows):
    out = []
    for rid, kind, payload, t, prio, ddl in rows:
        kw = dict(rid=rid, priority=prio, deadline_ms=ddl)
        if kind == "window":
            out.append(cls(window=payload.copy(), **kw))
        else:
            out.append(cls(intensities=payload.copy(), n_steps=t, **kw))
    return out


def _twins(*, encode="kernel", cycle="window", port_backend="ref",
           spec=None, hooks=None, policy=None, rows=None):
    """Run the same rows through a JAX and a port engine on virtual
    clocks; returns (jeng, teng, jreqs, treqs)."""
    pol = policy or dict(max_retries=1, canary_every=3, reprobe_after=2)
    kw = dict(encode=encode, cycle_backend=cycle, **PARAMS)
    jhook, thook = hooks or (None, None)
    if spec is not None:
        jhook, thook = JInjector(JSpec(**spec)), FaultInjector(
            FaultSpec(**spec))
    jeng = JServing(jnp.asarray(_bank()), JPlan(**kw),
                    neuron_class=np.arange(N) % 10, policy=JPolicy(**pol),
                    on_launch=jhook, clock=jmake_clock("virtual"))
    teng = SNNServingEngine(_bank(), SNNEnginePlan(
        kernel_backend=port_backend, **kw), neuron_class=np.arange(N) % 10,
        policy=SNNServingPolicy(**pol), on_launch=thook,
        clock=make_clock("virtual"), device="cpu")
    rows = rows if rows is not None else _rows()
    return (jeng, teng, jeng.run(_requests(JRequest, rows)),
            teng.run(_requests(SNNRequest, rows)))


def _oracle(r, plan):
    """The plain pre-packed version's counts for one request."""
    if r.window is not None:
        win = as_words(r.window[None])
    else:
        import torch
        win = encode_windows_host(r.seed, torch.from_numpy(
            r.intensities)[None], r.n_steps, W)
    return ops.infer_window_batch(as_words(_bank()), win,
                                  threshold=plan["threshold"],
                                  leak=plan["leak"],
                                  backend="ref")[0].numpy()


def assert_twins_equal(jeng, teng, jreqs, treqs, *, extra_rung=False):
    assert [r.status for r in treqs] == [r.status for r in jreqs]
    assert [r.retries for r in treqs] == [r.retries for r in jreqs]
    assert [r.pred for r in treqs] == [r.pred for r in jreqs]
    assert [r.error for r in treqs] == [r.error for r in jreqs]
    for a, b in zip(treqs, jreqs):
        assert (a.counts is None) == (b.counts is None)
        if a.counts is not None:
            np.testing.assert_array_equal(a.counts, np.asarray(b.counts))
            np.testing.assert_array_equal(a.counts, _oracle(a, PARAMS))
        assert (a.queue_wait_ms, a.service_ms) == (b.queue_wait_ms,
                                                   b.service_ms)
    assert teng.per_status() == jeng.per_status()
    assert teng.service_hist.to_dict() == jeng.service_hist.to_dict()
    assert teng.queue_wait_hist.to_dict() == jeng.queue_wait_hist.to_dict()
    js, ts = jeng.stats(), teng.stats()
    for k in WALL_KEYS:
        js.pop(k), ts.pop(k)
    if extra_rung:      # the CPU's plain rung after the JAX ladder
        assert ts["breaker_states"][-1] == "closed"
        ts["breaker_states"] = ts["breaker_states"][:-1]
    assert ts == js
    strip = (lambda e: {k: v for k, v in e.items()
                        if k != "kernel_backend"}) if extra_rung else dict
    assert [strip(e) for e in teng.degradation_events] == \
        [strip(e) for e in jeng.degradation_events]
    if hasattr(teng.on_launch, "stats"):
        assert teng.on_launch.stats() == jeng.on_launch.stats()


# --- the injector alone ------------------------------------------------------

def test_injector_decides_like_jax():
    """One spec, one sequence of hooked calls: the same raises, stalls,
    corruptions (applied to the same matrix) and counters."""
    spec = dict(p_launch_error=0.3, p_corrupt=0.4, p_stall=0.3,
                stall_ms=0.01, error_burst=2, p_refresh_corrupt=0.5,
                p_save_crash=0.5, p_slowdown=0.2, slowdown_steps=2, seed=3)
    ji, ti = JInjector(JSpec(**spec)), FaultInjector(FaultSpec(**spec))
    rng = np.random.default_rng(0)
    for step in range(60):
        kind = ("serve", "canary", "refresh", "save")[step % 4]
        ctx = dict(step=step, kind=kind, level=0, batch_size=3,
                   t_lens=[4, 9, 2])
        arg = (np.arange(6, dtype=np.uint32) if kind == "refresh"
               else rng.integers(0, 3, (3, 5), dtype=np.int32))
        outs = []
        for inj, err in ((ji, JFaultError), (ti, FaultInjectedError)):
            try:
                fn = inj(dict(ctx))
                outs.append("none" if fn is None else fn(arg))
            except err as e:
                outs.append(str(e))
        if isinstance(outs[0], np.ndarray):
            np.testing.assert_array_equal(outs[0], outs[1])
        else:
            assert outs[0] == outs[1]
        assert ji.service_inflation(ctx) == ti.service_inflation(ctx)
    assert ti.stats() == ji.stats()
    assert ti.errors and ti.corruptions and ti.save_crashes
    assert CRASH_EXIT_CODE == 73


@pytest.mark.parametrize("bad", [dict(p_launch_error=1.5),
                                 dict(error_burst=0), dict(stall_ms=-1),
                                 dict(slowdown_factor=0.5)])
def test_fault_spec_validates_like_jax(bad):
    with pytest.raises(ValueError):
        FaultSpec(**bad)
    with pytest.raises(ValueError):
        JSpec(**bad)


# --- seeded storms through both engines ---------------------------------------

STORM = dict(p_launch_error=0.35, p_corrupt=0.5, p_stall=0.2, stall_ms=0.01,
             error_burst=3, seed=11)


@pytest.mark.parametrize("encode", ["kernel", "host"])
@pytest.mark.parametrize("seed", [11, 12])
def test_seeded_fault_storm_equals_jax(encode, seed):
    """Launch failures in bursts past the retry budget, corrupted counts
    repaired on the last rung, stalls, dead deadlines: the same storm
    gives the same run where the ladders agree (the port's plan on its
    plain backend has the JAX ``ref`` plan's rungs)."""
    jeng, teng, jreqs, treqs = _twins(encode=encode,
                                      spec=dict(STORM, seed=seed))
    assert_twins_equal(jeng, teng, jreqs, treqs)
    assert all(r.terminal for r in treqs)
    st = teng.stats()
    assert st["retried"] > 0 and st["failed"] > 0
    assert st["degraded"] == (st["level"] if encode == "kernel" else 0)
    assert st["rejected"] == 1 and st["canary_checks"] > 0
    assert st["expired"] == sum(r.status == "EXPIRED" for r in treqs) > 0
    assert teng.on_launch.errors > 0


@pytest.mark.parametrize("encode", ["kernel", "host"])
def test_fault_storm_on_the_cpu_ladder_stays_exact(encode):
    """The port's CPU ladder has one rung more than the JAX ``ref``
    plan's (plan, host encode, then the plain backend), so a batch the
    JAX engine fails may be served here: statuses differ by design, but
    every request terminates and every SERVED count equals the plain
    oracle."""
    _, teng, _, treqs = _twins(encode=encode, spec=STORM,
                               port_backend="kernel")
    assert all(r.terminal for r in treqs)
    for r in treqs:
        if r.status == "SERVED":
            np.testing.assert_array_equal(r.counts, _oracle(r, PARAMS))
    assert teng.level <= 2 and len(teng._plans) == (3 if encode == "kernel"
                                                    else 2)
    assert teng.retried > 0 and teng.degraded > 0


def test_in_range_canary_corruption_degrades_like_jax():
    """A corruption the range guard cannot see (one count moved inside
    [0, T]) on the canary's launch: both engines count the canary
    failure and step down."""
    class CanaryFlip:
        def __call__(self, ctx):
            if ctx["kind"] == "canary" and ctx["level"] == 0:
                def flip(counts):
                    out = np.array(counts)
                    out[0, 0] = 1 - min(out[0, 0], 1)
                    return out
                return flip
            return None
    jeng, teng, jreqs, treqs = _twins(
        hooks=(CanaryFlip(), CanaryFlip()),
        policy=dict(canary_every=1, reprobe_after=3),
        rows=_rows(12, dead_every=0))
    assert_twins_equal(jeng, teng, jreqs, treqs)
    assert teng.canary_failures >= 1 and teng.degraded >= 1


def test_retry_backoff_is_charged_to_the_virtual_clock():
    class FailTwice:
        def __init__(self):
            self.n = 0

        def __call__(self, ctx):
            self.n += 1
            if ctx["kind"] == "serve" and self.n % 4 in (1, 2):
                raise RuntimeError("transient")
            return None
    pol = dict(max_retries=2, retry_backoff_ms=0.5)
    jeng, teng, jreqs, treqs = _twins(hooks=(FailTwice(), FailTwice()),
                                      policy=pol, rows=_rows(9, dead_every=0))
    assert_twins_equal(jeng, teng, jreqs, treqs)
    assert teng.retried > 0 and teng.clock.now_ms() == jeng.clock.now_ms()
    # 0.5 + 1.0 ms of backoff a failing batch, on top of service time
    assert teng.service_hist.max_ms > 1.5


# --- the step plan -------------------------------------------------------------

@pytest.mark.parametrize("port_backend", ["ref", "kernel"])
def test_step_plan_serves_the_mixed_list_like_jax(port_backend):
    """A step plan serves host-encoded windows through the step
    ``infer`` (one fused step launch per cycle on a card): the same
    statuses, counts and counters as the JAX engine's step plan, and as
    a window plan."""
    rows = _rows(16, dead_every=0)
    twins = _twins(cycle="step", encode="host", port_backend=port_backend,
                   rows=rows)
    assert_twins_equal(*twins, extra_rung=port_backend == "kernel")
    _, wteng, _, wreqs = _twins(encode="host", rows=rows)
    assert [r.status for r in twins[3]] == [r.status for r in wreqs]
    for a, b in zip(twins[3], wreqs):
        if a.counts is not None:
            np.testing.assert_array_equal(a.counts, b.counts)
    assert twins[1].windows_served == 16 and twins[1].canary_checks > 0


def test_step_plan_under_a_fault_storm_equals_jax():
    spec = dict(p_launch_error=0.3, p_corrupt=0.4, error_burst=2, seed=5)
    twins = _twins(cycle="step", encode="host", spec=spec,
                   policy=dict(max_retries=2, canary_every=2))
    assert_twins_equal(*twins)
    assert twins[1].retried > 0 and twins[1].integrity_failures > 0


# --- the CLI ----------------------------------------------------------------------

def test_serve_cli_fault_storm_matches_jax_on_the_cpu():
    """``serve --inject-faults`` through both launchers: every request
    terminal, the oracle check passes, the same statuses."""
    args = ["--arch", "wenquxing-snn", "--inject-faults", "--requests",
            "10", "--slots", "4"]
    port = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *args, "--device", "cpu"], capture_output=True,
                          text=True, env=ENV, timeout=300, cwd=REPO)
    jax_run = subprocess.run([sys.executable, "-m", "repro.launch.serve",
                              *args], capture_output=True, text=True,
                             env=ENV, timeout=300, cwd=REPO)
    assert port.returncode == jax_run.returncode == 0, port.stdout
    assert "oracle-check: ok" in port.stdout

    def statuses(out):
        return [ln for ln in out.splitlines() if ln.startswith("statuses")]
    assert statuses(port.stdout) == statuses(jax_run.stdout)
    assert "non-terminal=0" in statuses(port.stdout)[0]
    assert dataclasses.is_dataclass(FaultSpec())
