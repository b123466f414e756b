"""The port's engine and serving engine against the JAX package's.

One request list (ragged, mixed intensity and window requests, one
malformed) goes through both ``SNNServingEngine``s on the CPU; statuses,
counts, predictions and counters must be identical.  The JAX side runs
its ``ref`` ops (its Pallas window kernels do not run in interpret mode
on this JAX version); the port runs its plain versions on the CPU."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.wenquxing_snn import WENQUXING_22A as J_22A
from repro.core.encoder import quantize_intensities as jquantize
from repro.data.digits import make_digits as jmake_digits
from repro.engine import SNNEngine as JEngine
from repro.engine import SNNEnginePlan as JPlan
from repro.engine import plan_from_config as jplan_from_config
from repro.serving import SNNRequest as JRequest
from repro.serving import SNNServingEngine as JServing
from repro.serving import SNNServingPolicy as JPolicy
from repro_torch.configs.wenquxing_snn import WENQUXING_22A
from repro_torch.convert import weights_from_jax, weights_to_numpy
from repro_torch.core.encoder import quantize_intensities
from repro_torch.core.stdp import init_weights
from repro_torch.data.digits import make_digits
from repro_torch.engine import SNNEngine, SNNEnginePlan, plan_from_config
from repro_torch.kernels import ops
from repro_torch.core.bitpack import as_words
from repro_torch.serving import (SNNRequest, SNNServingEngine,
                                 SNNServingPolicy, VersionedWeightStore,
                                 degradation_ladder)
from repro_torch.serving.journal import _COUNTER_KEYS

REPO = Path(__file__).resolve().parents[1]

N, W, N_IN = 20, 4, 100
PARAMS = dict(threshold=40, leak=3, w_exp=None, max_batch=3)


def _bank(seed=0, n=N, w=W):
    return np.random.default_rng(seed).integers(0, 2**32, (n, w),
                                                dtype=np.uint32)


def _payloads(seed=1):
    """(kind, payload, n_steps) rows: ragged intensity requests, window
    requests, and one window of the wrong width (malformed)."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(11):
        t = (5, 9, 12, 16)[i % 4]
        if i in (4, 9):
            rows.append(("window", rng.integers(
                0, 2**32, (t, W), dtype=np.uint32)
                & rng.integers(0, 2**32, (t, W), dtype=np.uint32), None))
        else:
            rows.append(("inten", rng.integers(0, 256, (N_IN,),
                                               dtype=np.uint8), t))
    rows.insert(6, ("window", np.zeros((8, W + 1), np.uint32), None))
    return rows


def _requests(cls, rows):
    reqs = []
    for rid, (kind, payload, t) in enumerate(rows):
        if kind == "window":
            reqs.append(cls(rid=rid, window=payload.copy()))
        else:
            reqs.append(cls(rid=rid, intensities=payload.copy(), n_steps=t))
    return reqs


def _run_both(port_backend, *, on_launch=None, encode="kernel",
              policy_kw=None):
    bank = _bank()
    classes = np.arange(N) % 10
    pol = dict(canary_every=2, **(policy_kw or {}))
    jeng = JServing(jnp.asarray(bank),
                    JPlan(kernel_backend="ref", encode=encode, **PARAMS),
                    neuron_class=classes, policy=JPolicy(**pol),
                    on_launch=on_launch)
    teng = SNNServingEngine(
        weights_from_jax(bank)[0],
        SNNEnginePlan(kernel_backend=port_backend, encode=encode,
                      **PARAMS),
        neuron_class=classes, policy=SNNServingPolicy(**pol),
        on_launch=on_launch, device="cpu")
    rows = _payloads()
    jreqs = jeng.run(_requests(JRequest, rows))
    treqs = teng.run(_requests(SNNRequest, rows))
    return jeng, teng, jreqs, treqs


def _assert_same_outcome(jeng, teng, jreqs, treqs):
    assert [r.status for r in treqs] == [r.status for r in jreqs]
    assert [r.pred for r in treqs] == [r.pred for r in jreqs]
    for a, b in zip(treqs, jreqs):
        if b.counts is None:
            assert a.counts is None
        else:
            np.testing.assert_array_equal(a.counts, np.asarray(b.counts))
    for k in _COUNTER_KEYS:
        assert getattr(teng, k) == getattr(jeng, k), k
    assert teng.padded_slot_waste == jeng.padded_slot_waste
    assert teng.level == jeng.level


@pytest.mark.parametrize("encode", ["kernel", "host"])
@pytest.mark.parametrize("port_backend", ["kernel", "ref"])
def test_serving_engines_agree_on_a_mixed_ragged_request_list(
        port_backend, encode):
    jeng, teng, jreqs, treqs = _run_both(port_backend, encode=encode)
    _assert_same_outcome(jeng, teng, jreqs, treqs)
    assert treqs[6].status == "REJECTED" and "window" in treqs[6].error
    assert teng.windows_served == 11 and teng.batches == 4
    assert teng.canary_checks == 2 and teng.canary_failures == 0


class _FailFirstSteps:
    """Raises on every serve launch at rung 0 during the first two
    steps: the ladder must step down, then re-probe rung 0."""

    def __call__(self, info):
        if info["kind"] == "serve" and info["level"] == 0 \
                and info["step"] < 2:
            raise RuntimeError(f"injected fault at step {info['step']}")
        return None


@pytest.mark.parametrize("port_backend", ["kernel", "ref"])
def test_raising_launch_hook_gives_the_same_degradation(port_backend):
    jeng, teng, jreqs, treqs = _run_both(
        port_backend, on_launch=_FailFirstSteps(),
        policy_kw=dict(reprobe_after=1))
    _assert_same_outcome(jeng, teng, jreqs, treqs)
    jev, tev = list(jeng.degradation_events), list(teng.degradation_events)
    assert len(tev) >= 2 and teng.degraded == jeng.degraded >= 1
    jstates = jeng.breakers.states()
    if port_backend == "kernel":
        # the port names its backends itself, and its ladder has one more
        # rung (kernel -> host encode -> ref; the JAX one starts at ref)
        jev = [{k: v for k, v in e.items() if k != "kernel_backend"}
               for e in jev]
        tev = [{k: v for k, v in e.items() if k != "kernel_backend"}
               for e in tev]
        jstates += ["closed"]
    assert tev == jev
    assert teng.breakers.states() == jstates
    assert teng.breakers.trips == jeng.breakers.trips


def test_engine_infer_both_forms_equal_jax():
    bank = _bank(3, n=33, w=7)
    rng = np.random.default_rng(4)
    inten = rng.integers(0, 256, (5, 200), dtype=np.uint8)
    seeds = np.array([3, -1, 0x7FFFFFFF, 0, 9], np.int32)
    t_total = np.array([9, 0, 4, 8, 1], np.int32)
    wins = rng.integers(0, 2**32, (5, 9, 7), dtype=np.uint32)
    kw = dict(threshold=30, leak=2, w_exp=None, encode_seed=77)
    for encode in ("kernel", "host"):
        jeng = JEngine(JPlan(encode=encode, **kw))
        teng = SNNEngine(SNNEnginePlan(encode=encode, **kw), device="cpu")
        for call in (dict(seeds=seeds, t_total=t_total), dict()):
            got = teng.infer(weights_from_jax(bank)[0], intensities=inten,
                             n_steps=9, **call)
            want = jeng.infer(jnp.asarray(bank),
                              intensities=jnp.asarray(inten), n_steps=9,
                              **{k: jnp.asarray(v) for k, v in call.items()})
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        got = teng.infer(bank, wins)
        want = jeng.infer(jnp.asarray(bank), jnp.asarray(wins))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        teng.infer(bank, wins, intensities=inten, n_steps=9)
    with pytest.raises(ValueError):
        teng.infer(bank, intensities=inten)


def test_paper_width_slice_matches_jax():
    """Wenquxing 22A at full width (784-40), T = 24, one batch of 4
    digits, the port's LFSR bank carried to the JAX engine."""
    cfg = dataclasses.replace(WENQUXING_22A, n_steps=24, encode="kernel")
    jcfg = dataclasses.replace(J_22A, n_steps=24, encode="kernel")
    plan = dataclasses.replace(plan_from_config(cfg), max_batch=4)
    jplan = dataclasses.replace(jplan_from_config(jcfg), max_batch=4)
    for field in ("threshold", "leak", "w_exp", "gain", "n_syn", "ltp_prob",
                  "t_chunk", "encode", "encode_seed", "max_batch"):
        assert getattr(plan, field) == getattr(jplan, field), field
    bank = init_weights(cfg.n_neurons, cfg.words, dense=False)
    classes = np.tile(np.arange(cfg.n_classes), cfg.n_blocks)
    imgs, _ = make_digits(4, seed=0)
    jimgs, _ = jmake_digits(4, seed=0)
    np.testing.assert_array_equal(imgs, jimgs)
    inten = quantize_intensities(imgs).numpy()
    np.testing.assert_array_equal(inten, np.asarray(jquantize(jimgs)))
    policy = dict(canary_every=1)
    teng = SNNServingEngine(bank, plan, neuron_class=classes,
                            policy=SNNServingPolicy(**policy), device="cpu")
    jeng = JServing(jnp.asarray(weights_to_numpy(bank)), jplan,
                    neuron_class=classes, policy=JPolicy(**policy))
    ts = teng.run([SNNRequest(rid=i, intensities=inten[i],
                              n_steps=24 - 4 * (i % 3)) for i in range(4)])
    js = jeng.run([JRequest(rid=i, intensities=inten[i],
                            n_steps=24 - 4 * (i % 3)) for i in range(4)])
    _assert_same_outcome(jeng, teng, js, ts)
    assert all(r.status == "SERVED" for r in ts)
    assert sum(int(r.counts.sum()) for r in ts) > 0
    assert teng.batches == 1 and teng.canary_checks == 1


def test_serving_rejects_what_is_not_ported_and_bad_plans():
    bank = _bank()
    plan = SNNEnginePlan(**PARAMS)
    for kw in (dict(refresher=object()), dict(journal_dir="j"),
               dict(overload=object()), dict(state_dir="s")):
        with pytest.raises(NotImplementedError):
            SNNServingEngine(bank, plan, device="cpu", **kw)
    with pytest.raises(ValueError):
        SNNServingEngine(bank, dataclasses.replace(plan, threshold=0),
                         device="cpu")
    with pytest.raises(ValueError):
        SNNEnginePlan(kernel_backend="interp")


def test_cuda_is_the_default_device_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        SNNServingEngine(_bank(), SNNEnginePlan(**PARAMS))
    with pytest.raises(RuntimeError, match="CUDA"):
        SNNEngine(SNNEnginePlan(**PARAMS))


@pytest.mark.parametrize("encode", ["kernel", "host"])
def test_cuda_ladder_holds_only_kernel_rungs(encode):
    """On a card every rung launches the kernels; only the CPU ladder
    ends at the plain (ref) backend."""
    plan = SNNEnginePlan(encode=encode, **PARAMS)
    cuda = degradation_ladder(plan, "cuda")
    assert cuda[0] == plan and cuda[-1].encode == "host"
    assert {p.kernel_backend for p in cuda} == {"kernel"}
    cpu = degradation_ladder(plan, "cpu")
    assert cpu[:-1] == cuda and cpu[-1].kernel_backend == "ref"
    with pytest.raises(ValueError, match="CUDA"):
        degradation_ladder(dataclasses.replace(plan, kernel_backend="ref"),
                           torch.device("cuda"))


def test_canary_golden_is_ready_before_the_first_step():
    eng = SNNServingEngine(_bank(), SNNEnginePlan(**PARAMS),
                           policy=SNNServingPolicy(canary_every=3),
                           device="cpu")
    want = ops.infer_window_batch(as_words(_bank()),
                                  as_words(eng._canary_window[None]),
                                  threshold=PARAMS["threshold"],
                                  leak=PARAMS["leak"])[0].numpy()
    np.testing.assert_array_equal(eng._canary_golden, want)
    assert eng._canary_version == eng.store.serving.version
    assert SNNServingEngine(_bank(), SNNEnginePlan(**PARAMS),
                            device="cpu")._canary_golden is None


def test_memory_store_stage_promote_swap_rollback():
    store = VersionedWeightStore(_bank(0), device="cpu")
    assert store.serving.version == 0 and not store.can_rollback()
    cand = store.stage(_bank(1))
    assert cand.verify() and store.serving.version == 0
    assert store.promote(cand) and store.serving.version == 0
    assert store.swap_if_pending() and store.serving.version == 1
    np.testing.assert_array_equal(weights_to_numpy(store.serving.weights),
                                  _bank(1))
    tgt = store.rollback("test")
    assert tgt.version == 0 and store.swap_if_pending()
    assert store.serving.origin == "rollback"
    assert not store.is_live(1) and store.is_live(0)
    bad = dataclasses.replace(store.stage(_bank(2)),
                              weights=torch.zeros((N, W), dtype=torch.int32))
    with pytest.raises(ValueError):
        store.promote(bad)
    assert store.stats()["rollbacks"] == 1


def test_serve_cli_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "wenquxing-snn", "--device", "cpu", "--bench"],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "oracle-check: ok" in proc.stdout
    assert "SERVED=6" in proc.stdout
    assert set(ops.launch_counts()) >= {"infer_window_batch_encode",
                                        "infer_window_batch"}
    assert all(v == 0 for v in ops.launch_counts().values())
