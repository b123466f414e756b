"""The port's step path (``cycle_backend="step"``) against the JAX
package's.

The engine's ``infer`` / ``train`` / ``train_batch`` verbs, the stream
drivers, the ``core/network.py`` shims and the trainer's blocks run here
cycle by cycle (one ``snn.step`` per cycle, the plain version on the
CPU) and must equal the JAX package's step path bit for bit: weights,
v, LFSR, the spike register, rasters and counts.  Inside the port the
step path must equal the window path.  Both packages start from the
same state, carried with ``repro_torch.convert``."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.wenquxing_snn import WENQUXING_22A as J_CFG
from repro.core import lif as jlif
from repro.core import network as jnetwork
from repro.core import rvsnn as jrvsnn
from repro.core import stdp as jstdp
from repro.core import trainer as jtrainer
from repro.engine import SNNEngine as JEngine
from repro.engine import SNNEnginePlan as JPlan
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.configs.wenquxing_snn import WENQUXING_22A as CFG
from repro_torch.core import lif, network, stdp, trainer
from repro_torch.core.bitpack import as_words, words_to_numpy
from repro_torch.engine import (SNNEngine, SNNEnginePlan, plan_from_config,
                                train_stream, train_stream_batch)
from repro_torch.launch import quickstart
from repro_torch.serving import SNNServingEngine

REPO = Path(__file__).resolve().parents[1]
N_IN, N, T, W = 784, 10, 12, 25
SEEDS = np.array([-1, 0x7FFFFFFF, -0x80000000, 5], np.int32)


def _plans(learn=True, cycle_backend="step", **kw):
    p = dict(threshold=90, leak=4, w_exp=128 if learn else None, gain=4,
             n_syn=N_IN, ltp_prob=16, encode="host", encode_seed=0x22A)
    p.update(kw)
    return (SNNEnginePlan(cycle_backend=cycle_backend, **p),
            JPlan(cycle_backend="step", kernel_backend="ref", **p))


def _engines(learn=True, **kw):
    plan, jplan = _plans(learn, **kw)
    return SNNEngine(plan, device="cpu"), JEngine(jplan)


def _window_engine(eng):
    return SNNEngine(dataclasses.replace(eng.plan, cycle_backend="window"),
                     device="cpu")


def _data(seed, n_samples, t=T):
    rng = np.random.default_rng(seed)
    inten = rng.integers(0, 256, (n_samples, N_IN), dtype=np.uint8)
    inten[:, rng.random(N_IN) < 0.5] = 0
    spikes = (rng.integers(0, 2**32, (n_samples, t, W), dtype=np.uint32)
              & rng.integers(0, 2**32, (n_samples, t, W), dtype=np.uint32))
    labels = rng.integers(0, N, n_samples)
    teach = np.where(np.arange(N)[None] == labels[:, None], 64,
                     -1024).astype(np.int32)
    return inten, spikes, labels, teach


def _regfile(seed, lead=()):
    rng = np.random.default_rng(seed)
    return jrvsnn.SnnRegFile(
        spike=jnp.asarray(rng.integers(0, 2**32, lead + (W,),
                                       dtype=np.uint32)),
        v=jnp.asarray(rng.integers(0, 50, lead + (N,), dtype=np.int32)),
        lfsr=jnp.asarray(rng.integers(1, 2**16, lead + (N, W))
                         .astype(np.uint32)),
        weights=jnp.asarray(rng.integers(0, 2**32, lead + (N, W),
                                         dtype=np.uint32)))


def _assert_regfile(rf, jrf):
    got = convert.regfile_to_numpy(rf)
    for name in ("spike", "v", "lfsr", "weights"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(jrf, name)),
                                      err_msg=name)


def _assert_same_regfile(a, b):
    for name in ("spike", "v", "lfsr", "weights"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


# --- the plan -----------------------------------------------------------------

def test_plan_validates_its_cycle_backend():
    assert SNNEnginePlan().cycle_backend == "window"
    assert SNNEnginePlan(cycle_backend="step").cycle_backend == "step"
    with pytest.raises(ValueError, match="cycle_backend"):
        SNNEnginePlan(cycle_backend="scan")
    with pytest.raises(ValueError):        # as tests/test_encode.py asks
        SNNEnginePlan(encode="kernel", cycle_backend="step")   # of JAX
    cfg = dataclasses.replace(CFG, cycle_backend="step")
    assert plan_from_config(cfg).cycle_backend == "step"
    assert plan_from_config(cfg, 1).ltp_prob == cfg.ltp_prob_active
    with pytest.raises(NotImplementedError, match="step"):
        SNNServingEngine(np.zeros((N, W), np.uint32),
                         SNNEnginePlan(cycle_backend="step", w_exp=None),
                         device="cpu")


# --- the engine's verbs against the JAX step path ----------------------------

@pytest.mark.parametrize("form", ["windows", "intensities", "empty"])
def test_infer_step_matches_jax(form):
    eng, jeng = _engines(learn=False)
    b = 4
    inten, spikes, _, _ = _data(1, b, t=0 if form == "empty" else T)
    bank = _regfile(2).weights
    tt = np.array([T, 0, 5, T], np.int32)
    if form == "intensities":
        got = eng.infer(as_words(np.asarray(bank)), intensities=inten,
                        seeds=SEEDS, n_steps=T, t_total=tt)
        want = jeng.infer(bank, intensities=jnp.asarray(inten),
                          seeds=jnp.asarray(SEEDS), n_steps=T,
                          t_total=jnp.asarray(tt))
        again = _window_engine(eng).infer(
            as_words(np.asarray(bank)), intensities=inten, seeds=SEEDS,
            n_steps=T, t_total=tt)
    else:
        got = eng.infer(np.asarray(bank), spikes)
        want = jeng.infer(bank, jnp.asarray(spikes))
        again = _window_engine(eng).infer(np.asarray(bank), spikes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32 and got.shape == (b, N)
    assert torch.equal(got, again)                 # step == window
    assert (form == "empty") == (not got.any())


@pytest.mark.parametrize("form", ["windows", "intensities", "empty"])
@pytest.mark.parametrize("learn", [True, False])
def test_train_step_matches_jax(form, learn):
    eng, jeng = _engines(learn)
    inten, spikes, _, teach = _data(3, 1, t=0 if form == "empty" else T)
    jrf = _regfile(4)
    rf = convert.regfile_from_jax(jrf)
    if form == "intensities":
        kw = dict(teach=teach[0], intensities=inten[0], seed=int(SEEDS[0]),
                  n_steps=T)
        out = eng.train(rf, **kw)
        jout = jeng.train(jrf, teach=jnp.asarray(teach[0]),
                          intensities=jnp.asarray(inten[0]),
                          seed=jnp.int32(SEEDS[0]), n_steps=T)
        again = _window_engine(eng).train(rf, **kw)
    else:
        out = eng.train(rf, as_words(spikes[0]), torch.from_numpy(teach[0]))
        jout = jeng.train(jrf, jnp.asarray(spikes[0]), jnp.asarray(teach[0]))
        again = (None if form == "empty" else _window_engine(eng).train(
            rf, as_words(spikes[0]), torch.from_numpy(teach[0])))
    _assert_regfile(out.regfile, jout.regfile)
    np.testing.assert_array_equal(out.fired.numpy(), np.asarray(jout.fired))
    np.testing.assert_array_equal(out.spike_counts.numpy(),
                                  np.asarray(jout.spike_counts))
    _assert_regfile(rf, jrf)                       # the input is not written
    if form == "empty":                            # T = 0: nothing changes
        assert out.fired.shape == (0, N)
        _assert_regfile(out.regfile, jrf)
        return
    assert out.fired.any()
    _assert_same_regfile(out.regfile, again.regfile)
    assert torch.equal(out.fired, again.fired)


@pytest.mark.parametrize("form", ["windows", "intensities", "empty"])
def test_train_batch_step_matches_jax(form):
    eng, jeng = _engines()
    b = 3
    inten, spikes, _, teach = _data(5, b, t=0 if form == "empty" else T)
    jrfs = _regfile(6, (b,))
    rfs = convert.regfile_from_jax(jrfs)
    lp = np.array([16, 1023, 0], np.int32)
    if form == "intensities":
        kw = dict(teach=teach, ltp_prob=lp, intensities=inten,
                  seeds=SEEDS[:b], n_steps=T)
        got = eng.train_batch(rfs, **kw)
        want = jeng.train_batch(jrfs, teach=jnp.asarray(teach),
                                ltp_prob=jnp.asarray(lp),
                                intensities=jnp.asarray(inten),
                                seeds=jnp.asarray(SEEDS[:b]), n_steps=T)
        again = _window_engine(eng).train_batch(rfs, **kw)
    else:
        got = eng.train_batch(rfs, as_words(spikes), teach, ltp_prob=lp)
        want = jeng.train_batch(jrfs, jnp.asarray(spikes),
                                jnp.asarray(teach), ltp_prob=jnp.asarray(lp))
        again = (None if form == "empty" else _window_engine(eng)
                 .train_batch(rfs, as_words(spikes), teach, ltp_prob=lp))
    _assert_regfile(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    if form == "empty":
        assert got[2].shape == (b, 0, N)
        _assert_regfile(got[0], jrfs)
        return
    assert got[2].any()
    _assert_same_regfile(got[0], again[0])
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])


@pytest.mark.parametrize("batched", [False, True])
def test_stream_drivers_step_equal_window(batched):
    """train_stream(_batch) on the step path == on the window path."""
    eng, _ = _engines()
    n_samples, b = 3, 2
    inten, spikes, _, teach = _data(7, b * n_samples)
    if batched:
        rfs = convert.regfile_from_jax(_regfile(8, (b,)))
        lp = np.array([16, 1023], np.int32)
        args = (as_words(spikes.reshape(b, n_samples, T, W)),
                teach.reshape(b, n_samples, N))
        got = train_stream_batch(eng, rfs, *args, ltp_prob=lp)
        want = train_stream_batch(_window_engine(eng), rfs, *args,
                                  ltp_prob=lp)
    else:
        rf = convert.regfile_from_jax(_regfile(8))
        got = train_stream(eng, rf, teach=teach, intensities=inten,
                           n_steps=T)
        want = train_stream(_window_engine(eng), rf, teach=teach,
                            intensities=inten, n_steps=T)
    _assert_same_regfile(got[0], want[0])
    assert torch.equal(got[1], want[1]) and got[1].any()


# --- the network shims --------------------------------------------------------

@pytest.mark.parametrize("cycle_backend", ["step", "window"])
def test_network_shims_match_jax(cycle_backend):
    inten, spikes, _, teach = _data(9, 4)
    jrf = _regfile(10)
    rf = convert.regfile_from_jax(jrf)
    lp, jlp = lif.lif_params(90, 4), jlif.lif_params(90, 4)
    sp, jsp = stdp.stdp_params(N_IN, 128, 4, 16), jstdp.stdp_params(
        N_IN, 128, 4, 16)
    kw = dict(cycle_backend=cycle_backend)
    jkw = dict(cycle_backend=cycle_backend, kernel_backend="ref")
    # run_sample, learning and inference
    for su, jsu in ((sp, jsp), (None, None)):
        out = network.run_sample(rf, as_words(spikes[0]), lp, su,
                                 torch.from_numpy(teach[0]), **kw)
        jout = jnetwork.run_sample(jrf, jnp.asarray(spikes[0]), jlp, jsu,
                                   jnp.asarray(teach[0]), **jkw)
        _assert_regfile(out.regfile, jout.regfile)
        np.testing.assert_array_equal(out.fired.numpy(),
                                      np.asarray(jout.fired))
    # infer_batch
    got = network.infer_batch(rf.weights, as_words(spikes), lp, **kw)
    want = jnetwork.infer_batch(jrf.weights, jnp.asarray(spikes), jlp, **jkw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any()
    # train_stream
    got = network.train_stream(rf, as_words(spikes), teach, lp, sp, **kw)
    want = jnetwork.train_stream(jrf, jnp.asarray(spikes),
                                 jnp.asarray(teach), jlp, jsp, **jkw)
    _assert_regfile(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # train_stream_batch
    jrfs = _regfile(11, (2,))
    got = network.train_stream_batch(
        convert.regfile_from_jax(jrfs), as_words(spikes.reshape(2, 2, T, W)),
        teach.reshape(2, 2, N), lp, sp, **kw)
    want = jnetwork.train_stream_batch(
        jrfs, jnp.asarray(spikes.reshape(2, 2, T, W)),
        jnp.asarray(teach.reshape(2, 2, N)), jlp, jsp, **jkw)
    _assert_regfile(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert network.reset_between_samples(got[0]).v.abs().sum() == 0
    with pytest.raises(ValueError, match="cycle_backend"):
        network.infer_batch(rf.weights, as_words(spikes), lp,
                            cycle_backend="scan")


# --- the trainer's blocks on the step path -------------------------------------

def _configs(n_neurons, **kw):
    kw = dict(n_neurons=n_neurons, n_steps=T, epochs=2, **kw)
    return (dataclasses.replace(CFG, cycle_backend="step", **kw),
            dataclasses.replace(J_CFG, cycle_backend="step", **kw))


def test_train_block_step_matches_jax():
    cfg, jcfg = _configs(20)
    _, spikes, labels, _ = _data(12, 8)
    key = jax.random.key(3)
    want = jtrainer._train_block(jcfg, key, jnp.asarray(labels), 1,
                                 spike_trains=jnp.asarray(spikes))
    got = trainer._train_block(cfg, jtrainer._regfile_seed(key),
                               torch.from_numpy(labels.astype(np.int32)), 1,
                               spike_trains=as_words(spikes))
    np.testing.assert_array_equal(words_to_numpy(got), np.asarray(want))


def test_train_blocks_parallel_step_matches_jax():
    cfg, jcfg = _configs(30, train_mode="parallel")
    _, spikes, labels, _ = _data(13, 6)
    key = jax.random.key(4)
    seeds = [int(s) + 1 for s in jax.random.choice(
        key, (1 << 16) - 1, (3,), replace=False)]
    want = jtrainer._train_blocks_parallel(jcfg, key, jnp.asarray(labels),
                                           spike_trains=jnp.asarray(spikes))
    got = trainer._train_blocks_parallel(
        cfg, seeds, torch.from_numpy(labels.astype(np.int32)),
        spike_trains=as_words(spikes))
    np.testing.assert_array_equal(words_to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("mode", ["active", "parallel"])
def test_trainer_step_equals_window(mode):
    """``train()`` and ``classify`` give the same model and predictions
    on both cycle paths, from the same generator seed."""
    x = np.random.default_rng(14).random((8, N_IN)).astype(np.float32)
    labels = np.arange(8) % N
    models = {}
    for cb in ("step", "window"):
        cfg = dataclasses.replace(CFG, n_neurons=20, n_steps=T, epochs=1,
                                  train_mode=mode, cycle_backend=cb)
        models[cb] = trainer.train(cfg, x, labels, device="cpu",
                                   generator=torch.Generator().manual_seed(5))
    a, b = models["step"], models["window"]
    assert torch.equal(a.weights, b.weights)
    assert torch.equal(a.neuron_class, b.neuron_class)
    st = as_words(_data(15, 6)[1])
    assert torch.equal(trainer.classify(a, st), trainer.classify(b, st))


# --- the launchers --------------------------------------------------------------

def _run(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, env=env, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_mnist_stdp_cli_runs_the_step_path_on_the_cpu():
    out = _run("repro_torch.launch.mnist_stdp", "--device", "cpu",
               "--neurons", "20", "--train", "6", "--test", "4", "--epochs",
               "1", "--train-mode", "parallel", "--cycle-backend", "step")
    assert "parallel/step/host" in out
    assert "test accuracy:" in out and "cycle backend step" in out


def test_quickstart_fused_step_matches_jax_interp():
    got, want, ok = quickstart.fused_step_check("cpu")
    assert ok
    operands = [np.asarray(t) for t in quickstart.step_operands()]
    jw, jp, jv, jl, jt = (jnp.asarray(a.view(np.uint32) if i in (0, 1, 3)
                                      else a)
                          for i, a in enumerate(operands))
    jgot = jops.fused_snn_step(jw, jp, jv, jl, jt, backend="interp",
                               **quickstart.STEP_PARAMS)
    for a, b in zip(got, jgot):
        b = np.asarray(b)
        a = words_to_numpy(a) if b.dtype == np.uint32 else a.numpy()
        np.testing.assert_array_equal(a, b)
    out = _run("repro_torch.launch.quickstart", "--device", "cpu", "--train",
               "12", "--test", "6")
    assert "784-10 SNN accuracy:" in out
    assert "bit-exact vs plain version: True" in out
