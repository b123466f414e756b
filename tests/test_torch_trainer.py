"""The port's training engine and trainer against the JAX package's.

The engine's ``train`` / ``train_batch`` verbs, the stream drivers,
``refresh_weights`` and ``trainer.train`` run here on the CPU (the
kernels' plain versions) and must equal the JAX package (``ref``
kernels) bit for bit: weights, v, LFSR, the spike register, rasters,
counts, class maps and predictions.  Both packages start from the same
state, carried with ``repro_torch.convert``."""

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

from repro.configs.wenquxing_snn import WENQUXING_22A_INTENSITY as J_CFG
from repro.core import rvsnn as jrvsnn
from repro.core import trainer as jtrainer
from repro.core.preprocess import preprocess_batch as jpreprocess_batch
from repro.data.digits import make_digits
from repro.engine import SNNEngine as JEngine
from repro.engine import SNNEnginePlan as JPlan
from repro.engine import engine as jengine
from repro_torch import convert
from repro_torch.configs.wenquxing_snn import WENQUXING_22A_INTENSITY as CFG
from repro_torch.core import trainer
from repro_torch.core.bitpack import as_words, words_to_numpy
from repro_torch.engine import (SNNEngine, SNNEnginePlan, refresh_weights,
                                reset_between_samples, train_stream,
                                train_stream_batch)
from repro_torch.kernels import ops

REPO = Path(__file__).resolve().parents[1]
N_IN, N, T = 784, 10, 16
W = 25
SEEDS = np.array([-1, 0x7FFFFFFF, -0x80000000, 5], np.int32)


def _plans(encode="kernel", learn=True, **kw):
    p = dict(threshold=90, leak=4, w_exp=128 if learn else None, gain=4,
             n_syn=N_IN, ltp_prob=16, encode=encode, encode_seed=0x22A)
    p.update(kw)
    return SNNEnginePlan(**p), JPlan(kernel_backend="ref", **p)


def _engines(encode="kernel", learn=True, **kw):
    plan, jplan = _plans(encode, learn, **kw)
    return SNNEngine(plan, device="cpu"), JEngine(jplan)


def _data(seed, n_samples):
    rng = np.random.default_rng(seed)
    inten = rng.integers(0, 256, (n_samples, N_IN), dtype=np.uint8)
    inten[:, rng.random(N_IN) < 0.5] = 0
    spikes = (rng.integers(0, 2**32, (n_samples, T, W), dtype=np.uint32)
              & rng.integers(0, 2**32, (n_samples, T, W), dtype=np.uint32))
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


@pytest.mark.parametrize("form", ["windows", "host", "kernel"])
@pytest.mark.parametrize("learn", [True, False])
def test_engine_train_matches_jax(form, learn):
    eng, jeng = _engines("host" if form == "windows" else form, learn)
    inten, spikes, _, teach = _data(1, 1)
    jrf = _regfile(2)
    rf = convert.regfile_from_jax(jrf)
    if form == "windows":
        out = eng.train(rf, as_words(spikes[0]), torch.from_numpy(teach[0]))
        jout = jeng.train(jrf, jnp.asarray(spikes[0]), jnp.asarray(teach[0]))
    else:
        out = eng.train(rf, teach=teach[0], intensities=inten[0],
                        seed=int(SEEDS[0]), n_steps=T)
        jout = jeng.train(jrf, teach=jnp.asarray(teach[0]),
                          intensities=jnp.asarray(inten[0]),
                          seed=jnp.int32(SEEDS[0]), n_steps=T)
    _assert_regfile(out.regfile, jout.regfile)
    np.testing.assert_array_equal(out.fired.numpy(), np.asarray(jout.fired))
    np.testing.assert_array_equal(out.spike_counts.numpy(),
                                  np.asarray(jout.spike_counts))
    assert out.fired.any()
    # the input register file is not written
    _assert_regfile(rf, jrf)


@pytest.mark.parametrize("form", ["windows", "host", "kernel"])
def test_engine_train_batch_matches_jax(form):
    eng, jeng = _engines("host" if form == "windows" else form)
    b = 3
    inten, spikes, _, teach = _data(3, b)
    jrfs = _regfile(4, (b,))
    rfs = convert.regfile_from_jax(jrfs)
    lp = np.array([16, 1023, 0], np.int32)
    if form == "windows":
        got = eng.train_batch(rfs, as_words(spikes), teach, ltp_prob=lp)
        want = jeng.train_batch(jrfs, jnp.asarray(spikes),
                                jnp.asarray(teach), ltp_prob=jnp.asarray(lp))
    else:
        got = eng.train_batch(rfs, teach=teach, ltp_prob=lp,
                              intensities=inten, seeds=SEEDS[:b], n_steps=T)
        want = jeng.train_batch(jrfs, teach=jnp.asarray(teach),
                                ltp_prob=jnp.asarray(lp),
                                intensities=jnp.asarray(inten),
                                seeds=jnp.asarray(SEEDS[:b]), n_steps=T)
    _assert_regfile(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # stream b is one train call on regfile b (with its own ltp_prob)
    one_eng = SNNEngine(dataclasses.replace(eng.plan, ltp_prob=0),
                        device="cpu")
    rf2 = convert.regfile_from_jax(jax.tree.map(lambda x: x[2], jrfs))
    if form == "windows":
        one = one_eng.train(rf2, as_words(spikes[2]), teach[2])
    else:
        one = one_eng.train(rf2, teach=teach[2], intensities=inten[2],
                            seed=int(SEEDS[2]), n_steps=T)
    assert torch.equal(one.regfile.weights, got[0].weights[2])
    assert torch.equal(one.regfile.lfsr, got[0].lfsr[2])
    with pytest.raises(ValueError):
        _engines(learn=False)[0].train_batch(rfs, as_words(spikes), teach)


@pytest.mark.parametrize("form", ["windows", "intensities"])
def test_train_stream_matches_jax(form):
    eng, jeng = _engines("kernel")
    inten, spikes, _, teach = _data(5, 6)
    jrf = _regfile(6)
    rf = convert.regfile_from_jax(jrf)
    if form == "windows":
        got = train_stream(eng, rf, as_words(spikes), teach)
        want = jengine.train_stream(jeng, jrf, jnp.asarray(spikes),
                                    jnp.asarray(teach))
    else:
        got = train_stream(eng, rf, teach=teach, intensities=inten,
                           n_steps=T)
        want = jengine.train_stream(jeng, jrf, teach=jnp.asarray(teach),
                                    intensities=jnp.asarray(inten),
                                    n_steps=T)
    _assert_regfile(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].sum() > 0
    _assert_regfile(reset_between_samples(got[0]),
                    jengine.reset_between_samples(want[0]))


@pytest.mark.parametrize("form,seeds", [("windows", None),
                                        ("intensities", None),
                                        ("intensities", "shared"),
                                        ("intensities", "per_stream")])
def test_train_stream_batch_matches_jax(form, seeds):
    eng, jeng = _engines("kernel")
    b, n_samples = 2, 4
    inten, spikes, _, teach = _data(7, b * n_samples)
    inten = inten.reshape(b, n_samples, N_IN)
    spikes = spikes.reshape(b, n_samples, T, W)
    teach = teach.reshape(b, n_samples, N)
    sd = {None: None, "shared": SEEDS,
          "per_stream": np.stack([SEEDS, SEEDS[::-1]])}[seeds]
    lp = np.array([16, 1023], np.int32)
    jrfs = _regfile(8, (b,))
    rfs = convert.regfile_from_jax(jrfs)
    if form == "windows":
        got = train_stream_batch(eng, rfs, as_words(spikes), teach,
                                 ltp_prob=lp)
        want = jengine.train_stream_batch(jeng, jrfs, jnp.asarray(spikes),
                                          jnp.asarray(teach),
                                          ltp_prob=jnp.asarray(lp))
    else:
        got = train_stream_batch(eng, rfs, teach=teach, ltp_prob=lp,
                                 intensities=inten, seeds=sd, n_steps=T)
        want = jengine.train_stream_batch(
            jeng, jrfs, teach=jnp.asarray(teach), ltp_prob=jnp.asarray(lp),
            intensities=jnp.asarray(inten),
            seeds=None if sd is None else jnp.asarray(sd), n_steps=T)
    _assert_regfile(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("form", ["windows", "intensities"])
def test_refresh_weights_matches_jax_and_keeps_the_bank(form):
    eng, jeng = _engines("kernel")
    inten, spikes, labels, _ = _data(9, 5)
    bank = np.random.default_rng(10).integers(0, 2**32, (2 * N, W),
                                              dtype=np.uint32)
    w = as_words(bank)
    before = w.clone()
    kw = dict(labels=labels, n_classes=N, ltp_prob=np.array([16, 1023],
                                                            np.int32))
    if form == "windows":
        got = refresh_weights(eng, w, spike_trains=as_words(spikes), **kw)
        want = jengine.refresh_weights(jeng, jnp.asarray(bank),
                                       spike_trains=jnp.asarray(spikes),
                                       **kw)
    else:
        got = refresh_weights(eng, w, intensities=inten, seeds=SEEDS[:1],
                              n_steps=T, **kw)
        want = jengine.refresh_weights(jeng, jnp.asarray(bank),
                                       intensities=jnp.asarray(inten),
                                       seeds=jnp.asarray(SEEDS[:1]),
                                       n_steps=T, **kw)
    np.testing.assert_array_equal(words_to_numpy(got), np.asarray(want))
    assert torch.equal(w, before) and not torch.equal(got, before)
    with pytest.raises(ValueError):
        refresh_weights(eng, w[:N + 1], labels=labels, n_classes=N,
                        spike_trains=as_words(spikes))


def _digits(n, seed, n_neurons=20, epochs=2, **kw):
    imgs, labels = make_digits(n, seed=seed)
    x = np.asarray(jpreprocess_batch(jnp.asarray(imgs.reshape(-1, 28, 28)),
                                     0.1)).reshape(n, -1)
    cfg = dataclasses.replace(CFG, n_neurons=n_neurons, n_steps=T,
                              epochs=epochs, **kw)
    jcfg = dataclasses.replace(J_CFG, n_neurons=n_neurons, n_steps=T,
                               epochs=epochs, **kw)
    return x, labels, cfg, jcfg


@pytest.mark.parametrize("form", ["windows", "intensities"])
def test_train_block_matches_jax(form):
    x, labels, cfg, jcfg = _digits(12, 11, encode="host" if form ==
                                   "windows" else "kernel")
    key = jax.random.key(3)
    lfsr_seed = jtrainer._regfile_seed(key)
    lab = torch.from_numpy(labels.astype(np.int32))
    if form == "windows":
        trains = jnp.asarray(_data(12, 12)[1])
        want = jtrainer._train_block(jcfg, key, jnp.asarray(labels), 1,
                                     spike_trains=trains)
        got = trainer._train_block(cfg, lfsr_seed, lab, 1,
                                   spike_trains=as_words(np.asarray(trains)))
    else:
        inten = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) * 255), 0, 255)
                           ).astype(np.uint8)
        idx = np.arange(3, 15, dtype=np.int32)
        want = jtrainer._train_block(jcfg, key, jnp.asarray(labels), 0,
                                     intensities=jnp.asarray(inten),
                                     sample_idx=jnp.asarray(idx))
        got = trainer._train_block(cfg, lfsr_seed, lab, 0,
                                   intensities=torch.from_numpy(inten),
                                   sample_idx=torch.from_numpy(idx))
    np.testing.assert_array_equal(words_to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("form", ["windows", "intensities"])
def test_train_blocks_parallel_matches_jax(form):
    x, labels, cfg, jcfg = _digits(10, 12, n_neurons=30, train_mode=
                                   "parallel")
    key = jax.random.key(4)
    seeds = [int(s) + 1 for s in jax.random.choice(
        key, (1 << 16) - 1, (3,), replace=False)]
    lab = torch.from_numpy(labels.astype(np.int32))
    if form == "windows":
        trains = _data(13, 10)[1]
        want = jtrainer._train_blocks_parallel(
            jcfg, key, jnp.asarray(labels), spike_trains=jnp.asarray(trains))
        got = trainer._train_blocks_parallel(cfg, seeds, lab,
                                             spike_trains=as_words(trains))
    else:
        inten = _data(14, 10)[0]
        idx = np.arange(10, dtype=np.int32)
        want = jtrainer._train_blocks_parallel(
            jcfg, key, jnp.asarray(labels), intensities=jnp.asarray(inten),
            sample_idx=jnp.asarray(idx))
        got = trainer._train_blocks_parallel(
            cfg, seeds, lab, intensities=torch.from_numpy(inten),
            sample_idx=torch.from_numpy(idx))
    np.testing.assert_array_equal(words_to_numpy(got), np.asarray(want))


def _jax_block_seeds(jcfg):
    """The per-block LFSR seeds ``repro.core.trainer.train`` derives from
    its default key, in the order it draws them."""
    key = jax.random.key(jcfg.seed)
    key, _ = jax.random.split(key)        # the host-encode key
    if jcfg.train_mode == "parallel":
        _, bk = jax.random.split(key)
        return [int(s) + 1 for s in jax.random.choice(
            bk, (1 << 16) - 1, (jcfg.n_blocks,), replace=False)]
    seeds = []
    for _ in range(jcfg.n_blocks):
        key, bk = jax.random.split(key)
        seeds.append(jtrainer._regfile_seed(bk))
    return seeds


@pytest.mark.parametrize("mode,n,n_neurons,blank", [
    ("active", 40, 20, False), ("parallel", 40, 20, False),
    ("active", 2, 40, True)])
def test_train_end_to_end_matches_jax(mode, n, n_neurons, blank):
    x, labels, cfg, jcfg = _digits(n, 21, n_neurons=n_neurons,
                                   train_mode=mode)
    if blank:
        # blank images labeled 0: no neuron fires without the teacher, so
        # block 0 predicts class 0 for both and active learning stops
        x, labels = np.zeros_like(x), np.zeros_like(labels)
    jm = jtrainer.train(jcfg, x, labels)
    m = trainer.train(cfg, x, labels, block_seeds=_jax_block_seeds(jcfg),
                      device="cpu")
    np.testing.assert_array_equal(words_to_numpy(m.weights),
                                  np.asarray(jm.weights))
    np.testing.assert_array_equal(m.neuron_class.numpy(),
                                  np.asarray(jm.neuron_class))
    tx, tlabels, _, _ = _digits(24, 22)
    inten = np.asarray(jnp.clip(jnp.round(jnp.asarray(tx) * 255), 0, 255)
                       ).astype(np.uint8)
    seeds = np.arange(24, dtype=np.int32) * 7 - 50
    pred = trainer.classify(m, intensities=inten, seeds=seeds)
    jpred = jtrainer.classify(jm, intensities=jnp.asarray(inten),
                              seeds=jnp.asarray(seeds))
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jpred))
    acc = trainer.accuracy(m, labels=tlabels, intensities=inten,
                           seeds=seeds)
    assert acc == int((pred.numpy() == tlabels).sum()) / len(tlabels)
    # the JAX package's float32 mean rounds in its last place
    assert acc == pytest.approx(jtrainer.accuracy(
        jm, labels=jnp.asarray(tlabels), intensities=jnp.asarray(inten),
        seeds=jnp.asarray(seeds)), rel=1e-6)
    if blank:
        assert m.weights.shape[0] == jm.weights.shape[0] == cfg.n_classes


def test_train_draws_distinct_parallel_block_seeds_and_checks_its_input():
    x, labels, cfg, _ = _digits(3, 23, n_neurons=30, epochs=1,
                                train_mode="parallel")
    g = torch.Generator().manual_seed(0)
    seeds = trainer._block_seeds(cfg, g)
    assert len(set(seeds)) == 3 and all(1 <= s < 1 << 16 for s in seeds)
    m = trainer.train(cfg, x, labels, device="cpu")
    assert m.weights.shape == (30, W) and m.weights.device.type == "cpu"
    with pytest.raises(ValueError):
        trainer.train(dataclasses.replace(cfg, train_mode="bogus"), x,
                      labels, device="cpu")
    with pytest.raises(ValueError):
        trainer.train(cfg, x, labels, block_seeds=[1, 2], device="cpu")


def test_host_encode_training_runs_and_repeats_with_its_generator():
    x, labels, cfg, _ = _digits(6, 24, n_neurons=20, epochs=1,
                                encode="host")
    runs = [trainer.train(cfg, x, labels, device="cpu",
                          generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    assert torch.equal(runs[0].weights, runs[1].weights)
    counts = ops.launch_counts()
    assert all(v == 0 for v in counts.values())


def test_mnist_stdp_cli_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.mnist_stdp", "--device",
         "cpu", "--neurons", "20", "--train", "8", "--test", "6",
         "--epochs", "1", "--train-mode", "parallel"],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "test accuracy:" in proc.stdout
    assert "samples/s" in proc.stdout
