"""The port's training primitives against ``repro.core``.

STDP, the RV-SNN instructions and register files are bit-exact with the
JAX package; preprocessing agrees within atol 1e-5 (float32 sums in
another order); the Poisson encoder, whose PRNG bits cannot match
JAX's, is held to its rate.  State crosses with ``repro_torch.convert``
in both directions without changing a bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoder as jencoder
from repro.core import lif as jlif
from repro.core import rvsnn as jrvsnn
from repro.core import stdp as jstdp
from repro.core.preprocess import preprocess_batch as jpreprocess_batch
from repro.core.preprocess import soft_threshold as jsoft_threshold
from repro.core.trainer import SNNModel as JModel
from repro.data.digits import make_digits
from repro_torch import convert
from repro_torch.core import encoder, lif, rvsnn, stdp
from repro_torch.core.bitpack import as_words, words_to_numpy
from repro_torch.core.preprocess import (preprocess, preprocess_batch,
                                         soft_threshold)


def _stdp_operands(seed, n, w, fired_p):
    rng = np.random.default_rng(seed)
    weights = rng.integers(0, 2**32, (n, w), dtype=np.uint32)
    pre = rng.integers(0, 2**32, w, dtype=np.uint32)
    fired = rng.random(n) < fired_p
    lfsr = rng.integers(1, 2**16, (n, w)).astype(np.uint32)
    return weights, pre, fired, lfsr


@pytest.mark.parametrize("fired_p", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("ltp_prob", [0, 16, 1023])
@pytest.mark.parametrize("w_exp,gain", [(128, 4), (0, 2**28), (700, 3)])
def test_stdp_update_matches_jax(fired_p, ltp_prob, w_exp, gain):
    # gain 2**28 makes (pc - w_exp) * gain * 1024 wrap in int32
    weights, pre, fired, lfsr = _stdp_operands(ltp_prob + w_exp, 11, 25,
                                               fired_p)
    p = stdp.stdp_params(784, w_exp, gain, ltp_prob)
    w2, l2 = stdp.stdp_update(as_words(weights), as_words(pre),
                              torch.from_numpy(fired), as_words(lfsr), p)
    jw, jl = jstdp.stdp_update(jnp.asarray(weights), jnp.asarray(pre),
                               jnp.asarray(fired), jnp.asarray(lfsr),
                               jstdp.stdp_params(784, w_exp, gain, ltp_prob))
    np.testing.assert_array_equal(words_to_numpy(w2), np.asarray(jw))
    np.testing.assert_array_equal(words_to_numpy(l2), np.asarray(jl))
    if fired_p == 0.0:
        assert torch.equal(w2, as_words(weights))
        assert torch.equal(l2, as_words(lfsr))


def test_ltd_prob_wraps_in_int32_like_jax():
    pc = np.array([0, 1, 127, 128, 129, 300, 784, 70000], np.int32)
    for w_exp, gain, n_syn in ((128, 4, 784), (0, 2**28, 784),
                               (-2**31, 3, 7), (128, 2**31 - 1, 1)):
        got = stdp.ltd_prob(torch.from_numpy(pc),
                            stdp.STDPParams(w_exp, gain, n_syn, 0))
        want = jstdp.ltd_prob(jnp.asarray(pc), jstdp.STDPParams(
            jnp.int32(w_exp), jnp.int32(gain), jnp.int32(n_syn),
            jnp.uint32(0)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for pc_, w_exp in ((784, 128), (100, 128), (None, 256)):
        assert (stdp.ltd_prob_from_wexp(784, w_exp, pc_)
                == jstdp.ltd_prob_from_wexp(784, w_exp, pc_))


def test_stdp_update_per_stream_ltp_prob_equals_per_stream_calls():
    ops_ = [_stdp_operands(s, 6, 4, 0.7) for s in range(3)]
    lp = [0, 16, 1023]
    stack = [np.stack([o[i] for o in ops_]) for i in range(4)]
    w2, l2 = stdp.stdp_update(
        as_words(stack[0]), as_words(stack[1]), torch.from_numpy(stack[2]),
        as_words(stack[3]),
        stdp.STDPParams(100, 4, 128, torch.tensor(lp, dtype=torch.int32)))
    for i, (w, pre, f, lf) in enumerate(ops_):
        ww, ll = stdp.stdp_update(as_words(w), as_words(pre),
                                  torch.from_numpy(f), as_words(lf),
                                  stdp.STDPParams(100, 4, 128, lp[i]))
        assert torch.equal(w2[i], ww) and torch.equal(l2[i], ll)


@pytest.mark.parametrize("learn", [True, False])
def test_snn_step_matches_jax(learn):
    rng = np.random.default_rng(int(learn))
    weights = rng.integers(0, 2**32, (12, 25), dtype=np.uint32)
    rf = rvsnn.snn_regfile(as_words(weights), seed=0x1234)
    jrf = jrvsnn.snn_regfile(jnp.asarray(weights), seed=0x1234)
    teach = np.where(np.arange(12) == 3, 64, -1024).astype(np.int32)
    lp, jlp = lif.lif_params(100, 5), jlif.lif_params(100, 5)
    sp = stdp.stdp_params(784, 128, 4, 16) if learn else None
    jsp = jstdp.stdp_params(784, 128, 4, 16) if learn else None
    for t in range(6):
        words = rng.integers(0, 2**32, 25, dtype=np.uint32)
        tch = teach if t % 2 else None
        rf, fired = rvsnn.snn_step(
            rf, as_words(words), lp, sp,
            None if tch is None else torch.from_numpy(tch))
        jrf, jfired = jrvsnn.snn_step(
            jrf, jnp.asarray(words), jlp, jsp,
            None if tch is None else jnp.asarray(tch))
        np.testing.assert_array_equal(fired.numpy(), np.asarray(jfired))
    got = convert.regfile_to_numpy(rf)
    for name in ("spike", "v", "lfsr", "weights"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(jrf, name)))


@pytest.mark.parametrize("seed", [0, 0x22A, 0xFFFF, 0x1_0000, -1])
def test_snn_regfile_lanes_match_jax(seed):
    weights = np.full((7, 25), 0xFFFFFFFF, np.uint32)
    rf = convert.regfile_to_numpy(rvsnn.snn_regfile(as_words(weights),
                                                    seed=seed))
    jrf = jrvsnn.snn_regfile(jnp.asarray(weights), seed=seed & 0xFFFFFFFF)
    for name in ("spike", "v", "lfsr", "weights"):
        want = np.asarray(getattr(jrf, name))
        assert getattr(rf, name).dtype == want.dtype
        np.testing.assert_array_equal(getattr(rf, name), want)
    assert rf.lfsr.max() < 2**16 and rf.lfsr.min() > 0


def test_snn_regfile_batch_matches_jax_and_single_regfiles():
    weights = np.random.default_rng(1).integers(
        0, 2**32, (3, 5, 4), dtype=np.uint32)
    seeds = [1, 0x22A, 65535]
    rf = rvsnn.snn_regfile_batch(as_words(weights), seeds)
    jrf = jrvsnn.snn_regfile_batch(jnp.asarray(weights), seeds)
    got = convert.regfile_to_numpy(rf)
    for name in ("spike", "v", "lfsr", "weights"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(jrf, name)))
    for b, s in enumerate(seeds):
        one = rvsnn.snn_regfile(as_words(weights[b]), seed=s)
        assert torch.equal(one.lfsr, rf.lfsr[b])
    with pytest.raises(ValueError):
        rvsnn.snn_regfile_batch(as_words(weights), seeds[:2])


def test_preprocess_batch_matches_jax_within_float_tolerance():
    imgs, _ = make_digits(12, seed=4)
    x = imgs.reshape(-1, 28, 28)
    got = preprocess_batch(torch.from_numpy(x), 0.1)
    want = np.asarray(jpreprocess_batch(jnp.asarray(x), 0.1))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(preprocess(torch.from_numpy(x[0])).numpy(),
                               want[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        soft_threshold(torch.from_numpy(x)).numpy(),
        np.asarray(jsoft_threshold(jnp.asarray(x))), rtol=0, atol=1e-6)


def test_poisson_encode_fires_at_the_intensity_rate():
    x = torch.linspace(0.0, 1.0, 64)
    g = torch.Generator().manual_seed(7)
    packed = encoder.poisson_encode_batch(g, x.expand(8, 64), 512)
    assert packed.shape == (8, 512, 2) and packed.dtype == torch.int32
    rate = torch.stack([encoder.spike_rate_per_input(p, 64)
                        for p in packed]).mean(dim=0)
    # 4096 Bernoulli draws per input: 4 standard deviations < 0.032
    assert (rate - x).abs().max() < 0.032
    assert rate[0] == 0.0 and rate[-1] == 1.0
    one = encoder.poisson_encode(torch.Generator().manual_seed(7), x, 512)
    assert torch.equal(one, packed[0])


def test_spike_rates_match_jax_on_the_same_raster():
    rng = np.random.default_rng(2)
    packed = jencoder.encode_from_counter(
        5, jnp.asarray(rng.integers(0, 256, 70, dtype=np.uint8)), 16)
    words = as_words(np.asarray(packed))
    np.testing.assert_allclose(encoder.spike_rate(words, 70).numpy(),
                               np.asarray(jencoder.spike_rate(packed, 70)),
                               rtol=1e-6)
    np.testing.assert_allclose(
        encoder.spike_rate_per_input(words, 70).numpy(),
        np.asarray(jencoder.spike_rate_per_input(packed, 70)), rtol=1e-6)


@pytest.mark.parametrize("batched", [False, True])
def test_regfile_round_trips_bit_for_bit(batched):
    rng = np.random.default_rng(int(batched))
    lead = (3,) if batched else ()
    jrf = jrvsnn.SnnRegFile(
        spike=jnp.asarray(rng.integers(0, 2**32, lead + (25,),
                                       dtype=np.uint32)),
        v=jnp.asarray(rng.integers(-2**31, 2**31, lead + (10,),
                                   dtype=np.int32)),
        lfsr=jnp.asarray(rng.integers(0, 2**32, lead + (10, 25),
                                      dtype=np.uint32)),
        weights=jnp.asarray(rng.integers(0, 2**32, lead + (10, 25),
                                         dtype=np.uint32)))
    rf = convert.regfile_from_jax(jrf)
    assert all(t.dtype == torch.int32 for t in rf)
    back = convert.regfile_to_numpy(rf)
    for name in ("spike", "v", "lfsr", "weights"):
        want = np.asarray(getattr(jrf, name))
        assert getattr(back, name).dtype == want.dtype
        np.testing.assert_array_equal(getattr(back, name), want)
    with pytest.raises(ValueError):
        convert.regfile_from_jax(jrf._replace(v=jrf.v.astype(jnp.int16)))


def test_model_from_jax_carries_weights_and_classes():
    rng = np.random.default_rng(0)
    jm = JModel(jnp.asarray(rng.integers(0, 2**32, (20, 25),
                                         dtype=np.uint32)),
                jnp.tile(jnp.arange(10, dtype=jnp.int32), 2))
    m = convert.model_from_jax(jm, cfg="cfg")
    np.testing.assert_array_equal(words_to_numpy(m.weights),
                                  np.asarray(jm.weights))
    np.testing.assert_array_equal(m.neuron_class.numpy(),
                                  np.asarray(jm.neuron_class))
    assert m.neuron_class.dtype == torch.int32 and m.cfg == "cfg"
