"""The port's stream form of ``train_window_batch_encode`` against the
JAX package's stream drivers.

``ops.train_stream_batch_encode`` runs B training streams of N samples
in one launch on a card; on the CPU it runs its plain version, which
must equal the JAX package's ``engine.train_stream_batch`` with
intensities (``backend="ref"``) bit for bit: weights, LFSR lanes, the
last sample's v and every sample's spike counts.  The engine's stream
drivers, which call it once per stream on an in-kernel-encode plan, must
still equal JAX.  The kernel itself runs only on a card
(``test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rvsnn as jrvsnn
from repro.engine import SNNEngine as JEngine
from repro.engine import SNNEnginePlan as JPlan
from repro.engine import engine as jengine
from repro_torch import convert
from repro_torch.core.bitpack import as_words, words_to_numpy
from repro_torch.engine import (SNNEngine, SNNEnginePlan, train_stream,
                                train_stream_batch)
from repro_torch.kernels import ops

T = 6
# per-stream LTP probabilities: slow, always, never, and a u32 above 1023
LTP = np.array([16, 1023, 0, -1], np.int32)


def _params(n_in):
    """LIF/STDP parameters that make rows fire at this width."""
    return dict(threshold=max(8, n_in * 3 // 16), leak=5, w_exp=n_in // 6,
                gain=4, n_syn=n_in)


def _operands(seed, n_samples, b, n, n_in):
    """Random streams: weights ~50% ON, LFSR lanes in [1, 2^16), sparse
    intensities (a silent sample first), teacher currents from labels,
    seeds near both ends of the u32 range."""
    rng = np.random.default_rng(seed)
    w = -(-n_in // 32)
    weights = rng.integers(0, 2**32, (b, n, w), dtype=np.uint32)
    lfsr = rng.integers(1, 2**16, (b, n, w)).astype(np.uint32)
    inten = rng.integers(0, 256, (b, n_samples, n_in), dtype=np.uint8)
    inten[rng.random(inten.shape) < 0.5] = 0
    if n_samples:
        inten[:, 0] = 0
    labels = rng.integers(0, n, (b, n_samples))
    teach = np.where(np.arange(n) == labels[..., None], 64,
                     -300).astype(np.int32)
    seeds = rng.integers(-2**31, 2**31, (b, n_samples)).astype(np.int32)
    return weights, lfsr, inten, teach, seeds


def _jax_streams(weights, lfsr, inten, teach, seeds, ltp, kw):
    """The JAX package's train_stream_batch with intensities, ref ops."""
    b, n, w = weights.shape
    plan = JPlan(kernel_backend="ref", encode="kernel", **kw)
    rfs = jrvsnn.SnnRegFile(
        spike=jnp.zeros((b, w), jnp.uint32),
        v=jnp.zeros((b, n), jnp.int32), lfsr=jnp.asarray(lfsr),
        weights=jnp.asarray(weights))
    out, counts = jengine.train_stream_batch(
        JEngine(plan), rfs, teach=jnp.asarray(teach),
        ltp_prob=jnp.asarray(ltp), intensities=jnp.asarray(inten),
        seeds=jnp.asarray(seeds), n_steps=T)
    return out, np.asarray(counts)


@pytest.mark.parametrize("n_in", [784, 100])
@pytest.mark.parametrize("n", [10, 37])
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("n_samples", [0, 1, 5])
@pytest.mark.parametrize("seed_form", ["shared", "per_stream"])
def test_stream_plain_version_matches_jax(n_samples, b, n, n_in, seed_form):
    weights, lfsr, inten, teach, seeds = _operands(
        n_samples * 100 + b * 10 + n, n_samples, b, n, n_in)
    kw = _params(n_in)
    ltp = LTP[:b]
    # shared seeds: one per sample, the same for every stream
    jseeds = seeds[0] if seed_form == "shared" else seeds
    tseeds = (torch.from_numpy(seeds[0]) if seed_form == "shared"
              else torch.from_numpy(seeds.T.copy()))
    w2, v2, counts, lf2 = ops.train_stream_batch_encode(
        as_words(weights), torch.from_numpy(inten).transpose(0, 1), tseeds,
        as_words(lfsr), torch.from_numpy(teach).transpose(0, 1), n_steps=T,
        ltp_prob=torch.from_numpy(ltp), **kw)
    out, jcounts = _jax_streams(weights, lfsr, inten, teach, jseeds, ltp,
                                kw)
    np.testing.assert_array_equal(words_to_numpy(w2), np.asarray(out.weights))
    np.testing.assert_array_equal(words_to_numpy(lf2), np.asarray(out.lfsr))
    assert counts.shape == (n_samples, b, n) and counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.transpose(0, 1).numpy(), jcounts)
    if n_samples:
        np.testing.assert_array_equal(v2.numpy(), np.asarray(out.v))
        assert counts[-1].sum() > 0
    else:
        assert not v2.any()


def test_stream_reads_shared_operands_in_place():
    """A stream axis of stride 0 (one set of samples and teacher currents
    for every stream, as the parallel trainer passes them) equals the
    same operands copied out per stream."""
    weights, lfsr, inten, teach, seeds = _operands(3, 4, 3, 10, 784)
    x = torch.from_numpy(inten[0])[:, None].expand(4, 3, 784)
    tch = torch.from_numpy(teach[0])[:, None].expand(4, 3, 10)
    assert x.stride(1) == 0 and tch.stride(1) == 0
    kw = dict(_params(784), n_steps=T, ltp_prob=torch.from_numpy(LTP[:3]))
    shared = ops.train_stream_batch_encode(
        as_words(weights), x, torch.from_numpy(seeds[0]), as_words(lfsr),
        tch, **kw)
    copied = ops.train_stream_batch_encode(
        as_words(weights), x.contiguous(), torch.from_numpy(seeds[0]),
        as_words(lfsr), tch.contiguous(), **kw)
    for a, c in zip(shared, copied):
        assert torch.equal(a, c)


def test_stream_is_windows_from_zero_v_and_launches_nothing_on_the_cpu():
    """Sample by sample, the stream is the one-sample op from v = 0 with
    the weights and LFSR carried; on the CPU no kernel launches and no
    input is written."""
    weights, lfsr, inten, teach, seeds = _operands(5, 3, 2, 10, 100)
    ins = [as_words(weights), torch.from_numpy(inten).transpose(0, 1),
           torch.from_numpy(seeds.T.copy()), as_words(lfsr),
           torch.from_numpy(teach).transpose(0, 1)]
    before = [x.clone() for x in ins]
    launches = ops.launch_counts()
    kw = dict(_params(100), n_steps=T, ltp_prob=torch.from_numpy(LTP[:2]))
    w2, v2, counts, lf2 = ops.train_stream_batch_encode(*ins, **kw)
    w, lf = ins[0], ins[3]
    for i in range(3):
        w, v, fired, lf = ops.train_window_batch_encode(
            w, ins[1][i], ins[2][i], torch.zeros_like(v2), lf, ins[4][i],
            **kw)
        assert torch.equal(fired.sum(dim=1, dtype=torch.int32), counts[i])
    for a, c in zip((w, v, lf), (w2, v2, lf2)):
        assert torch.equal(a, c)
    assert ops.launch_counts() == launches
    for a, c in zip(ins, before):
        assert torch.equal(a, c)


@pytest.mark.parametrize("seeds,err", [
    (np.zeros(3, np.int32), "one per sample"),
    (np.zeros((2, 4), np.int32), "one per sample")])
def test_stream_rejects_seeds_of_another_shape(seeds, err):
    weights, lfsr, inten, teach, _ = _operands(7, 4, 2, 10, 100)
    with pytest.raises(ValueError, match=err):
        ops.train_stream_batch_encode(
            as_words(weights), torch.from_numpy(inten).transpose(0, 1),
            seeds, as_words(lfsr), torch.from_numpy(teach).transpose(0, 1),
            n_steps=T, **_params(100))


def _engines(**kw):
    p = dict(threshold=90, leak=4, w_exp=128, gain=4, n_syn=784,
             ltp_prob=16, encode="kernel", encode_seed=0x22A)
    p.update(kw)
    return (SNNEngine(SNNEnginePlan(**p), device="cpu"),
            JEngine(JPlan(kernel_backend="ref", **p)))


def _regfile(seed, lead=()):
    rng = np.random.default_rng(seed)
    return jrvsnn.SnnRegFile(
        spike=jnp.asarray(rng.integers(0, 2**32, lead + (25,),
                                       dtype=np.uint32)),
        v=jnp.asarray(rng.integers(0, 50, lead + (10,), dtype=np.int32)),
        lfsr=jnp.asarray(rng.integers(1, 2**16, lead + (10, 25))
                         .astype(np.uint32)),
        weights=jnp.asarray(rng.integers(0, 2**32, lead + (10, 25),
                                         dtype=np.uint32)))


def _assert_regfile(rf, jrf):
    got = convert.regfile_to_numpy(rf)
    for name in ("spike", "v", "lfsr", "weights"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(jrf, name)),
                                      err_msg=name)


@pytest.mark.parametrize("n_samples", [0, 1, 5])
@pytest.mark.parametrize("seeds", [None, "given"])
def test_engine_train_stream_matches_jax(n_samples, seeds):
    eng, jeng = _engines()
    _, _, inten, teach, sd = _operands(n_samples + 20, n_samples, 1, 10, 784)
    jrf = _regfile(n_samples)
    sd = None if seeds is None else sd[0]
    got = train_stream(eng, convert.regfile_from_jax(jrf), teach=teach[0],
                       intensities=inten[0], seeds=sd, n_steps=T)
    want = jengine.train_stream(
        jeng, jrf, teach=jnp.asarray(teach[0]),
        intensities=jnp.asarray(inten[0]),
        seeds=None if sd is None else jnp.asarray(sd), n_steps=T)
    _assert_regfile(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("n_samples", [1, 5])
@pytest.mark.parametrize("b", [1, 4])
def test_engine_train_stream_batch_matches_jax(n_samples, b):
    eng, jeng = _engines()
    _, _, inten, teach, sd = _operands(n_samples + b, n_samples, b, 10, 784)
    lp = LTP[:b]
    jrfs = _regfile(b, (b,))
    got = train_stream_batch(eng, convert.regfile_from_jax(jrfs),
                             teach=teach, ltp_prob=lp, intensities=inten,
                             seeds=sd, n_steps=T)
    want = jengine.train_stream_batch(
        jeng, jrfs, teach=jnp.asarray(teach), ltp_prob=jnp.asarray(lp),
        intensities=jnp.asarray(inten), seeds=jnp.asarray(sd), n_steps=T)
    _assert_regfile(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
