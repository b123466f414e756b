"""The port's integer SNN primitives are bit-exact with ``repro.core``.

Both sides get the same numpy inputs from a seed; u32 words cross as
numpy uint32 (the port holds them as int32 bit patterns)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitpack as jbitpack
from repro.core import encoder as jencoder
from repro.core import lfsr as jlfsr
from repro.core import lif as jlif
from repro.core import stdp as jstdp
from repro.serving.weights import weight_fingerprint as jfingerprint
from repro_torch.convert import weights_from_jax, weights_to_numpy
from repro_torch.core import bitpack, encoder, lfsr, lif, stdp
from repro_torch.core.bitpack import as_words, words_to_numpy
from repro_torch.serving.weights import weight_fingerprint

# seeds near both ends of the u32 range, as i32 bit patterns
EDGE_SEEDS = np.array([0, 1, 0x7FFFFFFF, -0x80000000, -1, -2, 0x22A,
                       -123456789], np.int32)


def _u32(rng, shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint32)


def _intensities(rng, b, n):
    x = rng.integers(0, 256, (b, n), dtype=np.uint8)
    x[:, :3] = 0          # silent inputs
    x[:, 3:6] = 255       # near-certain inputs
    return x


@pytest.mark.parametrize("n", [1, 31, 32, 70, 784])
def test_bitpack_matches_jax(n):
    rng = np.random.default_rng(n)
    bits = rng.integers(0, 2, (3, n)).astype(np.int32)
    packed = bitpack.pack(torch.from_numpy(bits))
    want = np.asarray(jbitpack.pack(jnp.asarray(bits)))
    np.testing.assert_array_equal(words_to_numpy(packed), want)
    np.testing.assert_array_equal(bitpack.unpack(packed, n).numpy(), bits)
    np.testing.assert_array_equal(words_to_numpy(bitpack.tail_mask(n)),
                                  np.asarray(jbitpack.tail_mask(n)))
    assert bitpack.n_words(n) == jbitpack.n_words(n)
    words = _u32(rng, (4, bitpack.n_words(n)))
    np.testing.assert_array_equal(
        bitpack.popcount(as_words(words)).numpy(),
        np.asarray(jbitpack.popcount(jnp.asarray(words))))
    np.testing.assert_array_equal(
        bitpack.unpack(as_words(words), n).numpy(),
        np.asarray(jbitpack.unpack(jnp.asarray(words), n)))


def test_words_round_trip_through_int32_bit_patterns():
    words = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF],
                     np.uint32)
    t = as_words(words)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(words_to_numpy(t), words)
    np.testing.assert_array_equal(
        bitpack.as_u32(t).numpy(), words.astype(np.int64))
    np.testing.assert_array_equal(
        bitpack.as_i32(bitpack.as_u32(t)).numpy(), t.numpy())


@pytest.mark.parametrize("base", [0, 5, 0xFFFF, 0x12345])
def test_lfsr_seed_step_draw10_match_jax(base):
    s_t = lfsr.seed(base, 300)
    s_j = jlfsr.seed(base, 300)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    for _ in range(5):
        s_t, x_t = lfsr.draw10(s_t)
        s_j, x_j = jlfsr.draw10(s_j)
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
        np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))


def test_mul32_wraps_to_the_low_32_bits():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, 1000, dtype=np.uint64)
    x[:3] = [0, 2**32 - 1, 2**31]
    for c in (lfsr.PHI32, 0x846CA68B, 0xFFFFFFFF, 1):
        got = lfsr.mul32(torch.from_numpy(x.astype(np.int64)), c).numpy()
        want = [(int(v) * c) % 2**32 for v in x]
        np.testing.assert_array_equal(got, want)


def test_counter_hash_matches_jax_at_edge_seeds():
    rng = np.random.default_rng(1)
    cycles = np.concatenate([np.arange(8), [2**31, 2**32 - 1]]
                            ).astype(np.uint32)
    idx = np.concatenate([np.arange(40), rng.integers(0, 2**32, 8)]
                         ).astype(np.uint32)
    got = lfsr.counter_hash(
        torch.from_numpy(EDGE_SEEDS)[:, None, None],
        torch.from_numpy(cycles.astype(np.int64))[None, :, None],
        torch.from_numpy(idx.astype(np.int64))[None, None, :]).numpy()
    want = np.asarray(jlfsr.counter_hash(
        jnp.asarray(EDGE_SEEDS.view(np.uint32))[:, None, None],
        jnp.asarray(cycles)[None, :, None], jnp.asarray(idx)[None, None, :]))
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("n_in", [70, 784])
def test_encode_from_counter_matches_jax(n_in):
    rng = np.random.default_rng(n_in)
    inten = _intensities(rng, len(EDGE_SEEDS), n_in)
    got = encoder.encode_from_counter_batch(
        torch.from_numpy(EDGE_SEEDS), torch.from_numpy(inten), 9)
    want = jencoder.encode_from_counter_batch(
        jnp.asarray(EDGE_SEEDS), jnp.asarray(inten), 9)
    np.testing.assert_array_equal(words_to_numpy(got), np.asarray(want))
    one = encoder.encode_from_counter(int(EDGE_SEEDS[4]),
                                      torch.from_numpy(inten[4]), 3, t0=6)
    np.testing.assert_array_equal(words_to_numpy(one),
                                  np.asarray(want)[4, 6:9])


def test_encode_windows_host_zero_masks_past_t_total():
    rng = np.random.default_rng(2)
    inten = _intensities(rng, 4, 70)
    seeds = EDGE_SEEDS[:4]
    t_total = np.array([9, 4, 0, 12], np.int32)    # 12 > T clips
    got = encoder.encode_windows_host(
        torch.from_numpy(seeds), torch.from_numpy(inten), 9, 5,
        torch.from_numpy(t_total))
    want = jencoder.encode_windows_host(
        jnp.asarray(seeds), jnp.asarray(inten), 9, 5, jnp.asarray(t_total))
    np.testing.assert_array_equal(words_to_numpy(got), np.asarray(want))
    assert not words_to_numpy(got)[2].any()


def test_quantize_and_sample_seeds_match_jax():
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.1, 1.1, (5, 50)).astype(np.float32)
    x[0, :4] = [0.5 / 255, 1.5 / 255, 2.5 / 255, 1.0]   # ties round even
    np.testing.assert_array_equal(
        encoder.quantize_intensities(x).numpy(),
        np.asarray(jencoder.quantize_intensities(jnp.asarray(x))))
    for base in (0, 0x22A, 2**32 - 5):
        for epoch in (0, 3):
            np.testing.assert_array_equal(
                encoder.sample_seeds(base, 64, epoch).numpy(),
                np.asarray(jencoder.sample_seeds(base, 64, epoch)))
    idx = np.array([0, 7, 2**31, 2**32 - 1], np.uint32)
    np.testing.assert_array_equal(
        encoder.sample_seeds_at(9, torch.from_numpy(idx.astype(np.int64)),
                                2).numpy(),
        np.asarray(jencoder.sample_seeds_at(9, jnp.asarray(idx), 2)))


def test_lif_step_matches_jax():
    rng = np.random.default_rng(4)
    v = rng.integers(0, 300, 64).astype(np.int32)
    count = rng.integers(-100, 200, 64).astype(np.int32)
    v_t, f_t = lif.lif_step(torch.from_numpy(v), torch.from_numpy(count),
                            lif.lif_params(192, 16))
    v_j, f_j = jlif.lif_step(jnp.asarray(v), jnp.asarray(count),
                             jlif.lif_params(192, 16))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    assert stdp.stdp_params(784, 128) == tuple(
        int(x) for x in jstdp.stdp_params(784, 128))


@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("shape,seed", [((40, 25), 0), ((7, 3), 11)])
def test_init_weights_bit_exact(dense, shape, seed):
    got = stdp.init_weights(*shape, density_seed=seed, dense=dense)
    want = np.asarray(jstdp.init_weights(*shape, density_seed=seed,
                                         dense=dense))
    np.testing.assert_array_equal(words_to_numpy(got), want)
    assert weight_fingerprint(got) == jfingerprint(want)


def test_weights_carried_across_unchanged():
    rng = np.random.default_rng(5)
    w = _u32(rng, (40, 25))
    bank, classes = weights_from_jax(w, np.tile(np.arange(10), 4),
                                     device="cpu")
    assert bank.dtype == torch.int32 and bank.shape == (40, 25)
    np.testing.assert_array_equal(weights_to_numpy(bank), w)
    np.testing.assert_array_equal(classes, np.tile(np.arange(10), 4))
    with pytest.raises(ValueError):
        weights_from_jax(w.astype(np.int64))
    with pytest.raises(ValueError):
        weights_from_jax(w, np.arange(3))
