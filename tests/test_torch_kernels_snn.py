"""The port's serving ops against the JAX package's.

On the CPU the ops run their plain versions; counts must equal the JAX
``backend="ref"`` ops exactly (and, for the encode op, the Pallas
kernel in interpret mode).  The CUDA kernels themselves run only on a
card: ``test_torch_cuda.py`` holds them against the plain versions
there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core.bitpack import as_words
from repro_torch.kernels import ops

SEEDS = np.array([0, -1, 0x7FFFFFFF, -0x80000000, 0x22A, -7], np.int32)


def _bank(rng, n, w):
    return rng.integers(0, 2**32, (n, w), dtype=np.uint32)


def _sparse_windows(rng, b, t, w):
    # ~25% density so counts sit near the threshold
    a = rng.integers(0, 2**32, (b, t, w), dtype=np.uint32)
    return a & rng.integers(0, 2**32, (b, t, w), dtype=np.uint32)


def _encode_operands(seed, b, n_in, n, t):
    rng = np.random.default_rng(seed)
    w = -(-n_in // 32)
    inten = rng.integers(0, 256, (b, n_in), dtype=np.uint8)
    inten[0] = 0                               # a silent sample
    inten[1 % b, : n_in // 2] = 255
    t_total = rng.integers(0, t + 1, b).astype(np.int32)
    t_total[0], t_total[-1] = 0, t             # ragged, incl. 0 and T
    seeds = np.resize(SEEDS, b)
    return _bank(rng, n, w), inten, seeds, t_total


@pytest.mark.parametrize("b,t,n,w", [(3, 9, 33, 7), (4, 16, 40, 25),
                                     (1, 1, 1, 1)])
def test_infer_window_batch_plain_matches_jax(b, t, n, w):
    rng = np.random.default_rng(b * 100 + n)
    bank, wins = _bank(rng, n, w), _sparse_windows(rng, b, t, w)
    thr, leak = 3 * w, 2
    got = ops.infer_window_batch(as_words(bank),
                                 as_words(wins), threshold=thr,
                                 leak=leak)
    want = jops.infer_window_batch(jnp.asarray(bank), jnp.asarray(wins),
                                   threshold=thr, leak=leak, backend="ref")
    assert got.dtype == torch.int32 and got.shape == (b, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.sum() > 0


@pytest.mark.parametrize("b,n_in,n,t", [(6, 200, 33, 9), (4, 784, 40, 24)])
def test_infer_window_batch_encode_plain_matches_jax(b, n_in, n, t):
    bank, inten, seeds, t_total = _encode_operands(n_in, b, n_in, n, t)
    thr, leak = n_in // 8, 3
    got = ops.infer_window_batch_encode(
        as_words(bank), torch.from_numpy(inten),
        torch.from_numpy(seeds), n_steps=t, threshold=thr, leak=leak,
        t_total=torch.from_numpy(t_total))
    want = jops.infer_window_batch_encode(
        jnp.asarray(bank), jnp.asarray(inten), jnp.asarray(seeds),
        n_steps=t, threshold=thr, leak=leak, t_total=jnp.asarray(t_total),
        backend="ref")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[0].any() and got.sum() > 0


def test_infer_window_batch_encode_plain_matches_pallas_interp():
    bank, inten, seeds, t_total = _encode_operands(7, 3, 200, 33, 9)
    got = ops.infer_window_batch_encode(
        as_words(bank), torch.from_numpy(inten),
        torch.from_numpy(seeds), n_steps=9, threshold=25, leak=2,
        t_total=torch.from_numpy(t_total))
    want = jops.infer_window_batch_encode(
        jnp.asarray(bank), jnp.asarray(inten), jnp.asarray(seeds),
        n_steps=9, threshold=25, leak=2, t_total=jnp.asarray(t_total),
        backend="interp")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    bank, inten, seeds, t_total = _encode_operands(8, 3, 64, 10, 8)
    w = as_words(bank)
    before = ops.launch_counts()
    for backend in ("kernel", "ref"):
        enc = ops.infer_window_batch_encode(
            w, torch.from_numpy(inten), torch.from_numpy(seeds), n_steps=8,
            threshold=8, leak=1, t_total=t_total, backend=backend)
        win = ops.infer_window_batch(
            w, as_words(_sparse_windows(np.random.default_rng(0),
                                                3, 8, 2)),
            threshold=8, leak=1, backend=backend)
        assert enc.shape == win.shape == (3, 10)
    assert ops.launch_counts() == before
    with pytest.raises(ValueError):
        ops.infer_window_batch(w, w[None], threshold=1, leak=0,
                               backend="interp")


def test_default_t_total_and_scalar_seed_broadcast():
    bank, inten, _, _ = _encode_operands(9, 4, 100, 12, 6)
    w, x = as_words(bank), torch.from_numpy(inten)
    full = ops.infer_window_batch_encode(w, x, 5, n_steps=6, threshold=10,
                                         leak=1)
    ragged = ops.infer_window_batch_encode(
        w, x, torch.full((4,), 5, dtype=torch.int32), n_steps=6,
        threshold=10, leak=1, t_total=[6] * 4)
    assert torch.equal(full, ragged)


def test_seed_vector_takes_seeds_mod_2_32():
    neg = torch.tensor([-1, -0x80000000, 7], dtype=torch.int32)
    as_u32 = np.array([-1, -0x80000000, 7], np.int32).view(np.uint32)
    for seeds in (neg, torch.from_numpy(as_u32.astype(np.int64)),
                  as_u32.tolist()):
        got = ops.seed_vector(seeds, 3, torch.device("cpu"))
        assert got.dtype == torch.int32 and torch.equal(got, neg)
    assert ops.seed_vector(neg, 3, torch.device("cpu")) is neg
    assert torch.equal(ops.seed_vector(2**32 + 5, 2, torch.device("cpu")),
                       torch.tensor([5, 5], dtype=torch.int32))


# --- the encode kernel's order of work, modelled in numpy --------------------
#
# ``infer_window_enc_kernel`` (and its GEMM regime) no longer runs a cycle
# at a time: it draws a sample's whole window, takes every synaptic sum
# c[t][i] = popcount(pre_t & w_i) at once (they depend on no state), and
# only then scans the LIF over them, stopping at t_total.  The model below
# does the same, in numpy, apart from the JAX package and the port.

def _counter_hash(seed, cycle, idx):
    """The counter hash in wrapping uint32 numpy arithmetic."""
    h = (np.uint32(seed) + np.asarray(cycle, np.uint32) * np.uint32(0x9E3779B9)
         + np.asarray(idx, np.uint32) * np.uint32(0x85EBCA6B))
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x7FEB352D)
    h ^= h >> np.uint32(15)
    h *= np.uint32(0x846CA68B)
    return h ^ (h >> np.uint32(16))


def _popcount(x):
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1, dtype=np.int64)


def kernel_order_model(bank, inten, seeds, t_total, n_steps, threshold,
                       leak):
    """counts int32[B, n]: the window drawn whole, all sums, the scan."""
    n, w = bank.shape
    counts = np.zeros((inten.shape[0], n), np.int32)
    idx = np.arange(32 * w, dtype=np.uint32)
    for b, (x, seed) in enumerate(zip(inten, seeds)):
        t_end = int(np.clip(t_total[b], 0, n_steps))
        xp = np.zeros(32 * w, np.uint32)
        xp[:x.size] = x
        t = np.arange(t_end, dtype=np.uint32)[:, None]
        bits = (_counter_hash(np.int32(seed).view(np.uint32), t, idx)
                & np.uint32(0xFF)) < xp
        pre = (bits.reshape(t_end, w, 32).astype(np.uint32)
               << np.arange(32, dtype=np.uint32)).sum(-1, dtype=np.uint32)
        c = _popcount((pre[:, None, :] & bank[None])[..., None])  # [t, n, w]
        c = c.sum(-1)                                             # all sums
        v = np.zeros(n, np.int64)
        for ct in c:                                    # the only serial part
            v = v + ct
            fired = v >= threshold
            v = np.where(fired, 0, np.maximum(v - leak, 0))
            counts[b] += fired
    return counts


@pytest.mark.parametrize("b,n_in,n,t,threshold", [
    (1, 784, 37, 72, 192), (33, 784, 37, 24, 192), (4, 100, 130, 9, 1),
    (33, 100, 37, 16, 1), (2, 4096, 130, 12, 192), (1, 4096, 37, 5, 1)])
def test_encode_kernel_order_equals_jax(b, n_in, n, t, threshold):
    bank, inten, seeds, t_total = _encode_operands(n_in + b, b, n_in, n, t)
    if b > 2:
        t_total[1] = t // 2                      # partial
    leak = 3
    got = kernel_order_model(bank, inten, seeds, t_total, t, threshold, leak)
    want = jops.infer_window_batch_encode(
        jnp.asarray(bank), jnp.asarray(inten), jnp.asarray(seeds),
        n_steps=t, threshold=threshold, leak=leak,
        t_total=jnp.asarray(t_total), backend="ref")
    np.testing.assert_array_equal(got, np.asarray(want))
    if b > 1:
        assert not got[0].any()                  # t_total 0
    assert got.sum() > 0


def test_encode_kernel_order_equals_pallas_interp():
    bank, inten, seeds, t_total = _encode_operands(11, 3, 100, 37, 9)
    got = kernel_order_model(bank, inten, seeds, t_total, 9, 1, 2)
    want = jops.infer_window_batch_encode(
        jnp.asarray(bank), jnp.asarray(inten), jnp.asarray(seeds),
        n_steps=9, threshold=1, leak=2, t_total=jnp.asarray(t_total),
        backend="interp")
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.sum() > 0


# --- the pre-packed kernel's order of work, modelled in numpy ----------------
#
# ``infer_window_pre_kernel`` (window regime) and
# ``infer_window_pre_sums_kernel`` (GEMM regime) take every synaptic sum
# first and scan the LIF over all T cycles after, as the encode kernel
# does.  The window regime splits a sample's cycles over the C blocks of
# its cluster; the GEMM regime splits the words over the G blocks of a
# (64-neuron tile, sample)'s cluster, in whole 32-word chunks, and adds
# their partial sums one pass of 72 cycles at a time, carrying v and the
# count from pass to pass.  The models below do the same, in numpy, from
# one table of per-word popcounts.

_CHUNK, _PASS, _TILE = 32, 72, 64


def _word_popcounts(bank, wins):
    """popcount(wins[b, t, k] & bank[i, k]) as int64[B, T, n, w]."""
    x = wins[:, :, None, :] & bank[None, None]
    return np.unpackbits(x.view(np.uint8).reshape(x.shape + (4,)),
                         axis=-1).sum(-1, dtype=np.int64)


def _lif_scan(c, v, cnt, threshold, leak):
    """The LIF over the cycles of c [T, n], from (v, cnt)."""
    for ct in c:
        v = v + ct
        fired = v >= threshold
        v = np.where(fired, 0, np.maximum(v - leak, 0))
        cnt = cnt + fired
    return v, cnt


def prepacked_window_model(bank, wins, threshold, leak, cluster):
    """counts int32[B, n]: rank r of a sample's cluster sums cycles
    [r per, (r + 1) per), per = ceil(T / C), for every neuron into the
    leader's [T, n] table; the leader scans all T cycles."""
    pc = _word_popcounts(bank, wins)
    n_b, t = wins.shape[:2]
    n = bank.shape[0]
    per = -(-t // cluster)
    counts = np.zeros((n_b, n), np.int32)
    for b in range(n_b):
        c = np.full((t, n), -1, np.int64)
        for rank in range(cluster):
            lo = min(rank * per, t)
            hi = min(lo + per, t)
            c[lo:hi] = pc[b, lo:hi].sum(-1)
        assert (c >= 0).all()                  # every cycle summed once
        counts[b] = _lif_scan(c, np.zeros(n, np.int64),
                              np.zeros(n, np.int64), threshold, leak)[1]
    return counts


def prepacked_gemm_model(bank, wins, threshold, leak, split):
    """counts int32[B, n]: per (64-neuron tile, sample), rank g of the
    ``split`` ranks sums words [g slice, (g + 1) slice) (slice whole
    32-word chunks) chunk by chunk; each pass of 72 cycles adds the ranks'
    partial sums, then scans them."""
    pc = _word_popcounts(bank, wins)
    n_b, t, w = wins.shape
    n = bank.shape[0]
    slice_ = -(-(-(-w // _CHUNK)) // split) * _CHUNK
    counts = np.zeros((n_b, n), np.int32)
    for b in range(n_b):
        for row0 in range(0, n, _TILE):
            rows = slice(row0, min(row0 + _TILE, n))
            v = np.zeros(rows.stop - row0, np.int64)
            cnt = np.zeros_like(v)
            for t0 in range(0, t, _PASS):
                cyc = slice(t0, min(t0 + _PASS, t))
                c = 0
                for rank in range(split):
                    k_hi = min(rank * slice_ + slice_, w)
                    for kc in range(rank * slice_, k_hi, _CHUNK):
                        c = c + pc[b, cyc, rows, kc:min(kc + _CHUNK, k_hi)
                                   ].sum(-1)
                v, cnt = _lif_scan(c, v, cnt, threshold, leak)
            counts[b, rows] = cnt
    return counts


@pytest.mark.parametrize("n", [1, 37, 40, 130])
@pytest.mark.parametrize("t", [0, 1, 8, 72, 75])
@pytest.mark.parametrize("threshold", [0, 1, 400])
def test_prepacked_kernel_order_equals_jax(threshold, t, n):
    """Both regimes' order of work on zero-masked ragged windows (100
    words: 3,200 inputs, threshold up to n_in / 8) at several cluster
    sizes equals JAX's ``infer_window_batch``, and so does the plain
    version the CPU op runs."""
    rng = np.random.default_rng(1000 * t + n + threshold)
    b, w, leak = 3, 100, 3
    bank, wins = _bank(rng, n, w), _sparse_windows(rng, b, t, w)
    t_total = np.array([0, t // 2, t])         # ragged, incl. 0 and T
    wins[np.arange(t)[None, :] >= t_total[:, None]] = 0
    want = np.asarray(jops.infer_window_batch(
        jnp.asarray(bank), jnp.asarray(wins), threshold=threshold, leak=leak,
        backend="ref"))
    for cluster in (1, 3, 8):
        np.testing.assert_array_equal(
            prepacked_window_model(bank, wins, threshold, leak, cluster),
            want)
    for split in (1, 3):
        np.testing.assert_array_equal(
            prepacked_gemm_model(bank, wins, threshold, leak, split), want)
    got = ops.infer_window_batch(as_words(bank), as_words(wins),
                                 threshold=threshold, leak=leak)
    np.testing.assert_array_equal(got.numpy(), want)
    if threshold == 0:          # an empty cycle fires: every cycle counts
        assert (want == t).all()
