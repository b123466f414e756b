"""The port's LM layers against the JAX package's, on the CPU in float32.

norm, rope (both forms), the two MLPs, the fused qkv split, the chunked
prefill attention, decode attention, the layer's forward, and decode
steps through a ring-buffer wrap.  The same inputs, made with numpy, go
through both; atol = rtol = 2e-5 (float32 sums in a different order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import attention as jattn
from repro.models.layers import mlp as jmlp
from repro.models.layers import norm as jnorm
from repro.models.layers import rope as jrope
from repro_torch.models.layers import attention, mlp, norm, rope

TOL = dict(atol=2e-5, rtol=2e-5)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach().float().numpy()),
                               np.asarray(want, dtype=np.float32), **TOL)


def _t(tree):
    """numpy leaves -> torch tensors."""
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _jnp(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def test_norms():
    rng = np.random.default_rng(0)
    x = _rand(rng, 3, 5, 48, scale=3.0)
    p = {"scale": _rand(rng, 48), "bias": _rand(rng, 48)}
    _close(norm.rmsnorm(_t(p), torch.from_numpy(x)),
           jnorm.rmsnorm(_jnp(p), jnp.asarray(x)))
    _close(norm.layernorm(_t(p), torch.from_numpy(x)),
           jnorm.layernorm(_jnp(p), jnp.asarray(x)))


@pytest.mark.parametrize("d,theta", [(32, 1e4), (256, 1e6)])
def test_rope_both_forms(d, theta):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 3, 17, d)
    pos = rng.integers(0, 5000, 17).astype(np.int32)
    _close(rope.rope_freqs(d, theta), jrope.rope_freqs(d, theta))
    _close(rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    xb = _rand(rng, 4, 3, 1, d)
    pb = np.array([0, 7, 511, 4095], np.int32)
    _close(rope.apply_rope_per_batch(torch.from_numpy(xb),
                                     torch.from_numpy(pb), theta),
           jrope.apply_rope_per_batch(jnp.asarray(xb), jnp.asarray(pb), theta))


def test_mlps():
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 7, 64)
    sw = {k: np.asarray(v) for k, v in jmlp.swiglu_init(
        jax.random.key(0), 64, 96, jnp.float32).items()}
    _close(mlp.swiglu(_t(sw), torch.from_numpy(x)),
           jmlp.swiglu(_jnp(sw), jnp.asarray(x)))
    ge = {k: np.asarray(v) for k, v in jmlp.gelu_mlp_init(
        jax.random.key(1), 64, 96, jnp.float32).items()}
    ge["bi"], ge["bo"] = _rand(rng, 96), _rand(rng, 64)
    _close(mlp.gelu_mlp(_t(ge), torch.from_numpy(x)),
           jmlp.gelu_mlp(_jnp(ge), jnp.asarray(x)))


def _cfgs(window=None, bias=False, chunk_k=16):
    kw = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
              rope_theta=1e4, window=window, use_bias=bias, chunk_k=chunk_k)
    return attention.AttnConfig(**kw), jattn.AttnConfig(**kw)


def _attn_params(seed, bias):
    rng = np.random.default_rng(seed)
    p = {"wqkv": _rand(rng, 64, 128, scale=64 ** -0.5),
         "wo": _rand(rng, 64, 64, scale=64 ** -0.5)}
    if bias:
        p["bqkv"], p["bo"] = _rand(rng, 128), _rand(rng, 64)
    return p


def test_split_qkv():
    tc, jc = _cfgs(bias=True)
    p = _attn_params(3, True)
    x = _rand(np.random.default_rng(3), 2, 9, 64)
    got = attention._split_qkv(_t(p), torch.from_numpy(x), tc)
    want = jattn._split_qkv(_jnp(p), jnp.asarray(x), jc)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)


@pytest.mark.parametrize("causal,window,chunk_k,tq,tk", [
    (True, None, 16, 40, 40),       # chunk does not divide Tk
    (True, 7, 8, 33, 33),
    (False, None, 64, 20, 50),
    (True, 12, 16, 10, 45),         # queries at an offset
])
def test_chunked_attention(causal, window, chunk_k, tq, tk):
    rng = np.random.default_rng(4)
    q, k, v = _rand(rng, 2, 4, tq, 16), _rand(rng, 2, 2, tk, 16), \
        _rand(rng, 2, 2, tk, 16)
    off = tk - tq
    got = attention.chunked_attention(
        *map(torch.from_numpy, (q, k, v)), causal=causal, window=window,
        chunk_k=chunk_k, q_offset=off)
    want = jattn.chunked_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal, window=window,
        chunk_k=chunk_k, q_offset=off)
    _close(got, want)


@pytest.mark.parametrize("cache_len,window", [
    (13, None), (np.array([1, 9, 24, 17], np.int32), None),
    (np.array([3, 20, 24, 11], np.int32), 6)])
def test_decode_attention(cache_len, window):
    rng = np.random.default_rng(5)
    q = _rand(rng, 4, 4, 1, 16)
    kc, vc = _rand(rng, 4, 2, 24, 16), _rand(rng, 4, 2, 24, 16)
    got = attention.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.as_tensor(cache_len), window=window)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.asarray(cache_len),
                                  window=window)
    _close(got, want)


@pytest.mark.parametrize("window,bias", [(None, False), (8, True)])
def test_forward_returns_output_and_cache_kv(window, bias):
    tc, jc = _cfgs(window=window, bias=bias)
    p = _attn_params(6, bias)
    x = _rand(np.random.default_rng(6), 2, 21, 64)
    y, (k, v) = attention.forward(_t(p), torch.from_numpy(x), tc,
                                  return_kv=True)
    jy, (jk, jv) = jattn.forward(_jnp(p), jnp.asarray(x), jc,
                                 return_kv=True)
    for g, w in ((y, jy), (k, jk), (v, jv)):
        _close(g, w)


@pytest.mark.parametrize("window,max_len", [(8, 32), (None, 32), (8, 6)])
def test_decode_steps_through_a_ring_wrap(window, max_len):
    """Per-sequence cache lengths, from staggered starts, for more steps
    than the window holds: the ring buffer wraps (window 8 of 32), a
    window layer without a ring (max_len 6 < window) and a global layer
    fill plain caches, the first past its end (where both packages clamp
    the slot); the cache and output match at every step."""
    tc, jc = _cfgs(window=window)
    p = _attn_params(7, False)
    rng = np.random.default_rng(7)
    cache = attention.init_cache(3, tc, max_len, torch.float32)
    jcache = jattn.init_cache(3, jc, max_len, jnp.float32)
    lens = np.array([0, 2, 5], np.int32)
    for _ in range(12):
        x = _rand(rng, 3, 1, 64)
        y, cache = attention.decode_step(_t(p), torch.from_numpy(x), cache,
                                         torch.from_numpy(lens), tc)
        jy, jcache = jattn.decode_step(_jnp(p), jnp.asarray(x), jcache,
                                       jnp.asarray(lens), jc)
        _close(y, jy)
        _close(cache["k"], jcache["k"])
        _close(cache["v"], jcache["v"])
        lens = lens + 1
    # one step with a scalar cache length
    x = _rand(rng, 3, 1, 64)
    y, cache = attention.decode_step(_t(p), torch.from_numpy(x), cache, 4,
                                     tc)
    jy, jcache = jattn.decode_step(_jnp(p), jnp.asarray(x), jcache,
                                   jnp.int32(4), jc)
    _close(y, jy)
    _close(cache["k"], jcache["k"])
