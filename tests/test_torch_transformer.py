"""The port's LM against the JAX package's, on the CPU in float32.

``reduced(gemma3-1b)`` (6 layers: 5 with a 16-token window, 1 global;
GQA group 4; tied embeddings) and ``reduced(starcoder2-3b)`` (biases, an
untied head), with the JAX params carried across by
``convert.lm_params_from_jax``: prefill logits and caches (prompts
shorter and longer than the window, so the ring buffer is filled both
ways), and decode steps that wrap the ring.  atol = rtol = 1e-4: the
sums run in a different order over 6 layers and the head.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models.transformer import Model as JModel
from repro_torch import convert
from repro_torch.configs.base import get_config, reduced
from repro_torch.models.transformer import Model

TOL = dict(atol=1e-4, rtol=1e-4)


def _pair(arch, n_layers=None):
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    if n_layers:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    jmodel = JModel(jcfg, dtype=jnp.float32, attn_chunk=16)
    params = jmodel.init_params(jax.random.key(0))
    model = Model(cfg, torch.float32, attn_chunk=16, device="cpu",
                  seed=None)
    convert.lm_params_from_jax(model, params)
    return jmodel, params, model


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


def _caches_close(cache, jcache, model):
    mine = convert.lm_cache_to_numpy(cache)
    theirs = convert.lm_cache_to_numpy(
        convert.lm_cache_from_jax(model, jcache))
    assert len(mine) == len(theirs) == model.cfg.n_layers
    for a, b in zip(mine, theirs):
        for name in ("k", "v"):
            assert a[name].shape == b[name].shape
            _close(a[name], b[name])


def test_reduced_configs_are_the_jax_packages():
    for arch in ("gemma3-1b", "starcoder2-3b", "llama3-405b",
                 "command-r-35b"):
        assert (dataclasses.asdict(reduced(get_config(arch)))
                == dataclasses.asdict(jreduced(jget_config(arch))))
        assert (get_config(arch).n_params()
                == jget_config(arch).n_params())


@pytest.mark.parametrize("arch,t", [("gemma3-1b", 13), ("gemma3-1b", 21),
                                    ("starcoder2-3b", 13)])
def test_prefill_and_decode_match(arch, t):
    """B = 2 prompts of t tokens, then 6 greedy decode steps: for
    gemma3-1b from 13 tokens the 16-slot ring wraps; from 21 the prefill
    scatters the last 16 tokens into the ring."""
    jmodel, params, model = _pair(arch)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, model.cfg.vocab_size, (2, t)).astype(np.int32)
    max_len = 32
    logits, cache, clen = model.prefill(torch.from_numpy(toks), max_len)
    jlogits, jcache, jclen = jmodel.prefill(
        params, {"tokens": jnp.asarray(toks)}, max_len)
    assert clen == int(jclen) == t
    _close(logits, jlogits)
    _caches_close(cache, jcache, model)
    for step in range(6):
        nxt = np.array(jnp.argmax(jlogits, axis=-1), np.int32)[:, None]
        # per-sequence lengths on odd steps, one scalar length on even
        lens = np.full((2,), t + step, np.int32) if step % 2 else t + step
        logits, cache = model.decode_step(torch.from_numpy(nxt), cache,
                                          torch.as_tensor(lens))
        jlogits, jcache = jmodel.decode_step(params, jnp.asarray(nxt),
                                             jcache, jnp.asarray(lens))
        _close(logits, jlogits)
        _caches_close(cache, jcache, model)


def test_prefill_with_lengths_gathers_each_sequences_last_token():
    jmodel, params, model = _pair("gemma3-1b")
    toks = np.random.default_rng(2).integers(0, 512, (3, 11)).astype(np.int32)
    lens = np.array([11, 4, 7], np.int32)
    logits, _, clen = model.prefill(torch.from_numpy(toks), 16,
                                    lengths=torch.from_numpy(lens))
    jlogits, _, _ = jmodel.prefill(params, {"tokens": jnp.asarray(toks)}, 16,
                                   lengths=jnp.asarray(lens))
    _close(logits, jlogits)
    assert clen.tolist() == lens.tolist()


def test_unstacking_reaches_the_remainder_layers():
    """14 layers of gemma3-1b's pattern: the JAX package scans a 6-layer
    super-block twice and keeps 2 remainder layers; the port's layer i
    holds scan[i % 6][i // 6] for i < 12 and rem[i - 12] after."""
    jmodel, params, model = _pair("gemma3-1b", n_layers=14)
    dec = params["decoder"]
    assert len(dec["scan"]) == 6 and len(dec["rem"]) == 2
    for i, block in enumerate(model.layers):
        want = (dec["scan"][i % 6]["mixer"]["wqkv"][i // 6] if i < 12
                else dec["rem"][i - 12]["mixer"]["wqkv"])
        np.testing.assert_array_equal(block.mixer["wqkv"].numpy(),
                                      np.asarray(want))
    toks = np.arange(1, 20, dtype=np.int32)[None]
    logits, cache, _ = model.prefill(torch.from_numpy(toks), 24)
    jlogits, jcache, _ = jmodel.prefill(params, {"tokens": jnp.asarray(toks)},
                                        24)
    _close(logits, jlogits)
    _caches_close(cache, jcache, model)


def test_cast_keeps_the_weights_and_the_seed_draws_them():
    cfg = reduced(get_config("starcoder2-3b"))
    a = Model(cfg, torch.float32, device="cpu", seed=5)
    assert all(not p.requires_grad for p in a.parameters())
    b = Model(cfg, torch.float32, device="cpu", seed=5)
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    c = a.cast(torch.bfloat16)
    assert c.dtype == torch.bfloat16 and c.embed.dtype == torch.bfloat16
    assert c.final_norm["scale"].dtype == torch.float32
    assert torch.equal(c.embed, a.embed.bfloat16())
    assert torch.equal(c.cast(torch.float32).lm_head, a.lm_head.bfloat16()
                       .float())


def test_model_defaults_to_the_card(monkeypatch):
    """Without a device the model goes to ``cuda``: with no card it
    raises instead of landing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(reduced(get_config("gemma3-1b")), torch.float32)


@pytest.mark.parametrize("change", [dict(mixer="rwkv"),
                                    dict(mixer="hybrid", attn_period=2),
                                    dict(moe_period=1, n_experts=4),
                                    dict(encoder_layers=2),
                                    dict(frontend="vision", frontend_len=8)])
def test_layers_not_ported_raise(change):
    cfg = dataclasses.replace(reduced(get_config("gemma3-1b")), **change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(cfg, torch.float32, device="cpu")
