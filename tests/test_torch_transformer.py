"""The port's LM against the JAX package's, on the CPU in float32.

``reduced(gemma3-1b)`` (6 layers: 5 with a 16-token window, 1 global;
GQA group 4; tied embeddings) and ``reduced(starcoder2-3b)`` (biases, an
untied head), with the JAX params carried across by
``convert.lm_params_from_jax``: prefill logits and caches (prompts
shorter and longer than the window, so the ring buffer is filled both
ways), and decode steps that wrap the ring; gemma3-1b with each of the
other families' layers swapped in (RWKV, Mamba hybrid, MoE, an encoder,
a vision prefix); the unstacking of a hybrid stack's remainder layers.
atol = rtol = 1e-4: the sums run in a different order over the layers
and the head.  ``tests/test_torch_lm_families.py`` holds the families'
own configs.
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


def _pair(arch, n_layers=None, **change):
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    if n_layers:
        change["n_layers"] = n_layers
    jcfg = dataclasses.replace(jcfg, **change)
    cfg = dataclasses.replace(cfg, **change)
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
    assert mine.keys() == theirs.keys()
    assert len(mine["decoder"]) == len(theirs["decoder"]) \
        == model.cfg.n_layers
    for a, b in zip(mine["decoder"], theirs["decoder"]):
        assert a.keys() == b.keys()
        for kind in a:
            assert a[kind].keys() == b[kind].keys()
            for name in a[kind]:
                assert a[kind][name].shape == b[kind][name].shape
                _close(a[kind][name], b[kind][name])
    if "enc_out" in mine:
        _close(mine["enc_out"], theirs["enc_out"])


def test_reduced_configs_are_the_jax_packages():
    for arch in ("gemma3-1b", "starcoder2-3b", "llama3-405b",
                 "command-r-35b", "mixtral-8x22b", "grok-1-314b",
                 "jamba-1.5-large-398b", "rwkv6-7b", "whisper-small",
                 "internvl2-26b"):
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
        np.testing.assert_array_equal(block.mixer["wqkv"].detach().numpy(),
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
    assert all(p.requires_grad for p in a.parameters())
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


@pytest.mark.parametrize("change", [dict(mixer="rwkv", use_rope=False),
                                    dict(mixer="hybrid", attn_period=2),
                                    dict(moe_period=1, n_experts=4),
                                    dict(encoder_layers=2, frontend="audio",
                                         frontend_len=8, use_rope=False),
                                    dict(frontend="vision", frontend_len=8)],
                         ids=["rwkv", "hybrid", "moe", "enc-dec", "vision"])
def test_other_families_layers_in_gemma3(change):
    """gemma3-1b's reduced config (16-token windows, GQA 4:1, tied head)
    with each other family's layers swapped in: an RWKV stack, Mamba at
    every other layer, MoE FFNs, an encoder with cross-attention and
    learned positions, a vision prefix.  Prefill of 13 tokens (21
    positions with the vision prefix's 8), then 4 decode steps, against
    the JAX package's."""
    jmodel, params, model = _pair("gemma3-1b", **change)
    cfg = model.cfg
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    front = {}
    if cfg.frontend:
        key = "frames" if cfg.is_enc_dec else "patches"
        front[key] = rng.standard_normal(
            (2, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    logits, cache, clen = model.prefill(
        torch.from_numpy(toks), 32,
        **{k: torch.from_numpy(v) for k, v in front.items()})
    jlogits, jcache, jclen = jmodel.prefill(
        params, {"tokens": jnp.asarray(toks),
                 **{k: jnp.asarray(v) for k, v in front.items()}}, 32)
    assert clen == int(jclen)
    _close(logits, jlogits)
    _caches_close(cache, jcache, model)
    for step in range(4):
        nxt = np.array(jnp.argmax(jlogits, axis=-1), np.int32)[:, None]
        lens = np.full((2,), clen + step, np.int32)
        logits, cache = model.decode_step(torch.from_numpy(nxt), cache,
                                          torch.as_tensor(lens))
        jlogits, jcache = jmodel.decode_step(params, jnp.asarray(nxt),
                                             jcache, jnp.asarray(lens))
        _close(logits, jlogits)
        _caches_close(cache, jcache, model)


def test_unstacking_reaches_a_hybrid_stacks_remainder_layers():
    """11 layers of jamba's pattern (attention at 4 of every 8, MoE at
    every odd layer): the JAX package scans the 8-layer super-block once
    and keeps 3 remainder layers (Mamba, MoE; Mamba; Mamba, MoE), whose
    params and Mamba caches the port's layers 8-10 take."""
    jmodel, params, model = _pair("jamba-1.5-large-398b", n_layers=11)
    dec = params["decoder"]
    assert len(dec["scan"]) == 8 and len(dec["rem"]) == 3
    for i, block in enumerate(model.layers):
        layer = dec["scan"][i % 8] if i < 8 else dec["rem"][i - 8]
        for part in ("mixer", "ffn"):
            for name, got in getattr(block, part).items():
                want = np.asarray(layer[part][name])
                np.testing.assert_array_equal(got.detach().numpy(),
                                              want[0] if i < 8 else want)
    toks = np.arange(1, 12, dtype=np.int32)[None]
    logits, cache, _ = model.prefill(torch.from_numpy(toks), 16)
    jlogits, jcache, _ = jmodel.prefill(params, {"tokens": jnp.asarray(toks)},
                                        16)
    _close(logits, jlogits)
    _caches_close(cache, jcache, model)
    assert [sorted(layer) for layer in cache["decoder"][8:]] == [["mamba"]] * 3
