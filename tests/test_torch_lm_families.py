"""The port's LM families against the JAX package's, on the CPU in
float32: MoE (mixtral, grok-1), the Mamba hybrid (jamba), RWKV6, the
encoder-decoder (whisper) and the vision prefix (internvl2).

The layers first (MoE with tokens dropped past capacity and a zero
router whose ties pick experts 0 and 1; Mamba's doubling scan; RWKV6's
per-token and blocked forms; cross-attention), then each family's
``reduced()`` model with the JAX params carried across by
``convert.lm_params_from_jax``: prefill logits, every cache kind, and 6
decode steps with scalar and per-sequence lengths.  The configs equal
the JAX package's.  The same numpy-seeded inputs go through both;
atol = rtol = 1e-4 (float32 sums in another order; the Mamba scan adds
in another order than JAX's scan tree).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import applicable_shapes as japplicable_shapes
from repro.configs import get_config as jget_config
from repro.configs import list_configs as jlist_configs
from repro.configs import reduced as jreduced
from repro.configs.shapes import LONG_SKIP_REASONS as JLONG_SKIP_REASONS
from repro.models.layers import attention as jattn
from repro.models.layers import mamba as jmamba
from repro.models.layers import moe as jmoe
from repro.models.layers import rwkv6 as jrwkv
from repro.models.transformer import Model as JModel
from repro_torch import convert
from repro_torch.configs import (applicable_shapes, get_config, list_configs,
                                 reduced)
from repro_torch.configs.shapes import LONG_SKIP_REASONS
from repro_torch.models.layers import attention, mamba, moe, rwkv6
from repro_torch.models.transformer import Model

TOL = dict(atol=1e-4, rtol=1e-4)
FAMILIES = ["mixtral-8x22b", "grok-1-314b", "jamba-1.5-large-398b",
            "rwkv6-7b", "whisper-small", "internvl2-26b"]


def _close(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _torch(tree):
    """A JAX params dict -> the same leaves as float32 torch tensors."""
    return {k: torch.from_numpy(np.asarray(v, np.float32).copy())
            for k, v in tree.items()}


# --- configs -----------------------------------------------------------------

@pytest.mark.parametrize("arch", jlist_configs())
def test_configs_equal_the_jax_packages(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (dataclasses.asdict(reduced(cfg))
            == dataclasses.asdict(jreduced(jcfg)))
    assert cfg.n_params() == jcfg.n_params()
    assert cfg.n_params_active() == jcfg.n_params_active()
    for c, j in ((cfg, jcfg), (reduced(cfg), jreduced(jcfg))):
        assert ([dataclasses.asdict(s) for s in applicable_shapes(c)]
                == [dataclasses.asdict(s) for s in japplicable_shapes(j)])


def test_every_lm_config_is_registered_and_builds():
    assert list_configs() == jlist_configs()
    assert LONG_SKIP_REASONS == JLONG_SKIP_REASONS
    for arch in list_configs():
        model = Model(reduced(get_config(arch)), torch.float32,
                      device="cpu", seed=1)
        assert len(model.layers) == model.cfg.n_layers


# --- MoE -----------------------------------------------------------------------

def _moe_pair(cf, e=4, k=2, d=32, ff=48, seed=0):
    jcfg = jmoe.MoEConfig(d_model=d, d_ff=ff, n_experts=e, top_k=k,
                          capacity_factor=cf)
    cfg = moe.MoEConfig(d_model=d, d_ff=ff, n_experts=e, top_k=k,
                        capacity_factor=cf)
    params = jmoe.init(jax.random.key(seed), jcfg, jnp.float32)
    return jcfg, cfg, params


@pytest.mark.parametrize("b,t,cf", [(2, 24, 0.25), (3, 40, 0.5),
                                    (1, 16, 1.25), (4, 1, 1.25)])
def test_moe_drops_the_same_tokens(b, t, cf):
    """A capacity factor small enough that tokens drop (B*T*k*cf/E rows
    an expert, then rounded up to 8): y and the aux loss equal JAX's,
    and so do the routes and each (token, slot)'s place."""
    jcfg, cfg, params = _moe_pair(cf)
    x = _rand(np.random.default_rng(b * t), b, t, 32)
    y, aux = moe.forward(_torch(params), torch.from_numpy(x), cfg)
    jy, jaux = jmoe.forward(params, jnp.asarray(x), jcfg)
    _close(y, jy)
    _close(aux, jaux)
    n = b * t
    probs, _, idx = moe.route(_torch(params), torch.from_numpy(x).reshape(
        n, 32), cfg)
    jprobs = jax.nn.softmax(jnp.asarray(x).reshape(n, 32) @ params["router"])
    _, jidx = jax.lax.top_k(jprobs, 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _, pos = moe.slots(idx, 4)
    dropped = int((pos >= moe.capacity(n, cfg)).sum())
    if cf < 1:
        assert dropped > 0
    assert moe.capacity(n, cfg) == jmoe.capacity(n, jcfg)


def test_moe_zero_router_ties_pick_the_lowest_experts():
    """Every probability equal: ``jax.lax.top_k`` picks experts 0 and 1,
    and so must the port (``torch.topk`` promises no order among ties);
    with 4 experts and 18 tokens, 18 slots land on each of experts 0 and
    1, whose capacity is 8, so tokens 8 to 17 drop."""
    jcfg, cfg, params = _moe_pair(0.9)
    params = dict(params, router=jnp.zeros_like(params["router"]))
    x = _rand(np.random.default_rng(3), 2, 9, 32)
    _, gate, idx = moe.route(_torch(params), torch.from_numpy(x).reshape(
        18, 32), cfg)
    assert (idx.numpy() == [0, 1]).all()
    assert torch.equal(gate, torch.full((18, 2), 0.5))
    _, pos = moe.slots(idx, 4)
    assert moe.capacity(18, cfg) == 8
    assert int((pos >= 8).sum()) == 20
    y, aux = moe.forward(_torch(params), torch.from_numpy(x), cfg)
    jy, jaux = jmoe.forward(params, jnp.asarray(x), jcfg)
    _close(y, jy)
    _close(aux, jaux)
    assert not y.reshape(18, 32)[8:].any()      # tokens 8 to 17 dropped


# --- Mamba -----------------------------------------------------------------------

def _mamba_pair(d=32, ds=8, seed=0):
    jcfg = jmamba.MambaConfig(d_model=d, d_inner=2 * d, d_state=ds)
    cfg = mamba.MambaConfig(d_model=d, d_inner=2 * d, d_state=ds)
    params = jmamba.init(jax.random.key(seed), jcfg, jnp.float32)
    # a non-zero conv bias and D, so both terms are checked
    rng = np.random.default_rng(seed)
    params = dict(params, conv_b=jnp.asarray(_rand(rng, 2 * d, scale=0.1)),
                  D=jnp.asarray(_rand(rng, 2 * d)))
    return jcfg, cfg, params


@pytest.mark.parametrize("b,t", [(2, 1), (1, 3), (2, 17), (3, 64)])
def test_mamba_forward_and_state_match(b, t):
    jcfg, cfg, params = _mamba_pair()
    x = _rand(np.random.default_rng(t), b, t, 32)
    y, cache = mamba.forward(_torch(params), torch.from_numpy(x), cfg,
                             return_state=True)
    jy, jcache = jmamba.forward(params, jnp.asarray(x), jcfg,
                                return_state=True)
    _close(y, jy)
    _close(cache["ssm"], jcache["ssm"])
    if t >= cfg.d_conv - 1:       # JAX keeps fewer rows for shorter T
        _close(cache["conv"], jcache["conv"])
    assert cache["conv"].shape == (b, cfg.d_conv - 1, cfg.d_inner)


def test_mamba_doubling_scan_equals_the_recurrence():
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.uniform(0.2, 1.0, (2, 37, 5, 3)))
    b = torch.from_numpy(rng.standard_normal((2, 37, 5, 3)))
    want, s = [], torch.zeros((2, 5, 3), dtype=a.dtype)
    for t in range(37):
        s = a[:, t] * s + b[:, t]
        want.append(s)
    got = mamba.scan(a.clone(), b.clone())
    torch.testing.assert_close(got, torch.stack(want, dim=1), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("t", [2, 9])
def test_mamba_decode_matches_jax_and_continues_the_forward(t):
    """Decode steps from the prefill's state equal JAX's, and forward
    over T then decode of token T+1 equals forward over T + 1 (at T 2
    too, where the conv state starts in the zeros before the
    sequence)."""
    jcfg, cfg, params = _mamba_pair(seed=1)
    tp = _torch(params)
    x = _rand(np.random.default_rng(5), 2, t + 3, 32)
    full = mamba.forward(tp, torch.from_numpy(x), cfg)
    _, cache = mamba.forward(tp, torch.from_numpy(x[:, :t]), cfg,
                             return_state=True)
    jcache = {k: jnp.asarray(v.numpy().copy()) for k, v in cache.items()}
    for i in range(t, t + 3):
        y, cache = mamba.decode_step(tp, torch.from_numpy(x[:, i:i + 1]),
                                     cache, cfg)
        jy, jcache = jmamba.decode_step(params, jnp.asarray(x[:, i:i + 1]),
                                        jcache, jcfg)
        _close(y, jy)
        _close(cache["ssm"], jcache["ssm"])
        _close(cache["conv"], jcache["conv"])
        _close(y, full[:, i:i + 1])


# --- RWKV6 -----------------------------------------------------------------------

def _rwkv_pair(d=64, hs=32, seed=0):
    jcfg = jrwkv.RWKV6Config(d_model=d, head_size=hs)
    cfg = rwkv6.RWKV6Config(d_model=d, head_size=hs)
    params = jrwkv.init(jax.random.key(seed), jcfg, jnp.float32)
    # decays near 1 and near 0 both, so the bonus and the state both count
    rng = np.random.default_rng(seed)
    params = dict(params, decay_base=jnp.asarray(_rand(rng, d, scale=2.0)
                                                 - 1.0))
    return jcfg, cfg, params


@pytest.mark.parametrize("b,t,chunk", [(2, 64, 32), (1, 96, 16),
                                       (3, 32, 32), (2, 7, 0)])
def test_rwkv6_forward_and_chunked_match(b, t, chunk):
    """The per-token form and the blocked form against JAX's (as
    ``tests/test_rwkv_chunked.py`` holds JAX's two forms), outputs and
    states."""
    jcfg, cfg, params = _rwkv_pair()
    tp = _torch(params)
    x = _rand(np.random.default_rng(t), b, t, 64)
    y, st = rwkv6.forward(tp, torch.from_numpy(x), cfg, return_state=True)
    jy, jst = jrwkv.forward(params, jnp.asarray(x), jcfg, return_state=True)
    _close(y, jy)
    for k in ("shift", "state"):
        _close(st[k], jst[k])
    if chunk:
        yc, stc = rwkv6.forward_chunked(tp, torch.from_numpy(x), cfg,
                                        chunk=chunk, return_state=True)
        jyc, jstc = jrwkv.forward_chunked(params, jnp.asarray(x), jcfg,
                                          chunk=chunk, return_state=True)
        _close(yc, jyc)
        _close(stc["state"], jstc["state"])
        np.testing.assert_allclose(yc.numpy(), y.numpy(), atol=2e-4,
                                   rtol=2e-4)


def test_rwkv6_decode_matches_and_continues_the_forward():
    jcfg, cfg, params = _rwkv_pair(seed=2)
    tp = _torch(params)
    x = _rand(np.random.default_rng(6), 2, 12, 64)
    full = rwkv6.forward(tp, torch.from_numpy(x), cfg)
    _, cache = rwkv6.forward_chunked(tp, torch.from_numpy(x[:, :8]), cfg,
                                     chunk=4, return_state=True)
    jcache = {k: jnp.asarray(v.numpy().copy()) for k, v in cache.items()}
    for i in range(8, 12):
        y, cache = rwkv6.decode_step(tp, torch.from_numpy(x[:, i:i + 1]),
                                     cache, cfg)
        jy, jcache = jrwkv.decode_step(params, jnp.asarray(x[:, i:i + 1]),
                                       jcache, jcfg)
        _close(y, jy)
        _close(cache["state"], jcache["state"])
        _close(cache["shift"], jcache["shift"])
        _close(y, full[:, i:i + 1])


# --- cross-attention ---------------------------------------------------------------

@pytest.mark.parametrize("tq,tk,bias", [(5, 8, True), (13, 40, False),
                                        (1, 7, True)])
def test_cross_attention_matches(tq, tk, bias):
    """q from the decoder stream, k and v from the encoder's output; no
    rope, not causal (the config's window and causal flag are
    ignored)."""
    kw = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
              use_bias=bias, chunk_k=16, window=3)
    jc, tc = jattn.AttnConfig(**kw), attention.AttnConfig(**kw)
    rng = np.random.default_rng(tq + tk)
    params = jattn.init(jax.random.key(tq), jc, jnp.float32)
    if bias:
        params = dict(params, bqkv=jnp.asarray(_rand(rng, 128, scale=0.3)),
                      bo=jnp.asarray(_rand(rng, 64, scale=0.3)))
    x, enc = _rand(rng, 2, tq, 64), _rand(rng, 2, tk, 64)
    y, (k, v) = attention.forward(_torch(params), torch.from_numpy(x), tc,
                                  kv_x=torch.from_numpy(enc), return_kv=True)
    jy, (jk, jv) = jattn.forward(params, jnp.asarray(x), jc,
                                 kv_x=jnp.asarray(enc), return_kv=True)
    _close(y, jy)
    _close(k, jk)
    _close(v, jv)
    assert k.shape == (2, 2, tk, 16)


# --- the families, whole ---------------------------------------------------------

def _pair(arch, change=None, **model_kw):
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    jcfg = dataclasses.replace(jcfg, **(change or {}))
    cfg = dataclasses.replace(cfg, **(change or {}))
    jmodel = JModel(jcfg, dtype=jnp.float32, attn_chunk=16, **model_kw)
    params = jmodel.init_params(jax.random.key(0))
    model = Model(cfg, torch.float32, attn_chunk=16, device="cpu", seed=None,
                  **model_kw)
    convert.lm_params_from_jax(model, params)
    return jmodel, params, model


def _caches_close(cache, jcache, model):
    mine = convert.lm_cache_to_numpy(cache)
    theirs = convert.lm_cache_to_numpy(
        convert.lm_cache_from_jax(model, jcache))
    assert len(mine["decoder"]) == len(theirs["decoder"]) \
        == model.cfg.n_layers
    for a, b in zip(mine["decoder"], theirs["decoder"]):
        assert a.keys() == b.keys()
        for kind in a:
            assert a[kind].keys() == b[kind].keys()
            for name in a[kind]:
                assert a[kind][name].shape == b[kind][name].shape
                _close(a[kind][name], b[kind][name])
    assert mine.keys() == theirs.keys()
    if "enc_out" in mine:
        _close(mine["enc_out"], theirs["enc_out"])
    return mine


def _frontend(cfg, rng, b):
    """The stub front ends' embeddings, as ``tests/test_models_smoke.py``
    makes them: [B, frontend_len, d] frames or patches."""
    if not cfg.frontend:
        return {}
    key = "frames" if cfg.is_enc_dec else "patches"
    return {key: _rand(rng, b, cfg.frontend_len, cfg.d_model)}


@pytest.mark.parametrize("arch,t,model_kw", [
    ("mixtral-8x22b", 13, {}), ("mixtral-8x22b", 21, {}),
    ("grok-1-314b", 11, {}), ("jamba-1.5-large-398b", 12, {}),
    ("rwkv6-7b", 9, {}), ("rwkv6-7b", 16, {"rwkv_chunk": 8}),
    ("whisper-small", 10, {}), ("internvl2-26b", 7, {})])
def test_prefill_and_decode_match(arch, t, model_kw):
    """B = 2 prompts of t tokens (with frames or patches), then 6 greedy
    decode steps, the lengths per sequence on odd steps and one scalar on
    even ones: logits and every cache kind.  mixtral's 16-token windows
    wrap their rings in decode from 13 tokens, and the prefill scatters
    into them from 21; rwkv6 at 16 with ``rwkv_chunk`` 8 takes the
    blocked form; internvl2's lengths count its 8-patch prefix."""
    jmodel, params, model = _pair(arch, **model_kw)
    cfg = model.cfg
    rng = np.random.default_rng(t)
    toks = rng.integers(0, cfg.vocab_size, (2, t)).astype(np.int32)
    front = _frontend(cfg, rng, 2)
    max_len = 40
    logits, cache, clen = model.prefill(
        torch.from_numpy(toks), max_len,
        **{k: torch.from_numpy(v) for k, v in front.items()})
    jlogits, jcache, jclen = jmodel.prefill(
        params, {"tokens": jnp.asarray(toks),
                 **{k: jnp.asarray(v) for k, v in front.items()}}, max_len)
    assert clen == int(jclen) == t + (cfg.frontend_len
                                      if cfg.frontend == "vision" else 0)
    _close(logits, jlogits)
    kinds = {k for layer in _caches_close(cache, jcache, model)["decoder"]
             for k in layer}
    want = {"mixtral-8x22b": {"kv"}, "grok-1-314b": {"kv"},
            "jamba-1.5-large-398b": {"kv", "mamba"}, "rwkv6-7b": {"rwkv"},
            "whisper-small": {"kv", "cross"}, "internvl2-26b": {"kv"}}[arch]
    assert kinds == want
    for step in range(6):
        nxt = np.array(jnp.argmax(jlogits, axis=-1), np.int32)[:, None]
        lens = (np.full((2,), clen + step, np.int32) if step % 2
                else clen + step)
        logits, cache = model.decode_step(torch.from_numpy(nxt), cache,
                                          torch.as_tensor(lens))
        jlogits, jcache = jmodel.decode_step(params, jnp.asarray(nxt),
                                             jcache, jnp.asarray(lens))
        _close(logits, jlogits)
        _caches_close(cache, jcache, model)


@pytest.mark.parametrize("capacity_factor", [1.25, 2.0])
def test_moe_decode_equals_prefill_only_without_drops(capacity_factor):
    """A prefill drops the (token, slot)s past an expert's capacity, and
    its capacity grows with the prompt, while a one-token decode step
    drops none.  So at the published capacity factor (1.25) a decode
    step after a prefill differs from the prefill one token longer, in
    the JAX package as in the port (each side's logits equal the other's
    both ways); at E / k = 2.0, where no expert overflows, they agree."""
    jmodel, params, model = _pair("mixtral-8x22b",
                                  dict(capacity_factor=capacity_factor))
    rng = np.random.default_rng(10)
    toks = rng.integers(0, 512, (1, 30)).astype(np.int32)
    nxt = rng.integers(0, 512, (1, 1)).astype(np.int32)
    longer = np.concatenate([toks, nxt], axis=1)
    _, cache, clen = model.prefill(torch.from_numpy(toks), 40)
    dec, _ = model.decode_step(torch.from_numpy(nxt), cache, clen)
    routes = []
    route = moe.route

    def recorded(*args):
        out = route(*args)
        routes.append(out[2])
        return out

    moe.route = recorded
    try:
        pre, _, _ = model.prefill(torch.from_numpy(longer), 40)
    finally:
        moe.route = route
    _, jcache, jclen = jmodel.prefill(params, {"tokens": jnp.asarray(toks)},
                                      40)
    jdec, _ = jmodel.decode_step(params, jnp.asarray(nxt), jcache, jclen)
    jpre, _, _ = jmodel.prefill(params, {"tokens": jnp.asarray(longer)}, 40)
    _close(dec, jdec)
    _close(pre, jpre)
    mcfg = model.moe_cfg()
    drops = sum(int((moe.slots(idx, 4)[1] >= moe.capacity(31, mcfg)).sum())
                for idx in routes)
    gap = float((dec - pre).abs().max())
    if capacity_factor == 2.0:
        assert drops == 0
        _close(dec, pre)
    else:
        assert drops > 0 and gap > 1e-2


def test_vision_prefill_with_lengths_counts_the_prefix():
    jmodel, params, model = _pair("internvl2-26b")
    rng = np.random.default_rng(8)
    toks = rng.integers(0, 512, (3, 6)).astype(np.int32)
    patches = _rand(rng, 3, 8, 128)
    lens = np.array([14, 9, 11], np.int32)       # 8 patches + 6, 1, 3
    logits, _, clen = model.prefill(torch.from_numpy(toks), 16,
                                    lengths=torch.from_numpy(lens),
                                    patches=torch.from_numpy(patches))
    jlogits, _, _ = jmodel.prefill(params, {"tokens": jnp.asarray(toks),
                                            "patches": jnp.asarray(patches)},
                                   16, lengths=jnp.asarray(lens))
    _close(logits, jlogits)
    assert clen.tolist() == lens.tolist()


@pytest.mark.parametrize("arch,key", [("whisper-small", "frames"),
                                      ("internvl2-26b", "patches")])
def test_prefill_without_the_front_end_raises(arch, key):
    model = Model(reduced(get_config(arch)), torch.float32, device="cpu")
    with pytest.raises(ValueError, match=key):
        model.prefill(torch.tensor([[1, 2, 3]]), 16)


@pytest.mark.parametrize("arch", FAMILIES)
def test_cast_keeps_the_float32_leaves(arch):
    """A bf16 copy keeps the router, Mamba's ``A_log``/``D``/``dt_bias``
    and RWKV's decay, bonus, mix and norm leaves in float32, as the JAX
    package draws them whatever the model's dtype."""
    model = Model(reduced(get_config(arch)), torch.float32, device="cpu",
                  seed=2)
    half = model.cast(torch.bfloat16)
    jparams = JModel(jreduced(jget_config(arch)), dtype=jnp.bfloat16
                     ).init_params(jax.random.key(0))
    jdtypes = {jax.tree_util.keystr(p).split("'")[-2]: leaf.dtype
               for p, leaf in jax.tree_util.tree_leaves_with_path(jparams)}
    for name, p in half.named_parameters():
        leaf = name.split(".")[-1]
        want = (torch.float32 if jdtypes[leaf] == jnp.float32
                else torch.bfloat16)
        assert p.dtype == want, name
        assert torch.equal(p, dict(model.named_parameters())[name].to(want))
