"""The port's LM training path against the JAX package's, on the CPU in
float32, for each of the ten registered LM configs ``reduced()``: the
JAX params carried across by ``convert.lm_params_from_jax``, the same
numpy-seeded batch (``SyntheticTokens``, plus random frames or patches)
through ``Model.loss`` / ``forward_hidden`` and through ``jax.grad``.
Loss and hidden states at atol = rtol = 1e-4; every gradient, mapped by
``convert.lm_tree_from_jax``, within 1e-4 of the leaf's largest
magnitude (float32 sums in another order; the Mamba scan adds in another
order than JAX's scan tree).  Then remat on and off (equal), the loss
mask, the padded vocabulary, the out-of-place Mamba scan, the flash
kernel's grad guard and that the training route never reaches it.
``test_torch_lm_train_step.py`` holds the training step and
``test_torch_lm_train_cli.py`` the two CLIs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_train_helpers import (ARCHS, B, T, _batch, _close, _grads, _j,
                              _pair, _t)
from repro.models.layers import mamba as jmamba
from repro_torch import convert
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.models.layers import attention, mamba


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_hidden_and_grads_equal_jax(arch):
    jmodel, params, model = _pair(arch)
    batch = _batch(model.cfg)
    h, aux = model.forward_hidden(_t(batch))
    (jh, jaux), (jloss, jgrads) = jax.jit(lambda p, b: (
        jmodel.forward_hidden(p, b),
        jax.value_and_grad(jmodel.loss)(p, b)))(params, _j(batch))
    assert h.shape == (B, T, model.cfg.d_model) and aux.dtype == torch.float32
    _close(h, jh)
    _close(aux, jaux)
    if model.cfg.n_experts:
        assert float(aux) > 0

    loss, grads = _grads(model, _t(batch))
    _close(loss, jloss)
    want = convert.lm_tree_from_jax(model, jgrads)
    assert sorted(want) == sorted(grads)
    for name, g in grads.items():
        w = np.asarray(want[name], np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("arch", ["gemma3-1b", "mixtral-8x22b",
                                  "jamba-1.5-large-398b", "whisper-small"])
def test_remat_on_and_off_give_equal_loss_and_grads(arch):
    _, _, model = _pair(arch)
    batch = _t(_batch(model.cfg))
    assert model.remat
    loss, grads = _grads(model, batch)
    model.remat = False
    loss2, grads2 = _grads(model, batch)
    assert torch.equal(loss, loss2)
    for name in grads:
        assert torch.equal(grads[name], grads2[name]), name


@pytest.mark.parametrize("arch", ["gemma3-1b", "internvl2-26b"])
def test_loss_mask_equals_jax(arch):
    jmodel, params, model = _pair(arch)
    batch = _batch(model.cfg, mask=True)
    _close(model.loss(_t(batch)), jax.jit(jmodel.loss)(params, _j(batch)))
    full = dict(batch, loss_mask=np.ones((B, T), np.float32))
    nomask = {k: v for k, v in batch.items() if k != "loss_mask"}
    assert torch.equal(model.loss(_t(full)), model.loss(_t(nomask)))


def test_padded_vocab_columns_take_no_probability():
    """vocab 500 pads to 512 columns: the padded ones are masked out of
    the loss (JAX's value) and get no gradient through the head."""
    jmodel, params, model = _pair("starcoder2-3b", vocab_size=500)
    assert model.cfg.vocab_padded == 512
    batch = _batch(model.cfg)
    loss, grads = _grads(model, _t(batch))
    _close(loss, jax.jit(jmodel.loss)(params, _j(batch)))
    head = grads["lm_head"] if "lm_head" in grads else grads["embed"].T
    assert torch.count_nonzero(head[:, 500:]) == 0


def test_loss_chunk_must_divide_the_sequence():
    _, _, model = _pair("gemma3-1b")
    with pytest.raises(AssertionError):
        model.loss(_t(_batch(model.cfg, seq=24)))


# --- the two repairs -------------------------------------------------------------

def _scan_in_place(a, b):
    """The Mamba scan as it was: the same doubling steps, written into
    ``a`` and ``b``."""
    t = a.shape[1]
    off = 1
    while off < t:
        b[:, off:] = b[:, :-off] * a[:, off:] + b[:, off:]
        if 2 * off < t:
            a[:, off:] = a[:, :-off] * a[:, off:]
        off *= 2
    return b


@pytest.mark.parametrize("t", [1, 2, 5, 16, 37])
def test_out_of_place_mamba_scan_bit_equal_to_before(t, monkeypatch):
    rng = np.random.default_rng(t)
    cfg = mamba.MambaConfig(d_model=32, d_inner=64, d_state=8)
    params = mamba.init(torch.Generator().manual_seed(0), cfg,
                        torch.float32)
    x = torch.from_numpy(rng.standard_normal((2, t, 32)).astype(np.float32))
    xs = torch.from_numpy(rng.standard_normal((2, 4, 1, 32)).astype(
        np.float32))

    def run():
        y, cache = mamba.forward(params, x, cfg, return_state=True)
        ys = [mamba.decode_step(params, xs[:, i], cache, cfg)[0]
              for i in range(4)]
        return [y, cache["conv"], cache["ssm"]] + ys

    a = torch.from_numpy(rng.random((2, t, 3, 4)).astype(np.float32))
    bx = torch.from_numpy(rng.standard_normal((2, t, 3, 4)).astype(
        np.float32))
    a0, b0 = a.clone(), bx.clone()
    assert torch.equal(mamba.scan(a, bx), _scan_in_place(a0.clone(),
                                                          b0.clone()))
    assert torch.equal(a, a0) and torch.equal(bx, b0)   # left as they were
    now = run()
    monkeypatch.setattr(mamba, "scan", _scan_in_place)
    before = run()
    for got, want in zip(now, before):
        assert torch.equal(got, want)


def test_mamba_layer_gradient_equals_jax():
    rng = np.random.default_rng(0)
    jcfg = jmamba.MambaConfig(d_model=32, d_inner=64, d_state=8)
    cfg = mamba.MambaConfig(d_model=32, d_inner=64, d_state=8)
    jparams = jmamba.init(jax.random.key(1), jcfg, jnp.float32)
    params = {k: torch.from_numpy(np.asarray(v, np.float32).copy())
              .requires_grad_(True) for k, v in jparams.items()}
    x = rng.standard_normal((2, 19, 32)).astype(np.float32)
    w = rng.standard_normal((2, 19, 32)).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jmamba.forward(p, x, jcfg) * w)

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jparams,
                                                       jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = torch.sum(mamba.forward(params, xt, cfg) * torch.from_numpy(w))
    grads = torch.autograd.grad(loss, [xt] + list(params.values()))
    _close(grads[0], jgx)
    for (name, _), g in zip(params.items(), grads[1:]):
        want = np.asarray(jg[name], np.float32)
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=name)


def test_flash_attention_refuses_grad():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 8, 32)).astype(
        np.float32)) for _ in range(3))
    flash_mod.flash_attention(q, k, v)                 # no grad: fine
    q.requires_grad_(True)
    with pytest.raises(ValueError, match="no backward"):
        flash_mod.flash_attention(q, k, v)
    with torch.no_grad():
        out = flash_mod.flash_attention(q, k, v)
    assert not out.requires_grad


@pytest.mark.parametrize("arch", ["gemma3-1b", "whisper-small"])
def test_training_route_never_reaches_the_flash_kernel(arch, monkeypatch):
    """Every attention of the loss (self and cross) takes
    ``backend="ref"``; the flash wrapper is never called, forward or
    backward."""
    _, _, model = _pair(arch)
    backends = []
    forward = attention.forward

    def recorded(*args, backend="kernel", **kw):
        backends.append(backend)
        return forward(*args, backend=backend, **kw)

    def refuse(*args, **kw):
        raise AssertionError("the training route reached flash_attention")

    monkeypatch.setattr(attention, "forward", recorded)
    monkeypatch.setattr(attention, "flash_attention", refuse)
    _grads(model, _t(_batch(model.cfg)))
    cfg = model.cfg
    n_attn = sum(k.mixer.startswith("attn") for k in model.kinds
                 + model.enc_kinds) + sum(k.cross_attn for k in model.kinds)
    # remat runs each layer's forward again in the backward
    assert backends and set(backends) == {"ref"}
    assert len(backends) == 2 * n_attn, (cfg.name, len(backends), n_attn)


def test_serving_entry_points_do_not_differentiate():
    _, _, model = _pair("gemma3-1b")
    toks = torch.from_numpy(_batch(model.cfg)["tokens"])
    logits, cache, n = model.prefill(toks, 40)
    assert not logits.requires_grad
    assert all(not t.requires_grad for layer in cache["decoder"]
               for kv in layer.values() for t in kv.values())
    out, _ = model.decode_step(toks[:, :1], cache, n)
    assert not out.requires_grad
