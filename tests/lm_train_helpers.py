"""Shared by the LM training tests (``test_torch_lm_train*.py``): a
reduced config's JAX model and params with the port's ``Model`` loaded
from them by ``convert.lm_params_from_jax``, numpy-seeded batches, and
the comparisons."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_configs as jlist_configs
from repro.configs import reduced as jreduced
from repro.models.transformer import Model as JModel
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.data import SyntheticTokens
from repro_torch.models.transformer import Model

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = jlist_configs()
B, T, CHUNK = 2, 32, 16


def _pair(arch, **change):
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), **change)
    cfg = dataclasses.replace(reduced(get_config(arch)), **change)
    jmodel = JModel(jcfg, dtype=jnp.float32, loss_chunk=CHUNK,
                    attn_chunk=CHUNK)
    params = jmodel.init_params(jax.random.key(0))
    model = Model(cfg, torch.float32, loss_chunk=CHUNK, attn_chunk=CHUNK,
                  device="cpu", seed=None)
    convert.lm_params_from_jax(model, params)
    return jmodel, params, model


def _batch(cfg, step=0, batch=B, seq=T, mask=False):
    """numpy batch: synthetic tokens and labels, random frames or
    patches where the config takes them, optionally a 0/1 loss mask."""
    out = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=seq,
                          batch_size=batch, seed=3).batch(step)
    rng = np.random.default_rng(step)
    front = (batch, cfg.frontend_len, cfg.d_model)
    if cfg.is_enc_dec:
        out["frames"] = rng.standard_normal(front).astype(np.float32)
    if cfg.frontend == "vision":
        out["patches"] = rng.standard_normal(front).astype(np.float32)
    if mask:
        out["loss_mask"] = (rng.random((batch, seq)) < 0.6).astype(
            np.float32)
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, **tol):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


def _grads(model, batch):
    params = dict(model.named_parameters())
    loss = model.loss(batch)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    return loss, dict(zip(params, grads))
