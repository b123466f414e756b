"""The tensor-parallel MoE, Mamba and RWKV6 layers
(``sharding.TensorParallel``) on a mesh whose dims have one rank each:
every ``model`` slice is the whole weight and every collective a sum of
one, so a sharded prefill, 4 decode steps and an AdamW step must be
``torch.equal`` to the unsharded port's on the same weights (float32,
reduced configs, one rank of a fake process group: no collective runs).
The multi-rank checks, within 1e-5, are ``tests/test_torch_dist_train.py``
on 8 gloo ranks."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.specs import map_tree, place_params
from repro_torch.launch.mesh import fake_world
from repro_torch.launch.serve import make_prefill_step, make_serve_step
from repro_torch.launch.train import bind_params, make_train_step
from repro_torch.optim import AdamW, AdamWConfig

# (arch, model keywords): rwkv6 also in its blocked form
CASES = [("mixtral-8x22b", {}), ("jamba-1.5-large-398b", {}),
         ("rwkv6-7b", {}), ("rwkv6-7b", {"rwkv_chunk": 8})]
# jamba cut to 2 layers: Mamba + MLP, then attention + MoE
JAMBA_CUT = {"n_layers": 2, "attn_period": 2}
PROMPT, MAX_LEN, DECODE = 16, 24, 4


@pytest.fixture(scope="module")
def mesh11():
    from torch.distributed.device_mesh import init_device_mesh

    with fake_world(1):
        yield init_device_mesh("cpu", (1, 1),
                               mesh_dim_names=("data", "model"))


def _full(t):
    return t.full_tensor() if shd.is_dtensor(t) else t


def _serve(model, params, tok, feed):
    logits, cache, n = make_prefill_step(model, MAX_LEN)(
        params, {"tokens": tok})
    out = [_full(logits)]
    first = map_tree(lambda t: _full(t).clone(), cache)
    step = make_serve_step(model)
    for i in range(DECODE):
        logits, cache = step(params, feed[i], cache, n + i)
        out.append(_full(logits))
    return out, [first, map_tree(_full, cache)]


def _leaves(tree) -> list:
    out = []
    map_tree(out.append, tree)
    return out


@pytest.mark.parametrize("arch,model_kw", CASES,
                         ids=["mixtral", "jamba", "rwkv6", "rwkv6-chunked"])
def test_one_rank_mesh_is_bit_equal_to_the_unsharded_port(mesh11, arch,
                                                          model_kw):
    from repro_torch.models.transformer import Model

    cfg = reduced(get_config(arch))
    if arch.startswith("jamba"):
        cfg = dataclasses.replace(cfg, **JAMBA_CUT)
    rules = shd.use_rules()
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, PROMPT)))
    feed = torch.from_numpy(rng.integers(0, cfg.vocab_size, (DECODE, 2, 1)))
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (2, 16)))}
    batch["labels"] = torch.roll(batch["tokens"], -1, 1)
    model = Model(cfg, torch.float32, attn_chunk=8, loss_chunk=8,
                  device="cpu", seed=3, **model_kw)
    plain = dict(model.named_parameters())
    want, c_want = _serve(model, plain, tok, feed)
    opt = AdamW(AdamWConfig(lr=1e-3))
    p_want, _, m_want = make_train_step(model, opt)(plain, opt.init(plain),
                                                    batch)
    bind_params(model, plain)
    with shd.use_mesh(mesh11, rules):
        params = place_params(model, mesh11, rules)
        got, c_got = _serve(model, params, tok, feed)
        p_got, _, m_got = make_train_step(model, opt)(
            params, opt.init(params), batch)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for g, w in zip(c_got, c_want):
        assert all(torch.equal(a, b) for a, b in zip(_leaves(g),
                                                     _leaves(w)))
    assert torch.equal(_full(m_got["loss"]), m_want["loss"])
    assert all(torch.equal(_full(p_got[k]), p_want[k]) for k in p_want)
