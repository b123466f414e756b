"""The port's training step against the JAX package's, on the CPU in
float32: ``make_train_step`` over three steps, every config ``reduced()``
with one microbatch and four with two (loss trajectory at 1e-4, the
first step's grad norm at 1e-4; the weights are not compared: Adam's
update of an element whose gradient is float32 noise has an arbitrary
sign); the params a step is given are what it differentiates; JAX's
AdamW state carried across by ``convert.adamw_state_from_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_train_helpers import ARCHS, _batch, _close, _j, _pair, _t
from repro.launch.train import make_train_step as jmake_train_step
from repro.optim import AdamW as JAdamW
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import cosine_schedule as jcosine_schedule
from repro_torch import convert
from repro_torch.launch.train import bind_params, make_train_step
from repro_torch.optim import AdamW, AdamWConfig, cosine_schedule


# every config with one microbatch; two microbatches on a dense, an MoE,
# the enc-dec and the vision config
STEP_CASES = [(a, 1) for a in ARCHS] + [
    (a, 2) for a in ("gemma3-1b", "mixtral-8x22b", "whisper-small",
                     "internvl2-26b")]


@pytest.mark.parametrize("arch,accum", STEP_CASES)
def test_train_step_equals_jax_over_three_steps(arch, accum):
    jmodel, params, model = _pair(arch)
    jopt = JAdamW(JAdamWConfig(lr=jcosine_schedule(1e-3, 1, 3)))
    opt = AdamW(AdamWConfig(lr=cosine_schedule(1e-3, 1, 3)))
    jstep = jax.jit(jmake_train_step(jmodel, jopt, accum_steps=accum))
    step = make_train_step(model, opt, accum_steps=accum)
    jstate = (params, jopt.init(params))
    tparams = dict(model.named_parameters())
    state = (tparams, opt.init(tparams))
    keep = {k: v.detach().clone() for k, v in tparams.items()}
    for i in range(3):
        batch = _batch(model.cfg, step=i, batch=4)
        jp, js, jm = jstep(*jstate, _j(batch), jax.random.key(i))
        p, s, m = step(*state, _t(batch), torch.Generator().manual_seed(i))
        _close(m["loss"], jm["loss"])
        if i == 0:  # later steps start from weights Adam moved apart
            _close(m["grad_norm"], jm["grad_norm"])
        assert int(m["step"]) == int(jm["step"]) == i + 1
        jstate, state = (jp, js), (p, s)
    # the step bound its result to the model and changed nothing it got
    assert all(model.get_parameter(k) is v for k, v in state[0].items())
    for k, v in tparams.items():
        assert torch.equal(v, keep[k]), k


def test_bound_params_are_what_the_next_step_reads():
    """A restored state (fresh tensors) is what the step differentiates:
    stepping from the initial params again after training gives the first
    step's result, not one from the trained weights."""
    _, _, model = _pair("gemma3-1b")
    opt = AdamW(AdamWConfig(lr=1e-2))
    step = make_train_step(model, opt)
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    s0 = opt.init(p0)
    batch = _t(_batch(model.cfg))
    p1, _, m1 = step(p0, s0, batch)
    p2, s2, _ = step(p1, opt.init(p1), batch)
    again, _, m1b = step(p0, s0, batch)
    assert torch.equal(m1["loss"], m1b["loss"])
    for k in p1:
        assert torch.equal(p1[k], again[k]), k
    bind_params(model, p2)
    assert model.get_parameter("embed") is p2["embed"]
    with pytest.raises(KeyError):
        bind_params(model, {"nope": torch.zeros(1)})


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_state_from_jax_continues_on_the_port(state_dtype):
    """JAX's AdamW state after one step, carried across by
    ``convert.adamw_state_from_jax``: every leaf under the port's name, in
    its dtype, equal to JAX's; the port's AdamW takes its next step from
    it (step 2; the loss of JAX's updated params at 1e-4)."""
    jmodel, params, model = _pair("gemma3-1b")
    jopt = JAdamW(JAdamWConfig(lr=1e-3, state_dtype=getattr(jnp,
                                                            state_dtype)))
    opt = AdamW(AdamWConfig(lr=1e-3, state_dtype=getattr(torch,
                                                         state_dtype)))
    jstep = jax.jit(jmake_train_step(jmodel, jopt))
    jp, js, _ = jstep(params, jopt.init(params), _j(_batch(model.cfg)),
                      jax.random.key(0))
    state = convert.adamw_state_from_jax(model, js)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 1
    names = sorted(n for n, _ in model.named_parameters())
    for part in ("m", "v"):
        assert sorted(state[part]) == names
        want = convert.lm_tree_from_jax(model, js[part])
        for n, t in state[part].items():
            assert t.dtype == getattr(torch, state_dtype)
            np.testing.assert_array_equal(t.float().numpy(),
                                          want[n].astype(np.float32))
    convert.lm_params_from_jax(model, jp)
    p = {k: v.detach().clone() for k, v in model.named_parameters()}
    batch = _batch(model.cfg, step=1)
    _, _, m = make_train_step(model, opt)(p, state, _t(batch))
    _, _, jm = jstep(jp, js, _j(batch), jax.random.key(1))
    _close(m["loss"], jm["loss"])
    assert int(m["step"]) == 2
