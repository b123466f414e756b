"""Training step builder: microbatch accumulation + optimizer update.

The port of the JAX package's ``launch/train.py``.
``make_train_step(model, opt, accum_steps)`` returns
    step(params, opt_state, batch, gen) -> (params', opt_state', metrics)
for the fault-tolerant loop (``repro_torch.runtime.train_loop``).
``params`` is a flat dict of the model's named parameters; the step
binds them to the model (:func:`bind_params`) before it runs, so the
tensors it is handed, restored from a checkpoint or not, are the ones
it differentiates, and binds the updated ones after, so the model
serves what was trained.  The step never changes a tensor it was
given.

Gradient accumulation splits the global batch [B, ...] into
``accum_steps`` microbatches of B/A along axis 0 and accumulates their
grads in ``accum_dtype`` (bf16 halves the grad-buffer footprint; the
stochastic-rounding AdamW makes that loss of precision safe), divided by
A at the end, as the JAX package does.

Under a mesh (``repro_torch.distributed.sharding.use_mesh``) the params
are DTensors (placed by ``distributed.specs.place_params``), each
gradient is redistributed to its parameter's placements
(:func:`_constrain_like_params`), and the AdamW states take them too.

    python -m repro_torch.launch.train --arch gemma3-1b --steps 5 \\
        --reduced --device cpu

(``--reduced``: the smoke-sized config in float32; without it the full
config in bf16, for the card.  ``--device`` defaults to ``cuda``.)
"""

from __future__ import annotations

import os
import tempfile
from typing import Any

import torch
from torch import nn

from repro_torch.distributed.sharding import (constrain, current_mesh,
                                             replicating)
from repro_torch.distributed.specs import param_logical_tree
from repro_torch.models.transformer import Model
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime import tracing


def bind_params(model: nn.Module, params: dict) -> dict:
    """Make the tensors of ``params`` (named as ``model.named_parameters()``
    names them) the model's parameters, each wrapped as an
    ``nn.Parameter`` that shares its storage where it is not one.
    Returns the bound parameters by name; ``params`` is left as it was."""
    bound = {}
    for name, t in params.items():
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        if attr not in mod._parameters:
            raise KeyError(f"{name} is not a parameter of the model")
        if mod._parameters[attr] is not t:
            if not isinstance(t, nn.Parameter):
                t = nn.Parameter(t.detach())
            mod._parameters[attr] = t
        bound[name] = t
    return bound


def _constrain_like_params(grads: dict, params: dict) -> dict:
    """Under a mesh, every gradient redistributed to its parameter's
    placements (the reduce-scatter into the FSDP layout, where DTensor's
    backward leaves partial sums or another split); without one, the
    gradients as they are."""
    if current_mesh() is None:
        return grads
    logical = param_logical_tree(params)
    return {k: constrain(g, *logical[k]) for k, g in grads.items()}


def _micro(batch: dict, i: int, accum_steps: int) -> dict:
    """Microbatch ``i`` of ``accum_steps``: rows [i*B/A, (i+1)*B/A)."""
    out = {}
    for k, v in batch.items():
        per = v.shape[0] // accum_steps
        out[k] = v[i * per:(i + 1) * per]
    return out


def make_train_step(model: Model, opt: AdamW, *, accum_steps: int = 1,
                    accum_dtype: Any = torch.bfloat16):
    def grad_fn(params: dict, micro: dict):
        bound = bind_params(model, params)
        with tracing.span("train/forward"):
            loss = model.loss(micro)
        with tracing.span("train/backward"):
            grads = torch.autograd.grad(loss, list(bound.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), _constrain_like_params(
            dict(zip(bound, grads)), bound)

    def train_step(params, opt_state, batch, gen=None):
        # under a mesh the backward and the update meet the plain tensors
        # the model and AdamW make for themselves (see replicating)
        with replicating():
            return _train_step(params, opt_state, batch, gen)

    def _train_step(params, opt_state, batch, gen):
        if accum_steps == 1:
            loss, grads = grad_fn(params, batch)
        else:
            for k, v in batch.items():
                if v.shape[0] % accum_steps:
                    raise ValueError(f"{k}: a batch of {v.shape[0]} does not"
                                     f" split into {accum_steps} "
                                     f"microbatches")
            loss = None
            grads = {k: torch.zeros_like(p, dtype=accum_dtype)
                     for k, p in params.items()}
            for i in range(accum_steps):
                l_i, g = grad_fn(params, _micro(batch, i, accum_steps))
                loss = l_i if loss is None else loss + l_i
                grads = {k: grads[k] + g[k].to(accum_dtype) for k in grads}
            loss = loss / accum_steps
            # stay in accum_dtype: /accum is exact for power-of-2 steps
            grads = {k: g / accum_steps for k, g in grads.items()}

        with tracing.span("train/optimizer"):
            new_params, new_state = opt.apply(grads, opt_state, params,
                                              rng=gen)
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for g in grads.values()))
        new_params = bind_params(model, new_params)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "step": new_state["step"]}
        return new_params, new_state, metrics

    return train_step


def frontend_inputs(cfg, batch: int, device) -> dict:
    """The zero ``frames`` (enc-dec) or ``patches`` (vision) a batch of
    tokens needs, as the JAX launcher makes them."""
    shape = (batch, cfg.frontend_len, cfg.d_model)
    out = {}
    if cfg.is_enc_dec:
        out["frames"] = torch.zeros(shape, device=device)
    if cfg.frontend == "vision":
        out["patches"] = torch.zeros(shape, device=device)
    return out


def main(argv=None):
    """CLI launcher: train any assigned architecture.  Returns the
    finished ``TrainLoop``."""
    import argparse

    from repro_torch.configs import get_config, list_configs, reduced
    from repro_torch.data import ShardedLoader, SyntheticTokens
    from repro_torch.engine.engine import resolve_device
    from repro_torch.optim import AdamWConfig, cosine_schedule
    from repro_torch.runtime import TrainLoop, TrainLoopConfig

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=list_configs())
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-sized config (CPU-runnable)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: <tmp>/repro_torch_train_ckpt/<arch>")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda needs a card; cpu runs the "
                         "plain versions)")
    args = ap.parse_args(argv)
    if args.ckpt_dir is None:
        args.ckpt_dir = os.path.join(tempfile.gettempdir(),
                                     "repro_torch_train_ckpt", args.arch)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    print(f"{cfg.name}: {cfg.n_params()/1e6:.1f}M params")
    model = Model(cfg, torch.float32 if args.reduced else torch.bfloat16,
                  loss_chunk=min(256, args.seq),
                  attn_chunk=min(512, args.seq), device=dev, seed=0)
    opt = AdamW(AdamWConfig(lr=cosine_schedule(
        args.lr, warmup_steps=5, total_steps=args.steps)))
    params = dict(model.named_parameters())
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt, accum_steps=args.accum)

    src = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          batch_size=args.batch, seed=0)
    loader = ShardedLoader(src.batch, prefetch=2)

    def batch_fn(step):
        out = {k: torch.from_numpy(v).to(dev)
               for k, v in loader.get(step).items()}
        out.update(frontend_inputs(cfg, args.batch, dev))
        return out

    loop = TrainLoop(step_fn, TrainLoopConfig(
        total_steps=args.steps, checkpoint_every=max(5, args.steps // 3)),
        args.ckpt_dir, batch_fn=batch_fn)
    loop.run((params, opt_state))
    if loop.metrics_log:
        print(f"loss {loop.metrics_log[0]['loss']:.3f} -> "
              f"{loop.metrics_log[-1]['loss']:.3f}")
    return loop


if __name__ == "__main__":
    main()
