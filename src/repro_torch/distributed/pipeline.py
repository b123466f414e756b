"""Pipeline parallelism: the GPipe microbatch schedule, single-controller.

The port of the JAX package's ``repro.distributed.pipeline``.  The layer
stack is split into S stages, stage ``s`` on ``devices[s]``;
microbatches flow stage to stage over T = M + S - 1 ticks (bubble
fraction (S - 1) / (S - 1 + M)).  Where the JAX package runs one program
per device under ``shard_map`` and moves activations with one
``ppermute`` a tick, this one is a single controller over a list of
devices (as ``distributed/snn_mesh.py``): at tick ``t`` stage ``s``
computes microbatch ``t - s`` when ``0 <= t - s < M`` (stage 0 ingests
microbatch ``t``), and its output moves on with one ``.to(next device)``.
Launches on different devices run concurrently, since the host does not
wait on any of them; S stages named on one device (the one-card
machine) run one after another on its stream.

``stage_fn`` is any function of (one stage's params, x): a tensor slice,
or a ``ModuleList`` of the stage's layers run in order.
"""

from __future__ import annotations

import torch


def _to(obj, device):
    if isinstance(obj, (torch.Tensor, torch.nn.Module)):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to(v, device) for v in obj)
    return obj


def pipeline_schedule(stage_fn, n_stages: int, n_micro: int):
    """The schedule as a function ``run(devices, stage_params, micro_x) ->
    micro_y``: ``stage_params[s]`` on ``devices[s]``, ``micro_x`` [M,
    ...] (all microbatches), ``micro_y`` [M, ...] the last stage's
    outputs on ``devices[0]``."""

    def run(devices, stage_params, micro_x):
        if len(devices) != n_stages or len(stage_params) != n_stages:
            raise ValueError(f"{n_stages} stages need as many devices and "
                             f"stage params, got {len(devices)} and "
                             f"{len(stage_params)}")
        if len(micro_x) != n_micro:
            raise ValueError(f"expected {n_micro} microbatches, got "
                             f"{len(micro_x)}")
        buf = [None] * n_stages        # the activation each stage receives
        out = [None] * n_micro
        for t in range(n_micro + n_stages - 1):
            nxt = [None] * n_stages
            for s in range(n_stages):
                if not 0 <= t - s < n_micro:
                    continue
                x_in = micro_x[t].to(devices[0]) if s == 0 else buf[s]
                y = stage_fn(stage_params[s], x_in)
                if s == n_stages - 1:
                    out[t - s] = y
                else:
                    nxt[s + 1] = y.to(devices[s + 1])
            buf = nxt
        return torch.stack([y.to(devices[0]) for y in out])

    return run


def pipelined_apply(devices, stage_fn, stage_params, micro_x):
    """Run the schedule over ``devices`` (one stage each; a device may be
    named more than once).  ``stage_params``: one object per stage (a
    tensor with a leading stage axis is split along it), each moved to
    its stage's device.  ``micro_x`` [M, ...].  Returns [M, ...] outputs
    of the last stage on ``devices[0]``."""
    devices = [torch.device(d) for d in devices]
    if isinstance(stage_params, torch.Tensor):
        stage_params = list(stage_params.unbind(0))
    if len(stage_params) != len(devices):
        raise ValueError(f"{len(devices)} devices for {len(stage_params)} "
                         f"stages")
    stage_params = [_to(p, d) for p, d in zip(stage_params, devices)]
    run = pipeline_schedule(stage_fn, len(devices), len(micro_x))
    return run(devices, stage_params, micro_x)
