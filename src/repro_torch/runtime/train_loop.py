"""Fault-tolerant training loop.

The port of the JAX package's ``runtime/train_loop.py``, on the port's
``CheckpointManager`` (the same on-disk layout):

* **checkpoint/restart** — periodic async checkpoints; on failure the
  loop restores the latest complete step and replays.  The data
  pipeline is stateless (step -> batch), so restart resumes the exact
  token stream: training after a crash is bit-identical to an
  uninterrupted run.  The restored tensors are the state the next step
  reads: the loop hands ``(params, opt_state)`` to the step function on
  every call, and a step function keeps no weights of its own
  (``launch.train.make_train_step`` binds the params it is given to the
  model before each step).
* **failure injection** — ``SimulatedFailure`` raised by the step
  function or the test hook triggers restore; ``max_restarts`` bounds
  flapping.
* **straggler watchdog** — per-step wall time EWMA over the whole
  iteration (input stalls are a straggler cause too); a step slower than
  ``straggler_factor x`` EWMA is recorded and a callback fires.
* **elastic restore** — ``TrainLoop.restore_onto`` restores the latest
  checkpoint onto the devices of ``like_state``'s leaves (CPU <-> cuda),
  or, given a placements tree, onto a (possibly different) mesh: every
  leaf a DTensor placed as the tree says (the JAX package's sharding
  tree).  A state of DTensors saves and restores in its own placements;
  every rank runs the loop, and after a failure every rank restores the
  step rank 0 wrote last (``CheckpointManager``'s sharded save and
  restore meet on every rank).

The step's loss is waited on with ``float()`` (a ``.item()``), so each
step's time includes its device work.  ``rng_fn`` defaults to a
``torch.Generator`` on the state's device seeded from ``(0, step)``, so
a replayed step draws the same bits.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.checkpointer import _flatten


class SimulatedFailure(RuntimeError):
    """Raised by the failure-injection hook to emulate a node loss."""


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    keep_checkpoints: int = 3
    straggler_factor: float = 3.0
    straggler_warmup: int = 5
    max_restarts: int = 5
    log_every: int = 10


def step_generator(step: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``(0, step)`` (the JAX
    package's ``fold_in(key(0), step)``, with torch's bits)."""
    seed = int(np.random.SeedSequence([0, step]).generate_state(
        1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def _device_of(state) -> torch.device:
    for _, leaf, _ in _flatten(state):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


class TrainLoop:
    def __init__(self, step_fn: Callable, cfg: TrainLoopConfig,
                 ckpt_dir: str, *, batch_fn: Callable[[int], Any],
                 rng_fn: Callable[[int], Any] | None = None,
                 on_straggler: Callable[[int, float, float], None] | None
                 = None,
                 failure_hook: Callable[[int], None] | None = None):
        self.step_fn = step_fn
        self.cfg = cfg
        self.ckpt = CheckpointManager(ckpt_dir, keep=cfg.keep_checkpoints)
        self.batch_fn = batch_fn
        self.rng_fn = rng_fn
        self.on_straggler = on_straggler
        self.failure_hook = failure_hook
        self.metrics_log: list[dict] = []
        self.straggler_events: list[dict] = []
        self.restarts = 0

    # --- elastic entry point ----------------------------------------------

    def restore_onto(self, like_state, placements_tree=None, mesh=None):
        """Restore the latest checkpoint onto the devices of
        ``like_state``'s leaves, each leaf that ``placements_tree`` names
        a DTensor on ``mesh`` (default the ``use_mesh`` context's) with
        those placements: ``(state, step)``."""
        return self.ckpt.restore(None, like_state, placements_tree, mesh)

    # --- main loop -----------------------------------------------------------

    def run(self, state) -> Any:
        """state: (params, opt_state).  Returns final state."""
        cfg = self.cfg
        dev = _device_of(state)
        rng_fn = self.rng_fn or (lambda s: step_generator(s, dev))
        start = 0
        if self.ckpt.latest_step(state) is not None:
            state, start = self.ckpt.restore(None, state)
            start += 1
        else:
            # anchor checkpoint: "state after step start-1", so a crash
            # before the first periodic save still restores cleanly
            self.ckpt.save(start - 1, state)
            self.ckpt.wait()
        step = start
        ewma = None
        while step < cfg.total_steps:
            try:
                t0 = time.monotonic()
                if self.failure_hook is not None:
                    self.failure_hook(step)
                batch = self.batch_fn(step)
                params, opt_state, metrics = self.step_fn(
                    state[0], state[1], batch, rng_fn(step))
                loss = float(metrics["loss"])
                dt = time.monotonic() - t0
                state = (params, opt_state)

                # straggler watchdog
                if ewma is not None and step - start >= cfg.straggler_warmup \
                        and dt > cfg.straggler_factor * ewma:
                    ev = {"step": step, "dt": dt, "ewma": ewma}
                    self.straggler_events.append(ev)
                    if self.on_straggler:
                        self.on_straggler(step, dt, ewma)
                ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt

                self.metrics_log.append({"step": step, "loss": loss,
                                         "dt": dt})
                if step % cfg.checkpoint_every == 0 and step > start:
                    self.ckpt.save(step, state)
                step += 1
            except SimulatedFailure:
                self.restarts += 1
                if self.restarts > cfg.max_restarts:
                    raise
                # a save in flight lands first (on every rank, sharded)
                self.ckpt.wait()
                state, latest = self.ckpt.restore(None, state)
                step = latest + 1
        self.ckpt.wait()
        return state
