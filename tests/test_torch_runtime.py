"""The port's fault tolerance: checkpoint/restart, failure injection,
exact resume, the straggler watchdog and the elastic restore — every
``tests/test_runtime.py`` case on the port, plus checkpoints crossing
between the two packages (bf16 leaves included) and the loop's step
generator."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.checkpoint import CheckpointManager
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.runtime import SimulatedFailure, TrainLoop, TrainLoopConfig
from repro_torch.runtime.train_loop import step_generator


def _toy_setup():
    """Tiny linear-regression training step with AdamW."""
    opt = AdamW(AdamWConfig(lr=0.05, weight_decay=0.0))
    w_true = np.linspace(-1, 1, 8).astype(np.float32)

    def batch_fn(step):
        rng = np.random.default_rng(step)  # stateless: step -> batch
        x = rng.normal(size=(16, 8)).astype(np.float32)
        return {"x": torch.from_numpy(x), "y": torch.from_numpy(x @ w_true)}

    def step_fn(params, opt_state, batch, rng):
        w = params["w"].detach().requires_grad_(True)
        loss = torch.mean((batch["x"] @ w - batch["y"]) ** 2)
        (g,) = torch.autograd.grad(loss, [w])
        params, opt_state = opt.apply({"w": g}, opt_state, params)
        return params, opt_state, {"loss": loss.detach(),
                                   "step": opt_state["step"]}

    params = {"w": torch.zeros(8)}
    return step_fn, batch_fn, params, opt.init(params)


def test_checkpoint_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.int32),
                  "h": torch.randn(5).to(torch.bfloat16)}}
    mgr.save(5, tree)
    out, step = mgr.restore(None, tree)
    assert step == 5
    for got, want in ((out["a"], tree["a"]), (out["b"]["c"], tree["b"]["c"]),
                      (out["b"]["h"], tree["b"]["h"])):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_checkpoint_keep_k_rotation(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    tree = {"a": torch.zeros(2)}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.all_steps() == [3, 4]


def test_checkpoint_async_is_consistent(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3, async_save=True)
    tree = {"a": torch.arange(1000.0)}
    mgr.save(1, tree)
    mgr.wait()
    out, _ = mgr.restore(1, tree)
    assert torch.equal(out["a"], tree["a"])


def test_bf16_checkpoints_cross_between_the_packages(tmp_path):
    """A bf16 leaf the JAX package saved restores in the port bit for
    bit, and the port writes it as the same 2-byte patterns under the
    same manifest dtype (numpy tags the JAX package's file ``<V2`` and
    the port's ``|V2``; it reads both as 2-byte voids)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7)).astype(np.float32)
    jtree = {"p": jnp.asarray(x, jnp.bfloat16), "step": jnp.int32(4)}
    JCheckpointManager(tmp_path / "j", async_save=False).save(4, jtree)
    like = {"p": torch.zeros(3, 7, dtype=torch.bfloat16),
            "step": torch.zeros((), dtype=torch.int32)}
    out, step = CheckpointManager(tmp_path / "j").restore(None, like)
    assert step == 4 and int(out["step"]) == 4
    want = torch.from_numpy(x).to(torch.bfloat16)
    assert out["p"].dtype == torch.bfloat16 and torch.equal(out["p"], want)

    CheckpointManager(tmp_path / "t", async_save=False).save(4, out)
    jdir, tdir = tmp_path / "j" / "step_4", tmp_path / "t" / "step_4"
    for name in ("p.proc0.npy", "step.proc0.npy"):
        got, want = np.load(tdir / name), np.load(jdir / name)
        assert got.shape == want.shape and got.tobytes() == want.tobytes()
    assert '"dtype": "bfloat16"' in (tdir / "manifest.json").read_text()


def test_train_loop_runs_and_logs(tmp_path):
    step_fn, batch_fn, params, opt_state = _toy_setup()
    loop = TrainLoop(step_fn, TrainLoopConfig(total_steps=30,
                                              checkpoint_every=10),
                     str(tmp_path), batch_fn=batch_fn)
    loop.run((params, opt_state))
    assert len(loop.metrics_log) == 30
    assert loop.metrics_log[-1]["loss"] < loop.metrics_log[0]["loss"]
    assert all(isinstance(m["loss"], float) for m in loop.metrics_log)


def test_failure_recovery_bit_identical(tmp_path):
    """Crash at step 17 -> restore -> final params identical to an
    uninterrupted run (stateless data pipeline + checkpointed state)."""
    step_fn, batch_fn, params0, opt0 = _toy_setup()
    ref_loop = TrainLoop(step_fn, TrainLoopConfig(total_steps=25,
                                                  checkpoint_every=5),
                         str(tmp_path / "ref"), batch_fn=batch_fn)
    ref_params, _ = ref_loop.run((params0, opt0))

    crashed = {"done": False}

    def failure_hook(step):
        if step == 17 and not crashed["done"]:
            crashed["done"] = True
            raise SimulatedFailure("node lost")

    loop = TrainLoop(step_fn, TrainLoopConfig(total_steps=25,
                                              checkpoint_every=5),
                     str(tmp_path / "crash"), batch_fn=batch_fn,
                     failure_hook=failure_hook)
    params, _ = loop.run((params0, opt0))
    assert loop.restarts == 1
    assert torch.equal(params["w"], ref_params["w"])
    # the replay re-ran steps 16 and 17 after restoring step 15
    assert [m["step"] for m in loop.metrics_log].count(16) == 2


def test_max_restarts_bounds_flapping(tmp_path):
    step_fn, batch_fn, params, opt_state = _toy_setup()

    def always(step):
        if step == 3:
            raise SimulatedFailure("flapping")

    loop = TrainLoop(step_fn, TrainLoopConfig(total_steps=6,
                                              checkpoint_every=2,
                                              max_restarts=2),
                     str(tmp_path), batch_fn=batch_fn, failure_hook=always)
    with pytest.raises(SimulatedFailure):
        loop.run((params, opt_state))
    assert loop.restarts == 3


def test_resume_after_stop(tmp_path):
    """Stopping at 10 and relaunching equals one 20-step run."""
    step_fn, batch_fn, params0, opt0 = _toy_setup()
    l1 = TrainLoop(step_fn, TrainLoopConfig(total_steps=10,
                                            checkpoint_every=3),
                   str(tmp_path / "c"), batch_fn=batch_fn)
    state = l1.run((params0, opt0))
    l2 = TrainLoop(step_fn, TrainLoopConfig(total_steps=20,
                                            checkpoint_every=3),
                   str(tmp_path / "c"), batch_fn=batch_fn)
    params, _ = l2.run(state)
    ref = TrainLoop(step_fn, TrainLoopConfig(total_steps=20,
                                             checkpoint_every=3),
                    str(tmp_path / "ref"), batch_fn=batch_fn)
    ref_params, _ = ref.run((params0, opt0))
    np.testing.assert_allclose(params["w"].numpy(), ref_params["w"].numpy(),
                               rtol=1e-6)


def test_straggler_watchdog_fires(tmp_path):
    step_fn, batch_fn, params, opt_state = _toy_setup()
    slow = {"hit": []}

    def slow_hook(step):
        if step == 20:
            time.sleep(0.5)

    loop = TrainLoop(step_fn, TrainLoopConfig(total_steps=25,
                                              checkpoint_every=100,
                                              straggler_factor=3.0),
                     str(tmp_path), batch_fn=batch_fn,
                     failure_hook=slow_hook,
                     on_straggler=lambda s, dt, ew: slow["hit"].append(s))
    loop.run((params, opt_state))
    assert 20 in slow["hit"]
    assert loop.straggler_events


def test_elastic_restore_onto_another_device(tmp_path):
    """``restore_onto`` places every leaf on its like leaf's device (here
    the meta device: the CPU is the only real one; the card's case is a
    ``gpu`` test)."""
    step_fn, batch_fn, params, opt_state = _toy_setup()
    loop = TrainLoop(step_fn, TrainLoopConfig(total_steps=4,
                                              checkpoint_every=2),
                     str(tmp_path), batch_fn=batch_fn)
    trained = loop.run((params, opt_state))
    like = ({"w": torch.empty(8, device="meta")},
            {"m": {"w": torch.empty(8, device="meta")},
             "v": {"w": torch.empty(8, device="meta")},
             "step": torch.empty((), dtype=torch.int32, device="meta")})
    (p, s), step = loop.restore_onto(like)
    assert step == 2
    assert p["w"].device.type == "meta" and s["step"].device.type == "meta"
    (p, s), _ = loop.restore_onto(trained)
    assert p["w"].device.type == "cpu" and int(s["step"]) == 3


def test_step_generator_replays_the_same_bits():
    a = torch.randint(0, 1 << 16, (64,), generator=step_generator(7, "cpu"))
    b = torch.randint(0, 1 << 16, (64,), generator=step_generator(7, "cpu"))
    c = torch.randint(0, 1 << 16, (64,), generator=step_generator(8, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
