"""The engine, trainer and serving stack on a device grid: a plan with a
placement (``mesh`` or ``mesh_shape``) against the local plan, and the
meshed trainer against the JAX package's.

Grids name the CPU several times (an engine on the CPU resolves
``mesh_shape`` that way), so every factorization runs here.  Every
comparison is exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.wenquxing_snn import WENQUXING_22A_INTENSITY as J_CFG
from repro.core import trainer as jtrainer
from repro.core.preprocess import preprocess_batch as jpreprocess_batch
from repro.data.digits import make_digits
from repro_torch.configs import WENQUXING_22A_MESH2D
from repro_torch.configs.wenquxing_snn import WENQUXING_22A_INTENSITY
from repro_torch.core import trainer
from repro_torch.core.bitpack import as_words, words_to_numpy
from repro_torch.core.rvsnn import snn_regfile, snn_regfile_batch
from repro_torch.core.trainer import SNNTrainConfig
from repro_torch.distributed import snn_mesh
from repro_torch.engine import (SNNEngine, SNNEnginePlan, plan_from_config,
                                refresh_weights, train_stream,
                                train_stream_batch)
from repro_torch.loadgen.runner import make_clock
from repro_torch.serving import (FaultInjector, FaultSpec, SNNRefreshPolicy,
                                 SNNRequest, SNNServingEngine,
                                 SNNServingPolicy, SNNWeightRefresher)

N, W, T, B = 11, 3, 8, 3
N_IN = W * 32 - 7


def _plan(**kw):
    p = dict(threshold=30, leak=2, w_exp=64, gain=4, n_syn=N_IN,
             ltp_prob=200, encode_seed=0x22A)
    p.update(kw)
    return SNNEnginePlan(**p)


def _cpus(k):
    return ["cpu"] * k


GRIDS = {"2x2": dict(mesh_shape=(2, 2)), "3x1": dict(mesh_shape=(3, 1)),
         "1d-4": dict(mesh=snn_mesh.snn_mesh(4, devices=_cpus(4)))}


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        weights=rng.integers(0, 2**32, (N, W), dtype=np.uint32),
        windows=(rng.integers(0, 2**32, (B, T, W), dtype=np.uint32)
                 & rng.integers(0, 2**32, (B, T, W), dtype=np.uint32)),
        inten=rng.integers(0, 256, (B, N_IN), dtype=np.uint8),
        teach=rng.integers(-50, 50, (B, N), dtype=np.int32),
        wts_b=rng.integers(0, 2**32, (B, N, W), dtype=np.uint32),
        stream=rng.integers(0, 256, (B, 5, N_IN), dtype=np.uint8),
        stream_teach=rng.integers(-50, 50, (B, 5, N), dtype=np.int32))


def _equal(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert torch.equal(a, b)


# --- the plan ---------------------------------------------------------------

def test_plan_mesh_shape_validation_and_roundtrip():
    cfg = SNNTrainConfig(mesh_shape=(2, 4))
    assert plan_from_config(cfg).mesh_shape == (2, 4)
    assert cfg.plan(1).mesh_shape == (2, 4)
    # an explicit mesh overrides the config's declarative shape
    m = snn_mesh.snn_mesh(2, devices=_cpus(2))
    p = plan_from_config(cfg, mesh=m)
    assert p.mesh is m and p.mesh_shape is None
    assert cfg.plan(0, m) == p
    # lists normalize to tuples so the frozen plan stays hashable
    assert _plan(mesh_shape=[1, 1]).mesh_shape == (1, 1)
    assert hash(_plan(mesh_shape=[2, 1])) == hash(_plan(mesh_shape=(2, 1)))
    assert hash(p) == hash(plan_from_config(cfg, mesh=snn_mesh.snn_mesh(
        2, devices=_cpus(2))))
    for bad in ((0, 2), (2,), (1, 2, 3), ("2", "4")):
        with pytest.raises(ValueError):
            _plan(mesh_shape=bad)
    with pytest.raises(ValueError):
        _plan(mesh_shape=(1, 1), cycle_backend="step")
    with pytest.raises(ValueError):
        _plan(mesh=m, cycle_backend="step", encode="host")
    with pytest.raises(ValueError):
        _plan(mesh_shape=(1, 1), mesh=m)


def test_plan_placement_resolution():
    assert _plan().placement() is None
    assert _plan().placement("cpu") is None
    m = snn_mesh.snn_mesh(2, devices=_cpus(2))
    assert _plan(mesh=m).placement("cpu") is m
    built = _plan(mesh_shape=(2, 3)).placement("cpu")
    assert built.shape == {"data": 2, "neuron": 3}
    assert built == snn_mesh.snn_mesh2d(2, 3, devices=_cpus(6))
    # off the CPU the grid takes the visible cards, and too few raise
    with pytest.raises(ValueError):
        _plan(mesh_shape=(torch.cuda.device_count() + 1, 1)).placement()


def test_engine_refuses_a_grid_that_gathers_elsewhere():
    grid = snn_mesh.snn_mesh(2, devices=["meta", "meta"])
    with pytest.raises(ValueError):
        SNNEngine(_plan(mesh=grid), device="cpu")
    assert SNNEngine(_plan(mesh_shape=(2, 1)), device="cpu").mesh.size == 2
    assert SNNEngine(_plan(), device="cpu").mesh is None


# --- every verb under a grid equals the local plan ---------------------------

@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("encode", ["host", "kernel"])
def test_infer_and_train_verbs_equal_the_local_plan(grid, encode):
    d = _data(1)
    local = SNNEngine(_plan(encode=encode), device="cpu")
    meshed = SNNEngine(_plan(encode=encode, **GRIDS[grid]), device="cpu")
    seeds = np.array([3, -4, 5], np.int32)
    t_total = np.array([T, 2, 0], np.int32)
    for eng_kw in (dict(windows=d["windows"]),
                   dict(intensities=d["inten"], seeds=seeds, n_steps=T,
                        t_total=t_total)):
        _equal(meshed.infer(d["weights"], **eng_kw),
               local.infer(d["weights"], **eng_kw))
    for learn in (True, False):
        lo, me = local, meshed
        if not learn:
            lo = SNNEngine(dataclasses.replace(local.plan, w_exp=None),
                           device="cpu")
            me = SNNEngine(dataclasses.replace(meshed.plan, w_exp=None),
                           device="cpu")
        rf = snn_regfile(as_words(d["weights"]), seed=9)
        for kw in (dict(window=d["windows"][1]),
                   dict(intensities=d["inten"][2], seed=17, n_steps=T)):
            got, want = (e.train(rf, teach=d["teach"][0], **kw)
                         for e in (me, lo))
            _equal(tuple(got.regfile) + got[1:],
                   tuple(want.regfile) + want[1:])


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("encode", ["host", "kernel"])
def test_batched_verbs_and_stream_drivers_equal_the_local_plan(grid, encode):
    d = _data(2)
    local = SNNEngine(_plan(encode=encode), device="cpu")
    meshed = SNNEngine(_plan(encode=encode, **GRIDS[grid]), device="cpu")
    rfs = snn_regfile_batch(as_words(d["wts_b"]), [5, 6, 7])
    lp = np.array([16, 500, 1023], np.int32)
    for kw in (dict(windows=d["windows"]),
               dict(intensities=d["inten"], seeds=[1, 2, 3], n_steps=T)):
        got = meshed.train_batch(rfs, teach=d["teach"], ltp_prob=lp, **kw)
        want = local.train_batch(rfs, teach=d["teach"], ltp_prob=lp, **kw)
        _equal(tuple(got[0]) + got[1:], tuple(want[0]) + want[1:])
    # the stream drivers: with intensities on an in-kernel-encode plan one
    # stream launch (a shard's), otherwise one launch a sample
    sd = np.arange(5, dtype=np.int32) * 3 - 4
    rf = snn_regfile(as_words(d["weights"]), seed=11)
    for kw in (dict(intensities=d["stream"][0], seeds=sd, n_steps=T),
               dict(spike_trains=np.stack([d["windows"][0]] * 5))):
        got = train_stream(meshed, rf, teach=d["stream_teach"][0], **kw)
        want = train_stream(local, rf, teach=d["stream_teach"][0], **kw)
        _equal(tuple(got[0]) + got[1:], tuple(want[0]) + want[1:])
    for kw in (dict(intensities=d["stream"], seeds=sd, n_steps=T),
               dict(spike_trains=np.stack([d["windows"]] * 5, axis=1))):
        got = train_stream_batch(meshed, rfs, teach=d["stream_teach"],
                                 ltp_prob=lp, **kw)
        want = train_stream_batch(local, rfs, teach=d["stream_teach"],
                                  ltp_prob=lp, **kw)
        _equal(tuple(got[0]) + got[1:], tuple(want[0]) + want[1:])
    # the train-while-serving verb on a serving-shaped bank of 3 blocks
    bank = np.concatenate([d["weights"][:4]] * 3)
    kw = dict(labels=[0, 3, 1, 2, 2], n_classes=4,
              intensities=d["stream"][1], seeds=sd, n_steps=T)
    _equal(refresh_weights(meshed, bank, **kw),
           refresh_weights(local, bank, **kw))


# --- the trainer ------------------------------------------------------------

def _digits(n, seed):
    imgs, labels = make_digits(n, seed=seed)
    x = np.asarray(jpreprocess_batch(jnp.asarray(imgs.reshape(-1, 28, 28)),
                                     0.1)).reshape(n, -1)
    return x, labels


def _jax_parallel_seeds(jcfg):
    """The per-block LFSR seeds ``repro.core.trainer.train`` draws in
    parallel mode from its default key."""
    key = jax.random.key(jcfg.seed)
    key, _ = jax.random.split(key)        # the host-encode key
    _, bk = jax.random.split(key)
    return [int(s) + 1 for s in jax.random.choice(
        bk, (1 << 16) - 1, (jcfg.n_blocks,), replace=False)]


def test_mesh2d_config_trains_as_the_local_run_and_the_jax_trainer():
    """``WENQUXING_22A_MESH2D`` (784-40, parallel mode, a (2, 4) grid) on
    24 digits at T 16: the same weights and class map as the local run,
    and as the JAX package's trainer (run locally: its process has one
    CPU device) with the block seeds made equal."""
    assert WENQUXING_22A_MESH2D.mesh_shape == (2, 4)
    assert WENQUXING_22A_MESH2D.train_mode == "parallel"
    assert dataclasses.replace(WENQUXING_22A_MESH2D, mesh_shape=None,
                               train_mode="active") == \
        WENQUXING_22A_INTENSITY
    x, labels = _digits(24, 31)
    cfg = dataclasses.replace(WENQUXING_22A_MESH2D, n_steps=16, epochs=1)
    jcfg = dataclasses.replace(J_CFG, n_steps=16, epochs=1,
                               train_mode="parallel")
    seeds = _jax_parallel_seeds(jcfg)
    meshed = trainer.train(cfg, x, labels, block_seeds=seeds, device="cpu")
    local = trainer.train(dataclasses.replace(cfg, mesh_shape=None), x,
                          labels, block_seeds=seeds, device="cpu")
    jm = jtrainer.train(jcfg, x, labels)
    assert torch.equal(meshed.weights, local.weights)
    assert torch.equal(meshed.neuron_class, local.neuron_class)
    np.testing.assert_array_equal(words_to_numpy(meshed.weights),
                                  np.asarray(jm.weights))
    np.testing.assert_array_equal(meshed.neuron_class.numpy(),
                                  np.asarray(jm.neuron_class))
    # an explicit grid in place of the config's, and the meshed classify
    grid = snn_mesh.snn_mesh2d(4, 2, devices=_cpus(8))
    again = trainer.train(dataclasses.replace(cfg, mesh_shape=None), x,
                          labels, block_seeds=seeds, device="cpu",
                          mesh=grid)
    assert torch.equal(again.weights, meshed.weights)
    inten = np.clip(np.round(x * 255), 0, 255).astype(np.uint8)
    sd = np.arange(24, dtype=np.int32)
    assert torch.equal(
        trainer.classify(meshed, intensities=inten, seeds=sd),
        trainer.classify(local, intensities=inten, seeds=sd, mesh=grid))


def test_active_mode_on_a_grid_equals_the_local_run():
    x, labels = _digits(12, 33)
    cfg = dataclasses.replace(WENQUXING_22A_INTENSITY, n_neurons=20,
                              n_steps=8, epochs=1, mesh_shape=(1, 3))
    got = trainer.train(cfg, x, labels, block_seeds=[4, 5], device="cpu")
    want = trainer.train(dataclasses.replace(cfg, mesh_shape=None), x,
                         labels, block_seeds=[4, 5], device="cpu")
    assert torch.equal(got.weights, want.weights)
    assert torch.equal(got.neuron_class, want.neuron_class)


# --- the serving stack ------------------------------------------------------

N_CLASSES, BLOCKS = 4, 2
SERVE_PLAN = dict(threshold=24, leak=2, w_exp=128, n_syn=64,
                  encode="kernel", cycle_backend="window", max_batch=4,
                  t_chunk=8, kernel_backend="ref")


def _quadrant_data(n):
    labels = np.arange(n) % N_CLASSES
    inten = np.zeros((n, 64), np.uint8)
    for i, c in enumerate(labels):
        inten[i, c * 16:(c + 1) * 16] = 200
    return inten, labels


def _serving(placement, spec=None):
    plan = SNNEnginePlan(**SERVE_PLAN, **placement)
    inten, labels = _quadrant_data(64)
    refresher = SNNWeightRefresher(
        plan, inten, labels, n_classes=N_CLASSES,
        probe_intensities=inten[:16], probe_labels=labels[:16],
        neuron_class=np.tile(np.arange(N_CLASSES), BLOCKS), n_steps=16,
        policy=SNNRefreshPolicy(refresh_every=2, probe_size=16,
                                refresh_samples=16), device="cpu")
    bank = np.random.default_rng(0).integers(
        0, 2**32, (N_CLASSES * BLOCKS, 2), dtype=np.uint32)
    return SNNServingEngine(
        bank, plan, neuron_class=np.tile(np.arange(N_CLASSES), BLOCKS),
        policy=SNNServingPolicy(canary_every=3), refresher=refresher,
        clock=make_clock("virtual"), device="cpu",
        on_launch=None if spec is None else FaultInjector(FaultSpec(**spec)))


@pytest.mark.parametrize("spec", [None, dict(p_launch_error=0.2,
                                             p_corrupt=0.1, seed=3)])
def test_meshed_serving_engine_and_refresher_equal_the_local_ones(spec):
    inten, _ = _quadrant_data(64)
    out = {}
    for name, placement in (("local", {}), ("grid", dict(mesh_shape=(2, 2)))):
        eng = _serving(placement, spec)
        reqs = eng.run([SNNRequest(rid=i, intensities=inten[i % 64],
                                   n_steps=16 - 4 * (i % 3))
                        for i in range(40)])
        out[name] = (eng, reqs)
    (le, lreqs), (ge, greqs) = out["local"], out["grid"]
    assert ge.engine.mesh is not None and ge.engine.mesh.size == 4
    assert [p.mesh_shape for p in ge._plans] == [(2, 2)] * len(ge._plans)
    assert [r.status for r in greqs] == [r.status for r in lreqs]
    assert [r.served_version for r in greqs] == \
        [r.served_version for r in lreqs]
    for a, b in zip(greqs, lreqs):
        assert (a.counts is None) == (b.counts is None)
        if a.counts is not None:
            np.testing.assert_array_equal(a.counts, b.counts)
    assert ge.canary_checks == le.canary_checks > 0
    assert ge.store.stats() == le.store.stats()
    assert torch.equal(ge.weights, le.weights)
