"""The port's sharded LM path on 8 gloo ranks, against its unsharded run
and the JAX package.

One subprocess (``tests/torch_dist_helpers.py``) spawns 8 CPU ranks on
a (data 2, model 4) ``DeviceMesh``, JAX's ``test_dryrun_small.py`` mesh,
and runs every multi-rank check once; a second runs the JAX package's
``compressed_psum`` under ``shard_map`` on 8 forced host devices.  Both
start together; the tests read what they wrote.

Tolerances: float32 throughout; a sharded matmul sums its contracting
dim in another order, so losses, gradients, AdamW states, and the
sharded prefill's and decode steps' logits and caches are held within
1e-5.  Params after 4 AdamW steps are held within 1e-5 but where the
first step's gradient is below ``GRAD_NOISE`` (2e-6, under a
seven-hundredth of the median |gradient|, 1.2e-3-1.5e-3 in both
configs): there Adam's m / sqrt(v) of near-zero moments turns that
reordering into a visible part of a step.  Those elements are counted
(at most one in ``1 / OVER_SHARE`` of all; measured 5 of 427,392 for
starcoder2 and 21 of 902,784 for gemma3) and held within 1e-4 under
SEQPAR (a tenth of lr; measured 2.0e-5) and half a step (lr / 2) under
heads-TP (measured 1.5e-4), so a step missed or doubled anywhere still
fails.

The tensor-parallel families (MoE experts' ``d_ff``, Mamba channels,
RWKV6 heads split over model): logits within 1e-5, cache leaves within
1e-5 of their scale (RWKV6's state sums k v over the prompt: up to ~30,
where float32 resolves 2e-6); the same (token, slot)s dropped past
capacity; one AdamW step's loss, first gradients and states within 1e-5,
its params within 1e-5 but where the first gradient is noise, those
held within ``ONE_STEP_CAP`` (2 lr: one step moves an element by at
most lr, so two runs of one step differ by at most twice that; measured
1.9e-4 for jamba), counted as above.
``compressed_psum`` is held within 1e-6 of JAX's (a sum of 8 signed
scales in another order).
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
RANK_TIMEOUT = 300
TOL = 1e-5
GRAD_NOISE = 2e-6
OVER_SHARE = 1e-4
SEQPAR_CAP = 1e-4  # lr / 10
HALF_STEP = 5e-4  # lr / 2
ONE_STEP_CAP = 2e-3  # 2 lr
FAMILIES = ["mixtral-8x22b/default", "mixtral-8x22b/seqpar",
            "jamba-1.5-large-398b/default", "rwkv6-7b/default"]
# the channels split over model in each family's tensor-parallel layers
TP_WIDTHS = {"mixtral-8x22b": {"d_ff"},
             "jamba-1.5-large-398b": {"d_ff", "d_inner"},
             "rwkv6-7b": {"heads"}}


def _jax_checkpoint(d: Path) -> dict:
    import jax.numpy as jnp

    from repro.checkpoint import CheckpointManager as JaxCheckpointManager

    rng = np.random.default_rng(7)
    tree = {"w": rng.normal(size=(8, 16)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}
    m = JaxCheckpointManager(d, async_save=False)
    m.save(3, {k: jnp.asarray(v) for k, v in tree.items()})
    m.wait()
    return tree


_JAX_PSUM = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, "src"); sys.path.insert(0, "tests")
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.optim.compression import compressed_psum
    from torch_dist_helpers import psum_inputs

    mesh = jax.make_mesh((8,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    ins = [psum_inputs(r) for r in range(8)]
    g = {k: jnp.stack([i[0][k] for i in ins]) for k in ins[0][0]}
    e = {k: jnp.stack([i[1][k] for i in ins]) for k in ins[0][1]}

    def step(g, e):
        sq = lambda t: {k: v[0] for k, v in t.items()}
        s, ne = compressed_psum(sq(g), sq(e), "data")
        return ({k: v[None] for k, v in s.items()},
                {k: v[None] for k, v in ne.items()})

    s, ne = jax.jit(jax.shard_map(step, mesh=mesh,
                                  in_specs=(P("data"), P("data")),
                                  out_specs=(P("data"), P("data"))))(g, e)
    np.savez(sys.argv[1], **{f"synced_{k}": np.asarray(v)
                             for k, v in s.items()},
             **{f"err_{k}": np.asarray(v) for k, v in ne.items()})
    print("JAX_PSUM_OK")
""")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist")
    jax_tree = _jax_checkpoint(out / "jax_ckpt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    # a session of its own, so that a hang is ended with every rank
    ranks = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dist_helpers.py"),
         str(out), str(WORLD)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        jax_run = subprocess.run(
            [sys.executable, "-c", _JAX_PSUM, str(out / "jax_psum.npz")],
            cwd=ROOT, capture_output=True, text=True, timeout=RANK_TIMEOUT)
        log, _ = ranks.communicate(timeout=RANK_TIMEOUT)
    finally:
        if ranks.poll() is None:
            os.killpg(ranks.pid, signal.SIGKILL)
            ranks.wait()
    assert ranks.returncode == 0, log[-4000:]
    assert "JAX_PSUM_OK" in jax_run.stdout, jax_run.stderr[-3000:]
    res = json.loads((out / "results.json").read_text())
    return out, res, jax_tree


def _held_to_unsharded(r, cap):
    np.testing.assert_allclose(r["losses_sharded"], r["losses_plain"],
                               rtol=TOL)
    assert r["losses_plain"][-1] < r["losses_plain"][0]
    assert r["first_grads_gap"] <= TOL, r["first_grads_gap"]
    assert r["state_gap"] <= TOL, r["state_gap"]
    # every param within TOL but where the first gradient is noise
    assert r["max_first_grad_over_tol"] < GRAD_NOISE, r
    assert r["n_over_tol"] <= OVER_SHARE * r["n_param_elements"], r
    assert r["max_param_gap"] <= cap, r["max_param_gap"]


def test_seqpar_training_matches_unsharded(run):
    _, res, _ = run
    _held_to_unsharded(res["seqpar"], SEQPAR_CAP)


def test_heads_tp_training_matches_unsharded(run):
    _, res, _ = run
    r = res["headstp"]
    _held_to_unsharded(r, HALF_STEP)
    # wqkv: p_in over data, the packed heads over model
    assert r["wqkv_placements"] == ["S(0)", "S(1)"]


@pytest.mark.parametrize("lengths", ["one_length", "lengths"])
def test_sharded_serving_matches_unsharded(run, lengths):
    _, res, _ = run
    r = res["serve"][lengths]
    assert r["calls"] == 5 and r["ring_slots"] == 16 and r["pad_masked"]
    assert r["logits_gap"] <= TOL, r
    assert r["cache_gap"] <= TOL, r


def test_trainloop_recovers_every_rank_on_one_step(run):
    _, res, _ = run
    r = res["loop"]
    assert r["restarts"] == 1
    # the failure at step 5 came right after step 4's async save: every
    # rank restored step 4 and went on from step 5 (an older step would
    # have run 3 and 4 twice)
    assert r["steps_by_rank"] == [list(range(8))] * WORLD
    assert all(r["equal_by_rank"]) and r["placed_as_before"]


def test_seqpar_params_are_sharded(run):
    _, res, _ = run
    placed = res["seqpar"]["placements"]
    # wqkv: p_in over data, p_out over model; the norms replicated
    assert placed["layers.0.mixer.wqkv"] == ["S(0)", "S(1)"]
    assert placed["layers.0.ln1.scale"] == ["R", "R"]
    assert placed["embed"] == ["S(0)", "S(1)"]


def test_sharded_save_writes_the_unsharded_bytes(run):
    out, _, _ = run
    a, b = out / "ckpt_sharded" / "step_0", out / "ckpt_plain" / "step_0"
    names = sorted(p.name for p in b.iterdir())
    assert names == sorted(p.name for p in a.iterdir())
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


def test_moe_gradients_take_the_params_placements(run):
    _, res, _ = run
    r = res["moe"]
    assert r["grads_placed_as_params"]
    assert r["new_placed_as_params"] and r["m_placed_as_params"]
    assert r["sharded_leaves"] > r["n_params"] // 2
    assert np.isfinite(r["loss"])


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "rwkv6-7b"])
def test_mamba_and_rwkv6_gradients_take_the_params_placements(run, arch):
    _, res, _ = run
    r = res["grads"][arch]
    assert r["grads_placed_as_params"]
    assert r["new_placed_as_params"] and r["m_placed_as_params"]
    assert r["sharded_leaves"] > r["n_params"] // 2
    assert np.isfinite(r["loss"])


@pytest.mark.parametrize("family", FAMILIES)
def test_tensor_parallel_family_serves_as_unsharded(run, family):
    _, res, _ = run
    r = res["families"][family]
    assert r["calls"] == 5 and r["cache_leaves"] > 0
    assert r["logits_gap"] <= TOL, r
    assert r["prefill_cache_gap"] <= TOL, r
    assert r["decode_cache_gap"] <= TOL, r
    # the same (token, slot)s dropped past capacity, and some are
    assert r["same_drops"]
    assert (r["n_drops"] > 0) == ("rwkv6" not in family), r


@pytest.mark.parametrize("family", FAMILIES)
def test_tensor_parallel_family_runs_on_its_model_slice(run, family):
    """Each rank's expert product, Mamba scan and RWKV6 recurrence see a
    quarter of d_ff, d_inner and the heads (model 4): no full copy."""
    _, res, _ = run
    r = res["families"][family]
    assert set(r["full"]) == TP_WIDTHS[family.split("/")[0]]
    assert r["local"] == {k: v // 4 for k, v in r["full"].items()}


@pytest.mark.parametrize("family", FAMILIES)
def test_tensor_parallel_family_trains_as_unsharded(run, family):
    _, res, _ = run
    r = res["families"][family]["train"]
    np.testing.assert_allclose(r["losses_sharded"], r["losses_plain"],
                               rtol=TOL)
    assert r["first_grads_gap"] <= TOL, r["first_grads_gap"]
    assert r["state_gap"] <= TOL, r["state_gap"]
    assert r["max_first_grad_over_tol"] < GRAD_NOISE, r
    assert r["n_over_tol"] <= OVER_SHARE * r["n_param_elements"], r
    assert r["max_param_gap"] <= ONE_STEP_CAP, r["max_param_gap"]


def test_compressed_psum_matches_jax(run):
    out, _, _ = run
    want = np.load(out / "jax_psum.npz")
    for rank in range(WORLD):
        got = np.load(out / f"psum_rank{rank}.npz")
        for key in got.files:
            np.testing.assert_allclose(got[key], want[key][rank], atol=1e-6,
                                       rtol=0, err_msg=f"{key} rank {rank}")


def test_compressed_psum_trains_the_toy_regression(run):
    _, res, _ = run
    assert res["psum"]["toy_final_mse"] < 0.05


@pytest.mark.parametrize("source", ["port", "jax"])
def test_restore_onto_a_sharded_layout(run, source):
    _, res, _ = run
    r = res["restore"][source]
    assert r["equal"] and r["placed_as_asked"]
    assert r["leaves"] == (2 if source == "jax" else 21)
