"""The port's dry run (``launch/dryrun.py``, ``op_cost.py``,
``roofline.py``, ``mesh.py``, ``inputs.py``), ``debug_colls`` and
``dryrun_snn``, against the JAX package where both compute the same
thing.

Counts are exact: bytes and FLOPs are integers of shapes, and
``model_flops`` the same float formula.  Cells run on ``meta`` tensors
in a fake process group (nothing allocated, no collective done).
"""

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.distributed import sharding as jshd
from repro.distributed import specs as jspecs
from repro.launch.roofline import model_flops as jmodel_flops
from repro.models.transformer import Model as JModel
from repro_torch.configs import SHAPES, get_config, list_configs, reduced
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed.specs import place_params
from repro_torch.launch import debug_colls, dryrun, dryrun_snn
from repro_torch.launch.mesh import fake_world
from repro_torch.launch.op_cost import OpCost
from repro_torch.launch.roofline import model_flops

ROOT = Path(__file__).resolve().parents[1]
TINY = {"train": ShapeSpec("tiny_train", 32, 8, "train"),
        "prefill": ShapeSpec("tiny_prefill", 32, 4, "prefill"),
        "decode": ShapeSpec("tiny_decode", 64, 8, "decode")}


@pytest.fixture
def world8():
    """A fake group of 8 ranks and its (2, 4) and (1, 8) meshes."""
    from torch.distributed.device_mesh import init_device_mesh

    with fake_world(8):
        yield {shape: init_device_mesh("cpu", shape,
                                       mesh_dim_names=("data", "model"))
               for shape in ((2, 4), (1, 8))}


CELLS = ([(a, "train") for a in ("gemma3-1b", "mixtral-8x22b")]
         + [(a, k) for a in ("gemma3-1b", "mixtral-8x22b", "whisper-small",
                             "jamba-1.5-large-398b")
            for k in ("prefill", "decode")])


@pytest.mark.parametrize("arch,kind", CELLS)
def test_lower_cell_on_a_fake_2x4_group(world8, arch, kind):
    cfg = reduced(get_config(arch))
    res = dryrun.lower_cell(arch, TINY[kind], mesh=world8[(2, 4)], cfg=cfg)
    assert res["status"] == "ok" and res["mesh"] == "2x4"
    assert res["chips"] == 8 and res["rules"] == "heads-tp"
    rl = res["roofline"]
    assert rl["flops_per_chip"] > 0 and rl["hbm_bytes_per_chip"] > 0
    assert rl["dominant"] in ("compute", "memory", "collective")
    assert 0 < res["arg_bytes"] <= res["peak_bytes_per_device"]
    assert res["fits_80GB"] and res["fits_80GB_traced"]
    assert res["model_flops_total"] == model_flops(cfg, TINY[kind])
    # no layer runs on full copies: the cell flags none
    assert "replicated_layers" not in res
    if kind != "decode":
        # FSDP gathers (data axis) at least
        assert res["collectives"] > 0 and rl["coll_by_axis"].get("data")


# the archs whose MoE experts, Mamba channels or RWKV6 heads split over
# model, and the local width each rank's layer sees on (2, 4)
TP_ARCHS = {"mixtral-8x22b": "d_ff", "grok-1-314b": "d_ff",
            "jamba-1.5-large-398b": "d_inner", "rwkv6-7b": "heads"}


@pytest.mark.parametrize("arch,kind", [(a, k) for a in TP_ARCHS
                                       for k in ("train", "decode")])
def test_tensor_parallel_cells_trace_on_their_model_slices(world8, arch,
                                                           kind):
    """The four archs' cells trace with every MoE, Mamba and RWKV6 layer
    on its model slice (no ``replicated_layers``): in training the
    expert product, the Mamba scan and the RWKV6 recurrence see a
    quarter of ``d_ff``, ``d_inner`` and the heads on (2, 4), and the
    model axis carries their collectives."""
    from repro_torch.models.layers import mamba, moe, rwkv6

    cfg = reduced(get_config(arch))
    seen = {}
    real = (moe.experts, mamba.scan, rwkv6.recurrence)

    def experts(params, buf):
        seen["d_ff"] = params["wi"].shape[-1]
        return real[0](params, buf)

    def scan(a, b):
        seen["d_inner"] = a.shape[2]
        return real[1](a, b)

    def recurrence(r, *args):
        seen["heads"] = r.shape[2]
        return real[2](r, *args)

    moe.experts, mamba.scan, rwkv6.recurrence = experts, scan, recurrence
    try:
        res = dryrun.lower_cell(arch, TINY[kind], mesh=world8[(2, 4)],
                                cfg=cfg)
    finally:
        moe.experts, mamba.scan, rwkv6.recurrence = real
    assert res["status"] == "ok" and "replicated_layers" not in res
    assert res["roofline"]["coll_by_axis"].get("model")
    full = {"d_ff": cfg.d_ff, "d_inner": 2 * cfg.d_model,
            "heads": cfg.d_model // cfg.rwkv_head_size}
    if kind == "train":
        assert seen[TP_ARCHS[arch]] == full[TP_ARCHS[arch]] // 4, seen
    assert all(v == full[k] // 4 for k, v in seen.items()), seen


def test_sequence_parallel_cell_on_model_8(world8):
    """4 reduced heads do not divide model 8: the cell runs SEQPAR."""
    cfg = reduced(get_config("starcoder2-3b"))
    res = dryrun.lower_cell("starcoder2-3b", TINY["prefill"],
                            mesh=world8[(1, 8)], cfg=cfg)
    assert res["status"] == "ok" and res["rules"] == "seqpar"


def _jax_param_bytes(jcfg, mesh: dict) -> int:
    """The bytes of one device's params as the JAX package places them:
    every leaf's spec (with its non-dividing axes dropped), its local
    shape from the mesh sizes, times its dtype's size."""
    m = type("Duck", (), {"shape": mesh})()
    rules = jshd.DEFAULT_RULES
    shapes = jax.eval_shape(
        lambda: JModel(jcfg, dtype=jnp.bfloat16).init_params(
            jax.random.key(0)))
    logical = jspecs.param_logical_tree(shapes)
    total = 0
    for names, leaf in zip(
            jax.tree.leaves(logical, is_leaf=lambda x: isinstance(x, tuple)),
            jax.tree.leaves(shapes)):
        spec = jshd._resolve(rules, m, names)
        n = 1
        for i, (dim, ax) in enumerate(zip(leaf.shape, tuple(spec))):
            probe = P(*([None] * i + [ax] + [None] * (leaf.ndim - i - 1)))
            k = 1
            if ax is not None and jshd._divisible(m, probe, leaf.shape):
                for a in (ax if isinstance(ax, tuple) else (ax,)):
                    k *= mesh[a]
            n *= dim // k
        total += n * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("arch", list_configs())
def test_param_bytes_per_device_equal_the_jax_shards(world8, arch):
    from repro_torch.distributed import sharding as shd

    mesh = world8[(2, 4)]
    model = dryrun.build_model(arch, cfg=reduced(get_config(arch)))
    with shd.use_mesh(mesh, shd.DEFAULT_RULES):
        params = place_params(model, mesh, shd.DEFAULT_RULES)
    got = OpCost().track(params)
    assert got == _jax_param_bytes(jreduced(jget_config(arch)),
                                   {"data": 2, "model": 4})


def test_model_flops_equal_the_jax_package():
    for arch in list_configs():
        for name, shape in SHAPES.items():
            assert model_flops(get_config(arch), shape) == jmodel_flops(
                jget_config(arch), JSHAPES[name]), (arch, name)


def test_seqpar_rule_gives_the_jax_set_at_model_16():
    """The JAX package's SEQPAR literal (read from its source: importing
    its dryrun module sets XLA_FLAGS for this process)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    jset = next(ast.literal_eval(n.value) for n in ast.walk(tree)
                if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "SEQPAR")
    m16 = type("Duck", (), {"shape": {"data": 16, "model": 16}})()
    m8 = type("Duck", (), {"shape": {"data": 32, "model": 8}})()
    assert {a for a in dryrun.ARCHS
            if dryrun.seqpar(get_config(a), m16)} == jset
    assert {a for a in dryrun.ARCHS if dryrun.seqpar(get_config(a), m8)} == {
        "gemma3-1b", "whisper-small"}


def test_op_cost_counts_a_matmul_and_a_python_loop():
    n = 512
    a, b = (torch.empty(n, n, device="meta") for _ in range(2))
    with OpCost() as c:
        a @ b
    assert c.flops == 2 * n ** 3
    assert c.bytes == 3 * n * n * 4
    ws = [torch.empty(n, n, device="meta") for _ in range(8)]
    with OpCost() as c8:
        x = a
        for w in ws:
            x = x @ w
    assert c8.flops == 8 * 2 * n ** 3
    assert c8.peak == 2 * n * n * 4        # a product and the next


def test_op_cost_counts_all_gather_bytes_by_axis(world8):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = world8[(2, 4)]
    x = distribute_tensor(torch.empty(64, 32, device="meta"), mesh,
                          [Shard(0), Shard(1)], src_data_rank=None)
    with OpCost(mesh) as c:
        x.redistribute(mesh, [Shard(0), Replicate()])
    # gathering dim 1 over model: the local [32, 8] becomes [32, 32]
    assert c.collectives["all-gather"] == 32 * 32 * 4
    assert dict(c.coll_by_axis) == {"model": 32 * 32 * 4}
    assert c.records[0]["kind"] == "all-gather"


def test_debug_colls_cli_runs_on_a_reduced_cell(capsys):
    rows = debug_colls.main(["--arch", "gemma3-1b", "--shape", "decode_32k",
                             "--reduced", "--top", "3"])
    assert rows and all(r[0] > 0 for r in rows)
    assert "Top collectives" in capsys.readouterr().out


def test_dryrun_snn_cli_runs_on_the_cpu(tmp_path):
    out = tmp_path / "snn.json"
    dryrun_snn.main(["--device", "cpu", "--mesh", "pod", "--neurons", "256",
                     "--batch", "256", "--out", str(out)])
    res = json.loads(out.read_text())
    infer = res["wenquxing-22a-x6|snn_infer|32x8"]
    unpacked = res["wenquxing-22a-x6|snn_infer|32x8#unpacked"]
    assert infer["shard"] == {"neurons": 32, "samples": 8}
    assert infer["peak_bytes_per_device"] < unpacked[
        "peak_bytes_per_device"]
    assert unpacked["roofline"]["flops_per_chip"] == 2 * 8 * 72 * 784 * 32
    run = res["wenquxing-22a-x6|snn_run|32x8"]
    assert run["infer"]["equal"] and run["train"]["equal"]


def test_skips_are_recorded_as_the_jax_package_records_them():
    skips = dryrun.skip_records(dryrun.ARCHS, None, [False, True])
    assert len(skips) == 2 * 6
    assert skips["llama3-405b|long_500k|2x32x8"]["reason"] == \
        "pure full attention"
    assert dryrun.skip_records(["llama3-405b"], "train_4k", [False]) == {}


def test_dryrun_cli_writes_a_full_size_cell(tmp_path):
    out = tmp_path / "dr.json"
    dryrun.main(["--arch", "gemma3-1b", "--shape", "decode_32k", "--mesh",
                 "pod", "--out", str(out)])
    cell = json.loads(out.read_text())["gemma3-1b|decode_32k|32x8"]
    assert cell["status"] == "ok" and cell["chips"] == 256
    assert cell["rules"] == "seqpar" and cell["fits_80GB"]
    assert set(cell["roofline"]) >= {"t_compute_s", "t_memory_s",
                                     "t_collective_s", "dominant"}
    assert np.isfinite(cell["useful_flops_frac"])
