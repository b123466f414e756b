"""Logical-axis sharding and the spec trees of the port, against the
JAX package's ``repro.distributed.sharding`` and ``specs``.

Specs are exact (no tolerance: they are names).  The full-size configs
are built on the ``meta`` device (no allocation) and the JAX ones with
``jax.eval_shape``; local shard shapes come from a fake process group of
256 ranks (``torch.testing``'s ``FakeStore``), rank 0's coordinate.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.distributed import sharding as jshd
from repro.distributed import specs as jspecs
from repro.models.transformer import Model as JModel
from repro_torch import convert
from repro_torch.configs import get_config, list_configs
from repro_torch.configs.base import scan_grouping
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import specs
from repro_torch.models.transformer import Model

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "32x8": {"data": 32, "model": 8},
          "2x32x8": {"pod": 2, "data": 32, "model": 8},
          "2x4": {"data": 2, "model": 4}, "1x1": {"data": 1, "model": 1}}
RULES = {"default": jshd.DEFAULT_RULES,
         "seqpar": jshd.use_rules(**jshd.SEQPAR_RULES_OVERRIDES)}
SEQPAR_ARCHS = {"gemma3-1b", "whisper-small", "starcoder2-3b"}


@dataclasses.dataclass(frozen=True)
class Duck:
    """A mesh with only ``.shape`` (axis name -> size), as both packages
    read one."""
    shape: dict

    def __hash__(self):
        return hash(tuple(self.shape.items()))


def _names(rules: dict) -> list[tuple]:
    """Every logical name alone, every pair (the used-axis rule), and the
    model's own tuples."""
    names = sorted(rules)
    return ([(n,) for n in names] + [(a, b) for a in names for b in names]
            + [("batch", "seq", "embed"), ("batch", "res_seq", "embed"),
               ("batch", "mix_seq", "embed"), ("batch", None, "vocab"),
               ("batch", "kv_heads", "kv_seq", "head_dim"),
               ("p_experts", "p_in", "p_out"), (None, None)])


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_resolve_and_divisible_equal_the_jax_package(mesh, rules):
    m, r = Duck(MESHES[mesh]), RULES[rules]
    assert shd.use_rules(**({} if rules == "default" else
                            shd.SEQPAR_RULES_OVERRIDES)) == r
    rng = np.random.default_rng(len(mesh))
    for names in _names(r):
        got = shd._resolve(r, m, names)
        assert got == tuple(jshd._resolve(r, m, names)), names
        for _ in range(3):
            shape = tuple(int(x) for x in rng.choice(
                [1, 2, 8, 12, 16, 64, 100, 256, 1500], len(names)))
            assert shd._divisible(m, got, shape) == jshd._divisible(
                m, P(*got), shape), (names, shape)


def test_placements_round_trip():
    from torch.distributed.tensor import Replicate, Shard

    m = Duck(MESHES["2x32x8"])
    for spec in [(None, "model"), (("pod", "data"), None, "model"),
                 ("data", None), ("model", ("pod", "data")), ()]:
        pl = shd.spec_placements(m, spec)
        assert len(pl) == 3
        trimmed = tuple(spec)
        while trimmed and trimmed[-1] is None:
            trimmed = trimmed[:-1]
        assert shd.placement_spec(m, pl) == trimmed
    assert shd.spec_placements(m, (("pod", "data"), "model")) == [
        Shard(0), Shard(0), Shard(1)]
    assert shd.spec_placements(m, (None,)) == [Replicate()] * 3


def test_constrain_is_the_identity_without_a_mesh():
    x = torch.randn(2, 3, 4)
    assert shd.current_mesh() is None
    assert shd.constrain(x, "batch", "seq", "embed") is x
    with pytest.raises(RuntimeError):
        shd.logical_spec(("batch",))
    with shd.use_mesh(Duck(MESHES["2x4"])):
        assert shd.logical_spec(("batch", "vocab")) == ("data", "model")
    assert shd.current_mesh() is None


def test_package_exports_what_the_jax_package_exports():
    import repro.distributed as jdist
    import repro_torch.distributed as dist

    for name in jdist.__all__:
        if name == "named_sharding":
            assert callable(dist.placements)
        else:
            assert name in dist.__all__, name


# --- the spec trees of the ten configs, at full size -----------------------

def _unstack(tree, reps: int):
    """A JAX logical tree with each ``scan`` leaf (``("layers",) +
    spec``) made an object array of ``reps`` copies of ``spec``, so that
    ``convert``'s unstacking indexes it as it indexes params."""
    def leaf(t):
        arr = np.empty(reps, dtype=object)
        for j in range(reps):
            arr[j] = tuple(t[1:])
        assert t[0] == "layers", t
        return arr

    def walk(t, stacked):
        if isinstance(t, dict):
            return {k: walk(v, stacked or k == "scan") for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, stacked) for v in t]
        return leaf(t) if stacked else t
    return walk(tree, False)


def _jax_param_specs(model, jmodel) -> dict:
    shapes = jax.eval_shape(lambda: jmodel.init_params(jax.random.key(0)))
    logical = jspecs.param_logical_tree(shapes)
    tree = dict(logical)
    _, reps, _ = scan_grouping(model.kinds)
    tree["decoder"] = _unstack(logical["decoder"], reps)
    if "encoder" in logical:
        _, reps_e, _ = scan_grouping(model.enc_kinds)
        tree["encoder"] = _unstack(logical["encoder"], reps_e)
    flat = convert.lm_tree_from_jax(model, tree)
    return {k: tuple(np.asarray(v, dtype=object).tolist())
            for k, v in flat.items()}


def _jax_cache_specs(model, jmodel, batch, max_len) -> dict:
    shapes = jax.eval_shape(lambda: jmodel.init_cache(batch, max_len))
    logical = jspecs.cache_logical_tree(shapes)
    _, reps, _ = scan_grouping(model.kinds)
    dec = _unstack(logical["decoder"], reps)
    layers = []
    for i in range(len(model.layers)):
        layer = convert._layer_of_stack(dec, model.kinds, i)
        layers.append({kind: {n: tuple(v) for n, v in t.items()}
                       for kind, t in layer.items()})
    out = {"decoder": layers}
    if "enc_out" in logical:
        out["enc_out"] = tuple(logical["enc_out"])
    return out, shapes


def _jax_local_shape(mesh: dict, rules: dict, names: tuple, shape: tuple
                     ) -> tuple:
    """A leaf's shard shape as the JAX package's ``to_shardings`` places
    it: the resolved spec, each axis that does not divide its dim
    dropped, then the mesh sizes divided out."""
    m = Duck(mesh)
    spec = jshd._resolve(rules, m, names)
    if not jshd._divisible(m, spec, shape):
        spec = P(*[ax if ax is not None and jshd._divisible(
            m, P(*([None] * i + [ax] + [None] * (len(shape) - i - 1))),
            shape) else None for i, ax in enumerate(spec)])
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        n = 1
        for a in (() if ax is None else (ax if isinstance(ax, tuple)
                                         else (ax,))):
            n *= mesh[a]
        out.append(dim // n)
    return tuple(out)


@pytest.fixture(scope="module")
def fake_meshes():
    """DeviceMeshes (16, 16) and (32, 8) of a fake 256-rank group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        yield {name: init_device_mesh("cpu", shape,
                                      mesh_dim_names=("data", "model"))
               for name, shape in (("16x16", (16, 16)), ("32x8", (32, 8)))}
    finally:
        dist.destroy_process_group()


def _flat_cache(tree, prefix=""):
    from torch.distributed.tensor import Placement

    if isinstance(tree, list) and tree and isinstance(tree[0], Placement):
        return {prefix.rstrip("/"): tree}
    if isinstance(tree, dict):
        return {k2: v for k, t in tree.items()
                for k2, v in _flat_cache(t, f"{prefix}{k}/").items()}
    if isinstance(tree, list):
        return {k2: v for i, t in enumerate(tree)
                for k2, v in _flat_cache(t, f"{prefix}{i}/").items()}
    return {prefix.rstrip("/"): tree}


@pytest.mark.parametrize("arch", list_configs())
def test_spec_trees_and_shard_shapes_equal_the_jax_package(arch,
                                                           fake_meshes):
    cfg, jcfg = get_config(arch), jget_config(arch)
    model = Model(cfg, torch.bfloat16, device="meta", seed=None)
    jmodel = JModel(jcfg)
    params = dict(model.named_parameters())
    logical = specs.param_logical_tree(params)
    assert logical == _jax_param_specs(model, jmodel)

    batch, max_len = 4, 4096
    cache = model.init_cache(batch, max_len)
    c_logical = specs.cache_logical_tree(cache)
    want, jshapes = _jax_cache_specs(model, jmodel, batch, max_len)
    assert c_logical == want

    rule_sets = ["default"] + (["seqpar"] if arch in SEQPAR_ARCHS else [])
    flat_c, flat_cl = _flat_cache(cache), _flat_cache(c_logical)
    for mesh_name, mesh in fake_meshes.items():
        sizes = MESHES[mesh_name]
        for rname in rule_sets:
            rules = RULES[rname]
            pl = specs.to_shardings(mesh, rules, logical, params)
            for k, p in params.items():
                got = shd.local_block(tuple(p.shape), mesh, pl[k])[0]
                assert got == _jax_local_shape(sizes, rules, logical[k],
                                               tuple(p.shape)), (k, rname)
            c_pl = _flat_cache(specs.to_shardings(mesh, rules, c_logical,
                                                  cache))
            for k, t in flat_c.items():
                got = shd.local_block(tuple(t.shape), mesh, c_pl[k])[0]
                assert got == _jax_local_shape(sizes, rules, flat_cl[k],
                                               tuple(t.shape)), (k, rname)
    # one leaf placed for real: DTensor's own shard equals local_block's
    from torch.distributed.tensor import distribute_tensor

    mesh = fake_meshes["32x8"]
    pl = specs.to_shardings(mesh, RULES["default"], logical, params)
    dt = distribute_tensor(params["embed"].detach(), mesh, pl["embed"],
                           src_data_rank=None)
    assert tuple(dt.to_local().shape) == shd.local_block(
        tuple(params["embed"].shape), mesh, pl["embed"])[0]
