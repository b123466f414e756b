"""Placement of the SNN window ops on a (data x neuron) device grid:
``repro_torch.distributed.snn_mesh`` against the unsharded port ops and
against the JAX package's ``repro.distributed.snn_mesh``.

Grids name the CPU several times (the counterpart of the JAX package's
forced host devices), so every shape runs in one process here.  Rows
and streams are chosen not to divide the grids (13 neurons, 3 streams),
so every wrapper pads and slices.  Every comparison is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import lfsr as jlfsr
from repro.distributed import snn_mesh as jsnn_mesh
from repro_torch.core.bitpack import as_words, words_to_numpy
from repro_torch.distributed import sharding, snn_mesh
from repro_torch.kernels import ops

N, W, T, B = 13, 3, 6, 3
KW = dict(threshold=30, leak=2, w_exp=64, gain=4, n_syn=W * 32,
          ltp_prob=200)
GRIDS = {"1d-1": (None, 1), "1d-2": (None, 2), "1d-8": (None, 8),
         "2x4": (2, 4), "4x2": (4, 2), "8x1": (8, 1)}
WRAPPERS = ("infer_window_batch", "fused_snn_window",
            "fused_snn_window_infer", "train_window_batch",
            "infer_window_batch_encode", "fused_snn_window_encode",
            "fused_snn_window_encode_infer", "train_window_batch_encode",
            "train_stream_batch_encode")


def _grid(name):
    data, neurons = GRIDS[name]
    if data is None:
        return snn_mesh.snn_mesh(neurons, devices=["cpu"] * neurons)
    return snn_mesh.snn_mesh2d(data, neurons, devices=["cpu"] * (data *
                                                                 neurons))


def _operands(seed=0x22A):
    """numpy operands (u32 words as uint32) shared by both packages."""
    rng = np.random.default_rng(seed)
    o = dict(
        weights=rng.integers(0, 2**32, (N, W), dtype=np.uint32),
        trains=(rng.integers(0, 2**32, (B, T, W), dtype=np.uint32)
                & rng.integers(0, 2**32, (B, T, W), dtype=np.uint32)),
        v=rng.integers(-20, 20, (N,), dtype=np.int32),
        teach=rng.integers(-50, 50, (N,), dtype=np.int32),
        lfsr=np.asarray(jlfsr.seed(7, N * W)).reshape(N, W),
        inten=rng.integers(0, 256, (B, W * 32 - 5), dtype=np.uint8),
        seeds=np.array([1, -2, 0x7FFFFFFF], np.int32),
        t_total=np.array([T, T - 2, 0], np.int32),
        wts_b=rng.integers(0, 2**32, (B, N, W), dtype=np.uint32),
        v_b=rng.integers(-20, 20, (B, N), dtype=np.int32),
        teach_b=rng.integers(-50, 50, (B, N), dtype=np.int32),
        lfsr_b=np.stack([np.asarray(jlfsr.seed(3 + i, N * W)).reshape(N, W)
                         for i in range(B)]),
        ltp_b=np.array([16, 500, 1023], np.int32))
    return o


def _torch(o):
    return {k: (as_words(v) if v.dtype == np.uint32 else torch.from_numpy(v))
            for k, v in o.items()}


def _call(name, ns, t, mesh=None):
    """The op ``name`` (``ns`` = ops, or the grid wrappers with a
    mesh) on the torch operands ``t``."""
    sharded = mesh is not None
    fn = (lambda op: getattr(ns, f"sharded_{op}")) if sharded else (
        lambda op: getattr(ns, op))
    extra = dict(mesh=mesh) if sharded else {}
    kw = {k: v for k, v in KW.items() if k != "ltp_prob"}
    if name == "infer_window_batch":
        return fn(name)(t["weights"], t["trains"], threshold=30, leak=2,
                        **extra)
    if name.startswith("fused_snn_window_encode"):
        return fn("fused_snn_window_encode")(
            t["weights"], t["inten"][1], 9, t["v"], t["lfsr"], t["teach"],
            n_steps=T, train=not name.endswith("_infer"), **KW, **extra)
    if name.startswith("fused_snn_window"):
        return fn("fused_snn_window")(
            t["weights"], t["trains"][1], t["v"], t["lfsr"], t["teach"],
            train=not name.endswith("_infer"), **KW, **extra)
    if name == "train_window_batch":
        return fn(name)(t["wts_b"], t["trains"], t["v_b"], t["lfsr_b"],
                        t["teach_b"], ltp_prob=t["ltp_b"], **kw, **extra)
    if name == "infer_window_batch_encode":
        return fn(name)(t["weights"], t["inten"], t["seeds"], n_steps=T,
                        threshold=30, leak=2, t_total=t["t_total"], **extra)
    if name == "train_window_batch_encode":
        return fn(name)(t["wts_b"], t["inten"], t["seeds"], t["v_b"],
                        t["lfsr_b"], t["teach_b"], n_steps=T,
                        ltp_prob=t["ltp_b"], **kw, **extra)
    # the stream form: 4 samples of every stream, intensities shared by
    # every stream (stride 0), one seed per sample and stream
    x = t["inten"][None].expand(4, -1, -1)
    teach = t["teach_b"][None].expand(4, -1, -1)
    seeds = torch.arange(4 * B, dtype=torch.int32).reshape(4, B) - 5
    return fn(name)(t["wts_b"], x, seeds, t["lfsr_b"], teach, n_steps=T,
                    ltp_prob=t["ltp_b"], **kw, **extra)


def _assert_equal(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert torch.equal(g, r)
        assert g.is_contiguous()


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_on_a_grid_equals_the_unsharded_op(name, grid):
    t = _torch(_operands())
    want = _call(name, ops, t)
    got = _call(name, snn_mesh, t, mesh=_grid(grid))
    _assert_equal(got, want)


def _jax_call(name, o, mesh):
    """The JAX package's grid wrapper on the same numpy operands."""
    j = {k: jnp.asarray(v) for k, v in o.items()}
    kw = {k: v for k, v in KW.items() if k != "ltp_prob"}
    if name == "infer_window_batch":
        return jsnn_mesh.sharded_infer_window_batch(
            j["weights"], j["trains"], threshold=30, leak=2, mesh=mesh)
    if name.startswith("fused_snn_window_encode"):
        return jsnn_mesh.sharded_fused_snn_window_encode(
            j["weights"], j["inten"][1], 9, j["v"], j["lfsr"], j["teach"],
            n_steps=T, train=not name.endswith("_infer"), mesh=mesh, **KW)
    if name.startswith("fused_snn_window"):
        return jsnn_mesh.sharded_fused_snn_window(
            j["weights"], j["trains"][1], j["v"], j["lfsr"], j["teach"],
            train=not name.endswith("_infer"), mesh=mesh, **KW)
    if name == "train_window_batch":
        return jsnn_mesh.sharded_train_window_batch(
            j["wts_b"], j["trains"], j["v_b"], j["lfsr_b"], j["teach_b"],
            ltp_prob=j["ltp_b"], mesh=mesh, **kw)
    if name == "infer_window_batch_encode":
        return jsnn_mesh.sharded_infer_window_batch_encode(
            j["weights"], j["inten"], j["seeds"], n_steps=T, threshold=30,
            leak=2, t_total=j["t_total"], mesh=mesh)
    return jsnn_mesh.sharded_train_window_batch_encode(
        j["wts_b"], j["inten"], j["seeds"], j["v_b"], j["lfsr_b"],
        j["teach_b"], n_steps=T, ltp_prob=j["ltp_b"], mesh=mesh, **kw)


def _numpy(x):
    if x.dtype == torch.int32 and x.ndim >= 2 and x.shape[-1] == W:
        return words_to_numpy(x)          # weights and LFSR words
    return x.numpy()


@pytest.mark.parametrize("grid", ["1d-8", "2x4"])
@pytest.mark.parametrize("name", WRAPPERS[:-1])
def test_wrapper_equals_the_jax_wrapper(name, grid):
    """The port's wrapper on a grid of 8 against the JAX package's on
    its local one-device grids (1-D and 2-D): equal outputs, field for
    field (v and counts int32, rasters bool, words u32)."""
    o = _operands(5)
    got = _call(name, snn_mesh, _torch(o), mesh=_grid(grid))
    jmesh = (jsnn_mesh.snn_mesh() if grid.startswith("1d")
             else jsnn_mesh.snn_mesh2d(1, 1))
    want = _jax_call(name, o, jmesh)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, r in zip(got, want, strict=True):
        np.testing.assert_array_equal(_numpy(g), np.asarray(r))


def test_padding_fills_lfsr_lanes_with_1_and_per_sample_fields_as_jax():
    """What the shards see: padded LFSR lanes 1 on both axes, padded
    t_total n_steps, padded seeds, ltp_prob, intensities and weights 0."""
    t = _torch(_operands())
    mesh = _grid("2x4")
    seen = {}

    def spy(name, real):
        def call(*args, **kw):
            seen.setdefault(name, []).append((args, kw))
            return real(*args, **kw)
        return call

    with pytest.MonkeyPatch.context() as mp:
        for name in ("train_window_batch", "infer_window_batch_encode",
                     "train_stream_batch_encode"):
            mp.setattr(ops, name, spy(name, getattr(ops, name)))
        _call("train_window_batch", snn_mesh, t, mesh=mesh)
        _call("infer_window_batch_encode", snn_mesh, t, mesh=mesh)
        _call("train_stream_batch_encode", snn_mesh, t, mesh=mesh)
    # 13 rows pad to 16 (4 a shard), 3 streams to 4 (2 a data row): the
    # last neuron column holds 1 real row, the last data row 1 stream
    calls = seen["train_window_batch"]
    assert len(calls) == 8
    (w, _, v, st, teach), kw = calls[7]          # shard (1, 3)
    lp = kw["ltp_prob"]
    assert w.shape == (2, 4, W)
    assert torch.equal(st[1], torch.ones_like(st[1]))          # stream pad
    assert torch.equal(st[0, 1:], torch.ones_like(st[0, 1:]))  # row pad
    assert not st[0, 0].eq(1).all()
    assert int(w[1].abs().sum()) == 0 and int(v[0, 1:].abs().sum()) == 0
    assert lp.tolist() == [1023, 0]
    (_, x, sd), kw = seen["infer_window_batch_encode"][4]   # shard (1, 0)
    tt = kw["t_total"]
    assert tt.tolist() == [0, T] and sd.tolist() == [0x7FFFFFFF, 0]
    assert int(x[1].sum()) == 0 and kw["n_steps"] == T
    (w, x, sd, st, teach), kw = seen["train_stream_batch_encode"][7]
    assert kw["ltp_prob"].tolist() == [1023, 0]
    assert x.shape == (4, 2, W * 32 - 5) and int(x[:, 1].sum()) == 0
    assert sd[:, 1].tolist() == [0] * 4
    assert torch.equal(st[1], torch.ones_like(st[1]))
    assert int(teach[:, 1].abs().sum()) == 0


def test_every_shard_issued_on_its_device_and_gathered_on_the_first():
    t = _torch(_operands())
    mesh = _grid("4x2")
    assert mesh.shape == {"data": 4, "neuron": 2} and mesh.size == 8
    assert mesh.first == torch.device("cpu")
    counts = snn_mesh.sharded_infer_window_batch(
        t["weights"], t["trains"], threshold=30, leak=2, mesh=mesh)
    assert counts.device == mesh.first and counts.shape == (B, N)


def test_a_grid_larger_than_the_visible_cards_raises():
    n_cards = torch.cuda.device_count()
    with pytest.raises(ValueError):
        snn_mesh.snn_mesh2d(n_cards + 1, 1)
    with pytest.raises(ValueError):
        snn_mesh.snn_mesh(n_cards + 1)
    with pytest.raises(ValueError):
        snn_mesh.snn_mesh(3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError):
        snn_mesh.snn_mesh2d(0, 2, devices=["cpu"] * 4)
    if n_cards == 0:
        with pytest.raises(ValueError):   # no card: no default grid
            snn_mesh.snn_mesh()


def test_sharding_rules_resolve_as_the_jax_package():
    from repro.distributed import sharding as jsharding

    mesh1, mesh2 = _grid("1d-2"), _grid("2x4")
    jm1, jm2 = jsnn_mesh.snn_mesh(), jsnn_mesh.snn_mesh2d(1, 1)
    rules = sharding.DEFAULT_RULES
    jrules = jsharding.DEFAULT_RULES
    for names in (("neurons", "syn_words"), ("data", None, "syn_words"),
                  ("data", "neurons"), ("data",), (None, "neurons"),
                  ("data", "neurons", "syn_words")):
        for m, jm in ((mesh1, jm1), (mesh2, jm2)):
            got = sharding.logical_spec(names, m)
            want = tuple(jsharding.logical_spec(names, jrules, jm))
            assert got == want + (None,) * (len(got) - len(want))
    # on a 1-D grid "data" replicates
    assert sharding.logical_spec(("data", "neurons"), mesh1) == (
        None, "neuron")
    assert {k: rules[k] for k in ("neurons", "syn_words", "data")} == {
        k: jrules[k] for k in ("neurons", "syn_words", "data")}


def test_mesh_is_hashable_and_compares_by_devices():
    a = snn_mesh.snn_mesh2d(2, 2, devices=["cpu"] * 4)
    b = snn_mesh.snn_mesh2d(2, 2, devices=[torch.device("cpu")] * 4)
    assert a == b and hash(a) == hash(b)
    assert a != snn_mesh.snn_mesh(4, devices=["cpu"] * 4)


@pytest.mark.parametrize("argv", [
    ["--devices", "8"],
    ["--mesh-shape", "2,4", "--mesh-shape", "8,1", "--neurons", "10",
     "--batch", "3"]])
def test_check_cli_on_the_cpu(argv, capsys):
    assert snn_mesh.main(["--check", "--device", "cpu", "--words", "4",
                          "--steps", "5", *argv]) == 0
    out = capsys.readouterr().out
    assert out.rstrip().endswith("OK")
    assert out.count("== single-device") == 9 * (1 if "--devices" in argv
                                                 else 2)


@pytest.mark.parametrize("shard_launches,on_card,ok", [
    (1, True, True),      # one launch a shard: passes
    (0, False, False),    # the plain version under the grid: refused
    (2, True, False),     # two launches a shard: refused
])
def test_check_holds_each_sharded_call_to_its_own_launches(
        shard_launches, on_card, ok):
    """``--check`` counts the sharded call's launches apart from the
    unsharded op's: a wrapper that ran no kernel while the unsharded op
    did is refused even though its outputs are equal."""
    mesh = snn_mesh.snn_mesh(4, devices=["cpu"] * 4)
    counter = ops.infer_window_batch

    def unsharded(x):
        counter.launches += 1
        return x + 1

    def sharded(x, *, mesh):
        counter.launches += shard_launches * mesh.size
        return x + 1

    total = {}
    x = torch.arange(4)
    ops.reset_launch_counts()
    try:
        if ok:
            snn_mesh._compare("op", sharded, unsharded, x, mesh=mesh,
                              on_card=on_card, total=total)
            assert total == {"infer_window_batch": 4}
        else:
            with pytest.raises(AssertionError, match="launched"):
                snn_mesh._compare("op", sharded, unsharded, x, mesh=mesh,
                                  on_card=on_card, total=total)
    finally:
        ops.reset_launch_counts()
    # on the card an unsharded op that launched nothing is refused too
    with pytest.raises(AssertionError, match="no kernel"):
        snn_mesh._compare("op", lambda x, *, mesh: x, lambda x: x, x,
                          mesh=mesh, on_card=True, total={})


def test_bench_cli_prints_its_lines(capsys):
    assert snn_mesh.main(["--bench", "--device", "cpu", "--devices", "4",
                          "--neurons", "16", "--words", "2", "--steps", "4",
                          "--batch", "2"]) == 0
    assert snn_mesh.main(["--bench", "--device", "cpu", "--mesh-shape",
                          "2,2", "--neurons", "16", "--words", "2",
                          "--steps", "4", "--batch", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    bench = [ln for ln in lines if ln.startswith("BENCH ")]
    bench2d = [ln for ln in lines if ln.startswith("BENCH2D ")]
    assert len(bench) == 1 and "devices=4" in bench[0]
    assert len(bench2d) == 1 and "shape=2x2" in bench2d[0]
    kv = dict(p.split("=", 1) for p in bench2d[0].split()[1:])
    assert float(kv["t_1d_us"]) > 0 and float(kv["t_2d_us"]) > 0
