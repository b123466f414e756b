"""The port's per-cycle RV-SNN ops against the JAX package's.

``spike_process``, ``lif_step``, ``stdp_update`` and ``fused_snn_step``
run their plain versions on the CPU, which must equal, bit for bit, both
the JAX package's ``backend="ref"`` ops and its Pallas kernels run in
interpret mode (``backend="interp"``: the kernel bodies themselves,
which pad to 128 lanes and 8-row blocks; the shapes here are not
multiples of either).  The stream axis is held against B separate calls,
the fused step against the SPU -> NU -> SU composition, and the RV-SNN
instructions of ``core/rvsnn.py`` against the JAX package's.  The CUDA
kernels run only on a card: ``test_torch_cuda.py`` holds them against
these plain versions there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lif as jlif
from repro.core import rvsnn as jrvsnn
from repro.core import stdp as jstdp
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import lif, rvsnn, stdp
from repro_torch.core.bitpack import as_words, words_to_numpy
from repro_torch.kernels import ops

# (n, w): n not a multiple of 8, w not a multiple of 128 (the JAX
# wrappers pad both), plus the paper's 784-input rows (w = 25)
SHAPES = [(10, 25), (33, 7), (40, 25), (5, 130)]
JAX_BACKENDS = ["interp", "ref"]


def _words(rng, shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint32)


def _step_operands(seed, n, w, lead=()):
    """Random step state: banks ~50% ON (tail bits included), LFSR lanes
    in [1, 2^16), membranes and teacher currents such that some rows
    fire and some do not."""
    rng = np.random.default_rng(seed)
    weights = _words(rng, lead + (n, w))
    pre = _words(rng, lead + (w,))
    lanes = rng.integers(1, 2**16, lead + (n, w)).astype(np.uint32)
    v = rng.integers(0, 200, lead + (n,)).astype(np.int32)
    teach = rng.integers(-300, 200, lead + (n,)).astype(np.int32)
    return weights, pre, v, lanes, teach


def _su(n_syn, w_exp=128, ltp_prob=16):
    return dict(w_exp=w_exp, gain=4, n_syn=n_syn, ltp_prob=ltp_prob)


def _port(*arrays):
    """numpy uint32 words / int32 / bool -> the port's CPU tensors."""
    return tuple(as_words(a) if a.dtype == np.uint32 else torch.from_numpy(a)
                 for a in arrays)


def _assert_equal(got, want):
    """Port outputs (int32 words, int32, bool tensors) == JAX outputs."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, x in zip(got, want):
        x = np.asarray(x)
        if x.dtype == np.uint32:
            np.testing.assert_array_equal(words_to_numpy(g), x)
        else:
            assert g.dtype == {np.int32: torch.int32,
                               np.bool_: torch.bool}[x.dtype.type]
            np.testing.assert_array_equal(g.numpy(), x)


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("n,w", SHAPES)
def test_spike_process_matches_jax(n, w, backend):
    weights, pre, *_ = _step_operands(n * 100 + w, n, w)
    got = ops.spike_process(*_port(pre, weights))
    want = jops.spike_process(jnp.asarray(pre), jnp.asarray(weights),
                              backend=backend)
    _assert_equal(got, want)
    assert torch.equal(got, ops.spike_process(*_port(pre, weights),
                                              backend="ref"))


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("n,threshold,leak", [(10, 192, 16), (77, 10, 1),
                                              (40, 1, 0)])
def test_lif_step_matches_jax(n, threshold, leak, backend):
    rng = np.random.default_rng(n)
    v = rng.integers(0, 300, n).astype(np.int32)
    c = rng.integers(-50, 120, n).astype(np.int32)
    v[:2] = 2**31 - 5                      # v + count wraps in int32
    c[:2] = (7, -9)
    got = ops.lif_step(*_port(v, c), threshold, leak)
    want = jops.lif_step(jnp.asarray(v), jnp.asarray(c), threshold, leak,
                         backend=backend)
    _assert_equal(got, want)
    assert got[1].any() and not got[1].all()


# Word widths at the edges of the CUDA SPU kernel's paths: rows of up to
# 128 words in a warp's registers (25, 128), longer rows 4 warps each
# (129, 2,047 with 4-byte loads; 2,048 with 16-byte loads, one round).
SPU_WIDTHS = [25, 128, 129, 2047, 2048]


@pytest.mark.parametrize("lead,shared", [((), False), ((1,), False),
                                         ((4,), False), ((4,), True)])
@pytest.mark.parametrize("n", [1, 9])
@pytest.mark.parametrize("w", SPU_WIDTHS)
def test_spike_process_edges_match_jax(w, n, lead, shared):
    """The SPU op at each kernel path's edge widths, n not a multiple of
    4 or 8, one stream or B streams against a bank each or one shared:
    each stream equals the JAX package's op on it alone, ``ref`` and
    ``interp``."""
    rng = np.random.default_rng(w + n + len(lead) + shared)
    weights = _words(rng, (() if shared else lead) + (n, w))
    pre = _words(rng, lead + (w,))
    got = ops.spike_process(*_port(pre, weights))
    assert got.shape == lead + (n,)
    for i in range(lead[0] if lead else 1):
        one = (lambda x: x[i]) if lead else (lambda x: x)
        bank = weights if shared or not lead else weights[i]
        for backend in JAX_BACKENDS:
            want = jops.spike_process(jnp.asarray(one(pre)),
                                      jnp.asarray(bank), backend=backend)
            _assert_equal(one(got), want)


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("total", [1, 3, 4, 4097])
def test_lif_step_totals_match_jax(total, backend):
    """The NU op at sizes a kernel's grid has edges at (a lone neuron, a
    part of a warp, 4,097 neurons: a last block of one), int32
    wraparound of v + count included."""
    rng = np.random.default_rng(total)
    v = rng.integers(0, 300, total).astype(np.int32)
    c = rng.integers(-50, 120, total).astype(np.int32)
    v[0], c[0] = 2**31 - 5, 7               # v + count wraps in int32
    got = ops.lif_step(*_port(v, c), 100, 3)
    want = jops.lif_step(jnp.asarray(v), jnp.asarray(c), 100, 3,
                         backend=backend)
    _assert_equal(got, want)
    assert bool(got[1][0]) is False         # wrapped below the threshold


# Word widths that pick each path of the CUDA SU kernel: rows of up to
# 128 words in a warp's registers (1, 25, 128), longer rows a block each
# with a shared-memory stash (129, 4,096; 4,096 takes 16-byte copies).
SU_WIDTHS = [1, 25, 128, 129, 4096]


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("n,w,w_exp,ltp", [(10, 25, 128, 16),
                                           (33, 7, 64, 1023),
                                           (40, 25, 512, 64),
                                           (5, 130, 128, 0),
                                           (9, 1, 16, 16),
                                           (12, 128, 2048, 1023),
                                           (11, 129, 2100, 64),
                                           (4, 4096, 65536, 512)])
def test_stdp_update_matches_jax(n, w, w_exp, ltp, backend):
    weights, pre, _, lanes, _ = _step_operands(n * 7 + w, n, w)
    fired = np.random.default_rng(n).integers(0, 2, n).astype(bool)
    fired[:2] = (True, False)
    kw = _su(32 * w - 3, w_exp, ltp)
    got = ops.stdp_update(*_port(weights, pre, fired, lanes), **kw)
    want = jops.stdp_update(jnp.asarray(weights), jnp.asarray(pre),
                            jnp.asarray(fired), jnp.asarray(lanes),
                            backend=backend, **kw)
    _assert_equal(got, want)
    # unfired rows pass through, weights and LFSR both
    assert torch.equal(got[0][~torch.from_numpy(fired)],
                       as_words(weights)[~fired])
    assert torch.equal(got[1][~torch.from_numpy(fired)],
                       as_words(lanes)[~fired])


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("n,w", SHAPES)
def test_fused_snn_step_matches_jax(n, w, train, backend):
    weights, pre, v, lanes, teach = _step_operands(n + w, n, w)
    # about 8 w spikes reach a row: near the threshold, some rows fire
    kw = dict(threshold=8 * w + 50, leak=16, train=train, **_su(32 * w))
    got = ops.fused_snn_step(*_port(weights, pre, v, lanes, teach), **kw)
    want = jops.fused_snn_step(*map(jnp.asarray, (weights, pre, v, lanes,
                                                   teach)),
                               backend=backend, **kw)
    _assert_equal(got, want)
    assert got[2].any() and not got[2].all()   # fired and unfired rows
    if not train:                              # the SU left them alone
        assert torch.equal(got[0], as_words(weights))
        assert torch.equal(got[3], as_words(lanes))


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("train", [True, False])
def test_stream_axis_equals_separate_streams(train, shared):
    """B streams in one call == B single-stream JAX kernel calls, each
    with its own ltp_prob; a shared bank (stream stride 0) == that bank
    handed to every stream."""
    b, n, w = 3, 12, 25
    weights, pre, v, lanes, teach = _step_operands(9, n, w, (b,))
    if shared:
        weights, lanes = weights[0], lanes[0]
    ltp = np.array([16, 1023, 0], np.int32)
    kw = dict(threshold=150, leak=4, **_su(784, ltp_prob=ltp))
    got = ops.fused_snn_step(*_port(weights, pre, v, lanes, teach),
                             train=train, **kw)
    assert got[2].any() and not got[2].all()
    for i in range(b):
        wi, li = (weights, lanes) if shared else (weights[i], lanes[i])
        want = jops.fused_snn_step(
            *map(jnp.asarray, (wi, pre[i], v[i], li, teach[i])),
            backend="interp", train=train, **dict(kw, ltp_prob=int(ltp[i])))
        one = [x if (not train and shared and k in (0, 3)) else x[i]
               for k, x in enumerate(got)]
        _assert_equal(tuple(one), want)
    # the SPU, NU and SU ops take the same stream axis
    counts = ops.spike_process(*_port(pre, weights))
    sv, fired = ops.lif_step(torch.from_numpy(v),
                             counts + torch.from_numpy(teach), 150, 4)
    assert torch.equal(fired, got[2]) and torch.equal(sv, got[1])
    if train:
        su = ops.stdp_update(*_port(weights, pre), fired, as_words(lanes),
                             **_su(784, ltp_prob=torch.from_numpy(ltp)))
        assert torch.equal(su[0], got[0]) and torch.equal(su[1], got[3])


def _fired_rows(pattern, shape, rng):
    if pattern == "all":
        return np.ones(shape, bool)
    if pattern == "none":
        return np.zeros(shape, bool)
    fired = rng.integers(0, 2, shape).astype(bool)
    fired[..., :2] = (True, False)
    return fired


@pytest.mark.parametrize("fired", ["all", "none", "mixed"])
@pytest.mark.parametrize("w", SU_WIDTHS)
@pytest.mark.parametrize("lead,shared", [((), False), ((3,), False),
                                         ((3,), True)])
def test_stdp_update_streams_match_jax(lead, shared, w, fired):
    """The SU op at each path's width, on one stream or B streams with
    their own ltp_prob (u32 compare: -1 is 2**32 - 1, always LTP), against
    a bank per stream or one shared bank: each stream equals the JAX
    package's op on that stream alone, ``ref`` and ``interp``."""
    n = 6
    weights, pre, _, lanes, _ = _step_operands(w + len(lead) + shared, n, w,
                                               () if shared else lead)
    pre = _words(np.random.default_rng(w), lead + (w,))
    post = _fired_rows(fired, lead + (n,), np.random.default_rng(n + w))
    ltp = np.array([16, -1, 0], np.int32)[:lead[0] if lead else 1]
    su = dict(w_exp=16 * w, gain=4, n_syn=32 * w - 5)
    got = ops.stdp_update(*_port(weights, pre, post, lanes),
                          ltp_prob=torch.from_numpy(ltp), **su)
    assert got[0].shape == lead + (n, w)
    for i in range(ltp.size):
        one = (lambda x: x[i]) if lead else (lambda x: x)
        bank = (lambda x: x) if shared or not lead else one
        for backend in JAX_BACKENDS:
            want = jops.stdp_update(
                jnp.asarray(bank(weights)), jnp.asarray(one(pre)),
                jnp.asarray(one(post)), jnp.asarray(bank(lanes)),
                ltp_prob=int(ltp[i]) & 0xFFFFFFFF, backend=backend, **su)
            _assert_equal((one(got[0]), one(got[1])), want)
    if fired == "none":         # every row copied through
        assert torch.equal(got[0], as_words(weights).expand(got[0].shape))
        assert torch.equal(got[1], as_words(lanes).expand(got[1].shape))


@pytest.mark.parametrize("lead", [(), (2,)])
def test_fused_equals_unfused_composition(lead):
    """The port of the JAX package's fused-vs-composition test: the
    fused SNNU step equals SPU -> NU -> SU, and the JAX kernels agree."""
    n, w = 40, 25
    weights, pre, _, lanes, _ = _step_operands(0, n, w, lead)
    v = np.zeros(lead + (n,), np.int32)
    teach = np.zeros(lead + (n,), np.int32)
    kw = _su(800, ltp_prob=1023)
    tw, tp, tv, tl, tt = _port(weights, pre, v, lanes, teach)
    counts = ops.spike_process(tp, tw)
    v2, fired = ops.lif_step(tv, counts, 50, 4)
    w2, l2 = ops.stdp_update(tw, tp, fired, tl, **kw)
    fused = ops.fused_snn_step(tw, tp, tv, tl, tt, threshold=50, leak=4,
                               **kw)
    for a, b in zip(fused, (w2, v2, fired, l2)):
        assert torch.equal(a, b)
    assert fired.any()
    if not lead:
        jw, jp, jv, jl = map(jnp.asarray, (weights, pre, v, lanes))
        jc = jops.spike_process(jp, jw, backend="interp")
        jv2, jf = jops.lif_step(jv, jc, 50, 4, backend="interp")
        jw2, jl2 = jops.stdp_update(jw, jp, jf, jl, backend="interp", **kw)
        _assert_equal((w2, v2, fired, l2), (jw2, jv2, jf, jl2))


def test_step_ops_take_teach_none_and_check_their_backend():
    weights, pre, v, lanes, teach = _port(*_step_operands(3, 10, 25))
    kw = dict(threshold=100, leak=2, **_su(784))
    a = ops.fused_snn_step(weights, pre, v, lanes, None, **kw)
    b = ops.fused_snn_step(weights, pre, v, lanes, torch.zeros_like(v), **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    before = ops.launch_counts()
    for bad in ("tpu", "interp"):
        with pytest.raises(ValueError):
            ops.fused_snn_step(weights, pre, v, lanes, teach, backend=bad,
                               **kw)
        with pytest.raises(ValueError):
            ops.spike_process(pre, weights, backend=bad)
    # the plain versions on the CPU launch nothing
    assert ops.launch_counts() == before
    assert {"fused_snn_step", "spike_process", "lif_step",
            "stdp_update"} <= set(before)


# --- the RV-SNN instructions (core/rvsnn.py) --------------------------------

def _regfiles(seed, lead=()):
    weights, pre, v, lanes, _ = _step_operands(seed, 12, 25, lead)
    jrf = jrvsnn.SnnRegFile(spike=jnp.asarray(pre), v=jnp.asarray(v),
                            lfsr=jnp.asarray(lanes),
                            weights=jnp.asarray(weights))
    return convert.regfile_from_jax(jrf), jrf


@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_rvsnn_instructions_match_jax(backend):
    rf, jrf = _regfiles(11)
    lp, jlp = lif.lif_params(300, 5), jlif.lif_params(300, 5)
    sp, jsp = stdp.stdp_params(784, 128, 4, 64), jstdp.stdp_params(784, 128,
                                                                   4, 64)
    counts = rvsnn.snn_sp(rf, backend=backend)
    jcounts = jrvsnn.snn_sp(jrf)
    _assert_equal(counts, jcounts)
    rf2, fired = rvsnn.snn_nu(rf, counts, lp, backend=backend)
    jrf2, jfired = jrvsnn.snn_nu(jrf, jcounts, jlp)
    _assert_equal((rf2.v, fired), (jrf2.v, jfired))
    assert fired.any() and not fired.all()
    rf3 = rvsnn.snn_su(rf2, fired, sp, backend=backend)
    jrf3 = jrvsnn.snn_su(jrf2, jfired, jsp)
    _assert_equal(tuple(rf3), tuple(jrf3))
    # snn.step is the same cycle, fused
    words = as_words(np.asarray(jrf.spike))
    rf4, fired4 = rvsnn.snn_step(rf, words, lp, sp, backend=backend)
    jrf4, jfired4 = jrvsnn.snn_step(jrf, jrf.spike, jlp, jsp)
    _assert_equal(tuple(rf4) + (fired4,), tuple(jrf4) + (jfired4,))
    _assert_equal(tuple(rf4), tuple(jrf3))


def test_snn_step_is_one_fused_launch(monkeypatch):
    """``snn.step`` goes to ``ops.fused_snn_step`` once per cycle, for
    every stream of a batched register file, and never to the three
    unfused ops."""
    calls = []
    for name in ("fused_snn_step", "spike_process", "lif_step",
                 "stdp_update"):
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _fn=fn, _name=name, **k:
                            calls.append(_name) or _fn(*a, **k))
    rf, jrf = _regfiles(12, (3,))
    lp = lif.lif_params(140, 5)
    sp = stdp.STDPParams(128, 4, 784, torch.tensor([16, 1023, 0],
                                                   dtype=torch.int32))
    for t in range(4):
        rf, fired = rvsnn.snn_step(rf, rf.spike, lp, sp if t % 2 else None)
    assert calls == ["fused_snn_step"] * 4
    assert fired.shape == (3, 12)


def test_rvsnn_program_with_dependent_launches_matches_jax():
    """Eight cycles of ``snn.ls -> snn.sp -> + teach -> snn.nu ->
    snn.su``, every instruction after the first cycle launched as a
    dependent (``dependent`` is ignored by the plain versions), equal bit
    for bit to the JAX package's instructions and to ``snn.step``."""
    rf, jrf = _regfiles(21)
    fused = rf
    rng = np.random.default_rng(21)
    spikes = _words(rng, (8, 25))
    teach = rng.integers(-300, 100, 12).astype(np.int32)
    tt, jt = torch.from_numpy(teach), jnp.asarray(teach)
    lp, jlp = lif.lif_params(200, 5), jlif.lif_params(200, 5)
    sp, jsp = stdp.stdp_params(784, 128, 4, 64), jstdp.stdp_params(784, 128,
                                                                   4, 64)
    fired_any = False
    for t in range(8):
        dep = t > 0
        words = as_words(spikes[t])
        rf = rvsnn.snn_ls(rf, words)
        counts = rvsnn.snn_sp(rf, dependent=dep) + tt
        rf, fired = rvsnn.snn_nu(rf, counts, lp, dependent=dep)
        rf = rvsnn.snn_su(rf, fired, sp, dependent=dep)
        jrf = jrvsnn.snn_ls(jrf, jnp.asarray(spikes[t]))
        jrf, jfired = jrvsnn.snn_nu(jrf, jrvsnn.snn_sp(jrf) + jt, jlp)
        jrf = jrvsnn.snn_su(jrf, jfired, jsp)
        fused, fused_fired = rvsnn.snn_step(fused, words, lp, sp, tt,
                                            dependent=dep)
        _assert_equal(tuple(rf) + (fired,), tuple(jrf) + (jfired,))
        assert torch.equal(fired, fused_fired)
        fired_any |= bool(fired.any())
    for a, b in zip(rf, fused):
        assert torch.equal(a, b)
    assert fired_any
