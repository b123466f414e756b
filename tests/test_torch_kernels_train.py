"""The port's training and read-only window ops against the JAX package's.

On the CPU the ops run their plain versions, which must equal the JAX
``backend="ref"`` ops bit for bit on every output: weights, v, the
fired raster and the LFSR state.  (The JAX package's interpret-mode
path of these kernels does not run on JAX 0.9.)  The CUDA kernels run
only on a card: ``test_torch_cuda.py`` holds them against these plain
versions there."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core.bitpack import as_words, words_to_numpy
from repro_torch.kernels import build, ops

# seeds near both ends of the u32 range, as i32 bit patterns
SEEDS = np.array([-1, 0x7FFFFFFF, -0x80000000, 0, 0x22A, -7], np.int32)
# per-stream LTP probabilities: slow, always, never (compared as u32)
LTP = np.array([16, 1023, 0], np.int32)


def _operands(seed, b, n, n_in, t):
    """Random training state: weights ~50% ON (tail bits included), LFSR
    lanes in [1, 2^16), sparse spike windows, membranes, and teacher
    currents from labels (+64 / -300, so some rows are inhibited)."""
    rng = np.random.default_rng(seed)
    w = -(-n_in // 32)
    weights = rng.integers(0, 2**32, (b, n, w), dtype=np.uint32)
    lfsr = rng.integers(1, 2**16, (b, n, w)).astype(np.uint32)
    spikes = (rng.integers(0, 2**32, (b, t, w), dtype=np.uint32)
              & rng.integers(0, 2**32, (b, t, w), dtype=np.uint32))
    v = rng.integers(0, 40, (b, n)).astype(np.int32)
    labels = rng.integers(0, n, b)
    teach = np.where(np.arange(n)[None, :] == labels[:, None], 64,
                     -300).astype(np.int32)
    inten = rng.integers(0, 256, (b, n_in), dtype=np.uint8)
    inten[0] = 0                                 # a silent stream
    return weights, lfsr, spikes, v, teach, inten


def _params(n_in):
    """LIF/STDP parameters that make rows fire at this width."""
    return dict(threshold=max(8, n_in * 3 // 16), leak=5, w_exp=n_in // 6,
                gain=4, n_syn=n_in)


def _assert_same(got, want):
    w2, v2, fired, lf2 = got
    jw, jv, jf, jl = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(words_to_numpy(w2), jw)
    np.testing.assert_array_equal(v2.numpy(), jv)
    assert fired.dtype == torch.bool
    np.testing.assert_array_equal(fired.numpy(), jf)
    np.testing.assert_array_equal(words_to_numpy(lf2), jl)


def _t(x):
    return as_words(x) if x.dtype == np.uint32 else torch.from_numpy(x)


SHAPES = [(1, 1, 13, 784), (3, 9, 13, 784), (3, 9, 5, 70), (1, 9, 5, 70)]


@pytest.mark.parametrize("b,t,n,n_in", SHAPES)
def test_train_window_batch_plain_matches_jax(b, t, n, n_in):
    weights, lfsr, spikes, v, teach, _ = _operands(b * 10 + n, b, n, n_in, t)
    kw = _params(n_in)
    lp = LTP[:b]
    got = ops.train_window_batch(_t(weights), _t(spikes), _t(v), _t(lfsr),
                                 _t(teach), ltp_prob=torch.from_numpy(lp),
                                 **kw)
    want = jops.train_window_batch(
        jnp.asarray(weights), jnp.asarray(spikes), jnp.asarray(v),
        jnp.asarray(lfsr), jnp.asarray(teach), ltp_prob=jnp.asarray(lp),
        backend="ref", **kw)
    _assert_same(got, want)
    if t > 1:
        assert got[2].any() and not got[2].all()


@pytest.mark.parametrize("b,t,n,n_in", SHAPES)
def test_train_window_batch_encode_plain_matches_jax(b, t, n, n_in):
    weights, lfsr, _, v, teach, inten = _operands(b + n, b, n, n_in, t)
    kw = _params(n_in)
    seeds = SEEDS[:b]
    got = ops.train_window_batch_encode(
        _t(weights), torch.from_numpy(inten), torch.from_numpy(seeds),
        _t(v), _t(lfsr), _t(teach), n_steps=t, ltp_prob=LTP[:b].tolist(),
        **kw)
    want = jops.train_window_batch_encode(
        jnp.asarray(weights), jnp.asarray(inten), jnp.asarray(seeds),
        jnp.asarray(v), jnp.asarray(lfsr), jnp.asarray(teach), n_steps=t,
        ltp_prob=jnp.asarray(LTP[:b]), backend="ref", **kw)
    _assert_same(got, want)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("t,n,n_in", [(1, 13, 784), (9, 13, 784),
                                      (9, 5, 70)])
def test_fused_snn_window_plain_matches_jax(t, n, n_in, train):
    weights, lfsr, spikes, v, teach, _ = _operands(t + n, 1, n, n_in, t)
    kw = dict(_params(n_in), ltp_prob=1023, train=train)
    got = ops.fused_snn_window(_t(weights[0]), _t(spikes[0]), _t(v[0]),
                               _t(lfsr[0]), _t(teach[0]), **kw)
    want = jops.fused_snn_window(
        jnp.asarray(weights[0]), jnp.asarray(spikes[0]), jnp.asarray(v[0]),
        jnp.asarray(lfsr[0]), jnp.asarray(teach[0]), backend="ref", **kw)
    _assert_same(got, want)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("t,n,n_in,seed", [(1, 13, 784, -1),
                                           (9, 13, 784, 0x7FFFFFFF),
                                           (9, 5, 70, -0x80000000)])
def test_fused_snn_window_encode_plain_matches_jax(t, n, n_in, seed, train):
    weights, lfsr, _, v, teach, inten = _operands(t * n, 2, n, n_in, t)
    kw = dict(_params(n_in), ltp_prob=16, train=train)
    got = ops.fused_snn_window_encode(
        _t(weights[1]), torch.from_numpy(inten[1]), seed, _t(v[1]),
        _t(lfsr[1]), _t(teach[1]), n_steps=t, **kw)
    want = jops.fused_snn_window_encode(
        jnp.asarray(weights[1]), jnp.asarray(inten[1]), jnp.int32(seed),
        jnp.asarray(v[1]), jnp.asarray(lfsr[1]), jnp.asarray(teach[1]),
        n_steps=t, backend="ref", **kw)
    _assert_same(got, want)


def test_zero_intensities_never_fire_without_teach():
    weights, lfsr, _, v, _, inten = _operands(4, 3, 8, 100, 6)
    zero = torch.zeros_like(torch.from_numpy(inten))
    teach = torch.zeros((3, 8), dtype=torch.int32)
    w2, v2, fired, lf2 = ops.train_window_batch_encode(
        _t(weights), zero, torch.from_numpy(SEEDS[:3]),
        torch.zeros((3, 8), dtype=torch.int32), _t(lfsr), teach,
        n_steps=6, **_params(100))
    assert not fired.any() and not v2.any()
    assert torch.equal(w2, _t(weights)) and torch.equal(lf2, _t(lfsr))


def test_encode_form_equals_host_encoded_windows():
    from repro_torch.core.encoder import encode_windows_host

    weights, lfsr, _, v, teach, inten = _operands(7, 3, 13, 784, 9)
    x, sd = torch.from_numpy(inten), torch.from_numpy(SEEDS[:3])
    kw = dict(_params(784), ltp_prob=torch.from_numpy(LTP))
    enc = ops.train_window_batch_encode(_t(weights), x, sd, _t(v),
                                        _t(lfsr), _t(teach), n_steps=9, **kw)
    wins = encode_windows_host(sd, x, 9, weights.shape[2])
    pre = ops.train_window_batch(_t(weights), wins, _t(v), _t(lfsr),
                                 _t(teach), **kw)
    for a, b in zip(enc, pre):
        assert torch.equal(a, b)


def test_cpu_ops_write_no_input_and_launch_nothing():
    weights, lfsr, spikes, v, teach, inten = _operands(9, 3, 13, 784, 9)
    ins = [_t(x) for x in (weights, spikes, v, lfsr, teach)]
    before = [x.clone() for x in ins]
    counts = ops.launch_counts()
    kw = _params(784)
    for backend in ("kernel", "ref"):
        ops.train_window_batch(*ins, backend=backend, **kw)
        ops.train_window_batch_encode(
            ins[0], torch.from_numpy(inten), 5, *ins[2:], n_steps=9,
            backend=backend, **kw)
        for train in (True, False):
            ops.fused_snn_window(*(x[0] for x in ins), train=train,
                                 backend=backend, **kw)
            ops.fused_snn_window_encode(
                ins[0][0], torch.from_numpy(inten[0]), 5, ins[2][0],
                ins[3][0], ins[4][0], n_steps=9, train=train,
                backend=backend, **kw)
    assert ops.launch_counts() == counts
    for a, b in zip(ins, before):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        ops.train_window_batch(*ins, backend="interp", **kw)


def test_read_only_window_passes_weights_and_lfsr_through():
    weights, lfsr, spikes, v, teach, _ = _operands(3, 1, 5, 70, 4)
    w, lf = _t(weights[0]), _t(lfsr[0])
    w2, _, _, lf2 = ops.fused_snn_window(w, _t(spikes[0]), _t(v[0]), lf,
                                         _t(teach[0]), train=False,
                                         **_params(70))
    assert w2 is w and lf2 is lf


def _csrc_copy(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    return csrc


def test_library_path_is_keyed_on_every_header(tmp_path, monkeypatch):
    csrc = _csrc_copy(tmp_path, monkeypatch)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "the kernels share a header"
    paths = {name: build.library_path(name)
             for name in ("snn_infer", "snn_train")}
    assert build.library_path("snn_infer") == paths["snn_infer"]
    with headers[0].open("a") as f:
        f.write("\n// edited\n")
    for name, old in paths.items():
        new = build.library_path(name)
        assert new != old and new.parent == old.parent
        assert new.name.startswith(f"{name}-")
    edited = build.library_path("snn_train")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build.library_path("snn_train") != edited


def test_library_path_is_keyed_on_its_source(tmp_path, monkeypatch):
    csrc = _csrc_copy(tmp_path, monkeypatch)
    infer, train = (build.library_path(n) for n in ("snn_infer",
                                                     "snn_train"))
    with (csrc / "snn_train.cu").open("a") as f:
        f.write("\n// edited\n")
    assert build.library_path("snn_train") != train
    assert build.library_path("snn_infer") == infer
