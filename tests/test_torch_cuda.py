"""The CUDA kernels against their plain versions, on a card.

Marked ``gpu``: they skip without a CUDA card (the kernels have no CPU
mode).  This file imports no JAX, so it runs on a machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.bitpack import as_words
from repro_torch.kernels import ops

SEEDS = np.array([0, -1, 0x7FFFFFFF, -0x80000000, 0x22A, -7], np.int32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _encode_operands(seed, b, n_in, n, t):
    rng = np.random.default_rng(seed)
    w = -(-n_in // 32)
    bank = rng.integers(0, 2**32, (n, w), dtype=np.uint32)
    inten = rng.integers(0, 256, (b, n_in), dtype=np.uint8)
    inten[rng.random((b, n_in)) < 0.6] = 0
    t_total = rng.integers(0, t + 1, b).astype(np.int32)
    t_total[0], t_total[-1] = 0, t             # ragged, incl. 0 and T
    return bank, inten, np.resize(SEEDS, b), t_total


def _sparse_windows(rng, b, t, w):
    a = rng.integers(0, 2**32, (b, t, w), dtype=np.uint32)
    return a & rng.integers(0, 2**32, (b, t, w), dtype=np.uint32)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n_in,n,t", [(32, 784, 40, 72), (5, 200, 70, 9),
                                        (3, 4096, 130, 16), (2, 65536, 20, 4)])
def test_cuda_kernels_equal_plain_versions(cuda, b, n_in, n, t):
    bank, inten, seeds, t_total = _encode_operands(n, b, n_in, n, t)
    w = as_words(bank, cuda)
    x = torch.from_numpy(inten).to(cuda)
    sd = torch.from_numpy(seeds).to(cuda)
    tt = torch.from_numpy(t_total).to(cuda)
    kw = dict(n_steps=t, threshold=n_in // 8, leak=3, t_total=tt)
    launches = ops.infer_window_batch_encode.launches
    got = ops.infer_window_batch_encode(w, x, sd, **kw)
    torch.cuda.synchronize()
    assert ops.infer_window_batch_encode.launches == launches + 1
    assert torch.equal(got, ops.infer_window_batch_encode(
        w, x, sd, backend="ref", **kw))
    wins = as_words(
        _sparse_windows(np.random.default_rng(n), b, t, bank.shape[1]), cuda)
    got = ops.infer_window_batch(w, wins, threshold=n_in // 8, leak=3)
    torch.cuda.synchronize()
    assert torch.equal(got, ops.infer_window_batch(
        w, wins, threshold=n_in // 8, leak=3, backend="ref"))


@pytest.mark.gpu
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    w = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    x = torch.zeros((3, 64), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):      # threshold < 1
        ops.infer_window_batch_encode(w, x, 0, n_steps=4, threshold=0,
                                      leak=0)
    with pytest.raises(ValueError):      # intensities on another device
        ops.infer_window_batch_encode(w, x.cpu(), 0, n_steps=4,
                                      threshold=1, leak=0)
    with pytest.raises(ValueError):      # non-contiguous spike window
        ops.infer_window_batch(w, torch.zeros((3, 2, 4), dtype=torch.int32,
                                              device=cuda)[..., ::2],
                               threshold=1, leak=0)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,words,t,regime", [
    (32, 40, 25, 72, "window"),     # the paper's: SMs // 32 blocks a sample
    (32, 40, 25, 8, "window"),      # the canary's
    (1, 40, 25, 72, "window"),      # 8 blocks a sample
    (16, 1000, 2048, 72, "gemm"),   # 256 (tile, sample)s: 8 blocks each
    (4, 4, 32768, 8, "gemm"),       # 8 blocks each
    (5, 1000, 25, 75, "gemm"),      # one 32-word chunk: no split
])
def test_prepacked_plan_names_each_regime(cuda, b, n, words, t, regime):
    """The pre-packed kernel's plan: the window regime where a sample's
    weights, sums and share of its window fit a block (without the encode
    kernel's 32-bytes-a-word intensity stage), else the GEMM regime, by
    clusters that split the words: the least power of two giving 8
    blocks an SM, at most 8 and at most the 32-word chunks."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    limit = torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin
    plan = ops.encode_plan(b, n, words, t, encode=False)
    enc = ops.encode_plan(b, n, words, t)
    assert plan.regime == regime and plan.smem_bytes <= limit
    if regime == "window":
        assert plan.cluster == min(8, max(sms // b, 1), t)
        assert enc.regime == "window" and enc.cluster == plan.cluster
        assert enc.smem_bytes - plan.smem_bytes == 32 * words
    else:
        chunks, g = -(-words // 32), 1
        while g < 8 and g < chunks and b * -(-n // 64) * g < 8 * sms:
            g *= 2
        assert plan.cluster == enc.cluster == min(g, chunks)


@pytest.mark.gpu
def test_prepacked_32768_word_bank_is_served(cuda):
    """A 32,768-word bank (a row of 128 KiB: the old pre-packed kernel
    refused it) runs in the GEMM regime and equals its plain version, at
    threshold 0 too; so does the encode kernel's GEMM regime (8,192
    words)."""
    rng = np.random.default_rng(4)
    w = as_words(rng.integers(0, 2**32, (4, 32768), dtype=np.uint32), cuda)
    wins = as_words(_sparse_windows(rng, 2, 8, 32768), cuda)
    assert ops.encode_plan(2, 4, 32768, 8, encode=False).regime == "gemm"
    for thr in (0, 1, 32768 * 4):
        got = ops.infer_window_batch(w, wins, threshold=thr, leak=3)
        torch.cuda.synchronize()
        assert torch.equal(got, ops.infer_window_batch(
            w, wins, threshold=thr, leak=3, backend="ref"))
    assert (got > 0).any() and (got < 8).any()
    w = as_words(rng.integers(0, 2**32, (4, 8192), dtype=np.uint32), cuda)
    x = torch.from_numpy(rng.integers(0, 256, (1, 8192 * 32),
                                      dtype=np.uint8)).to(cuda)
    assert ops.encode_plan(1, 4, 8192, 2).regime == "gemm"
    kw = dict(n_steps=2, threshold=1, leak=0)
    got = ops.infer_window_batch_encode(w, x, 3, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, ops.infer_window_batch_encode(w, x, 3,
                                                          backend="ref", **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("t", [0, 1, 75])
def test_cuda_prepacked_runs_every_cycle(cuda, t):
    """The pre-packed kernel runs all T cycles of every sample (T = 0
    launches nothing and gives zeros), unaligned operands included (the
    GEMM regime then copies 4 bytes at a time)."""
    rng = np.random.default_rng(t)
    for n, words in ((40, 25), (70, 2048)):
        w = as_words(rng.integers(0, 2**32, (n, words), dtype=np.uint32),
                     cuda)
        flat = as_words(_sparse_windows(rng, 1, 3 * t * words + 1, 1)
                        .reshape(-1), cuda)
        wins = flat[1:].view(3, t, words)       # 4 bytes past 16-aligned
        launches = ops.infer_window_batch.launches
        for thr in (0, 1, 8 * words):
            got = ops.infer_window_batch(w, wins, threshold=thr, leak=3)
            torch.cuda.synchronize()
            assert torch.equal(got, ops.infer_window_batch(
                w, wins, threshold=thr, leak=3, backend="ref"))
        assert ops.infer_window_batch.launches == launches + 3 * (t > 0)
        if t == 0:
            assert not got.any()


@pytest.mark.gpu
@pytest.mark.parametrize("b,n_in,n,t,regime", [
    (32, 784, 40, 72, "window"),      # the paper's shape: a cluster of 4
    (32, 784, 40, 8, "window"),       # the canary's
    (1, 784, 40, 72, "window"),       # a cluster of 8
    (33, 100, 37, 16, "window"),
    (3, 4096, 130, 9, "window"),
    (2, 65536, 130, 72, "gemm"),
    (5, 784, 1000, 75, "gemm"),       # two passes of 72 cycles
])
def test_cuda_encode_regimes_equal_plain_and_prepacked(cuda, b, n_in, n, t,
                                                       regime):
    """Each regime the encode launcher picks equals the plain version
    (t_total 0, partial and T among the samples, threshold 1 and higher)
    and the pre-packed kernel on the host-encoded windows."""
    from repro_torch.core.encoder import encode_windows_host
    bank, inten, seeds, t_total = _encode_operands(n + t, b, n_in, n, t)
    w = as_words(bank, cuda)
    x = torch.from_numpy(inten).to(cuda)
    sd = torch.from_numpy(seeds).to(cuda)
    tt = torch.from_numpy(t_total).to(cuda)
    plan = ops.encode_plan(b, n, bank.shape[1], t)
    assert plan.regime == regime
    if (b, t) == (32, 72):
        assert plan.cluster == min(8, torch.cuda.get_device_properties(
            cuda).multi_processor_count // 32)
    for thr in (1, n_in // 8):
        kw = dict(n_steps=t, threshold=thr, leak=3, t_total=tt)
        got = ops.infer_window_batch_encode(w, x, sd, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, ops.infer_window_batch_encode(
            w, x, sd, backend="ref", **kw))
        if b > 1:
            assert not got[0].any()             # t_total[0] == 0
        wins = encode_windows_host(sd, x, t, bank.shape[1], tt)
        assert torch.equal(got, ops.infer_window_batch(w, wins, threshold=thr,
                                                       leak=3))
    # threshold 0 on the pre-packed op: the zero-masked tail fires too
    got = ops.infer_window_batch(w, wins, threshold=0, leak=3)
    torch.cuda.synchronize()
    assert torch.equal(got, ops.infer_window_batch(w, wins, threshold=0,
                                                   leak=3, backend="ref"))
    assert (got == t).all()


def _serving(cuda, on_launch):
    from repro_torch.serving import (SNNRequest, SNNServingEngine,
                                     SNNServingPolicy)
    from repro_torch.engine import SNNEnginePlan

    rng = np.random.default_rng(5)
    bank = rng.integers(0, 2**32, (20, 4), dtype=np.uint32)
    plan = SNNEnginePlan(threshold=40, leak=3, w_exp=None, max_batch=4,
                         encode="kernel")
    eng = SNNServingEngine(bank, plan, on_launch=on_launch,
                           policy=SNNServingPolicy(max_retries=1),
                           device=cuda)
    reqs = [SNNRequest(rid=i, n_steps=(9, 12)[i % 2],
                       intensities=rng.integers(0, 256, 100, dtype=np.uint8))
            for i in range(4)]
    return bank, eng, eng.run(reqs)


@pytest.mark.gpu
def test_cuda_serving_fails_instead_of_serving_the_plain_version(cuda):
    def always_raise(info):
        raise RuntimeError("injected")

    ops.reset_launch_counts()
    _, eng, reqs = _serving(cuda, always_raise)
    assert [r.status for r in reqs] == ["FAILED"] * 4
    assert [p.kernel_backend for p in eng._plans] == ["kernel", "kernel"]
    assert eng.degraded == 1 and eng.level == 1
    assert all(v == 0 for v in ops.launch_counts().values())


@pytest.mark.gpu
def test_cuda_integrity_reserve_runs_a_kernel(cuda):
    from repro_torch.core.encoder import encode_windows_host
    from repro_torch.kernels.ref import infer_window_batch_ref

    def corrupt_first(info):
        if info["kind"] == "serve" and info["step"] == 0:
            return lambda c: c - 1 - c.max()
        return None

    ops.reset_launch_counts()
    bank, eng, reqs = _serving(cuda, corrupt_first)
    assert [r.status for r in reqs] == ["SERVED"] * 4
    assert eng.integrity_failures == 4 and eng.level == 1
    # the serve on the encode kernel, the re-serve on the pre-packed one
    assert ops.launch_counts() == {"infer_window_batch_encode": 1,
                                   "infer_window_batch": 1,
                                   "train_window_batch": 0,
                                   "train_window_batch_encode": 0,
                                   "fused_snn_window": 0,
                                   "fused_snn_window_encode": 0,
                                   "fused_snn_step": 0,
                                   "spike_process": 0,
                                   "lif_step": 0,
                                   "stdp_update": 0,
                                   "flash_attention": 0}
    inten = torch.from_numpy(np.stack([r.intensities for r in reqs]))
    seeds = torch.tensor([r.seed for r in reqs])
    tt = torch.tensor([r.n_steps for r in reqs], dtype=torch.int32)
    want = infer_window_batch_ref(
        as_words(bank), encode_windows_host(seeds, inten, 16, 4, tt),
        40, 3)
    assert np.array_equal(np.stack([r.counts for r in reqs]), want.numpy())


# --- training and read-only window kernels (csrc/snn_train.cu) --------------

def _train_operands(seed, b, n, n_in, t, cuda):
    rng = np.random.default_rng(seed)
    w = -(-n_in // 32)
    words = lambda shape: as_words(                      # noqa: E731
        rng.integers(0, 2**32, shape, dtype=np.uint32), cuda)
    weights, lfsr = words((b, n, w)), as_words(
        rng.integers(1, 2**16, (b, n, w)).astype(np.uint32), cuda)
    spikes = as_words(_sparse_windows(rng, b, t, w), cuda)
    v = torch.from_numpy(rng.integers(0, 40, (b, n)).astype(np.int32)).to(cuda)
    labels = rng.integers(0, n, b)
    teach = torch.from_numpy(np.where(
        np.arange(n)[None] == labels[:, None], 64, -300).astype(np.int32)
    ).to(cuda)
    inten = rng.integers(0, 256, (b, n_in), dtype=np.uint8)
    inten[rng.random((b, n_in)) < 0.6] = 0
    inten = torch.from_numpy(inten).to(cuda)
    seeds = torch.from_numpy(np.resize(SEEDS, b)).to(cuda)
    ltp = torch.from_numpy(np.resize(np.array([16, 1023, 0, -1], np.int32),
                                     b)).to(cuda)
    kw = dict(threshold=max(8, n_in * 3 // 16), leak=5, w_exp=n_in // 6,
              gain=4, n_syn=n_in)
    return weights, lfsr, spikes, v, teach, inten, seeds, ltp, kw


def _equal_all(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,n_in,t", [(4, 10, 784, 72), (3, 70, 4096, 9),
                                        (2, 130, 65536, 4)])
def test_cuda_train_kernels_equal_plain_versions(cuda, b, n, n_in, t):
    weights, lfsr, spikes, v, teach, inten, seeds, ltp, kw = \
        _train_operands(n + t, b, n, n_in, t, cuda)
    ins = [x.clone() for x in (weights, lfsr, spikes, v, teach)]
    ops.reset_launch_counts()
    got = ops.train_window_batch(weights, spikes, v, lfsr, teach,
                                 ltp_prob=ltp, **kw)
    enc = ops.train_window_batch_encode(weights, inten, seeds, v, lfsr,
                                        teach, n_steps=t, ltp_prob=ltp, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["train_window_batch"] == 1
    assert ops.launch_counts()["train_window_batch_encode"] == 1
    _equal_all(got, ops.train_window_batch(weights, spikes, v, lfsr, teach,
                                           ltp_prob=ltp, backend="ref",
                                           **kw))
    _equal_all(enc, ops.train_window_batch_encode(
        weights, inten, seeds, v, lfsr, teach, n_steps=t, ltp_prob=ltp,
        backend="ref", **kw))
    assert got[2].any()
    for a, x in zip(ins, (weights, lfsr, spikes, v, teach)):
        assert torch.equal(a, x)             # inputs never written


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,n_in,t,n_samples,shared", [
    (4, 10, 784, 72, 8, True),         # the parallel trainer's stream
    (1, 10, 784, 72, 8, False),        # the active trainer's
    (3, 70, 4096, 9, 3, False),
    (2, 5, 70, 6, 4, True),            # n_in not whole words
    (2, 20, 70, 5, 3, False),          # more rows than row warps
    (2, 130, 65536, 4, 2, False)])     # per-cycle window rows
def test_cuda_train_stream_equals_plain_version(cuda, b, n, n_in, t,
                                                n_samples, shared):
    weights, lfsr, _, _, _, _, _, ltp, kw = _train_operands(
        n_in + n_samples, b, n, n_in, t, cuda)
    rng = np.random.default_rng(n_samples)
    inten = rng.integers(0, 256, (n_samples, 1 if shared else b, n_in),
                         dtype=np.uint8)
    inten[rng.random(inten.shape) < 0.6] = 0
    inten = torch.from_numpy(inten).to(cuda).expand(n_samples, b, n_in)
    labels = rng.integers(0, n, (n_samples, b))
    teach = torch.from_numpy(np.where(
        np.arange(n) == labels[..., None], 64, -300).astype(np.int32)).to(cuda)
    seeds = torch.from_numpy(rng.integers(-2**31, 2**31, (n_samples, b))
                             .astype(np.int32)).to(cuda)
    ops.reset_launch_counts()
    got = ops.train_stream_batch_encode(weights, inten, seeds, lfsr, teach,
                                        n_steps=t, ltp_prob=ltp, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["train_window_batch_encode"] == 1
    want = ops.train_stream_batch_encode(weights, inten, seeds, lfsr, teach,
                                         n_steps=t, ltp_prob=ltp,
                                         backend="ref", **kw)
    _equal_all(got, want)
    assert got[2].any()
    # sample by sample through the one-sample op
    w, lf = weights, lfsr
    for i in range(n_samples):
        w, v, fired, lf = ops.train_window_batch_encode(
            w, inten[i].contiguous(), seeds[i], torch.zeros_like(got[1]), lf,
            teach[i], n_steps=t, ltp_prob=ltp, **kw)
        assert torch.equal(fired.sum(dim=1, dtype=torch.int32), got[2][i])
    _equal_all((w, v, lf), (got[0], got[1], got[3]))


@pytest.mark.gpu
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("n,n_in,t", [(10, 784, 72), (1000, 65536, 3)])
def test_cuda_fused_windows_equal_plain_versions(cuda, train, n, n_in, t):
    weights, lfsr, spikes, v, teach, inten, seeds, _, kw = \
        _train_operands(n, 1, n, n_in, t, cuda)
    kw = dict(kw, ltp_prob=16, train=train)
    ops.reset_launch_counts()
    got = ops.fused_snn_window(weights[0], spikes[0], v[0], lfsr[0],
                               teach[0], **kw)
    enc = ops.fused_snn_window_encode(weights[0], inten[0], seeds[:1], v[0],
                                      lfsr[0], teach[0], n_steps=t, **kw)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if train:
        assert counts["train_window_batch"] == 1
        assert counts["train_window_batch_encode"] == 1
    else:
        assert counts["fused_snn_window"] == 1
        assert counts["fused_snn_window_encode"] == 1
        assert got[0] is weights[0] or torch.equal(got[0], weights[0])
    _equal_all(got, ops.fused_snn_window(weights[0], spikes[0], v[0],
                                         lfsr[0], teach[0], backend="ref",
                                         **kw))
    _equal_all(enc, ops.fused_snn_window_encode(
        weights[0], inten[0], seeds[:1], v[0], lfsr[0], teach[0],
        n_steps=t, backend="ref", **kw))


@pytest.mark.gpu
def test_cuda_train_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    weights, lfsr, spikes, v, teach, inten, seeds, ltp, kw = \
        _train_operands(1, 2, 8, 100, 4, cuda)
    with pytest.raises(ValueError, match="n_syn"):
        ops.train_window_batch(weights, spikes, v, lfsr, teach,
                               **dict(kw, n_syn=0))
    with pytest.raises(ValueError, match="contiguous"):
        ops.train_window_batch(weights.transpose(1, 2).contiguous()
                               .transpose(1, 2), spikes, v, lfsr, teach,
                               **kw)
    with pytest.raises(ValueError, match="CUDA"):
        ops.train_window_batch(weights, spikes, v.cpu(), lfsr, teach, **kw)
    with pytest.raises(ValueError, match="shape"):
        ops.train_window_batch(weights, spikes, v,
                               lfsr[:, :4].contiguous(), teach, **kw)
    with pytest.raises(ValueError, match="dtype|torch"):
        ops.train_window_batch(weights, spikes, v.to(torch.int64), lfsr,
                               teach, **kw)
    with pytest.raises(ValueError, match="exceed"):
        ops.train_window_batch_encode(weights[:, :, :1].contiguous(), inten,
                                      seeds, v, lfsr[:, :, :1].contiguous(),
                                      teach, n_steps=4, **kw)
    with pytest.raises(ValueError, match="per stream"):
        ops.train_window_batch(weights, spikes, v, lfsr, teach,
                               ltp_prob=torch.zeros(3, dtype=torch.int32,
                                                    device=cuda), **kw)


@pytest.mark.gpu
def test_cuda_failing_train_launches_raise(cuda):
    # a row of 32,768 words with its LFSR lanes (256 KiB) fits no block
    assert ops.train_tile_rows(4, 32768, encode=False, learn=True) == 0
    w = torch.zeros((1, 4, 32768), dtype=torch.int32, device=cuda)
    z = torch.zeros((1, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ops.train_window_batch(w, w[:, :1], z, w, z, threshold=1, leak=0,
                               w_exp=0, gain=0, n_syn=1)
    # a grid of 70,000 streams is refused by the card itself
    v = torch.zeros((4,), dtype=torch.int32, device=cuda)
    out = torch.empty((4,), dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        ops._launch("probe", "snn_train", "snn_window_infer", cuda,
                    w.data_ptr(), w.data_ptr(), v.data_ptr(), v.data_ptr(),
                    out.data_ptr(), out.data_ptr(), 70_000, 4, 1, 1, 1, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("n,words,encode,learn", [(10, 25, True, True),
                                                  (1000, 2048, True, True),
                                                  (1000, 2048, False, False),
                                                  (7, 1, False, True)])
def test_train_tile_rows_fit_shared_memory(cuda, n, words, encode, learn):
    rows = ops.train_tile_rows(n, words, encode, learn)
    limit = torch.cuda.get_device_properties(cuda) \
        .shared_memory_per_block_optin
    assert 1 <= rows <= n
    assert ops.train_smem_bytes(rows, words, encode, learn) <= limit


@pytest.mark.gpu
@pytest.mark.parametrize("mode,encode", [("parallel", "kernel"),
                                         ("active", "kernel"),
                                         ("active", "host")])
def test_cuda_trainer_equals_the_cpu_run(cuda, mode, encode):
    import dataclasses

    from repro_torch.configs.wenquxing_snn import WENQUXING_22A_INTENSITY
    from repro_torch.core import trainer
    from repro_torch.launch.mnist_stdp import preprocessed_digits

    x, labels = preprocessed_digits(30, 3)
    cfg = dataclasses.replace(WENQUXING_22A_INTENSITY, n_neurons=20,
                              n_steps=24, epochs=1, train_mode=mode,
                              encode=encode)
    ops.reset_launch_counts()
    card = trainer.train(cfg, x, labels, device=cuda)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["train_window_batch" if encode == "host"
                  else "train_window_batch_encode"] > 0
    host = trainer.train(cfg, x, labels, device="cpu")
    assert card.weights.device.type == "cuda"
    assert torch.equal(card.weights.cpu(), host.weights)
    assert torch.equal(card.neuron_class.cpu(), host.neuron_class)


# --- per-cycle RV-SNN step kernels (csrc/snn_step.cu) -----------------------

def _step_operands(seed, lead, n, n_in, cuda, shared=False):
    """Step state on the card: random banks and spikes, LFSR lanes in
    [1, 2^16), membranes and teacher currents so some rows fire."""
    rng = np.random.default_rng(seed)
    w = -(-n_in // 32)
    bank_lead = () if shared else lead
    weights = as_words(rng.integers(0, 2**32, bank_lead + (n, w),
                                    dtype=np.uint32), cuda)
    lanes = as_words(rng.integers(1, 2**16, bank_lead + (n, w))
                     .astype(np.uint32), cuda)
    pre = as_words(rng.integers(0, 2**32, lead + (w,), dtype=np.uint32),
                   cuda)
    v = torch.from_numpy(rng.integers(0, 200, lead + (n,))
                         .astype(np.int32)).to(cuda)
    teach = torch.from_numpy(rng.integers(-300, 200, lead + (n,))
                             .astype(np.int32)).to(cuda)
    b = lead[0] if lead else 1
    ltp = torch.from_numpy(np.resize(np.array([16, 1023, 0, -1], np.int32),
                                     b)).to(cuda)
    kw = dict(threshold=8 * w + 50, leak=16, w_exp=n_in // 6, gain=4,
              n_syn=n_in)
    return weights, pre, v, lanes, teach, ltp, kw


@pytest.mark.gpu
@pytest.mark.parametrize("lead,shared", [((), False), ((4,), False),
                                         ((32,), True)])
@pytest.mark.parametrize("n,n_in", [(10, 784), (1000, 65536)])
def test_cuda_step_kernels_equal_plain_versions(cuda, lead, shared, n, n_in):
    weights, pre, v, lanes, teach, ltp, kw = _step_operands(
        n + len(lead), lead, n, n_in, cuda, shared)
    ins = [x.clone() for x in (weights, pre, v, lanes, teach)]
    ltp = ltp if lead else ltp[:1]
    su = dict(w_exp=kw["w_exp"], gain=4, n_syn=n_in, ltp_prob=ltp)
    ops.reset_launch_counts()
    counts = ops.spike_process(pre, weights)
    v2, fired = ops.lif_step(v, counts + teach, kw["threshold"], kw["leak"])
    w2, l2 = ops.stdp_update(weights, pre, fired, lanes, **su)
    fused = ops.fused_snn_step(weights, pre, v, lanes, teach, ltp_prob=ltp,
                               **kw)
    idle = ops.fused_snn_step(weights, pre, v, lanes, None, ltp_prob=ltp,
                              train=False, **kw)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    assert [launches[k] for k in ("fused_snn_step", "spike_process",
                                  "lif_step", "stdp_update")] == [2, 1, 1, 1]
    _equal_all((counts,), (ops.spike_process(pre, weights, backend="ref"),))
    _equal_all((v2, fired), ops.lif_step(v, counts + teach, kw["threshold"],
                                         kw["leak"], backend="ref"))
    _equal_all((w2, l2), ops.stdp_update(weights, pre, fired, lanes,
                                         backend="ref", **su))
    _equal_all(fused, ops.fused_snn_step(weights, pre, v, lanes, teach,
                                         ltp_prob=ltp, backend="ref", **kw))
    _equal_all(idle, ops.fused_snn_step(weights, pre, v, lanes, None,
                                        ltp_prob=ltp, train=False,
                                        backend="ref", **kw))
    # the unfused chain equals the fused step; some rows fire, some not
    _equal_all(fused, (w2, v2, fired, l2))
    assert fired.any() and not fired.all()
    assert idle[0] is weights and idle[3] is lanes
    for a, x in zip(ins, (weights, pre, v, lanes, teach)):
        assert torch.equal(a, x)             # inputs never written


@pytest.mark.gpu
@pytest.mark.parametrize("fired", ["all", "none", "mixed"])
@pytest.mark.parametrize("words,offset", [
    (1, 0), (25, 0), (128, 0),          # a warp a row, in registers
    (129, 0), (2048, 0), (4096, 0),     # a block a row (16-byte copies)
    (2048, 1),                          # ... unaligned: 4-byte copies
    (32768, 0),                         # too wide for the stash: two passes
])
@pytest.mark.parametrize("lead,shared", [((), False), ((4,), False),
                                         ((4,), True)])
def test_cuda_stdp_update_paths_equal_plain(cuda, lead, shared, words,
                                            offset, fired):
    rng = np.random.default_rng(words + offset + len(lead))
    n = 5
    bank_lead = () if shared else lead

    def words_at(shape, lanes=False):     # ``offset`` words past aligned
        x = (rng.integers(1, 2**16, shape).astype(np.uint32) if lanes else
             rng.integers(0, 2**32, shape, dtype=np.uint32))
        flat = as_words(np.concatenate([np.zeros(offset, np.uint32),
                                        x.reshape(-1)]), cuda)
        return flat[offset:].view(shape)

    weights = words_at(bank_lead + (n, words))
    lanes = words_at(bank_lead + (n, words), lanes=True)
    pre = words_at(lead + (words,))
    post = (torch.ones if fired == "all" else torch.zeros)(
        lead + (n,), dtype=torch.bool, device=cuda)
    if fired == "mixed":
        post[..., ::2] = True
    b = lead[0] if lead else 1
    ltp = torch.tensor([16, -1, 0, 1023][:b], dtype=torch.int32,
                       device=cuda)
    su = dict(w_exp=16 * words, gain=4, n_syn=32 * words - 5, ltp_prob=ltp)
    ins = [x.clone() for x in (weights, lanes, pre, post)]
    launches = ops.stdp_update.launches
    got = ops.stdp_update(weights, pre, post, lanes, **su)
    torch.cuda.synchronize()
    assert ops.stdp_update.launches == launches + 1
    _equal_all(got, ops.stdp_update(weights, pre, post, lanes,
                                    backend="ref", **su))
    for a, x in zip(ins, (weights, lanes, pre, post)):
        assert torch.equal(a, x)             # inputs never written
    if fired != "none":
        assert not torch.equal(got[1], lanes.expand(got[1].shape))


def _words_at(rng, shape, offset, cuda, lanes=False):
    """Random words (or LFSR lanes) on the card as a view ``offset``
    words past a 16-byte aligned base."""
    x = (rng.integers(1, 2**16, shape).astype(np.uint32) if lanes else
         rng.integers(0, 2**32, shape, dtype=np.uint32))
    flat = as_words(np.concatenate([np.zeros(offset, np.uint32),
                                    x.reshape(-1)]), cuda)
    return flat[offset:].view(shape)


@pytest.mark.gpu
@pytest.mark.parametrize("dependent", [False, True])
@pytest.mark.parametrize("words,offset", [
    (1, 0), (25, 0), (128, 0),          # a warp a row, in registers
    (129, 0), (2047, 0),                # 4 warps a row, 4-byte loads
    (2048, 0), (4100, 0),               # ... 16-byte loads, 1 and 2 rounds
    (2048, 1),                          # ... a view one word off: 4-byte
])
@pytest.mark.parametrize("n", [1, 9])   # 9: the last block's rows part-used
@pytest.mark.parametrize("lead,shared", [((), False), ((4,), False),
                                         ((4,), True)])
def test_cuda_spike_process_paths_equal_plain(cuda, lead, shared, n, words,
                                              offset, dependent):
    """Each path of the SPU kernel equals its plain version; as a
    dependent, it reads the bank only after the kernel that wrote it
    (an elementwise PyTorch kernel, launched just before) has ended."""
    rng = np.random.default_rng(words + 7 * offset + n + len(lead))
    bank_lead = () if shared else lead
    src = _words_at(rng, bank_lead + (n, words), offset, cuda)
    pre = _words_at(rng, lead + (words,), offset, cuda)
    flip = int(rng.integers(1, 2**31))
    weights = torch.empty_like(src)
    if offset:                              # keep the bank's odd base
        weights = _words_at(rng, bank_lead + (n, words), offset, cuda)
    torch.bitwise_xor(src, flip, out=weights)
    launches = ops.spike_process.launches
    got = ops.spike_process(pre, weights, dependent=dependent)
    torch.cuda.synchronize()
    assert ops.spike_process.launches == launches + 1
    want = ops.spike_process(pre, weights, backend="ref")
    _equal_all((got,), (want,))
    assert got.shape == lead + (n,)


@pytest.mark.gpu
@pytest.mark.parametrize("dependent", [False, True])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("total", [1, 3, 4, 40, 1280, 4096, 4097, 9001])
def test_cuda_lif_step_paths_equal_plain(cuda, total, offset, dependent):
    """The NU kernel at its grid's edges (a lone neuron, part of a warp,
    a last block of one or of part of a warp) and on a view one element
    off; int32 wraparound of v + count as the plain version has it.  As
    a dependent it reads count only after the kernel that wrote it."""
    rng = np.random.default_rng(total + offset)
    v_np = rng.integers(0, 300, total + offset).astype(np.int32)
    c_np = rng.integers(-50, 120, total + offset).astype(np.int32)
    v_np[offset], c_np[offset] = 2**31 - 5, 7   # v + count wraps in int32
    v = torch.from_numpy(v_np).to(cuda)[offset:]
    c = torch.from_numpy(c_np).to(cuda)[offset:]
    count = torch.empty_like(c)
    torch.add(c, 0, out=count)
    launches = ops.lif_step.launches
    got = ops.lif_step(v, count, 100, 3, dependent=dependent)
    torch.cuda.synchronize()
    assert ops.lif_step.launches == launches + 1
    _equal_all(got, ops.lif_step(v, count, 100, 3, backend="ref"))
    if total > 40:
        assert got[1].any() and not got[1].all()


def _chain_window(o, wins, dependent, fused):
    """``len(wins)`` cycles from ``o``'s state: the fused step, or
    ``snn.sp -> + teach -> snn.nu -> snn.su`` (the SU where ``o``
    trains), every launch after the first a programmatic dependent
    where ``dependent``.  Returns (bank, v, LFSR, raster)."""
    from repro_torch.core import rvsnn
    from repro_torch.core.lif import LIFParams
    from repro_torch.core.stdp import STDPParams

    kw, train = o["kw"], o["train"]
    rf = rvsnn.SnnRegFile(spike=wins[0], v=o["v"], lfsr=o["lanes"],
                          weights=o["weights"])
    lif = LIFParams(kw["threshold"], kw["leak"])
    su = STDPParams(kw["w_exp"], kw["gain"], kw["n_syn"], o["ltp"])
    raster = []
    for t, words in enumerate(wins):
        dep = dependent and t > 0
        if fused:
            rf, fired = rvsnn.snn_step(rf, words, lif, su if train else None,
                                       o["teach"], dependent=dep)
        else:
            rf = rvsnn.snn_ls(rf, words)
            counts = rvsnn.snn_sp(rf, dependent=dep)
            if o["teach"] is not None:
                counts = counts + o["teach"]
            rf, fired = rvsnn.snn_nu(rf, counts, lif, dependent=dependent)
            if train:
                rf = rvsnn.snn_su(rf, fired, su, dependent=dependent)
        raster.append(fired)
    return rf.weights, rf.v, rf.lfsr, torch.stack(raster)


@pytest.mark.gpu
@pytest.mark.parametrize("lead,shared,n,n_in,train", [
    ((4,), False, 10, 784, True),        # the trainer's parallel cycle
    ((32,), True, 40, 784, False),       # serving: one shared bank, SU idle
    ((), False, 37, 65536, True),        # long rows
])
def test_cuda_chain_graph_dependent_equals_serial(cuda, lead, shared, n,
                                                  n_in, train):
    """The unfused chain's cycles recorded as one CUDA graph with
    dependent launches leave the same bank, v, LFSR and raster as the
    chain launched serially, in a graph and outside one, and as the
    fused step's graph; recording counts no launch."""
    weights, _, v, lanes, teach, ltp, kw = _step_operands(
        n + len(lead), lead, n, n_in, cuda, shared)
    rng = np.random.default_rng(n)
    wins = as_words(_sparse_windows(rng, 24, lead[0] if lead else 1,
                                    weights.shape[-1]), cuda)
    if not lead:
        wins = wins[:, 0]
    o = dict(weights=weights, v=v, lanes=lanes, ltp=ltp, kw=kw, train=train,
             teach=teach if train else None)
    eager = _chain_window(o, wins, False, False)
    out = {}
    for fused in (False, True):
        for dependent in (False, True):
            _chain_window(o, wins, dependent, fused)      # warm-up
            before = ops.launch_counts()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                res = _chain_window(o, wins, dependent, fused)
            assert ops.launch_counts() == before
            graph.replay()
            torch.cuda.synchronize()
            out[(fused, dependent)] = [x.clone() for x in res]
            del graph
    for got in out.values():
        _equal_all(got, eager)
    assert eager[3].any() and not eager[3].all()


@pytest.mark.gpu
def test_cuda_step_wrappers_reject_what_the_kernels_do_not_take(cuda):
    weights, pre, v, lanes, teach, ltp, kw = _step_operands(
        1, (3,), 8, 100, cuda)
    with pytest.raises(ValueError, match="n_syn"):
        ops.fused_snn_step(weights, pre, v, lanes, teach,
                           **dict(kw, n_syn=0))
    with pytest.raises(ValueError, match="shape"):
        ops.fused_snn_step(weights, pre[:2].contiguous(), v, lanes, teach,
                           **kw)
    with pytest.raises(ValueError, match="CUDA"):
        ops.spike_process(pre.cpu(), weights)
    with pytest.raises(ValueError, match="contiguous"):
        ops.lif_step(v.t(), v.t(), 1, 0)
    with pytest.raises(ValueError, match="torch"):
        ops.stdp_update(weights, pre, v, lanes, w_exp=1, gain=1, n_syn=1)
    with pytest.raises(ValueError, match="per stream"):
        ops.fused_snn_step(weights, pre, v, lanes, teach,
                           **dict(kw, ltp_prob=ltp[:2]))


@pytest.mark.gpu
@pytest.mark.parametrize("verb", ["infer", "train", "train_batch"])
def test_cuda_step_path_equals_window_path(cuda, verb):
    """The engine's three verbs on the step path (one fused step launch
    per cycle) equal the window path on the card, and the CPU run."""
    from repro_torch.core.rvsnn import snn_regfile_batch
    from repro_torch.engine import SNNEngine, SNNEnginePlan

    rng = np.random.default_rng(7)
    b, n, w, t = 4, 10, 25, 24
    bank = rng.integers(0, 2**32, (b, n, w), dtype=np.uint32)
    wins = (rng.integers(0, 2**32, (b, t, w), dtype=np.uint32)
            & rng.integers(0, 2**32, (b, t, w), dtype=np.uint32))
    teach = np.where(np.arange(n)[None] == np.arange(b)[:, None], 64,
                     -300).astype(np.int32)
    lp = np.array([16, 1023, 0, 64], np.int32)
    out = {}
    for cb, dev in (("step", cuda), ("window", cuda), ("step", "cpu")):
        plan = SNNEnginePlan(threshold=90, leak=4, n_syn=784,
                             w_exp=None if verb == "infer" else 128,
                             cycle_backend=cb)
        eng = SNNEngine(plan, device=dev)
        rfs = snn_regfile_batch(as_words(bank), [3, 5, 7, 9])
        ops.reset_launch_counts()
        if verb == "infer":
            res = (eng.infer(bank[0], wins),)
        elif verb == "train":
            o = eng.train(type(rfs)(*(x[0] for x in rfs)), wins[0],
                          teach[0])
            res = tuple(o.regfile) + (o.fired,)
        else:
            r, counts, fired = eng.train_batch(rfs, wins, teach, ltp_prob=lp)
            res = tuple(r) + (counts, fired)
        if dev == cuda:
            torch.cuda.synchronize()
            launches = ops.launch_counts()
            if cb == "step":
                assert launches["fused_snn_step"] == t
                assert sum(launches.values()) == t
            else:
                assert launches["fused_snn_step"] == 0
        out[(cb, str(dev))] = [x.cpu() for x in res]
    step, window, cpu = out.values()
    _equal_all(step, window)
    _equal_all(step, cpu)
    assert step[-1].any()


@pytest.mark.gpu
@pytest.mark.parametrize("verb", ["infer", "train", "train_batch"])
def test_cuda_step_graph_replays_equal_window_path(cuda, verb):
    """Three presentations of one window key on the step path: the first
    launches its steps one by one, the second records and replays the
    window's CUDA graph, the third replays it.  Each equals the window
    path, counts T fused step launches, and what a replay returned stays
    as it was after the next replay (no output aliases graph memory)."""
    from repro_torch.core.rvsnn import snn_regfile_batch
    from repro_torch.engine import SNNEngine, SNNEnginePlan
    from repro_torch.engine import engine as engine_mod

    rng = np.random.default_rng(11)
    b, n, w, t = 4, 10, 25, 24
    engines = {cb: SNNEngine(SNNEnginePlan(
        threshold=90, leak=4, n_syn=784, w_exp=None if verb == "infer"
        else 128, cycle_backend=cb), device=cuda) for cb in ("step",
                                                            "window")}
    lp = torch.tensor([16, 1023, 0, 64], dtype=torch.int32, device=cuda)
    rfs = snn_regfile_batch(as_words(rng.integers(
        0, 2**32, (b, n, w), dtype=np.uint32), cuda), [3, 5, 7, 9])
    engine_mod._graphs.clear()
    engine_mod._seen.clear()
    kept = []
    for k in range(3):
        wins = as_words(_sparse_windows(rng, b, t, w), cuda)
        teach = torch.from_numpy(rng.integers(-300, 100, (b, n))
                                 .astype(np.int32)).to(cuda)
        out = {}
        for cb, eng in engines.items():
            ops.reset_launch_counts()
            if verb == "infer":
                res = (eng.infer(rfs.weights[0], wins),)
            elif verb == "train":
                o = eng.train(type(rfs)(*(x[0] for x in rfs)), wins[0],
                              teach[0])
                res = tuple(o.regfile) + (o.fired,)
            else:
                r, counts, fired = eng.train_batch(rfs, wins, teach,
                                                   ltp_prob=lp)
                res = tuple(r) + (counts, fired)
            torch.cuda.synchronize()
            launches = ops.launch_counts()
            assert launches["fused_snn_step"] == (t if cb == "step" else 0)
            out[cb] = res
        _equal_all(out["step"], out["window"])
        assert engine_mod.step_graph_stats()["kept"] == (0 if k == 0 else 1)
        kept.append(([x.clone() for x in out["step"]], out["step"]))
        if verb == "train_batch":        # the next window starts here
            rfs = type(rfs)(*out["step"][:4])
    for snapshot, returned in kept:
        _equal_all(snapshot, returned)


# --- the LM slice: flash attention (csrc/flash_attn.cu) ---------------------

# (b, hq, hkv, d, tq, tk, causal, window): the chip smoke test's shapes
# (gemma3-1b global and local, ragged lengths, GQA non-causal, the
# starcoder2-3b width), then queries that are the last Tq of a longer
# stream, rows masked everywhere (Tq > Tk), and the small head_dims; then
# the bf16 kernel's edges: GQA group 1 at D 256 and B 2, Tq > Tk at D 256,
# windows shorter than one 64-row KV tile (17) and longer than Tk, group
# 12 at D 32, one query over one key, and one whole tile
FLASH_SHAPES = [
    (1, 4, 1, 256, 2048, 2048, True, None),
    (1, 4, 1, 256, 2048, 2048, True, 512),
    (1, 4, 1, 256, 37, 37, True, 512),
    (1, 4, 1, 256, 1000, 1000, True, 512),
    (2, 8, 2, 128, 512, 512, False, None),
    (1, 24, 2, 128, 1024, 1024, True, None),
    (2, 4, 2, 64, 70, 200, True, 50),
    (1, 2, 1, 32, 90, 60, True, None),
    (3, 6, 3, 64, 129, 129, False, 17),
    (2, 2, 2, 256, 130, 130, True, None),
    (1, 4, 1, 256, 100, 70, True, None),
    (1, 4, 1, 256, 200, 200, True, 17),
    (1, 4, 2, 128, 150, 150, True, 1000),
    (2, 12, 1, 32, 65, 65, True, 17),
    (1, 2, 1, 64, 1, 1, True, None),
    (1, 8, 8, 128, 64, 64, False, None),
]


def _flash_operands(shape, dtype, dev, seed=0):
    b, hq, hkv, d, tq, tk = shape[:6]
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)
                             ).to(dev, dtype)
            for s in ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d))]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=str)
def test_cuda_flash_attention_equals_plain_version(cuda, shape, dtype, tol):
    from repro_torch.kernels.flash_attention import flash_attention
    q, k, v = _flash_operands(shape, dtype, cuda)
    causal, window = shape[6:]
    launches = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    want = flash_attention(q, k, v, causal=causal, window=window,
                           backend="ref")
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:             # also within 1% of the output
        err = (got.float() - want.float()).abs().max()
        assert err <= 1e-2 * want.float().abs().max()
    if shape[4] > shape[5]:                 # rows masked everywhere
        assert not got[:, :, :shape[4] - shape[5]].any()


@pytest.mark.gpu
def test_cuda_flash_attention_reads_strided_views(cuda):
    """q, k, v as the transposed views of one fused projection."""
    from repro_torch.kernels.flash_attention import flash_attention
    b, t, hq, hkv, d = 2, 100, 4, 2, 64
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.standard_normal(
        (b, t, (hq + 2 * hkv) * d), dtype=np.float32)).to(cuda)
    q, k, v = qkv.split([hq * d, hkv * d, hkv * d], dim=-1)
    q, k, v = (x.reshape(b, t, -1, d).transpose(1, 2) for x in (q, k, v))
    assert not q.is_contiguous()
    got = flash_attention(q, k, v, window=30)
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           window=30)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 256])
def test_cuda_flash_f32_takes_any_alignment(cuda, d):
    """f32 q, k, v at gemma3-1b's widths as views of one fused projection,
    and the same one float off 16 bytes (the kernel then copies 4 bytes at
    a time instead of 16): both equal the call on contiguous copies."""
    from repro_torch.kernels.flash_attention import flash_attention
    b, t, hq, hkv = 2, 300, 4, 1
    rng = np.random.default_rng(3)
    flat = torch.from_numpy(rng.standard_normal(
        b * t * (hq + 2 * hkv) * d + 1, dtype=np.float32)).to(cuda)
    for off in (0, 1):
        qkv = flat[off:off + b * t * (hq + 2 * hkv) * d].view(b, t, -1)
        q, k, v = qkv.split([hq * d, hkv * d, hkv * d], dim=-1)
        q, k, v = (x.reshape(b, t, -1, d).transpose(1, 2) for x in (q, k, v))
        assert (q.data_ptr() % 16 != 0) == bool(off)
        for window in (None, 100):
            got = flash_attention(q, k, v, window=window)
            want = flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), window=window)
            torch.cuda.synchronize()
            assert torch.equal(got, want)


@pytest.mark.gpu
def test_cuda_flash_attention_reads_strided_bf16_views(cuda):
    """bf16 q, k, v as TMA reads them: the transposed views of gemma3-1b's
    fused projection (4 query heads and 1 KV head of 256, ragged T),
    equal to the call on contiguous copies."""
    from repro_torch.kernels.flash_attention import flash_attention
    b, t, hq, hkv, d = 2, 300, 4, 1, 256
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.standard_normal(
        (b, t, (hq + 2 * hkv) * d), dtype=np.float32)).to(cuda,
                                                           torch.bfloat16)
    q, k, v = qkv.split([hq * d, hkv * d, hkv * d], dim=-1)
    q, k, v = (x.reshape(b, t, -1, d).transpose(1, 2) for x in (q, k, v))
    assert not q.is_contiguous() and not v.is_contiguous()
    for window in (None, 100):
        got = flash_attention(q, k, v, window=window)
        want = flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), window=window)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_is_deterministic(cuda, dtype):
    from repro_torch.kernels.flash_attention import flash_attention
    q, k, v = _flash_operands((1, 24, 2, 128, 1024, 1024), dtype, cuda)
    first = flash_attention(q, k, v)
    second = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_cuda_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels.flash_attention import flash_attention
    q, k, v = _flash_operands((1, 4, 2, 64, 16, 16), torch.float32, cuda)
    with pytest.raises(ValueError):          # float16
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):          # head_dim 48
        flash_attention(q[..., :48], k[..., :48], v[..., :48])
    with pytest.raises(ValueError):          # 3 query heads over 2 KV heads
        flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError):          # last dimension strided
        flash_attention(q[..., ::2], k[..., ::2], v[..., ::2])
    with pytest.raises(ValueError):          # k on the CPU
        flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError):          # window 0
        flash_attention(q, k, v, window=0)
    # bf16 goes through TMA: a base on 16 bytes and strides of whole 16
    # bytes, or a ValueError (never a copy)
    wide = torch.zeros((1, 4, 16, 72), dtype=torch.bfloat16, device=cuda)
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    with pytest.raises(ValueError):          # base 2 bytes off
        flash_attention(wide[..., 1:65], kb, vb)
    with pytest.raises(ValueError):          # rows 136 bytes apart
        flash_attention(qb, kb, torch.zeros(
            (1, 2, 16, 68), dtype=torch.bfloat16, device=cuda)[..., :64])
    assert flash_attention(wide[..., 8:72], kb, vb).shape == qb.shape


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma3-1b", "starcoder2-3b"])
def test_cuda_lm_serving_equals_the_cpu_run(cuda, arch):
    """reduced LM served greedily on the card (prefill through the flash
    kernel, one launch per layer per prefill) and on the CPU: the same
    tokens."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models.transformer import Model
    from repro_torch.serving import Request, ServingEngine
    cfg = reduced(get_config(arch))
    assert Model(cfg, torch.float32, seed=None).device.type == "cuda"
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        model = Model(cfg, torch.float32, attn_chunk=16, device="cpu",
                      seed=3).to(dev)
        eng = ServingEngine(model, n_slots=2, max_len=64)
        reqs = [Request(rid=i, prompt=list(range(1 + i, 30 + 7 * i)),
                        max_new_tokens=6) for i in range(3)]
        ops.reset_launch_counts()
        eng.run(reqs)
        assert all(r.done for r in reqs)
        launches = ops.launch_counts()["flash_attention"]
        assert launches == (cfg.n_layers * len(reqs) if dev == cuda else 0)
        outs[dev.type] = [r.output for r in reqs]
    assert outs["cuda"] == outs["cpu"]


# --- the serving stack on the card -------------------------------------------

def _stack_rows(n=14, n_in=100, words=4, seed=1):
    """Ragged intensity requests (T 5 to 16) with some pre-packed windows."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        t = (5, 9, 12, 16)[i % 4]
        if i % 4 == 1:
            rows.append(dict(rid=i, window=rng.integers(
                0, 2**32, (t, words), dtype=np.uint32)
                & rng.integers(0, 2**32, (t, words), dtype=np.uint32)))
        else:
            rows.append(dict(rid=i, intensities=rng.integers(
                0, 256, (n_in,), dtype=np.uint8), n_steps=t))
    return rows


def _stack_oracle(bank, r, threshold, leak):
    from repro_torch.core.encoder import encode_windows_host
    if r.window is not None:
        win = as_words(r.window[None])
    else:
        win = encode_windows_host(r.seed, torch.from_numpy(
            r.intensities)[None], r.n_steps, bank.shape[1])
    return ops.infer_window_batch(as_words(bank).cpu(), win,
                                  threshold=threshold, leak=leak,
                                  backend="ref")[0].numpy()


@pytest.mark.gpu
def test_cuda_step_plan_serves_like_the_window_plan(cuda):
    """A step plan on the card serves host-encoded windows through the
    fused step kernel: the same statuses and counts as a window plan on
    the card and as the step plan's plain run on the CPU."""
    from repro_torch.engine import SNNEnginePlan
    from repro_torch.serving import SNNRequest, SNNServingEngine
    bank = np.random.default_rng(0).integers(0, 2**32, (20, 4),
                                             dtype=np.uint32)
    kw = dict(threshold=40, leak=3, w_exp=None, max_batch=3)
    runs = {}
    for name, plan, dev in (
            ("window", SNNEnginePlan(encode="kernel", **kw), cuda),
            ("step", SNNEnginePlan(cycle_backend="step", **kw), cuda),
            ("cpu", SNNEnginePlan(cycle_backend="step", **kw), "cpu")):
        ops.reset_launch_counts()
        eng = SNNServingEngine(bank, plan, device=dev)
        reqs = eng.run([SNNRequest(**r) for r in _stack_rows()])
        runs[name] = (reqs, ops.launch_counts())
    step_reqs, launches = runs["step"]
    assert launches["fused_snn_step"] > 0
    assert launches["infer_window_batch_encode"] == 0
    for name in ("window", "cpu"):
        assert [r.status for r in runs[name][0]] == \
            [r.status for r in step_reqs]
    for r, w, c in zip(step_reqs, runs["window"][0], runs["cpu"][0]):
        assert r.status == "SERVED"
        np.testing.assert_array_equal(r.counts, w.counts)
        np.testing.assert_array_equal(r.counts, c.counts)
        np.testing.assert_array_equal(r.counts,
                                      _stack_oracle(bank, r, 40, 3))


@pytest.mark.gpu
@pytest.mark.parametrize("encode", ["kernel", "host"])
def test_cuda_fault_storm_serves_only_exact_counts(cuda, encode):
    """A seeded storm on the card (launch failures past the retry budget,
    corrupted counts, stalls): every request terminal, every SERVED count
    equal to the plain oracle, recovery counters nonzero."""
    from repro_torch.engine import SNNEnginePlan
    from repro_torch.loadgen.runner import make_clock
    from repro_torch.serving import (FaultInjector, FaultSpec, SNNRequest,
                                     SNNServingEngine, SNNServingPolicy)
    bank = np.random.default_rng(2).integers(0, 2**32, (20, 4),
                                             dtype=np.uint32)
    inj = FaultInjector(FaultSpec(p_launch_error=0.35, p_corrupt=0.5,
                                  p_stall=0.2, stall_ms=0.5, error_burst=3,
                                  seed=11))
    eng = SNNServingEngine(
        bank, SNNEnginePlan(threshold=40, leak=3, w_exp=None, max_batch=3,
                            encode=encode),
        policy=SNNServingPolicy(max_retries=1, canary_every=2,
                                reprobe_after=2),
        on_launch=inj, clock=make_clock("virtual"), device=cuda)
    reqs = eng.run([SNNRequest(**r) for r in _stack_rows(24, seed=3)])
    assert all(r.terminal for r in reqs)
    for r in reqs:
        if r.status == "SERVED":
            np.testing.assert_array_equal(r.counts,
                                          _stack_oracle(bank, r, 40, 3))
    st = eng.stats()
    assert st["retried"] > 0 and st["canary_checks"] > 0
    assert inj.errors > 0 and st["windows_served"] > 0
    assert st["degraded"] > 0 or encode == "host"


@pytest.mark.gpu
def test_cuda_train_while_serving_equals_the_cpu_run(cuda, tmp_path):
    """Probe-gated refresh on the card (the stream kernel trains each
    candidate; the probe and the canary run the serving kernels) with a
    corrupt candidate: the same promotions, rejections and state_dir
    bytes as the plain run on the CPU, counts exact under the version
    each batch pinned, and a second engine over the state_dir restores
    the newest version."""
    from repro_torch.engine import SNNEnginePlan
    from repro_torch.loadgen.runner import make_clock
    from repro_torch.serving import (FaultInjector, FaultSpec,
                                     SNNRefreshPolicy, SNNRequest,
                                     SNNServingEngine, SNNServingPolicy,
                                     SNNWeightRefresher)
    n_cls, n_in, t = 4, 64, 16
    labels = np.arange(64) % n_cls
    inten = np.zeros((64, n_in), np.uint8)
    for i, c in enumerate(labels):
        inten[i, c * 16:(c + 1) * 16] = 200
    plan = SNNEnginePlan(threshold=24, leak=2, w_exp=128, n_syn=n_in,
                         encode="kernel", max_batch=4, t_chunk=8)
    nc = np.tile(np.arange(n_cls), 2)
    bank = np.random.default_rng(0).integers(0, 2**32, (8, 2),
                                             dtype=np.uint32)
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        ops.reset_launch_counts()
        rf = SNNWeightRefresher(
            plan, inten, labels, n_classes=n_cls,
            probe_intensities=inten[:16], probe_labels=labels[:16],
            neuron_class=nc, n_steps=t, device=dev,
            policy=SNNRefreshPolicy(refresh_every=2, probe_size=16,
                                    refresh_samples=16))
        sd = tmp_path / dev.type
        eng = SNNServingEngine(
            bank, plan, neuron_class=nc, refresher=rf, state_dir=str(sd),
            keep_versions=64, clock=make_clock("virtual"),
            policy=SNNServingPolicy(canary_every=2), device=dev,
            on_launch=FaultInjector(FaultSpec(p_refresh_corrupt=0.3,
                                              seed=4)))
        reqs = eng.run([SNNRequest(rid=i, intensities=inten[i], n_steps=t)
                        for i in range(40)])
        for r in reqs:
            assert r.status == "SERVED"
            ver = eng.store.get(r.served_version)
            np.testing.assert_array_equal(
                r.counts, _stack_oracle(ver.weights.cpu(), r, 24, 2))
        st = eng.stats()
        st.pop("mean_step_ms"), st.pop("last_step_ms")
        runs[dev.type] = (st, [r.served_version for r in reqs],
                          {p.relative_to(sd): p.read_bytes()
                           for p in sorted(sd.rglob("*")) if p.is_file()},
                          ops.launch_counts())
        again = SNNServingEngine(np.zeros((8, 2), np.uint32), plan,
                                 state_dir=str(sd), device=dev)
        assert again.store.serving.fingerprint == \
            eng.store.serving.fingerprint
    card, cpu = runs["cuda"], runs["cpu"]
    assert card[3]["train_window_batch_encode"] >= card[0]["refresh_runs"] \
        - card[0]["refresh_failed"] > 0
    assert card[3]["infer_window_batch_encode"] > 0
    assert card[3]["infer_window_batch"] > 0
    st = card[0]
    assert st["versions_promoted"] >= 1 and st["refresh_corrupt"] >= 1
    # the card's ladder has no plain rung: one breaker fewer
    assert st.pop("breaker_states") == cpu[0].pop("breaker_states")[:-1]
    assert card[:3] == cpu[:3]


# --- placement on a device grid (repro_torch.distributed.snn_mesh) ----------

def _mesh_operands(dev, n=13, w=25, t=72, b=6, n_in=784):
    from repro_torch.core import lfsr

    rng = np.random.default_rng(n * b)
    o = dict(
        weights=as_words(rng.integers(0, 2**32, (n, w), dtype=np.uint32),
                         dev),
        trains=as_words(_sparse_windows(rng, b, t, w), dev),
        v=torch.zeros((n,), dtype=torch.int32, device=dev),
        teach=torch.from_numpy(rng.integers(-50, 50, (n,), dtype=np.int32)
                               ).to(dev),
        lfsr=lfsr.seed(7, n * w, device=dev).reshape(n, w),
        inten=torch.from_numpy(rng.integers(0, 256, (b, n_in),
                                            dtype=np.uint8)).to(dev),
        seeds=torch.from_numpy(np.resize(SEEDS, b)).to(dev),
        t_total=torch.from_numpy(rng.integers(1, t + 1, b).astype(np.int32)
                                 ).to(dev),
        wts_b=as_words(rng.integers(0, 2**32, (b, n, w), dtype=np.uint32),
                       dev),
        v_b=torch.zeros((b, n), dtype=torch.int32, device=dev),
        teach_b=torch.from_numpy(rng.integers(-50, 50, (b, n),
                                              dtype=np.int32)).to(dev),
        lfsr_b=torch.stack([lfsr.seed(3 + i, n * w, device=dev)
                            .reshape(n, w) for i in range(b)]),
        ltp_b=torch.tensor(np.resize([16, 1023, 500], b), dtype=torch.int32,
                           device=dev))
    return o


def _mesh_calls(o, t, n_syn):
    """(op name, args, kwargs) of every wrapper at the operands ``o``."""
    kw = dict(threshold=90, leak=3, w_exp=128, gain=4, n_syn=n_syn)
    x3 = o["inten"][None].expand(3, -1, -1)
    return [
        ("infer_window_batch", (o["weights"], o["trains"]),
         dict(threshold=90, leak=3)),
        ("fused_snn_window", (o["weights"], o["trains"][1], o["v"],
                              o["lfsr"], o["teach"]),
         dict(kw, ltp_prob=200, train=True)),
        ("fused_snn_window", (o["weights"], o["trains"][1], o["v"],
                              o["lfsr"], o["teach"]),
         dict(kw, ltp_prob=200, train=False)),
        ("train_window_batch", (o["wts_b"], o["trains"], o["v_b"],
                                o["lfsr_b"], o["teach_b"]),
         dict(kw, ltp_prob=o["ltp_b"])),
        ("infer_window_batch_encode", (o["weights"], o["inten"], o["seeds"]),
         dict(n_steps=t, threshold=90, leak=3, t_total=o["t_total"])),
        ("fused_snn_window_encode", (o["weights"], o["inten"][0], 9, o["v"],
                                     o["lfsr"], o["teach"]),
         dict(kw, n_steps=t, ltp_prob=200, train=True)),
        ("fused_snn_window_encode", (o["weights"], o["inten"][0], 9, o["v"],
                                     o["lfsr"], o["teach"]),
         dict(kw, n_steps=t, ltp_prob=200, train=False)),
        ("train_window_batch_encode", (o["wts_b"], o["inten"], o["seeds"],
                                       o["v_b"], o["lfsr_b"], o["teach_b"]),
         dict(kw, n_steps=t, ltp_prob=o["ltp_b"])),
        ("train_stream_batch_encode", (o["wts_b"], x3, o["seeds"][:3],
                                       o["lfsr_b"],
                                       o["teach_b"][None].expand(3, -1, -1)),
         dict(kw, n_steps=t, ltp_prob=o["ltp_b"])),
    ]


# the kernel each wrapper launches (and counts under); a read-only
# window (train=False) counts under its own name
_COUNTED = {"fused_snn_window": "train_window_batch",
            "fused_snn_window_encode": "train_window_batch_encode",
            "train_stream_batch_encode": "train_window_batch_encode"}


@pytest.mark.gpu
@pytest.mark.parametrize("grid", ["1d-4", "2x2", "4x1"])
@pytest.mark.parametrize("n,w,t,b,n_in", [(13, 25, 72, 6, 784),
                                          (40, 25, 16, 32, 784),
                                          (130, 128, 8, 3, 4096)])
def test_cuda_grid_wrappers_equal_the_unsharded_kernels(cuda, grid, n, w, t,
                                                        b, n_in):
    """Every wrapper with every shard on one card (``cuda:0`` named 4
    times), against the unsharded kernel op: ``torch.equal`` outputs and
    one launch per shard."""
    from repro_torch.distributed import snn_mesh

    dev = torch.device("cuda", 0)
    mesh = (snn_mesh.snn_mesh(4, devices=[dev] * 4) if grid == "1d-4" else
            snn_mesh.snn_mesh2d(*map(int, grid.split("x")),
                                devices=[dev] * 4))
    o = _mesh_operands(dev, n, w, t, b, n_in)
    for name, args, kw in _mesh_calls(o, t, n_in):
        want = getattr(ops, name)(*args, **kw)
        counted = (name if not kw.get("train", True)
                   else _COUNTED.get(name, name))
        ops.reset_launch_counts()
        got = getattr(snn_mesh, f"sharded_{name}")(*args, mesh=mesh, **kw)
        torch.cuda.synchronize()
        assert getattr(ops, counted).launches == 4, (name, kw.get("train"))
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, r in zip(got, want, strict=True):
            assert g.device == dev and torch.equal(g, r), name


@pytest.mark.gpu
def test_cuda_meshed_engine_and_trainer_equal_the_local_ones(cuda):
    import dataclasses

    from repro_torch.configs.wenquxing_snn import WENQUXING_22A_MESH2D
    from repro_torch.core.trainer import train
    from repro_torch.data.digits import make_digits
    from repro_torch.distributed import snn_mesh
    from repro_torch.engine import SNNEngine, SNNEnginePlan

    dev = torch.device("cuda", 0)
    grid = snn_mesh.snn_mesh2d(2, 2, devices=[dev] * 4)
    o = _mesh_operands(dev, 40, 25, 72, 32)
    for encode in ("kernel", "host"):
        plan = SNNEnginePlan(threshold=90, leak=3, n_syn=784, encode=encode)
        local = SNNEngine(plan, device="cuda")
        meshed = SNNEngine(dataclasses.replace(plan, mesh=grid),
                           device="cuda")
        for kw in (dict(windows=o["trains"]),
                   dict(intensities=o["inten"], seeds=o["seeds"],
                        n_steps=72, t_total=o["t_total"])):
            assert torch.equal(meshed.infer(o["weights"], **kw),
                               local.infer(o["weights"], **kw))
    # a grid larger than the visible cards raises; named devices do not
    with pytest.raises(ValueError):
        SNNEngine(dataclasses.replace(plan, mesh_shape=(
            torch.cuda.device_count() + 1, 1)), device="cuda")
    imgs, labels = make_digits(24, seed=5)
    x = imgs.reshape(24, -1).astype(np.float32)
    cfg = dataclasses.replace(WENQUXING_22A_MESH2D, n_steps=16, epochs=1)
    ops.reset_launch_counts()
    m = train(cfg, x, labels, device="cuda",
              mesh=snn_mesh.snn_mesh2d(2, 4, devices=[dev] * 8))
    assert ops.launch_counts()["train_window_batch_encode"] == 8
    loc = train(dataclasses.replace(cfg, mesh_shape=None), x, labels,
                device="cuda")
    assert torch.equal(m.weights, loc.weights)
    assert torch.equal(m.neuron_class, loc.neuron_class)
