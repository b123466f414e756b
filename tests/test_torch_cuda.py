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
@pytest.mark.parametrize("n,words,encode", [(40, 25, True), (1000, 2048, True),
                                            (1000, 2048, False),
                                            (7, 1, False)])
def test_tile_rows_fit_shared_memory(cuda, n, words, encode):
    rows = ops.tile_rows(n, words, encode)
    props = torch.cuda.get_device_properties(cuda)
    limit = props.shared_memory_per_block_optin
    assert 1 <= rows <= n
    assert ops.smem_bytes(rows, words, encode) <= limit


@pytest.mark.gpu
def test_tile_rows_rejects_rows_wider_than_shared_memory(cuda):
    assert ops.tile_rows(4, 8192, encode=True) == 0
    w = torch.zeros((4, 8192), dtype=torch.int32, device=cuda)
    x = torch.zeros((1, 64), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ops.infer_window_batch_encode(w, x, 0, n_steps=2, threshold=1,
                                      leak=0)


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
    assert ops.launch_counts() == {"infer_window_batch_encode": 0,
                                   "infer_window_batch": 0}


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
                                   "infer_window_batch": 1}
    inten = torch.from_numpy(np.stack([r.intensities for r in reqs]))
    seeds = torch.tensor([r.seed for r in reqs])
    tt = torch.tensor([r.n_steps for r in reqs], dtype=torch.int32)
    want = infer_window_batch_ref(
        as_words(bank), encode_windows_host(seeds, inten, 16, 4, tt),
        40, 3)
    assert np.array_equal(np.stack([r.counts for r in reqs]), want.numpy())
