"""The port's flash attention on the CPU against the JAX package's.

On a CPU tensor ``flash_attention`` runs its plain version, which must
match the JAX package's Pallas kernel run in interpret mode at the
shapes of ``tests/test_kernels_attention.py`` (plus head_dim 256, as in
gemma3-1b) and both packages' dense ``attention_ref`` at ragged lengths
the Pallas kernel cannot take.  atol = rtol = 2e-5, as in the JAX
package's own test.  The CUDA kernel runs only on a card:
``test_torch_cuda.py`` holds it against this plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.ref import attention_ref as jattention_ref
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import attention_ref

TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(seed, b, hq, hkv, tq, tk, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d))]


def _port(q, k, v, **kw):
    return flash_attention(*map(torch.from_numpy, (q, k, v)), **kw).numpy()


@pytest.mark.parametrize("b,hq,hkv,t,d", [
    (1, 2, 2, 128, 64),
    (2, 4, 2, 256, 64),   # GQA group 2
    (1, 8, 1, 128, 128),  # MQA
    (1, 4, 1, 128, 256),  # gemma3-1b's head_dim and group
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_matches_the_pallas_kernel(b, hq, hkv, t, d, causal):
    q, k, v = _qkv(0, b, hq, hkv, t, t, d)
    launches = ops.launch_counts()["flash_attention"]
    got = _port(q, k, v, causal=causal)
    assert ops.launch_counts()["flash_attention"] == launches
    want = jflash(*map(jnp.asarray, (q, k, v)), causal=causal, block_q=64,
                  block_k=64, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("window", [64, 128])
def test_plain_flash_sliding_window_matches_the_pallas_kernel(window):
    q, k, v = _qkv(1, 1, 4, 2, 256, 256, 64)
    got = _port(q, k, v, causal=True, window=window)
    want = jflash(*map(jnp.asarray, (q, k, v)), causal=True, window=window,
                  block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("tq,tk,causal,window", [
    (37, 37, True, 16), (100, 100, True, None), (23, 61, True, 9),
    (45, 45, False, None), (29, 70, False, 12)])
def test_plain_flash_at_ragged_lengths_matches_attention_ref(tq, tk, causal,
                                                             window):
    q, k, v = _qkv(2, 2, 4, 1, tq, tk, 32)
    got = _port(q, k, v, causal=causal, window=window)
    want = jattention_ref(*map(jnp.asarray, (q, k, v)), causal=causal,
                          window=window)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    mine = attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal,
                         window=window)
    np.testing.assert_allclose(mine.numpy(), np.asarray(want), **TOL)


def test_plain_flash_gives_zeros_for_rows_masked_everywhere():
    """Tq > Tk: the first Tq - Tk queries sit before the stream starts."""
    q, k, v = _qkv(3, 1, 2, 1, 20, 12, 32)
    got = _port(q, k, v, causal=True)
    assert not got[:, :, :8].any()
    want = jattention_ref(*map(jnp.asarray, (q, k, v)), causal=True)
    np.testing.assert_allclose(got[:, :, 8:], np.asarray(want)[:, :, 8:],
                               **TOL)


def test_plain_flash_bf16_close_to_f32():
    q, k, v = _qkv(4, 1, 2, 2, 128, 128, 64)
    got = flash_attention(*(torch.from_numpy(x).bfloat16()
                            for x in (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    want = jattention_ref(*(jnp.asarray(x).astype(jnp.bfloat16)
                            .astype(jnp.float32) for x in (q, k, v)),
                          causal=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               atol=3e-2, rtol=3e-2)


def test_wrapper_takes_no_other_backend():
    q, k, v = map(torch.from_numpy, _qkv(5, 1, 2, 2, 8, 8, 32))
    with pytest.raises(ValueError):
        flash_attention(q, k, v, backend="tpu")


def _fused(t: int, hq: int, hkv: int, d: int):
    """q, k as the transposed views of one fused qkv projection."""
    qkv = torch.zeros(1, t, (hq + 2 * hkv) * d)
    q, k, _ = qkv.split([hq * d, hkv * d, hkv * d], dim=-1)
    return (q.reshape(1, t, hq, d).transpose(1, 2),
            k.reshape(1, t, hkv, d).transpose(1, 2))


@pytest.mark.parametrize("make,want", [
    (lambda: _fused(5, 4, 1, 256)[0], [1024, 256, 1536]),
    (lambda: _fused(5, 4, 1, 256)[1], [7680, 7680, 1536]),
    (lambda: torch.zeros(2, 3, 8, 64)[:, :, 3:4], [1536, 512, 64]),
    (lambda: torch.empty_strided((1, 2, 4, 32), (3, 128, 32, 1)),
     [256, 128, 32]),
], ids=["fused-q", "fused-k-one-head", "one-row", "odd-batch-stride"])
def test_kernel_strides_are_the_callers_with_size_one_dims_packed(make,
                                                                   want):
    """The batch, head and row strides the wrapper hands the kernel: the
    caller's, except that a dimension of size 1, never stepped, takes a
    packed layout's (TMA needs whole 16 bytes whatever torch gives it)."""
    from repro_torch.kernels.flash_attention import _strides

    assert _strides(make()) == want


def test_decode_wrapper_sends_cpu_tensors_and_ref_to_the_plain_version(
        monkeypatch):
    """``decode_attention`` runs ``decode_attention_ref`` for CPU tensors
    and for ``backend="ref"``, launching nothing, and takes no other
    backend."""
    from repro_torch.kernels import decode_attention as mod

    calls, ref = [], mod.decode_attention_ref

    def plain(*args, **kwargs):
        calls.append(kwargs["window"])
        return ref(*args, **kwargs)

    monkeypatch.setattr(mod, "decode_attention_ref", plain)
    q, k, v = map(torch.from_numpy, _qkv(6, 2, 4, 2, 1, 24, 32))
    lens = torch.tensor([5, 24])
    before = ops.launch_counts()
    want = plain(q, k, v, lens, window=8)
    calls.clear()
    for kw in ({}, {"backend": "ref"}):
        got = mod.decode_attention(q, k, v, lens, window=8, **kw)
        assert torch.equal(got, want)
    assert calls == [8, 8]
    assert ops.launch_counts() == before
    assert before["decode_attention"] == mod.decode_attention.launches
    with pytest.raises(ValueError):
        mod.decode_attention(q, k, v, lens, backend="tpu")


@pytest.mark.parametrize("cache_len,want", [
    (7, (0, None, 0, 7)),
    (np.int32(7), (0, None, 0, 7)),
    (torch.tensor(7), (0, None, 0, 7)),
    (torch.tensor([3, 9], dtype=torch.int32), (1, [3, 9], 1, 0)),
    (torch.tensor([3, 9, 4, 1])[::2], (2, [3, 4], 2, 0)),
], ids=["int", "numpy-int", "host-scalar", "int32-rows", "strided-int64"])
def test_decode_lengths_as_the_kernel_reads_them(cache_len, want):
    """A length on the host for every row is passed by value; per-row
    lengths stay a tensor (kind 1: int32, 2: int64) with their stride."""
    from repro_torch.kernels.decode_attention import _lengths

    kind, lens, stride, value = _lengths(cache_len, 2, torch.device("cpu"))
    got = (kind, None if lens is None else lens.tolist(), stride, value)
    assert got == want


@pytest.mark.parametrize("cache_len", [
    torch.tensor([3.0, 9.0]), torch.tensor([3, 9, 4]),
    torch.tensor([[3], [9]])])
def test_decode_lengths_refuse_what_the_kernel_does_not_read(cache_len):
    from repro_torch.kernels.decode_attention import _lengths

    with pytest.raises(ValueError):
        _lengths(cache_len, 2, torch.device("cpu"))
