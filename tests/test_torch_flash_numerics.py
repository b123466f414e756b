"""The flash kernels' tensor-core arithmetic, modelled on the CPU.

``flash_wgmma_kernel`` (``csrc/flash_attn.cu``) multiplies bf16 q and k
on the tensor cores into f32 scores, scales them in f32 after the
product (log2 e folded in, exp2), runs the online softmax over 64-row KV
tiles in f32, rounds p to bf16 as the A operand of P V, accumulates O in
f32 and rounds o to bf16.  The model below does the same in plain
PyTorch; held against the plain version ``flash_attention_ref`` (f32
throughout, q scaled before the product) it stays within the kernel's
unchanged bf16 tolerances, atol = rtol = 3e-2 and 1e-2 of the output's
largest magnitude, at gemma3-1b's head dim and group and at the
starcoder2-3b width.

``flash_fwd_kernel`` (f32) runs both products on the tensor cores in
split TF32: each operand x is split into big = tf32(x) and small =
tf32(x - big), rounded as ``cvt.rna.tf32.f32`` rounds (10 mantissa bits,
to nearest, ties away from zero), and each product is big.big +
big.small + small.big with f32 sums; p is split too.  Its model below
holds the unchanged f32 tolerance, atol = rtol = 1e-4, against the plain
version and against the JAX package's Pallas kernel in interpret mode,
where one TF32 product alone does not.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels.flash_attention import flash_attention_ref

BLOCK_KV = 64
ATOL = RTOL = 3e-2
REL = 1e-2


def tensor_core_model(q, k, v, *, causal, window, p_dtype=torch.bfloat16):
    """bf16 q [B, Hq, Tq, D], k, v [B, Hkv, Tk, D] -> bf16 o with the
    kernel's rounding points (``p_dtype``: what p is rounded to before
    P V)."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, hkv, hq // hkv, tq, d)
    kf, vf = k.float(), v.float()
    scale_log2 = d ** -0.5 * math.log2(math.e)
    qpos = torch.arange(tq)[:, None] + (tk - tq)
    m = torch.full((b, hkv, hq // hkv, tq, 1), -1e30)
    l = torch.zeros_like(m)
    o = torch.zeros((b, hkv, hq // hkv, tq, d))
    for k0 in range(0, tk, BLOCK_KV):
        kt, vt = kf[:, :, k0:k0 + BLOCK_KV], vf[:, :, k0:k0 + BLOCK_KV]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kt) * scale_log2
        kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        mask = torch.ones((tq, kt.shape[2]), dtype=torch.bool)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        s = s.masked_fill(~mask, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new) * mask
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + torch.einsum("bhgqk,bhkd->bhgqd",
                                     p.to(p_dtype).float(), vt)
        m = m_new
    o = o / torch.where(l == 0.0, 1.0, l)
    return o.reshape(b, hq, tq, d).bfloat16()


def _qkv(seed, b, hq, hkv, t, d):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
            .bfloat16() for s in ((b, hq, t, d), (b, hkv, t, d),
                                  (b, hkv, t, d))]


@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("t", [100, 256])
@pytest.mark.parametrize("hq,hkv,d", [(4, 1, 256), (24, 2, 128)],
                         ids=["gemma3-1b", "starcoder2-3b"])
def test_tensor_core_rounding_within_bf16_tolerance(hq, hkv, d, t, window):
    q, k, v = _qkv(t + d, 1, hq, hkv, t, d)
    got = tensor_core_model(q, k, v, causal=True, window=window).float()
    want = flash_attention_ref(q, k, v, causal=True, window=window).float()
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    assert (got - want).abs().max() <= REL * want.abs().max()


def test_p_in_bf16_is_the_models_only_departure():
    """With p kept in f32 the model is the plain version up to one bf16
    rounding of the output; rounding p to bf16 is what moves it further."""
    q, k, v = _qkv(7, 1, 4, 1, 130, 64)
    want = flash_attention_ref(q, k, v, causal=True, window=None).float()
    exact_p = tensor_core_model(q, k, v, causal=True, window=None,
                                p_dtype=torch.float32).float()
    torch.testing.assert_close(exact_p, want, atol=1e-6, rtol=2 ** -7)
    bf16_p = tensor_core_model(q, k, v, causal=True, window=None).float()
    assert (bf16_p - want).abs().max() > (exact_p - want).abs().max()


# --- f32: split TF32 on the tensor cores ------------------------------------

F32_TOL = dict(atol=1e-4, rtol=1e-4)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to TF32 as the kernel does it (``tf32_rna``): add half
    of the 13 dropped bits' weight to the bit pattern, then clear them."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def split_tf32_model(q, k, v, *, causal, window, split=True):
    """f32 q [B, Hq, Tq, D], k, v [B, Hkv, Tk, D] -> f32 o with the
    kernel's products (three TF32 products of split operands, or one of
    plain TF32 ones where ``split`` is False), its KV tiles (32 rows at
    D >= 128, else 64) and its online softmax in the log2 domain."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    block_kv = 32 if d >= 128 else 64

    def mm(eq, x, y):
        if not split:
            return torch.einsum(eq, tf32_rna(x), tf32_rna(y))
        xb, xs = split_tf32(x)
        yb, ys = split_tf32(y)
        return torch.einsum(eq, xb, yb) + (torch.einsum(eq, xb, ys)
                                           + torch.einsum(eq, xs, yb))

    qf = q.float().reshape(b, hkv, hq // hkv, tq, d)
    scale_log2 = d ** -0.5 * math.log2(math.e)
    qpos = torch.arange(tq)[:, None] + (tk - tq)
    m = torch.full((b, hkv, hq // hkv, tq, 1), -1e30)
    l = torch.zeros_like(m)
    o = torch.zeros((b, hkv, hq // hkv, tq, d))
    for k0 in range(0, tk, block_kv):
        kt, vt = k[:, :, k0:k0 + block_kv], v[:, :, k0:k0 + block_kv]
        s = mm("bhgqd,bhkd->bhgqk", qf, kt) * scale_log2
        kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        mask = torch.ones((tq, kt.shape[2]), dtype=torch.bool)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        s = s.masked_fill(~mask, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new) * mask
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + mm("bhgqk,bhkd->bhgqd", p, vt)
        m = m_new
    o = o / torch.where(l == 0.0, 1.0, l)
    return o.reshape(b, hq, tq, d)


def _qkv32(seed, b, hq, hkv, t, d):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
            for s in ((b, hq, t, d), (b, hkv, t, d), (b, hkv, t, d))]


def test_tf32_rna_rounds_to_nearest_ties_away():
    """Against the rounding done in float64 on the significand: 11
    significant bits, halves away from zero (normal numbers, both signs,
    exact ties included)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal(4096).astype(np.float32) * np.float32(
        2.0) ** rng.integers(-60, 60, 4096).astype(np.float32)
    ties = (np.float32(1.0) + np.float32(2.0 ** -11)) * np.float32(
        [1, -1, 3.0 / 2 ** 10, -7.0 * 2 ** 20])
    x = np.concatenate([x, ties]).astype(np.float32)
    mant, exp = np.frexp(x.astype(np.float64))             # |mant| in [0.5, 1)
    want = np.ldexp(np.sign(mant) * np.floor(np.abs(mant) * 2 ** 11 + 0.5),
                    exp - 11).astype(np.float32)
    got = tf32_rna(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (np.abs(got[-4:]) > np.abs(x[-4:])).all()       # ties away


@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("t", [100, 256])
@pytest.mark.parametrize("hq,hkv,d", [(4, 1, 256), (24, 2, 128)],
                         ids=["gemma3-1b", "starcoder2-3b"])
def test_split_tf32_within_f32_tolerance(hq, hkv, d, t, window):
    q, k, v = _qkv32(t + d, 1, hq, hkv, t, d)
    got = split_tf32_model(q, k, v, causal=True, window=window)
    want = flash_attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got, want, **F32_TOL)


def test_one_tf32_product_misses_the_f32_tolerance():
    """The split is what keeps f32's accuracy: with plain TF32 operands
    (one product) the same model leaves the 1e-4 tolerance."""
    q, k, v = _qkv32(356, 1, 4, 1, 100, 256)
    want = flash_attention_ref(q, k, v, causal=True, window=None)
    split = split_tf32_model(q, k, v, causal=True, window=None)
    plain = split_tf32_model(q, k, v, causal=True, window=None, split=False)
    assert not torch.allclose(plain, want, **F32_TOL)
    assert (split - want).abs().max() < (plain - want).abs().max() / 10


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 64)])
def test_split_tf32_matches_the_pallas_kernel(causal, window):
    q, k, v = _qkv32(5, 1, 4, 2, 128, 64)
    got = split_tf32_model(q, k, v, causal=causal, window=window)
    want = jflash(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                  causal=causal, window=window, block_q=64, block_k=64,
                  interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
