"""The bf16 tensor-core flash kernel's rounding, modelled on the CPU.

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
"""

import math

import numpy as np
import pytest
import torch

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
