"""Decode attention: the CUDA kernel's wrapper and its plain version.

    decode_attention(q, k_cache, v_cache, cache_len, window=)
      tensor on a CUDA card -> csrc/decode_attn.cu (launches or raises)
      tensor elsewhere      -> decode_attention_ref, the plain version
                               (the CPU; ``meta`` in the dry run)
      backend="ref"         -> the plain version on any device

q [B, Hq, 1, D] against caches [B, Hkv, S, D] -> [B, Hq, 1, D] in q's
dtype.  ``cache_len`` is an int or an int[B] (per sequence: continuous
batching) count of valid positions, the new token's k and v already
written at ``cache_len - 1``; ``window`` masks positions at or before
``cache_len - 1 - window``.  The KV head of query head h is
h // (Hq // Hkv).  The kernel reads each sequence's live positions of the
cache once, in place, converting each element to float32 in registers;
scores, softmax and P V are float32, as in the plain version, which
upcasts the whole cache and masks afterwards.  It takes bf16 or float32
(q, k and v alike), head_dim 32, 64, 128 or 256, any GQA group, q with
any strides whose last one is 1, and caches whose base is 16-byte aligned
and whose strides are whole 16 bytes, the last one 1 (its 16-byte copies
need it).  ``cache_len`` stays on the device: the wrapper never reads it
(no sync), and picks the kernel's split of the positions from the shapes
alone.  The wrapper counts its launches in ``decode_attention.launches``
(``ops.launch_counts()`` lists it); a call whose positions are split
launches a second, small kernel that merges the splits, counted with it.
The kernel has no backward: on a card, under grad mode with a q, k or v
that requires grad, the wrapper raises (the plain version keeps
autograd).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels.flash_attention import _strides

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128, 256)
_LEN_KINDS = {torch.int32: 1, torch.int64: 2}
_MAX_GRID = 65_535          # query heads ride grid y, batch grid z
_NEG_INF = -1e30


def decode_attention_ref(q, k_cache, v_cache, cache_len, *, window=None):
    """The kernel's function in plain PyTorch: single-token attention
    over a cache, the whole cache upcast to float32 and masked after the
    product."""
    b, hq, _, d = q.shape
    hkv, s_len = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    scale = d ** -0.5
    cl = torch.as_tensor(cache_len, device=q.device)
    if cl.ndim == 1:
        cl = cl[:, None, None, None]
    qg = (q.float() * scale).reshape(b, hkv, group, d)
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k_cache.float())
    k_pos = torch.arange(s_len, device=q.device)
    mask = k_pos[None, None, None, :] < cl
    if window is not None:
        mask = mask & (k_pos[None, None, None, :] > cl - 1 - window)
    s = torch.where(mask, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    return out.reshape(b, hq, 1, d).to(q.dtype)


def _check(q, k, v, window) -> None:
    """Raise on what the kernel does not take."""
    what = "decode_attention"
    for name, t in (("q", q), ("k_cache", k), ("v_cache", v)):
        if t.device != q.device:
            raise ValueError(f"{what}: {name} is on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{what}: {name} is {t.dtype}, q {q.dtype}")
        if t.ndim != 4 or t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} must be 4-D with a "
                             f"contiguous last dimension, got shape "
                             f"{tuple(t.shape)} strides {t.stride()}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{what}: dtype must be float32 or bfloat16, got "
                         f"{q.dtype}")
    b, hq, one, d = q.shape
    if one != 1:
        raise ValueError(f"{what}: q must hold one token a sequence, got "
                         f"shape {tuple(q.shape)}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{what}: k_cache {tuple(k.shape)} and v_cache "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if hq % k.shape[1]:
        raise ValueError(f"{what}: {hq} query heads are not a multiple of "
                         f"{k.shape[1]} KV heads")
    if k.shape[2] < 1:
        raise ValueError(f"{what}: the cache holds no position")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {d} not in {_HEAD_DIMS}")
    if hq > _MAX_GRID or b > _MAX_GRID:
        raise ValueError(f"{what}: {b} sequences of {hq} heads exceed the "
                         f"grid's {_MAX_GRID} per launch")
    if window is not None and window < 1:
        raise ValueError(f"{what}: window must be >= 1, got {window}")
    per16 = 16 // q.element_size()
    for name, t in (("k_cache", k), ("v_cache", v)):
        if t.data_ptr() % 16 or any(s % per16 for s in _strides(t)):
            raise ValueError(
                f"{what}: {name} must start on 16 bytes and have strides "
                f"of whole 16 bytes (16-byte copies), got address "
                f"{t.data_ptr():#x} strides {t.stride()}")


def _lengths(cache_len, b: int, dev: torch.device):
    """(kind, tensor or None, stride, value) of ``cache_len`` as the
    kernel reads it: one value on the host for every row (kind 0), or an
    int32 / int64 tensor of one or ``b`` values on ``dev`` (copied there
    from the host where it is not), never read on the host."""
    if not isinstance(cache_len, torch.Tensor):
        cache_len = torch.as_tensor(cache_len)
    if cache_len.device.type == "cpu" and cache_len.ndim == 0 \
            and cache_len.dtype in _LEN_KINDS:
        return 0, None, 0, int(cache_len)
    if cache_len.dtype not in _LEN_KINDS:
        raise ValueError(f"decode_attention: cache_len must be an int or "
                         f"an int32 / int64 tensor, got {cache_len.dtype}")
    if cache_len.ndim > 1 or (cache_len.ndim == 1
                              and cache_len.shape[0] != b):
        raise ValueError(f"decode_attention: cache_len must hold one value "
                         f"or {b} (one a sequence), got shape "
                         f"{tuple(cache_len.shape)}")
    cache_len = cache_len.to(dev)
    stride = cache_len.stride(0) if cache_len.ndim else 0
    return _LEN_KINDS[cache_len.dtype], cache_len, stride, 0


@functools.cache
def _plan(dev: int, b: int, hq: int, hkv: int, s: int, d: int,
          dtype: int) -> tuple[int, int]:
    """(splits, positions a split) of a call of these shapes on card
    ``dev``: chosen in ``csrc/decode_attn.cu`` from the shapes and how
    many blocks the card holds at once."""
    import ctypes

    from repro_torch.kernels import ops

    out = (ctypes.c_int * 2)()
    with torch.cuda.device(dev):
        err = ops._libraries()["decode_attn"].decode_attn_plan(
            b, hq, hkv, s, d, dtype, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"decode_attention: planning failed ({err})")
    return out[0], out[1]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     window: int | None = None,
                     backend: str = "kernel") -> torch.Tensor:
    """q: [B, Hq, 1, D]; caches: [B, Hkv, S, D] -> [B, Hq, 1, D]."""
    from repro_torch.kernels import ops

    ops._check_backend(backend)
    if backend == "ref" or q.device.type != "cuda":
        return decode_attention_ref(q, k_cache, v_cache, cache_len,
                                    window=window)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (q, k_cache, v_cache)):
        raise ValueError("decode_attention: the kernel has no backward: "
                         "call it under torch.no_grad(), on tensors that do "
                         "not require grad, or with backend='ref'")
    _check(q, k_cache, v_cache, window)
    b, hq, _, d = q.shape
    hkv, s_len = k_cache.shape[1], k_cache.shape[2]
    kind, lens, len_stride, len_value = _lengths(cache_len, b, q.device)
    out = torch.empty((b, hq, 1, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    dev = q.device.index if q.device.index is not None else \
        torch.cuda.current_device()
    n_split, split_len = _plan(dev, b, hq, hkv, s_len, d, _DTYPES[q.dtype])
    part = (torch.empty(b * hq * n_split * (d + 2), dtype=torch.float32,
                        device=q.device) if n_split > 1 else None)
    q_sb, q_sh, _ = _strides(q)
    ops._launch("decode_attention", "decode_attn", "decode_attn_forward",
                q.device, q.data_ptr(), k_cache.data_ptr(),
                v_cache.data_ptr(), out.data_ptr(),
                None if part is None else part.data_ptr(),
                None if lens is None else lens.data_ptr(), q_sb, q_sh,
                *_strides(k_cache), *_strides(v_cache), len_stride,
                len_value, kind, b, hq, hkv, s_len, d,
                0 if window is None else window, _DTYPES[q.dtype], n_split,
                split_len, d ** -0.5)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
