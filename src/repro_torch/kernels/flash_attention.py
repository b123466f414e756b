"""Prefill attention: the CUDA kernel's wrapper and its plain version.

    flash_attention(q, k, v, causal=, window=, scale=)
      tensor on the CPU     -> flash_attention_ref, the plain version
      tensor on a CUDA card -> csrc/flash_attn.cu (launches or raises)
      backend="ref"         -> the plain version on any device

q [B, Hq, Tq, D] and k, v [B, Hkv, Tk, D] -> [B, Hq, Tq, D], in the
input dtype with float32 accumulation.  Queries are the last Tq
positions of the Tk-long stream; the KV head of query head h is
h // (Hq // Hkv); the masks are causal and a sliding ``window``; a row
masked everywhere gives zeros.  The kernel takes any Tq and Tk (it masks
the ragged edge itself), bf16 or float32, head_dim 32, 64, 128 or 256,
and q, k, v with any strides whose last one is 1 (the transposed views of
a fused qkv projection).  Both dtypes run on the tensor cores.  bf16
reads its operands with TMA, which needs each base address 16-byte
aligned and each stride a whole number of 16 bytes (8 elements); float32
runs split TF32 (each operand split into two TF32 halves, three products
summed in float32, about float32's accuracy) and takes any alignment.
This is the counterpart of the JAX package's Pallas ``flash_attention``,
which needs Tq and Tk in whole blocks.

The kernel has no backward, so the wrapper raises ``ValueError`` (on
every device) when grad mode is on and q, k or v requires grad: it never
returns an output cut off from autograd.  The wrapper counts its
launches in ``flash_attention.launches`` (``ops.launch_counts()`` lists
it beside the SNN kernels).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ref import attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128, 256)
_MAX_GRID = 65_535          # heads ride grid y, batch grid z


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the dense ``attention_ref``
    with the kernel's masking (zeros for a row masked everywhere)."""
    return attention_ref(q, k, v, causal, window, scale,
                         masked_rows_zero=True)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int | None) -> None:
    """Raise on what the kernel does not take."""
    what = "flash_attention"
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{what}: {name} must be a CUDA tensor on "
                             f"{q.device}, got {t.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{what}: {name} is {t.dtype}, q {q.dtype}")
        if t.ndim != 4 or t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} must be 4-D with a "
                             f"contiguous last dimension, got shape "
                             f"{tuple(t.shape)} strides {t.stride()}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{what}: dtype must be float32 or bfloat16, got "
                         f"{q.dtype}")
    b, hq, tq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{what}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if hq % k.shape[1]:
        raise ValueError(f"{what}: {hq} query heads are not a multiple of "
                         f"{k.shape[1]} KV heads")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {d} not in {_HEAD_DIMS}")
    if hq > _MAX_GRID or b > _MAX_GRID:
        raise ValueError(f"{what}: {b} sequences of {hq} heads exceed the "
                         f"grid's {_MAX_GRID} per launch")
    if window is not None and window < 1:
        raise ValueError(f"{what}: window must be >= 1, got {window}")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(s % 8 for s in _strides(t)):
                raise ValueError(
                    f"{what}: bf16 {name} must start on 16 bytes and have "
                    f"strides of whole 16 bytes (TMA), got address "
                    f"{t.data_ptr():#x} strides {t.stride()}")


def _strides(t: torch.Tensor) -> list[int]:
    """Element strides of batch, head and row as the kernel reads them.
    A dimension of size 1 is never stepped, so its stride is set to that
    of a packed layout (torch may give it any value; TMA needs whole 16
    bytes)."""
    st = list(t.stride()[:3])
    for i in (2, 1, 0):
        if t.shape[i] == 1:
            st[i] = t.shape[i + 1] * (st[i + 1] if i < 2 else 1)
    return st


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None,
                    backend: str = "kernel") -> torch.Tensor:
    """q: [B, Hq, Tq, D]; k, v: [B, Hkv, Tk, D] -> [B, Hq, Tq, D]."""
    from repro_torch.kernels import ops

    ops._check_backend(backend)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError("flash_attention has no backward: call it under "
                         "torch.no_grad() or on tensors that do not "
                         "require grad (training attends through "
                         "attention.chunked_attention)")
    if backend == "ref" or q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    _check(q, k, v, window)
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    out = torch.empty((b, hq, tq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = ops._libraries()["flash_attn"]
    smem = lib.flash_attn_smem_bytes(d, _DTYPES[q.dtype])
    limit = getattr(torch.cuda.get_device_properties(q.device),
                    "shared_memory_per_block_optin", None)
    if limit is not None and smem > limit:
        raise ValueError(f"flash_attention: a block needs {smem} bytes of "
                         f"shared memory, the card gives {limit}")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    ops._launch("flash_attention", "flash_attn", "flash_attn_forward",
                q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), *_strides(q), *_strides(k), *_strides(v),
                b, hq, hkv, tq, tk, d, int(causal),
                0 if window is None else window, _DTYPES[q.dtype], scale)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
