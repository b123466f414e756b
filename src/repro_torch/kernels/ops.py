"""Public wrappers of the serving kernels, with dispatch by device.

  tensor on the CPU    -> the plain PyTorch version (``kernels/ref.py``)
  tensor on a CUDA card -> the CUDA kernel (``csrc/snn_infer.cu``); a
                          launch that fails raises, nothing falls back
  backend="ref"        -> the plain version on any device, asked for
                          by name (the CPU degradation ladder's last
                          rung; comparisons with the kernels)

Each wrapper counts its kernel launches in a plain integer attribute
(``infer_window_batch.launches``), so a run can show that its main path
went through the kernel; :func:`reset_launch_counts` sets them to 0.

``t_chunk`` is accepted for the JAX signature and has no effect: a
block stages its weight tile in shared memory once and streams the
window one cycle at a time, so there is no spike slab to bound.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import lfsr
from repro_torch.core.bitpack import as_i32
from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

_SOURCE = "snn_infer"
_BACKENDS = ("kernel", "ref")

_MAX_GRID_Y = 65_535      # samples ride the grid's y dimension
_ROW_TOO_WIDE = -1        # the launchers' code for a row that does not fit


@functools.cache
def _kernels() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.snn_infer_window_batch_encode.argtypes = (
        [ptr] * 5 + [i32] * 7 + [ptr])
    lib.snn_infer_window_batch_encode.restype = i32
    lib.snn_infer_window_batch.argtypes = [ptr] * 3 + [i32] * 6 + [ptr]
    lib.snn_infer_window_batch.restype = i32
    lib.snn_tile_rows.argtypes = [i32] * 3
    lib.snn_tile_rows.restype = i32
    lib.snn_smem_bytes.argtypes = [i32] * 3
    lib.snn_smem_bytes.restype = ctypes.c_longlong
    lib.snn_error_string.argtypes = [i32]
    lib.snn_error_string.restype = ctypes.c_char_p
    return lib


def load_kernels() -> None:
    """Build (``nvcc``, first use only) and load the serving kernels.
    Raises if the build fails."""
    _kernels()


def tile_rows(n: int, words: int, encode: bool) -> int:
    """Neurons per thread block the kernel takes for an ``n``-neuron,
    ``words``-wide bank on the current card (0: one row does not fit
    its shared memory).  The layout lives in ``csrc/snn_infer.cu``."""
    return _kernels().snn_tile_rows(n, words, int(encode))


def smem_bytes(rows: int, words: int, encode: bool) -> int:
    """Shared-memory bytes of one block holding ``rows`` neurons."""
    return _kernels().snn_smem_bytes(rows, words, int(encode))


def launch_counts() -> dict[str, int]:
    return {f.__name__: f.launches
            for f in (infer_window_batch_encode, infer_window_batch)}


def reset_launch_counts() -> None:
    infer_window_batch_encode.launches = 0
    infer_window_batch.launches = 0


def _check_backend(backend: str) -> None:
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got "
                         f"{backend!r}")


def seed_vector(seeds, b: int, device: torch.device) -> torch.Tensor:
    """Counter seeds as int32[b] bit patterns on ``device``: values are
    taken mod 2**32 (negative int32 and u32 seeds agree).  An int32[b]
    tensor already there passes through; anything else is converted on
    the host and copied to ``device`` once."""
    if isinstance(seeds, torch.Tensor):
        if (seeds.dtype == torch.int32 and seeds.device == device
                and seeds.shape == (b,)):
            return seeds.contiguous()
        seeds = seeds.cpu()
    return as_i32(lfsr.u32(seeds).expand(b)).contiguous().to(device)


def _check_operands(what: str, **tensors) -> torch.device:
    """All operands on one CUDA device, contiguous, of the kernel's
    dtype (given as ``name=(tensor, dtype, ndim)``)."""
    dev = None
    for name, (t, dtype, ndim) in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{what}: {name} must be a CUDA tensor, got "
                             f"{t.device}")
        if dev is not None and t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, expected "
                             f"{dev}")
        dev = t.device
        if t.dtype != dtype or t.ndim != ndim:
            raise ValueError(f"{what}: {name} must be {ndim}-D {dtype}, "
                             f"got {t.ndim}-D {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    return dev


def _check_grid(what: str, b: int) -> None:
    if b > _MAX_GRID_Y:
        raise ValueError(f"{what}: batch {b} exceeds the grid's "
                         f"{_MAX_GRID_Y} samples per launch")


def _launch(what: str, fn, dev: torch.device, *args) -> None:
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
    if err != 0:
        msg = _kernels().snn_error_string(err).decode()
        raise (ValueError if err == _ROW_TOO_WIDE else RuntimeError)(
            f"{what}: CUDA launch failed ({err}): {msg}")


def infer_window_batch_encode(weights: torch.Tensor,
                              intensities: torch.Tensor, seeds, *,
                              n_steps: int, threshold: int, leak: int,
                              t_total=None, t_chunk: int | None = None,
                              backend: str = "kernel") -> torch.Tensor:
    """Intensity-resident serving: spike counts int32[B, n].

    weights int32[n, w] (u32 bit patterns), intensities uint8[B, n_in]
    (n_in <= 32 w), seeds int | i32[B] (read as u32), ``t_total``
    (i32[B], optional) each sample's true window length.  Each cycle's
    spikes are drawn from the counter hash; cycles at or past a sample's
    ``t_total`` change nothing.  Equal in counts to host-encode +
    zero-mask + :func:`infer_window_batch` for ``threshold >= 1``, which
    the kernel requires.
    """
    _check_backend(backend)
    dev = weights.device
    b = intensities.shape[0]
    sd = seed_vector(seeds, b, dev)
    tt = (torch.full((b,), n_steps, dtype=torch.int32, device=dev)
          if t_total is None else
          torch.as_tensor(t_total, dtype=torch.int32, device=dev)
          .expand(b).contiguous())
    if backend == "ref" or dev.type == "cpu":
        return _ref.infer_window_batch_encode_ref(
            weights, intensities, sd, n_steps, threshold, leak, tt)
    what = "infer_window_batch_encode"
    _check_operands(what, weights=(weights, torch.int32, 2),
                    intensities=(intensities, torch.uint8, 2),
                    seeds=(sd, torch.int32, 1), t_total=(tt, torch.int32, 1))
    n, w = weights.shape
    n_in = intensities.shape[1]
    if n_in > 32 * w:
        raise ValueError(f"{what}: {n_in} intensities exceed the {w}-word "
                         f"spike width ({32 * w} inputs)")
    if threshold < 1:
        raise ValueError(f"{what}: the kernel stops each sample at its "
                         f"t_total, which needs threshold >= 1, got "
                         f"{threshold}")
    if n_steps < 0:
        raise ValueError(f"{what}: n_steps must be >= 0, got {n_steps}")
    _check_grid(what, b)
    counts = torch.empty((b, n), dtype=torch.int32, device=dev)
    if b == 0 or n == 0:
        return counts.zero_()
    _launch(what, _kernels().snn_infer_window_batch_encode, dev,
            weights.data_ptr(), intensities.data_ptr(), sd.data_ptr(),
            tt.data_ptr(), counts.data_ptr(), b, n, w, n_in, n_steps,
            threshold, leak)
    infer_window_batch_encode.launches += 1
    return counts


def infer_window_batch(weights: torch.Tensor, spike_trains: torch.Tensor,
                       *, threshold: int, leak: int,
                       t_chunk: int | None = None,
                       backend: str = "kernel") -> torch.Tensor:
    """Serving path on pre-packed windows: spike counts int32[B, n].

    weights int32[n, w], spike_trains int32[B, T, w] (u32 bit patterns);
    weights frozen, membrane reset per sample.
    """
    _check_backend(backend)
    if backend == "ref" or weights.device.type == "cpu":
        return _ref.infer_window_batch_ref(weights, spike_trains,
                                           threshold, leak)
    what = "infer_window_batch"
    dev = _check_operands(what, weights=(weights, torch.int32, 2),
                          spike_trains=(spike_trains, torch.int32, 3))
    n, w = weights.shape
    b, t_steps, ws = spike_trains.shape
    if ws != w:
        raise ValueError(f"{what}: spike_trains are {ws} words wide, the "
                         f"weights {w}")
    _check_grid(what, b)
    counts = torch.empty((b, n), dtype=torch.int32, device=dev)
    if b == 0 or n == 0:
        return counts.zero_()
    _launch(what, _kernels().snn_infer_window_batch, dev,
            weights.data_ptr(), spike_trains.data_ptr(), counts.data_ptr(),
            b, n, w, t_steps, threshold, leak)
    infer_window_batch.launches += 1
    return counts


infer_window_batch_encode.launches = 0
infer_window_batch.launches = 0
