"""Public wrappers of the SNN kernels, with dispatch by device.

  tensor on the CPU    -> the plain PyTorch version (``kernels/ref.py``)
  tensor on a CUDA card -> the CUDA kernel (``csrc/snn_infer.cu`` for
                          serving, ``csrc/snn_train.cu`` for the training
                          and read-only windows, ``csrc/snn_step.cu`` for
                          the per-cycle RV-SNN instructions); a launch
                          that fails raises, nothing falls back
  backend="ref"        -> the plain version on any device, asked for
                          by name (the CPU degradation ladder's last
                          rung; comparisons with the kernels)

Each wrapper counts its kernel launches in a plain integer attribute
(``infer_window_batch.launches``), so a run can show that its main path
went through the kernel; :func:`reset_launch_counts` sets them to 0.
``fused_snn_window(train=True)`` is the one-stream case of
:func:`train_window_batch` and launches (and counts) that kernel, as
the JAX package's op does; ``train=False`` launches the read-only
window kernel.  The encode forms pair the same way, and
:func:`train_stream_batch_encode` (a stream of samples per launch) is
the same kernel as :func:`train_window_batch_encode` (its one-sample
case), counted under that name.

The step ops (:func:`spike_process`, :func:`lif_step`,
:func:`stdp_update`, :func:`fused_snn_step`) take one stream, or a
leading stream axis B on every per-stream operand; the weight bank (and
its LFSR lanes) is then one per stream ([B, n, w]) or one shared by all
([n, w]), which the kernels read with a stream stride of 0.  No padding
is needed: shapes are the caller's own.

``launch_counts`` also lists ``flash_attention`` and
``decode_attention``, whose wrappers (the LM's prefill attention,
``csrc/flash_attn.cu``, and its decode attention, ``csrc/decode_attn.cu``)
live in ``kernels/flash_attention.py`` and ``kernels/decode_attention.py``
beside their plain versions.

Each step op can launch as a programmatic dependent of the stream's
previous kernel (``dependent=True``): its blocks start while that one
ends, load what the op's docstring names before waiting for it, and
read everything else and write only after.  The engine's CUDA graph of
a window's fused steps does, and so can the unfused chain
(``snn.sp -> snn.nu -> snn.su``); a graph's replays count their
launches here.  A launch made while a graph is being captured runs
nothing and counts nothing.

The kernels never write their inputs: the training ops return new
weight, v and LFSR tensors.  ``t_chunk`` is accepted for the JAX
signature and has no effect: a block stages its state in shared memory
once and sizes its spike window to its shared memory itself (whole
windows where they fit, else one cycle's row at a time).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core import lfsr
from repro_torch.core.bitpack import as_i32
from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

_SOURCES = ("snn_infer", "snn_train", "snn_step", "flash_attn",
            "decode_attn")
_BACKENDS = ("kernel", "ref")

_MAX_GRID_Y = 65_535      # samples ride the grid's y dimension
_ROW_TOO_WIDE = -1        # the launchers' code for a row that does not fit


# (symbol, argument kinds, result kind) of each library's C functions:
# p a pointer (a launcher's stream is its last), i an int, l a 64-bit
# int, f a float.
_SIGNATURES = {
    "snn_infer": (("snn_infer_window_batch_encode", "pppppp iiiiiii p", "i"),
                  ("snn_infer_window_batch", "ppp iiiiii p", "i"),
                  ("snn_infer_plan", "iiiii p", "i")),
    "snn_train": (("snn_train_window_batch", "pppppppppp iiiiiiiii p", "i"),
                  ("snn_train_window_batch_encode",
                   "ppppppppppp iiiiiiiiii p", "i"),
                  ("snn_train_stream_encode",
                   "pppppppppp llllll iiiiiiiiiii p", "i"),
                  ("snn_window_infer", "pppppp iiiiii p", "i"),
                  ("snn_window_infer_encode", "ppppppp iiiiiii p", "i"),
                  ("snn_train_tile_rows", "iiii", "i"),
                  ("snn_train_smem_bytes", "iiii", "l")),
    "snn_step": (("snn_spike_process", "ppp iiiii p", "i"),
                 ("snn_lif_step", "pppp iiii p", "i"),
                 ("snn_stdp_update", "ppppppp iiiiiiii p", "i"),
                 ("snn_fused_step", "pppppppppp iiiiiiiiiii p", "i")),
    "flash_attn": (("flash_attn_forward", "pppp lllllllll iiiiiiiii f p",
                    "i"),
                   ("flash_attn_smem_bytes", "ii", "l")),
    "decode_attn": (("decode_attn_forward",
                     "pppppp llllllllll iiiiiiiiii f p", "i"),
                    ("decode_attn_plan", "iiiiii p", "i")),
}
_ERROR_STRING = {"snn_infer": "snn_error_string",
                 "snn_train": "snn_train_error_string",
                 "snn_step": "snn_step_error_string",
                 "flash_attn": "flash_attn_error_string",
                 "decode_attn": "decode_attn_error_string"}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong,
           "f": ctypes.c_float}


@functools.cache
def _libraries() -> dict[str, ctypes.CDLL]:
    libs = {name: ctypes.CDLL(str(path))
            for name, path in build.build_all(_SOURCES).items()}
    for name, lib in libs.items():
        for symbol, args, result in _SIGNATURES[name]:
            fn = getattr(lib, symbol)
            fn.argtypes = [_CTYPES[a] for a in args.replace(" ", "")]
            fn.restype = _CTYPES[result]
        err = getattr(lib, _ERROR_STRING[name])
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return libs


def load_kernels() -> None:
    """Build (``nvcc``, first use only, one compiler per source, all at
    once) and load every kernel library.  Raises if a build fails."""
    _libraries()


class EncodePlan(NamedTuple):
    """How a serving kernel runs a shape on a card."""
    regime: str          # "window" (one cluster a sample) or "gemm"
    cluster: int         # blocks a cluster: a sample's (window), or a
                         # (64-neuron tile, sample)'s (gemm)
    smem_bytes: int      # shared bytes a block


@functools.cache
def _encode_plan(dev: int, b: int, n: int, words: int, n_steps: int,
                 encode: bool) -> EncodePlan:
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(dev):
        err = _libraries()["snn_infer"].snn_infer_plan(
            b, n, words, n_steps, int(encode), ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"serving kernel: planning failed ({err})")
    return EncodePlan(("window", "gemm")[out[0]], out[1], out[2])


def encode_plan(b: int, n: int, words: int, n_steps: int, device=None, *,
                encode: bool = True) -> EncodePlan:
    """The regime a serving kernel picks for ``b`` samples of an
    ``n``-neuron, ``words``-wide bank over ``n_steps`` cycles on the card
    (the current one, or ``device``): :func:`infer_window_batch_encode`'s,
    or with ``encode=False`` :func:`infer_window_batch`'s.  The window
    regime where a sample's weights, sums and a share of its window fit a
    block's shared memory (a cluster of blocks a sample), else the GEMM
    regime: a popcount product and the LIF scan, by clusters of blocks
    that split the words, after a draw launch into a scratch window for
    the encode op; the pre-packed op reads its spikes where they are.  The
    choice lives in ``csrc/snn_infer.cu``."""
    dev = torch.device("cuda" if device is None else device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return _encode_plan(idx, b, n, words, n_steps, encode)


def train_tile_rows(n: int, words: int, encode: bool, learn: bool) -> int:
    """Neurons per thread block of the training (``learn``) or read-only
    window kernels on the current card (0: one row, weights and LFSR
    lanes, does not fit its shared memory).  The layout lives in
    ``csrc/snn_train.cu``."""
    return _libraries()["snn_train"].snn_train_tile_rows(
        n, words, int(encode), int(learn))


def train_smem_bytes(rows: int, words: int, encode: bool,
                     learn: bool) -> int:
    """Shared-memory bytes of one training-window block of ``rows``."""
    return _libraries()["snn_train"].snn_train_smem_bytes(
        rows, words, int(encode), int(learn))


def _wrappers():
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    return (infer_window_batch_encode, infer_window_batch,
            train_window_batch, train_window_batch_encode,
            fused_snn_window, fused_snn_window_encode,
            fused_snn_step, spike_process, lif_step, stdp_update,
            flash_attention, decode_attention)


def launch_counts() -> dict[str, int]:
    return {f.__name__: f.launches for f in _wrappers()}


def reset_launch_counts() -> None:
    for f in _wrappers():
        f.launches = 0


def _check_backend(backend: str) -> None:
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got "
                         f"{backend!r}")


def seed_vector(seeds, b: int, device: torch.device) -> torch.Tensor:
    """Counter seeds (or any per-stream u32 operand, such as
    ``ltp_prob``) as int32[b] bit patterns on ``device``: values are
    taken mod 2**32 (negative int32 and u32 values agree).  An int32[b]
    tensor already there passes through; anything else is converted on
    the host and copied to ``device`` once."""
    if isinstance(seeds, torch.Tensor):
        if (seeds.dtype == torch.int32 and seeds.device == device
                and seeds.shape == (b,)):
            return seeds.contiguous()
        seeds = seeds.cpu()
    values = lfsr.u32(seeds)
    if values.numel() != 1 and tuple(values.shape) != (b,):
        raise ValueError(f"expected one value or {b} (one per stream), "
                         f"got shape {tuple(values.shape)}")
    return as_i32(values.reshape(-1).expand(b)).contiguous().to(device)


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


def _launch(what: str, library: str, symbol: str, dev: torch.device,
            *args) -> None:
    lib = _libraries()[library]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, symbol)(*args, stream)
    if err != 0:
        msg = getattr(lib, _ERROR_STRING[library])(err).decode()
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
    the kernel requires.  On a card the kernel runs in the regime
    :func:`encode_plan` names; the GEMM regime takes a scratch window
    int32[B, n_steps, w], allocated here.
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
    scratch = (torch.empty((b, n_steps, w), dtype=torch.int32, device=dev)
               if encode_plan(b, n, w, n_steps, dev).regime == "gemm"
               else None)
    _launch(what, "snn_infer", "snn_infer_window_batch_encode", dev,
            weights.data_ptr(), intensities.data_ptr(), sd.data_ptr(),
            tt.data_ptr(), counts.data_ptr(),
            None if scratch is None else scratch.data_ptr(), b, n, w, n_in,
            n_steps, threshold, leak)
    infer_window_batch_encode.launches += 1
    return counts


def infer_window_batch(weights: torch.Tensor, spike_trains: torch.Tensor,
                       *, threshold: int, leak: int,
                       t_chunk: int | None = None,
                       backend: str = "kernel") -> torch.Tensor:
    """Serving path on pre-packed windows: spike counts int32[B, n].

    weights int32[n, w], spike_trains int32[B, T, w] (u32 bit patterns);
    weights frozen, membrane reset per sample, every sample over all T
    cycles (any threshold).  On a card the kernel runs in the regime
    ``encode_plan(..., encode=False)`` names; neither regime allocates.
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
    if b == 0 or n == 0 or t_steps == 0:
        return counts.zero_()
    _launch(what, "snn_infer", "snn_infer_window_batch", dev,
            weights.data_ptr(), spike_trains.data_ptr(), counts.data_ptr(),
            b, n, w, t_steps, threshold, leak)
    infer_window_batch.launches += 1
    return counts


# --- training and read-only windows (csrc/snn_train.cu) --------------------

def _check_shapes(what: str, **shapes) -> None:
    """Each operand's shape as the kernel reads it
    (``name=(tensor, expected shape)``)."""
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(want)}")


def _check_window(what: str, b: int, n_syn: int) -> None:
    _check_grid(what, b)
    if n_syn < 1:
        raise ValueError(f"{what}: n_syn must be >= 1, got {n_syn}")


def _check_encode(what: str, n_in: int, w: int, n_steps: int) -> None:
    if n_in > 32 * w:
        raise ValueError(f"{what}: {n_in} intensities exceed the {w}-word "
                         f"spike width ({32 * w} inputs)")
    if n_steps < 0:
        raise ValueError(f"{what}: n_steps must be >= 0, got {n_steps}")


def _train_outputs(b: int, n: int, w: int, t_steps: int,
                   dev: torch.device):
    """New (weights', v', fired, lfsr') tensors for a training launch."""
    return (torch.empty((b, n, w), dtype=torch.int32, device=dev),
            torch.empty((b, n), dtype=torch.int32, device=dev),
            torch.empty((b, t_steps, n), dtype=torch.bool, device=dev),
            torch.empty((b, n, w), dtype=torch.int32, device=dev))


def train_window_batch(weights: torch.Tensor, spike_trains: torch.Tensor,
                       v: torch.Tensor, lfsr_state: torch.Tensor,
                       teach: torch.Tensor, *, threshold: int, leak: int,
                       w_exp: int, gain: int, n_syn: int, ltp_prob=1023,
                       t_chunk: int | None = None,
                       backend: str = "kernel"):
    """B independent training streams, T fused SNNU cycles each.

    weights, lfsr_state int32[B, n, w] (u32 bit patterns, 16-bit LFSR
    lanes), spike_trains int32[B, T, w], v, teach int32[B, n];
    ``ltp_prob`` an int shared by every stream or one per stream
    (int32[B], compared as u32).  Stream b is exactly one
    :func:`fused_snn_window` run.  Returns new (weights', v', fired
    bool[B, T, n], lfsr').
    """
    _check_backend(backend)
    if backend == "ref" or weights.device.type == "cpu":
        return _ref.train_window_batch_ref(
            weights, spike_trains, v, lfsr_state, teach, threshold, leak,
            w_exp, gain, n_syn, ltp_prob)
    what = "train_window_batch"
    b, n, w = weights.shape
    t_steps = spike_trains.shape[1]
    lp = seed_vector(ltp_prob, b, weights.device)
    dev = _check_operands(what, weights=(weights, torch.int32, 3),
                          spike_trains=(spike_trains, torch.int32, 3),
                          v=(v, torch.int32, 2),
                          lfsr_state=(lfsr_state, torch.int32, 3),
                          teach=(teach, torch.int32, 2),
                          ltp_prob=(lp, torch.int32, 1))
    _check_shapes(what, spike_trains=(spike_trains, (b, t_steps, w)),
                  v=(v, (b, n)), lfsr_state=(lfsr_state, (b, n, w)),
                  teach=(teach, (b, n)))
    _check_window(what, b, n_syn)
    w2, v2, fired, lf2 = _train_outputs(b, n, w, t_steps, dev)
    if b == 0 or n == 0:
        return w2, v2, fired, lf2
    _launch(what, "snn_train", "snn_train_window_batch", dev,
            weights.data_ptr(), spike_trains.data_ptr(), v.data_ptr(),
            lfsr_state.data_ptr(), teach.data_ptr(), lp.data_ptr(),
            w2.data_ptr(), v2.data_ptr(), fired.data_ptr(), lf2.data_ptr(),
            b, n, w, t_steps, threshold, leak, w_exp, gain, n_syn)
    train_window_batch.launches += 1
    return w2, v2, fired, lf2


def train_window_batch_encode(weights: torch.Tensor,
                              intensities: torch.Tensor, seeds,
                              v: torch.Tensor, lfsr_state: torch.Tensor,
                              teach: torch.Tensor, *, n_steps: int,
                              threshold: int, leak: int, w_exp: int,
                              gain: int, n_syn: int, ltp_prob=1023,
                              t_chunk: int | None = None,
                              backend: str = "kernel"):
    """:func:`train_window_batch` with each cycle's spikes drawn in the
    kernel from uint8 ``intensities`` [B, n_in] (n_in <= 32 w) and
    per-stream counter ``seeds`` (int | i32[B], read as u32).  Bit-exact
    with host-encoding each stream and running the pre-packed op.
    Returns new (weights', v', fired bool[B, n_steps, n], lfsr').
    """
    _check_backend(backend)
    b, n, w = weights.shape
    dev = weights.device
    sd = seed_vector(seeds, b, dev)
    if backend == "ref" or dev.type == "cpu":
        return _ref.train_window_batch_encode_ref(
            weights, intensities, sd, v, lfsr_state, teach, n_steps,
            threshold, leak, w_exp, gain, n_syn, ltp_prob)
    what = "train_window_batch_encode"
    lp = seed_vector(ltp_prob, b, dev)
    _check_operands(what, weights=(weights, torch.int32, 3),
                    intensities=(intensities, torch.uint8, 2),
                    seeds=(sd, torch.int32, 1), v=(v, torch.int32, 2),
                    lfsr_state=(lfsr_state, torch.int32, 3),
                    teach=(teach, torch.int32, 2),
                    ltp_prob=(lp, torch.int32, 1))
    n_in = intensities.shape[1]
    _check_shapes(what, intensities=(intensities, (b, n_in)),
                  v=(v, (b, n)), lfsr_state=(lfsr_state, (b, n, w)),
                  teach=(teach, (b, n)))
    _check_encode(what, n_in, w, n_steps)
    _check_window(what, b, n_syn)
    w2, v2, fired, lf2 = _train_outputs(b, n, w, n_steps, dev)
    if b == 0 or n == 0:
        return w2, v2, fired, lf2
    _launch(what, "snn_train", "snn_train_window_batch_encode", dev,
            weights.data_ptr(), intensities.data_ptr(), sd.data_ptr(),
            v.data_ptr(), lfsr_state.data_ptr(), teach.data_ptr(),
            lp.data_ptr(), w2.data_ptr(), v2.data_ptr(), fired.data_ptr(),
            lf2.data_ptr(), b, n, w, n_in, n_steps, threshold, leak,
            w_exp, gain, n_syn)
    train_window_batch_encode.launches += 1
    return w2, v2, fired, lf2


def _seed_matrix(seeds, n_samples: int, b: int,
                 device: torch.device) -> torch.Tensor:
    """Counter seeds as int32[N, B] bit patterns on ``device``: one value
    for every sample, one per sample (i32[N], shared by every stream) or
    one per sample and stream (i32[N, B]), taken mod 2**32.  An
    int32[N, B] tensor already there passes through."""
    if isinstance(seeds, torch.Tensor):
        if (seeds.dtype == torch.int32 and seeds.device == device
                and tuple(seeds.shape) == (n_samples, b)):
            return seeds.contiguous()
        seeds = seeds.cpu()
    values = lfsr.u32(seeds)
    if values.numel() == 1:
        values = values.reshape(1, 1)
    elif values.ndim == 1 and values.numel() == n_samples:
        values = values[:, None]
    elif tuple(values.shape) != (n_samples, b):
        raise ValueError(f"expected one seed, {n_samples} (one per "
                         f"sample) or ({n_samples}, {b}), got shape "
                         f"{tuple(values.shape)}")
    return as_i32(values.expand(n_samples, b)).contiguous().to(device)


def _check_per_sample(what: str, dev: torch.device, **tensors) -> None:
    """The stream kernel's per-sample operands (``name=(tensor, dtype,
    shape)``): on ``dev``, of its dtype and shape, the last axis
    contiguous; the sample and stream axes may take any non-negative
    stride (0: one operand shared by every stream)."""
    for name, (t, dtype, want) in tensors.items():
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, expected "
                             f"{dev}")
        if t.dtype != dtype:
            raise ValueError(f"{what}: {name} must be {dtype}, got "
                             f"{t.dtype}")
        _check_shapes(what, **{name: (t, want)})
        if (t.shape[-1] > 1 and t.stride(-1) != 1) or min(t.stride()) < 0:
            raise ValueError(f"{what}: {name}'s last axis must be "
                             f"contiguous")


def train_stream_batch_encode(weights: torch.Tensor,
                              intensities: torch.Tensor, seeds,
                              lfsr_state: torch.Tensor, teach: torch.Tensor,
                              *, n_steps: int, threshold: int, leak: int,
                              w_exp: int, gain: int, n_syn: int,
                              ltp_prob=1023, backend: str = "kernel"):
    """B training streams of N samples each, in one launch: the kernel
    form of the stream driver ``engine.train_stream_batch`` with
    intensities.

    weights, lfsr_state int32[B, n, w] (u32 bit patterns); intensities
    uint8[N, B, n_in] (n_in <= 32 w) and teach int32[N, B, n], whose
    sample and stream axes may take any stride (0: one operand shared by
    every stream); seeds int | i32[N] (shared by every stream) |
    i32[N, B], read as u32; ``ltp_prob`` an int or int32[B].  Sample i
    of stream b is one :func:`train_window_batch_encode` window from
    v = 0; weights and LFSR carry to sample i + 1.  Returns new
    (weights', v' of the last sample, counts int32[N, B, n], lfsr');
    with N = 0, the weights and LFSR as they came and v' = 0.
    """
    _check_backend(backend)
    b, n, w = weights.shape
    n_samples = intensities.shape[0]
    dev = weights.device
    sd = _seed_matrix(seeds, n_samples, b, dev)
    if backend == "ref" or dev.type == "cpu":
        return _ref.train_stream_batch_encode_ref(
            weights, intensities, sd, lfsr_state, teach, n_steps, threshold,
            leak, w_exp, gain, n_syn, ltp_prob)
    what = "train_stream_batch_encode"
    lp = seed_vector(ltp_prob, b, dev)
    _check_operands(what, weights=(weights, torch.int32, 3),
                    lfsr_state=(lfsr_state, torch.int32, 3),
                    ltp_prob=(lp, torch.int32, 1))
    n_in = intensities.shape[-1]
    _check_shapes(what, lfsr_state=(lfsr_state, (b, n, w)))
    _check_per_sample(what, dev,
                      intensities=(intensities, torch.uint8,
                                   (n_samples, b, n_in)),
                      teach=(teach, torch.int32, (n_samples, b, n)))
    _check_encode(what, n_in, w, n_steps)
    _check_window(what, b, n_syn)
    v2 = torch.zeros((b, n), dtype=torch.int32, device=dev)
    counts = torch.zeros((n_samples, b, n), dtype=torch.int32, device=dev)
    if n_samples == 0 or b == 0 or n == 0:
        return weights.clone(), v2, counts, lfsr_state.clone()
    w2 = torch.empty_like(weights)
    lf2 = torch.empty_like(lfsr_state)
    _launch(what, "snn_train", "snn_train_stream_encode", dev,
            weights.data_ptr(), intensities.data_ptr(), sd.data_ptr(),
            lfsr_state.data_ptr(), teach.data_ptr(), lp.data_ptr(),
            w2.data_ptr(), v2.data_ptr(), counts.data_ptr(), lf2.data_ptr(),
            *intensities.stride()[:2], *sd.stride(), *teach.stride()[:2],
            n_samples, b, n, w, n_in, n_steps, threshold, leak, w_exp, gain,
            n_syn)
    train_window_batch_encode.launches += 1
    return w2, v2, counts, lf2


def fused_snn_window(weights: torch.Tensor, spike_train: torch.Tensor,
                     v: torch.Tensor, lfsr_state: torch.Tensor,
                     teach: torch.Tensor, *, threshold: int, leak: int,
                     w_exp: int, gain: int, n_syn: int, ltp_prob=1023,
                     train: bool = True, t_chunk: int | None = None,
                     backend: str = "kernel"):
    """T fused SNNU cycles on one stream.

    weights, lfsr_state int32[n, w], spike_train int32[T, w], v, teach
    int32[n].  ``train=True`` is the one-stream case of
    :func:`train_window_batch`.  ``train=False`` (SU idle) runs the
    read-only window: new v' and raster, and the input weights and LFSR
    returned as they are.  Returns (weights', v', fired bool[T, n],
    lfsr').
    """
    _check_backend(backend)
    if train:
        w2, v2, fired, lf2 = train_window_batch(
            weights[None], spike_train[None], v[None], lfsr_state[None],
            teach[None], threshold=threshold, leak=leak, w_exp=w_exp,
            gain=gain, n_syn=n_syn, ltp_prob=ltp_prob, backend=backend)
        return w2[0], v2[0], fired[0], lf2[0]
    if backend == "ref" or weights.device.type == "cpu":
        return _ref.fused_snn_window_ref(
            weights, spike_train, v, lfsr_state, teach, threshold, leak,
            w_exp, gain, n_syn, ltp_prob, False)
    what = "fused_snn_window"
    dev = _check_operands(what, weights=(weights, torch.int32, 2),
                          spike_train=(spike_train, torch.int32, 2),
                          v=(v, torch.int32, 1), teach=(teach, torch.int32, 1))
    n, w = weights.shape
    t_steps = spike_train.shape[0]
    _check_shapes(what, spike_train=(spike_train, (t_steps, w)),
                  v=(v, (n,)), teach=(teach, (n,)))
    v2 = torch.empty((n,), dtype=torch.int32, device=dev)
    fired = torch.empty((t_steps, n), dtype=torch.bool, device=dev)
    if n:
        _launch(what, "snn_train", "snn_window_infer", dev,
                weights.data_ptr(), spike_train.data_ptr(), v.data_ptr(),
                teach.data_ptr(), v2.data_ptr(), fired.data_ptr(), 1, n, w,
                t_steps, threshold, leak)
        fused_snn_window.launches += 1
    return weights, v2, fired, lfsr_state


def fused_snn_window_encode(weights: torch.Tensor,
                            intensities: torch.Tensor, seed,
                            v: torch.Tensor, lfsr_state: torch.Tensor,
                            teach: torch.Tensor, *, n_steps: int,
                            threshold: int, leak: int, w_exp: int,
                            gain: int, n_syn: int, ltp_prob=1023,
                            train: bool = True,
                            t_chunk: int | None = None,
                            backend: str = "kernel"):
    """:func:`fused_snn_window` with the spikes drawn in the kernel from
    uint8 ``intensities`` [n_in] and a counter ``seed`` (an int or a
    one-element tensor, read as u32).  Bit-exact with host-encoding
    ``encode_from_counter(seed, intensities, n_steps)`` and running the
    pre-packed op.  Returns (weights', v', fired bool[n_steps, n],
    lfsr').
    """
    _check_backend(backend)
    dev = weights.device
    sd = seed_vector(seed, 1, dev)
    if train:
        w2, v2, fired, lf2 = train_window_batch_encode(
            weights[None], intensities[None], sd, v[None], lfsr_state[None],
            teach[None], n_steps=n_steps, threshold=threshold, leak=leak,
            w_exp=w_exp, gain=gain, n_syn=n_syn, ltp_prob=ltp_prob,
            backend=backend)
        return w2[0], v2[0], fired[0], lf2[0]
    if backend == "ref" or dev.type == "cpu":
        return _ref.fused_snn_window_encode_ref(
            weights, intensities, sd, v, lfsr_state, teach, n_steps,
            threshold, leak, w_exp, gain, n_syn, ltp_prob, False)
    what = "fused_snn_window_encode"
    _check_operands(what, weights=(weights, torch.int32, 2),
                    intensities=(intensities, torch.uint8, 1),
                    seed=(sd, torch.int32, 1), v=(v, torch.int32, 1),
                    teach=(teach, torch.int32, 1))
    n, w = weights.shape
    n_in = intensities.shape[0]
    _check_shapes(what, v=(v, (n,)), teach=(teach, (n,)))
    _check_encode(what, n_in, w, n_steps)
    v2 = torch.empty((n,), dtype=torch.int32, device=dev)
    fired = torch.empty((n_steps, n), dtype=torch.bool, device=dev)
    if n:
        _launch(what, "snn_train", "snn_window_infer_encode", dev,
                weights.data_ptr(), intensities.data_ptr(), sd.data_ptr(),
                v.data_ptr(), teach.data_ptr(), v2.data_ptr(),
                fired.data_ptr(), 1, n, w, n_in, n_steps, threshold, leak)
        fused_snn_window_encode.launches += 1
    return weights, v2, fired, lfsr_state


# --- per-cycle RV-SNN instructions (csrc/snn_step.cu) -----------------------

def _step_streams(what: str, pre: torch.Tensor, weights: torch.Tensor):
    """The stream layout of a step op: ``pre`` [w] is one stream, [B, w]
    B streams, against one bank per stream (weights [B, n, w], or [n, w]
    for one stream) or one bank shared by all (weights [n, w] with
    ``pre`` [B, w]).  Returns (B, shared, lead, n, w), ``lead`` the
    per-stream operands' leading shape (() or (B,))."""
    if pre.ndim not in (1, 2) or weights.ndim not in (2, pre.ndim + 1):
        raise ValueError(f"{what}: takes pre [w] with weights [n, w], or "
                         f"pre [B, w] with weights [B, n, w] or [n, w]; got "
                         f"{tuple(pre.shape)} and {tuple(weights.shape)}")
    lead = tuple(pre.shape[:-1])
    n, w = weights.shape[-2:]
    shared = int(weights.ndim == 2 and pre.ndim == 2)
    _check_shapes(what, pre=(pre, lead + (w,)),
                  weights=(weights, (() if shared else lead) + (n, w)))
    b = lead[0] if lead else 1
    _check_grid(what, b)
    return b, shared, lead, n, w


def _counted(op) -> None:
    """One more launch of ``op``, unless the stream is being captured
    (a graph's launches count when it is replayed)."""
    if not torch.cuda.is_current_stream_capturing():
        op.launches += 1


def spike_process(spikes: torch.Tensor, weights: torch.Tensor, *,
                  dependent: bool = False,
                  backend: str = "kernel") -> torch.Tensor:
    """SPU (``snn.sp``): valid-spike counts int32[..., n] =
    popcount(spikes & weights[i]) per row.  spikes int32[w] or [B, w],
    weights int32[n, w] (shared) or [B, n, w] (u32 bit patterns).

    ``dependent`` launches the kernel as a programmatic dependent of the
    stream's previous kernel (the last ``snn.su`` of the chain, or
    whichever kernel wrote the bank): it reads the spikes before waiting
    for that kernel to finish, so the previous kernel must not write
    them, and the bank only after.
    """
    _check_backend(backend)
    if backend == "ref" or weights.device.type == "cpu":
        return _ref.spike_process_ref(spikes, weights)
    what = "spike_process"
    dev = _check_operands(what, spikes=(spikes, torch.int32, spikes.ndim),
                          weights=(weights, torch.int32, weights.ndim))
    b, shared, lead, n, w = _step_streams(what, spikes, weights)
    counts = torch.empty(lead + (n,), dtype=torch.int32, device=dev)
    if b and n:
        _launch(what, "snn_step", "snn_spike_process", dev,
                spikes.data_ptr(), weights.data_ptr(), counts.data_ptr(),
                b, n, w, shared, int(dependent))
        _counted(spike_process)
    return counts


def lif_step(v: torch.Tensor, count: torch.Tensor, threshold: int,
             leak: int, *, dependent: bool = False, backend: str = "kernel"):
    """NU (``snn.nu``): the streamlined LIF on int32 v and count of one
    shape (any leading axes).  Returns (v' int32, fired bool).

    ``dependent`` launches the kernel as a programmatic dependent of the
    stream's previous kernel: it loads nothing before waiting for that
    kernel to finish (the chain writes both v and count), so any
    previous kernel will do.
    """
    _check_backend(backend)
    if backend == "ref" or v.device.type == "cpu":
        return _ref.lif_step_ref(v, count, threshold, leak)
    what = "lif_step"
    dev = _check_operands(what, v=(v, torch.int32, v.ndim),
                          count=(count, torch.int32, v.ndim))
    _check_shapes(what, count=(count, v.shape))
    if v.numel() >= 2**31:
        raise ValueError(f"{what}: {v.numel()} neurons exceed one launch")
    v2 = torch.empty_like(v)
    fired = torch.empty(v.shape, dtype=torch.bool, device=dev)
    if v.numel():
        _launch(what, "snn_step", "snn_lif_step", dev, v.data_ptr(),
                count.data_ptr(), v2.data_ptr(), fired.data_ptr(),
                v.numel(), threshold, leak, int(dependent))
        _counted(lif_step)
    return v2, fired


def stdp_update(weights: torch.Tensor, pre_spikes: torch.Tensor,
                post_fired: torch.Tensor, lfsr_state: torch.Tensor, *,
                w_exp: int, gain: int, n_syn: int, ltp_prob=1023,
                dependent: bool = False, backend: str = "kernel"):
    """SU (``snn.su``): binary stochastic STDP on the fired rows.

    weights, lfsr_state int32[n, w] or [B, n, w] (u32 bit patterns,
    16-bit LFSR lanes), pre_spikes int32[w] or [B, w], post_fired bool
    [n] or [B, n]; ``ltp_prob`` an int or one value per stream (int32[B],
    compared as u32).  Returns new (weights', lfsr'), [B, n, w] for B
    streams; unfired rows are copied through.  ``dependent`` launches
    the kernel as a programmatic dependent of the stream's previous
    kernel (``snn.nu``, which wrote the fired mask): it loads nothing
    before waiting for that kernel to finish.
    """
    _check_backend(backend)
    if backend == "ref" or weights.device.type == "cpu":
        return _ref.stdp_update_ref(weights, pre_spikes, post_fired,
                                    lfsr_state, w_exp, gain, n_syn, ltp_prob)
    what = "stdp_update"
    b, shared, lead, n, w = _step_streams(what, pre_spikes, weights)
    lp = seed_vector(ltp_prob, b, weights.device)
    dev = _check_operands(
        what, weights=(weights, torch.int32, weights.ndim),
        pre_spikes=(pre_spikes, torch.int32, pre_spikes.ndim),
        post_fired=(post_fired, torch.bool, pre_spikes.ndim),
        lfsr_state=(lfsr_state, torch.int32, weights.ndim),
        ltp_prob=(lp, torch.int32, 1))
    _check_shapes(what, post_fired=(post_fired, lead + (n,)),
                  lfsr_state=(lfsr_state, weights.shape))
    _check_window(what, b, n_syn)
    w2 = torch.empty(lead + (n, w), dtype=torch.int32, device=dev)
    lf2 = torch.empty_like(w2)
    if b and n:
        _launch(what, "snn_step", "snn_stdp_update", dev,
                weights.data_ptr(), pre_spikes.data_ptr(),
                post_fired.data_ptr(), lfsr_state.data_ptr(), lp.data_ptr(),
                w2.data_ptr(), lf2.data_ptr(), b, n, w, shared, w_exp, gain,
                n_syn, int(dependent))
        _counted(stdp_update)
    return w2, lf2


def fused_snn_step(weights: torch.Tensor, pre_spikes: torch.Tensor,
                   v: torch.Tensor, lfsr_state: torch.Tensor, teach, *,
                   threshold: int, leak: int, w_exp: int, gain: int,
                   n_syn: int, ltp_prob=1023, train: bool = True,
                   dependent: bool = False, backend: str = "kernel"):
    """SNNU (``snn.step``): one fused SPU -> teach -> NU -> SU cycle in
    one launch.

    Operands as :func:`spike_process` and :func:`stdp_update`; v (and
    ``teach``, or None for no teacher current) int32[n] or [B, n].
    ``train=False`` leaves the SU idle: the input weights and LFSR are
    returned as they are (a shared bank stays [n, w]).  ``dependent``
    launches the kernel as a programmatic dependent of the stream's
    previous kernel, which must be the step that wrote this step's v,
    weights and LFSR: it starts while that one ends and reads the spikes,
    teacher current and ``ltp_prob`` (and a shared bank) before waiting
    for it, so nothing the previous kernel writes may be among those.
    Returns (weights', v', fired bool, lfsr').
    """
    _check_backend(backend)
    if backend == "ref" or weights.device.type == "cpu":
        return _ref.fused_snn_step_ref(
            weights, pre_spikes, v, lfsr_state, teach, threshold, leak,
            w_exp, gain, n_syn, ltp_prob, train)
    what = "fused_snn_step"
    b, shared, lead, n, w = _step_streams(what, pre_spikes, weights)
    operands = dict(weights=(weights, torch.int32, weights.ndim),
                    pre_spikes=(pre_spikes, torch.int32, pre_spikes.ndim),
                    v=(v, torch.int32, pre_spikes.ndim))
    if teach is not None:
        operands["teach"] = (teach, torch.int32, pre_spikes.ndim)
    if train:
        lp = seed_vector(ltp_prob, b, weights.device)
        operands.update(lfsr_state=(lfsr_state, torch.int32, weights.ndim),
                        ltp_prob=(lp, torch.int32, 1))
    dev = _check_operands(what, **operands)
    _check_shapes(what, v=(v, lead + (n,)))
    if teach is not None:
        _check_shapes(what, teach=(teach, lead + (n,)))
    v2 = torch.empty(lead + (n,), dtype=torch.int32, device=dev)
    fired = torch.empty(lead + (n,), dtype=torch.bool, device=dev)
    if train:
        _check_shapes(what, lfsr_state=(lfsr_state, weights.shape))
        _check_window(what, b, n_syn)
        w2 = torch.empty(lead + (n, w), dtype=torch.int32, device=dev)
        lf2 = torch.empty_like(w2)
        su = (lfsr_state.data_ptr(), lp.data_ptr(), w2.data_ptr(),
              lf2.data_ptr())
    else:
        w2, lf2 = weights, lfsr_state
        su = (None, None, None, None)
    if b and n:
        _launch(what, "snn_step", "snn_fused_step", dev, weights.data_ptr(),
                pre_spikes.data_ptr(), v.data_ptr(), su[0],
                None if teach is None else teach.data_ptr(), su[1], su[2],
                v2.data_ptr(), fired.data_ptr(), su[3], b, n, w, shared,
                threshold, leak, w_exp, gain, n_syn, int(train),
                int(dependent))
        _counted(fused_snn_step)
    return w2, v2, fired, lf2


reset_launch_counts()
