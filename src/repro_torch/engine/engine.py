"""The SNN engine: three verbs over one execution plan.

``infer(weights, windows)``
    Spike counts i32[B, n] for B presentation windows, weights frozen,
    membrane reset per sample: the serving path.  One kernel launch.

``train(rf, window, teach)``
    Present one window to one register file with online STDP (SU idle
    for inference-only plans).  One window-kernel launch.

``train_batch(rfs, windows, teach)``
    B independent training streams in one launch, with an optional
    per-stream ``ltp_prob``.

Those are the window path (``cycle_backend="window"``).  On the step
path (``"step"``) each verb instead runs the window cycle by cycle, a
Python loop of ``rvsnn.snn_step`` (the JAX package's ``lax.scan``, under
``vmap`` for the batched verbs): one fused RV-SNN step launch per cycle
for every stream of the call, T launches per window.  ``infer`` runs its
B samples against the one bank (stream stride 0, never copied B times).
The two paths are bit-exact with each other.  On a card the step path
records a window's T launches as one CUDA graph the second time it sees
the window's key (shapes, parameters, device), and replays it from then
on: still one ``fused_snn_step`` per cycle, each a programmatic
dependent of the step before it, without the host's per-launch cost.

The module-level :func:`train_stream` / :func:`train_stream_batch`
compose the verbs over a stream of samples (membrane reset between
samples), with the register file kept on the device across the loop.
With intensities and an in-kernel-encode learning plan, a whole stream
is one launch of the stream kernel (``ops.train_stream_batch_encode``);
otherwise one launch per presented sample.  :func:`refresh_weights`
runs one such pass over a serving-shaped bank.

The engine places its inputs on its device.  On a CUDA device with
``kernel_backend="kernel"`` the kernels are built when the engine is
constructed, so a build failure raises there and not inside a launch.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import torch

from repro_torch.core.bitpack import as_words
from repro_torch.core.encoder import (encode_from_counter_batch,
                                      encode_windows_host)
from repro_torch.core.rvsnn import (SnnRegFile, snn_regfile,
                                    snn_regfile_batch, snn_step)
from repro_torch.core.stdp import STDPParams
from repro_torch.engine.plan import SNNEnginePlan
from repro_torch.kernels import ops


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    asks for another.  Asking for ``cuda`` without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run the plain versions")
    return dev


class SNNOutput(NamedTuple):
    """One presented window: updated regfile + spike statistics."""
    regfile: SnnRegFile
    spike_counts: torch.Tensor  # int32[n] output spikes over the window
    fired: torch.Tensor         # bool[T, n] raster


def reset_between_samples(rf: SnnRegFile) -> SnnRegFile:
    """Clear the membrane and spike registers, keep weights and LFSR
    (the paper resets neuron state between digit presentations)."""
    return rf._replace(v=torch.zeros_like(rf.v),
                       spike=torch.zeros_like(rf.spike))


def _teach_arr(teach, v: torch.Tensor) -> torch.Tensor:
    return (torch.zeros_like(v) if teach is None
            else torch.as_tensor(teach, dtype=torch.int32, device=v.device))


def _last_cycle_spikes(seeds, intensities: torch.Tensor, n_steps: int,
                       words: int) -> torch.Tensor:
    """Packed words of the window's final cycle (the spike register
    after a presentation), regenerated in isolation from the counter.
    intensities uint8[n_in] (one seed) or [B, n_in] (one seed each)."""
    x = intensities if intensities.ndim == 2 else intensities[None]
    rows = encode_from_counter_batch(seeds, x, 1, t0=n_steps - 1)[:, 0]
    pad = words - rows.shape[-1]
    if pad:
        rows = torch.nn.functional.pad(rows, (0, pad))
    return rows if intensities.ndim == 2 else rows[0]


def _one_of(windows, intensities, n_steps, what: str) -> None:
    if (windows is None) == (intensities is None):
        raise ValueError(f"{what}: pass exactly one of the packed "
                         "window(s) or intensities")
    if intensities is not None and n_steps is None:
        raise ValueError(f"{what}: n_steps is required with intensities")


class SNNEngine:
    """Dispatches the three verbs according to one frozen plan."""

    def __init__(self, plan: SNNEnginePlan, device=None):
        self.plan = plan
        self.device = resolve_device(device)
        if self.device.type == "cuda" and plan.kernel_backend == "kernel":
            ops.load_kernels()
        self._ltp = None     # the plan's ltp_prob, int32[1] on the device

    def __repr__(self) -> str:
        return f"SNNEngine({self.plan!r}, device={self.device})"

    # --- encoding --------------------------------------------------------

    def _seeds(self, seeds, b: int, device: torch.device) -> torch.Tensor:
        """Per-sample counter seeds i32[B] on ``device`` (default: plan
        seed + sample index), as :func:`ops.seed_vector` gives them."""
        if seeds is None:
            seeds = self.plan.encode_seed + torch.arange(b)
        return ops.seed_vector(seeds, b, device)

    def _place(self, rf: SnnRegFile) -> SnnRegFile:
        """A register file on the engine's device (words as int32 bit
        patterns; numpy uint32 is accepted)."""
        return SnnRegFile(
            spike=as_words(rf.spike, self.device),
            v=torch.as_tensor(rf.v, dtype=torch.int32, device=self.device),
            lfsr=as_words(rf.lfsr, self.device),
            weights=as_words(rf.weights, self.device))

    # --- infer -----------------------------------------------------------

    def infer(self, weights, windows=None, *, intensities=None, seeds=None,
              n_steps: int | None = None, t_total=None) -> torch.Tensor:
        """Spike counts int32[B, n] for B presentation windows.

        Pass EITHER pre-packed ``windows`` u32[B, T, w] (numpy, or int32
        bit patterns) OR uint8 ``intensities`` [B, n_in] with ``n_steps``
        (and optional per-sample ``seeds`` i32[B] / true lengths
        ``t_total`` i32[B]).  The intensity form draws its spikes from
        the counter, inside the kernel when the plan says
        ``encode="kernel"``, on the host otherwise, with equal counts.
        """
        p = self.plan
        w = as_words(weights, self.device)
        if intensities is not None or windows is None:
            _one_of(windows, intensities, n_steps, "infer")
            inten = torch.as_tensor(intensities, dtype=torch.uint8,
                                    device=self.device)
            sd = self._seeds(seeds, inten.shape[0], w.device)
            if p.encode == "kernel":
                return ops.infer_window_batch_encode(
                    w, inten, sd, n_steps=n_steps, threshold=p.threshold,
                    leak=p.leak, t_total=t_total, t_chunk=p.t_chunk,
                    backend=p.kernel_backend)
            windows = encode_windows_host(sd, inten, n_steps, w.shape[1],
                                          t_total)
        windows = as_words(windows, self.device)
        if p.cycle_backend == "step":
            b, n = windows.shape[0], w.shape[0]
            rf = snn_regfile(w)._replace(
                v=torch.zeros((b, n), dtype=torch.int32, device=w.device))
            _, fired = self._steps(rf, windows.transpose(0, 1).contiguous(),
                                   None, None)
            return fired.sum(dim=0, dtype=torch.int32)
        return ops.infer_window_batch(
            w, windows, threshold=p.threshold, leak=p.leak,
            t_chunk=p.t_chunk, backend=p.kernel_backend)

    # --- train -----------------------------------------------------------

    def _steps(self, rf: SnnRegFile, windows: torch.Tensor, teach,
               stdp: STDPParams | None) -> tuple[SnnRegFile, torch.Tensor]:
        """The step path: one ``snn.step`` launch per cycle of
        ``windows`` (cycle-major: [T, w] for one stream, [T, B, w] for
        the B streams of ``rf``), SU idle when ``stdp`` is None.
        Returns (rf', fired bool[T, ..., n]); T = 0 launches nothing and
        returns ``rf`` as it is."""
        lif = self.plan.lif()
        if (len(windows) and rf.v.device.type == "cuda"
                and self.plan.kernel_backend == "kernel"):
            return _graph_steps(rf, windows, teach, stdp, lif)
        return _run_steps(rf, windows, teach, stdp, lif,
                          self.plan.kernel_backend)

    def _plan_ltp(self) -> torch.Tensor:
        """The plan's ``ltp_prob`` as int32[1] on the device."""
        if self._ltp is None:
            self._ltp = ops.seed_vector(self.plan.ltp_prob, 1, self.device)
        return self._ltp

    def _stdp(self, ltp_prob) -> STDPParams | None:
        """The step path's SU operands, with ``ltp_prob`` (one value per
        stream, on the device); None for an inference-only plan."""
        p = self.plan
        return (STDPParams(p.w_exp, p.gain, p.n_syn, ltp_prob) if p.learn
                else None)

    def _window(self, rf: SnnRegFile, teach: torch.Tensor, *, window=None,
                intensities=None, seed=None, n_steps=None):
        """One stream's window on the plan's path, operands on the
        device (``seed`` int32[1]): (weights', v', fired, lfsr')."""
        p = self.plan
        kw = dict(p.window_kwargs(), t_chunk=p.t_chunk,
                  backend=p.kernel_backend)
        if p.learn:
            kw["ltp_prob"] = self._plan_ltp()
        if window is None and p.encode == "kernel":
            return ops.fused_snn_window_encode(
                rf.weights, intensities, seed, rf.v, rf.lfsr, teach,
                n_steps=n_steps, **kw)
        if window is None:
            window = encode_windows_host(seed, intensities[None], n_steps,
                                         rf.weights.shape[1])[0]
        if p.cycle_backend == "step":
            out, fired = self._steps(rf, window, teach,
                                     self._stdp(kw.get("ltp_prob")))
            return out.weights, out.v, fired, out.lfsr
        return ops.fused_snn_window(rf.weights, window, rf.v, rf.lfsr,
                                    teach, **kw)

    def train(self, rf: SnnRegFile, window=None, teach=None, *,
              intensities=None, seed=None, n_steps: int | None = None
              ) -> SNNOutput:
        """Present one window to one regfile.

        Pass EITHER a packed ``window`` u32[T, w] OR uint8
        ``intensities`` [n_in] with ``n_steps`` (+ optional counter
        ``seed``; default: the plan's).  Online STDP when the plan
        learns (``w_exp`` set); SU idle otherwise.  Returns
        :class:`SNNOutput`; the input register file is not written.
        """
        p = self.plan
        rf = self._place(rf)
        teach = _teach_arr(teach, rf.v)
        words = rf.weights.shape[1]
        if intensities is not None or window is None:
            _one_of(window, intensities, n_steps, "train")
            x = torch.as_tensor(intensities, dtype=torch.uint8,
                                device=self.device)
            sd = ops.seed_vector(p.encode_seed if seed is None else seed,
                                 1, self.device)
            w2, v2, fired, lf2 = self._window(rf, teach, intensities=x,
                                              seed=sd, n_steps=n_steps)
            spike = _last_cycle_spikes(sd, x, n_steps, words)
        else:
            window = as_words(window, self.device)
            w2, v2, fired, lf2 = self._window(rf, teach, window=window)
            spike = window[-1] if len(window) else rf.spike
        rf_out = rf._replace(weights=w2, v=v2, lfsr=lf2, spike=spike)
        return SNNOutput(rf_out, fired.sum(dim=0, dtype=torch.int32), fired)

    # --- train_batch -----------------------------------------------------

    def _window_batch(self, rfs: SnnRegFile, teach: torch.Tensor,
                      ltp_prob, *, windows=None, intensities=None,
                      seeds=None, n_steps=None):
        """B streams' windows in one launch, operands on the device:
        (weights', v', fired, lfsr')."""
        p = self.plan
        kw = {k: v for k, v in p.window_kwargs().items()
              if k not in ("train", "ltp_prob")}
        kw.update(ltp_prob=ltp_prob, t_chunk=p.t_chunk,
                  backend=p.kernel_backend)
        if windows is None and p.encode == "kernel":
            return ops.train_window_batch_encode(
                rfs.weights, intensities, seeds, rfs.v, rfs.lfsr, teach,
                n_steps=n_steps, **kw)
        if windows is None:
            windows = encode_windows_host(seeds, intensities, n_steps,
                                          rfs.weights.shape[2])
        if p.cycle_backend == "step":
            out, fired = self._steps(rfs, windows.transpose(0, 1)
                                     .contiguous(), teach,
                                     self._stdp(ltp_prob))
            return out.weights, out.v, fired.transpose(0, 1), out.lfsr
        return ops.train_window_batch(rfs.weights, windows, rfs.v,
                                      rfs.lfsr, teach, **kw)

    def _stream_kernel(self, rfs: SnnRegFile, intensities: torch.Tensor,
                       seeds: torch.Tensor, teach: torch.Tensor,
                       ltp_prob: torch.Tensor, n_steps: int):
        """B streams of N samples in one stream-kernel launch: batched
        ``rfs``, intensities uint8[N, B, n_in], seeds i32[N, B], teach
        i32[N, B, n] (any strides on the first two axes).  Returns
        (weights', v', counts i32[N, B, n], lfsr')."""
        p = self.plan
        kw = {k: v for k, v in p.window_kwargs().items()
              if k not in ("train", "ltp_prob")}
        return ops.train_stream_batch_encode(
            rfs.weights, intensities, seeds, rfs.lfsr, teach,
            n_steps=n_steps, ltp_prob=ltp_prob, backend=p.kernel_backend,
            **kw)

    def _stream_ltp(self, ltp_prob, b: int) -> torch.Tensor:
        """Per-stream ``ltp_prob`` int32[b] on the device (default: the
        plan's, for every stream)."""
        lp = self.plan.ltp_prob if ltp_prob is None else ltp_prob
        return ops.seed_vector(lp, b, self.device)

    def train_batch(self, rfs: SnnRegFile, windows=None, teach=None, *,
                    ltp_prob=None, intensities=None, seeds=None,
                    n_steps: int | None = None
                    ) -> tuple[SnnRegFile, torch.Tensor, torch.Tensor]:
        """B independent streams, one launch: a batched regfile (leading
        stream axis), windows u32[B, T, w] OR intensities uint8
        [B, n_in] + ``n_steps`` (+ per-stream counter ``seeds`` i32[B]),
        teach i32[B, n].

        ``ltp_prob`` overrides the plan's shared value with a per-stream
        i32[B] vector.  Returns (rfs', spike_counts i32[B, n], fired
        bool[B, T, n]); stream b is bit-exact with a :meth:`train` call
        on regfile b.
        """
        p = self.plan
        if not p.learn:
            raise ValueError("train_batch needs a learning plan "
                             "(w_exp is None)")
        rfs = self._place(rfs)
        lp = self._stream_ltp(ltp_prob, rfs.v.shape[0])
        teach = _teach_arr(teach, rfs.v)
        words = rfs.weights.shape[2]
        if intensities is not None or windows is None:
            _one_of(windows, intensities, n_steps, "train_batch")
            x = torch.as_tensor(intensities, dtype=torch.uint8,
                                device=self.device)
            sd = self._seeds(seeds, x.shape[0], self.device)
            w2, v2, fired, lf2 = self._window_batch(
                rfs, teach, lp, intensities=x, seeds=sd, n_steps=n_steps)
            spike = _last_cycle_spikes(sd, x, n_steps, words)
        else:
            windows = as_words(windows, self.device)
            w2, v2, fired, lf2 = self._window_batch(rfs, teach, lp,
                                                    windows=windows)
            spike = windows[:, -1] if windows.shape[1] else rfs.spike
        rfs_out = rfs._replace(weights=w2, v=v2, lfsr=lf2, spike=spike)
        return rfs_out, fired.sum(dim=1, dtype=torch.int32), fired


# --- the step path: eager cycles, or one CUDA graph per window key ----------

def _run_steps(rf: SnnRegFile, windows: torch.Tensor, teach,
               stdp: STDPParams | None, lif, backend: str,
               dependent: bool = False) -> tuple[SnnRegFile, torch.Tensor]:
    """One ``snn.step`` per cycle of ``windows``; with ``dependent`` every
    step after the first launches as a programmatic dependent of the one
    before it."""
    rasters = []
    for t, words in enumerate(windows):
        rf, fired = snn_step(rf, words, lif, stdp, teach, backend=backend,
                             dependent=dependent and t > 0)
        rasters.append(fired)
    if not rasters:
        return rf, torch.zeros((0,) + rf.v.shape, dtype=torch.bool,
                               device=rf.v.device)
    return rf, torch.stack(rasters)


class _StepGraph:
    """A window's T ``snn.step`` launches recorded once as a CUDA graph:
    T ``fused_snn_step`` kernel nodes, the first launched as usual, each
    later one a programmatic dependent of the one before.  Its inputs are
    static buffers, filled before each replay; its outputs are copied out
    after it, so nothing returned aliases memory a later replay writes."""

    def __init__(self, rf: SnnRegFile, windows: torch.Tensor, teach,
                 stdp: STDPParams | None, lif):
        def buffer(x):
            return torch.empty(x.shape, dtype=x.dtype, device=x.device)

        self.rf = SnnRegFile(*(buffer(x) for x in rf))
        self.windows = buffer(windows)
        self.teach = None if teach is None else buffer(teach)
        self.stdp = (None if stdp is None else
                     stdp._replace(ltp_prob=buffer(stdp.ltp_prob)))
        self.cycles = len(windows)
        self.graph = torch.cuda.CUDAGraph()
        dev = windows.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.graph.capture_begin()
            try:
                self.out = _run_steps(self.rf, self.windows, self.teach,
                                      self.stdp, lif, "kernel",
                                      dependent=True)
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)

    def replay(self, rf: SnnRegFile, windows: torch.Tensor, teach,
               stdp: STDPParams | None) -> tuple[SnnRegFile, torch.Tensor]:
        s = self.rf
        s.weights.copy_(rf.weights)
        s.v.copy_(rf.v)
        self.windows.copy_(windows)
        if self.teach is not None:
            self.teach.copy_(teach)
        if self.stdp is not None:
            s.lfsr.copy_(rf.lfsr)
            self.stdp.ltp_prob.copy_(stdp.ltp_prob)
        self.graph.replay()
        ops.fused_snn_step.launches += self.cycles
        _graph_stats["replays"] += 1
        out, fired = self.out

        def own(got, static, given):
            return given if got is static else got.clone()

        return (rf._replace(spike=windows[-1], v=out.v.clone(),
                            weights=own(out.weights, s.weights, rf.weights),
                            lfsr=own(out.lfsr, s.lfsr, rf.lfsr)),
                fired.clone())


# One cache for the process, not per engine: the trainer builds an engine
# per block and per classification, and their windows share keys.
_GRAPHS_KEPT = 8           # recorded windows kept (least recently used go)
_KEYS_KEPT = 64            # window keys remembered as seen once
_graphs: collections.OrderedDict = collections.OrderedDict()
_seen: collections.OrderedDict = collections.OrderedDict()
_graph_stats = {"recorded": 0, "replays": 0}


def _keep(cache: collections.OrderedDict, key, value, size: int) -> None:
    cache[key] = value
    cache.move_to_end(key)
    while len(cache) > size:
        cache.popitem(last=False)


def _graph_steps(rf: SnnRegFile, windows: torch.Tensor, teach,
                 stdp: STDPParams | None, lif
                 ) -> tuple[SnnRegFile, torch.Tensor]:
    """The step path on a card.  A window key (shapes, LIF and STDP
    constants, teacher current or none, device) seen for the first time
    runs its steps one launch each, which also warms up what a capture
    needs; the second time, its launches are recorded as a
    :class:`_StepGraph`; from then on the graph is replayed.  A capture
    or replay that fails raises."""
    key = (tuple(windows.shape), tuple(rf.weights.shape),
           tuple(rf.v.shape), None if teach is None else tuple(teach.shape),
           None if stdp is None else (stdp.w_exp, stdp.gain, stdp.n_syn,
                                      tuple(stdp.ltp_prob.shape)),
           tuple(lif), str(windows.device))
    graph = _graphs.get(key)
    if graph is None:
        if key not in _seen:
            _keep(_seen, key, None, _KEYS_KEPT)
            return _run_steps(rf, windows, teach, stdp, lif, "kernel")
        graph = _StepGraph(rf, windows, teach, stdp, lif)
        _graph_stats["recorded"] += 1
    _keep(_graphs, key, graph, _GRAPHS_KEPT)
    return graph.replay(rf, windows, teach, stdp)


def step_graph_stats() -> dict[str, int]:
    """The step path's CUDA graphs: how many are kept now, and how many
    were recorded and replayed since the process started."""
    return dict(_graph_stats, kept=len(_graphs))


# --- stream drivers (compose the verbs over the sample axis) ---------------

def _stream_in_kernel(plan: SNNEnginePlan) -> bool:
    """Whether a stream of intensities runs as one stream-kernel launch:
    an in-kernel-encode plan that learns."""
    return plan.encode == "kernel" and plan.learn


def _counts(rasters: list[torch.Tensor], shape, device) -> torch.Tensor:
    """Per-sample spike counts from per-sample rasters [..., T, n],
    stacked on a new leading sample axis, in one reduction."""
    if not rasters:
        return torch.zeros(shape, dtype=torch.int32, device=device)
    return torch.stack(rasters).sum(dim=-2, dtype=torch.int32)


def train_stream(engine: SNNEngine, rf: SnnRegFile, spike_trains=None,
                 teach=None, *, intensities=None, seeds=None,
                 n_steps: int | None = None
                 ) -> tuple[SnnRegFile, torch.Tensor]:
    """Online STDP over a stream of samples (sequential, as in hardware).

    Pass EITHER pre-packed ``spike_trains`` u32[N, T, w] OR uint8
    ``intensities`` [N, n_in] with ``n_steps`` and per-sample counter
    ``seeds`` i32[N] (default: the engine's seed chain); teach
    i32[N, n].  Neuron state resets between presentations; weights and
    LFSR persist.  One window launch per sample, with the regfile kept
    on the engine's device (one stream-kernel launch for the whole
    stream with intensities on an in-kernel-encode plan); the spike
    register of the result is the last presentation's.  Returns (rf',
    spike_counts i32[N, n]).
    """
    _one_of(spike_trains, intensities, n_steps, "train_stream")
    dev = engine.device
    rf = engine._place(rf)
    n, words = rf.weights.shape
    if intensities is not None:
        samples = torch.as_tensor(intensities, dtype=torch.uint8,
                                  device=dev)
        sd = engine._seeds(seeds, samples.shape[0], dev)
    else:
        samples = as_words(spike_trains, dev)
    n_samples = samples.shape[0]
    teach = (torch.zeros((n_samples, n), dtype=torch.int32, device=dev)
             if teach is None else
             torch.as_tensor(teach, dtype=torch.int32, device=dev))
    if intensities is not None and n_samples and _stream_in_kernel(
            engine.plan):
        w2, v2, counts, lf2 = engine._stream_kernel(
            SnnRegFile(*(x[None] for x in rf)), samples[:, None],
            sd[:, None], teach[:, None], engine._plan_ltp(), n_steps)
        spike = _last_cycle_spikes(sd[-1:], samples[-1], n_steps, words)
        return rf._replace(weights=w2[0], v=v2[0], lfsr=lf2[0],
                           spike=spike), counts[:, 0]
    v0 = torch.zeros_like(rf.v)        # read, never written, by launches
    rasters = []
    for i in range(n_samples):
        cur = rf._replace(v=v0)
        if intensities is not None:
            out = engine._window(cur, teach[i], intensities=samples[i],
                                 seed=sd[i:i + 1], n_steps=n_steps)
        else:
            out = engine._window(cur, teach[i], window=samples[i])
        w2, v2, fired, lf2 = out
        rf = rf._replace(weights=w2, v=v2, lfsr=lf2)
        rasters.append(fired)
    if n_samples:
        spike = (_last_cycle_spikes(sd[-1:], samples[-1], n_steps, words)
                 if intensities is not None else samples[-1, -1])
        rf = rf._replace(spike=spike)
    return rf, _counts(rasters, (0, n), dev)


def train_stream_batch(engine: SNNEngine, rfs: SnnRegFile,
                       spike_trains=None, teach=None, *, ltp_prob=None,
                       intensities=None, seeds=None,
                       n_steps: int | None = None
                       ) -> tuple[SnnRegFile, torch.Tensor]:
    """B independent sample streams, one :meth:`SNNEngine.train_batch`
    launch per presented sample.

    Pass EITHER ``spike_trains`` u32[B, N, T, w] OR uint8
    ``intensities`` [B, N, n_in] with ``n_steps`` and per-sample
    ``seeds`` i32[N] (shared by every stream) or i32[B, N]; teach
    i32[B, N, n].  ``ltp_prob`` optionally carries a per-stream i32[B]
    schedule through every launch.  With intensities and an
    in-kernel-encode plan, the whole stream is one launch.  Returns
    (rfs', spike_counts i32[B, N, n]).
    """
    _one_of(spike_trains, intensities, n_steps, "train_stream_batch")
    p = engine.plan
    if not p.learn:
        raise ValueError("train_stream_batch needs a learning plan "
                         "(w_exp is None)")
    dev = engine.device
    rfs = engine._place(rfs)
    b, n, words = rfs.weights.shape
    lp = engine._stream_ltp(ltp_prob, b)
    # sample-major copies, so each launch reads contiguous [B, ...] slabs
    if intensities is not None:
        x = torch.as_tensor(intensities, dtype=torch.uint8, device=dev)
        n_samples = x.shape[1]
        samples = x.transpose(0, 1)
        sd = torch.as_tensor(engine._seeds(None, n_samples, dev)
                             if seeds is None else seeds)
        sd = ops.seed_vector(sd.expand(b, n_samples).reshape(-1),
                             b * n_samples, dev)
        sd = sd.reshape(b, n_samples).transpose(0, 1).contiguous()
    else:
        trains = as_words(spike_trains, dev)
        n_samples = trains.shape[1]
        samples = trains.transpose(0, 1).contiguous()
    teach_t = (torch.zeros((n_samples, b, n), dtype=torch.int32, device=dev)
               if teach is None else
               torch.as_tensor(teach, dtype=torch.int32, device=dev)
               .transpose(0, 1))
    if intensities is not None and n_samples and _stream_in_kernel(p):
        # the stream kernel reads the sample-major views in place
        w2, v2, counts, lf2 = engine._stream_kernel(
            rfs, samples, sd, teach_t, lp, n_steps)
        spike = _last_cycle_spikes(sd[-1], samples[-1], n_steps, words)
        return (rfs._replace(weights=w2, v=v2, lfsr=lf2, spike=spike),
                counts.transpose(0, 1))
    teach_t = teach_t.contiguous()
    v0 = torch.zeros_like(rfs.v)
    rasters = []
    for i in range(n_samples):
        cur = rfs._replace(v=v0)
        if intensities is not None:
            out = engine._window_batch(cur, teach_t[i], lp,
                                       intensities=samples[i].contiguous(),
                                       seeds=sd[i], n_steps=n_steps)
        else:
            out = engine._window_batch(cur, teach_t[i], lp,
                                       windows=samples[i])
        w2, v2, fired, lf2 = out
        rfs = rfs._replace(weights=w2, v=v2, lfsr=lf2)
        rasters.append(fired)
    if n_samples:
        spike = (_last_cycle_spikes(sd[-1], samples[-1], n_steps, words)
                 if intensities is not None else samples[-1][:, -1])
        rfs = rfs._replace(spike=spike)
    return rfs, _counts(rasters, (0, b, n), dev).transpose(0, 1)


def refresh_weights(engine: SNNEngine, weights, *, labels, n_classes: int,
                    teach_pos: int = 64, teach_neg: int = -1024,
                    intensities=None, seeds=None, n_steps: int | None = None,
                    spike_trains=None, lfsr_seeds=None,
                    ltp_prob=None) -> torch.Tensor:
    """One online-STDP refresh pass over a packed population bank: the
    train-while-serving verb.

    ``weights`` is a serving-shaped u32[n, w] bank whose n = blocks x
    ``n_classes`` rows follow the trainer's block layout (neuron i's
    class is ``i % n_classes``).  The bank is reshaped into per-block
    regfiles, the labeled samples go through :func:`train_stream_batch`
    across all blocks (one stream-kernel launch for intensities on an
    in-kernel-encode plan), and the result is reshaped back.  Samples
    are uint8 ``intensities`` [N, n_in] + counter ``seeds`` i32[N] with
    ``n_steps``, OR pre-packed ``spike_trains`` u32[N, T, w].
    ``teach_pos``/``teach_neg`` build the supervision currents from
    ``labels`` as the trainer does; ``lfsr_seeds`` (one per block,
    default a fixed decorrelated chain) key the STDP lanes; ``ltp_prob``
    optionally carries a per-block schedule.  Returns a new bank
    int32[n, w] on the engine's device; the input bank is never written.
    """
    if not engine.plan.learn:
        raise ValueError("refresh_weights needs a learning plan "
                         "(w_exp is None)")
    bank = as_words(weights, engine.device)
    n, w = bank.shape
    if n % n_classes:
        raise ValueError(f"weight bank rows ({n}) must be a multiple "
                         f"of n_classes ({n_classes})")
    b = n // n_classes
    if lfsr_seeds is None:
        # a fixed decorrelated per-block chain (the 0x9E37 Weyl step
        # lfsr.seed uses); refresh determinism comes from the caller's
        # epoch-keyed sample seeds, not from these bases
        lfsr_seeds = [(0x22A + 0x9E37 * i) & 0xFFFF or 0xACE1
                      for i in range(b)]
    rfs = snn_regfile_batch(bank.reshape(b, n_classes, w), lfsr_seeds)
    labels = torch.as_tensor(labels, dtype=torch.int64, device=engine.device)
    onehot = torch.nn.functional.one_hot(labels, n_classes).to(torch.int32)
    teach = onehot * teach_pos + (1 - onehot) * teach_neg
    teach_b = teach.expand((b,) + teach.shape)
    if intensities is not None:
        x = torch.as_tensor(intensities, dtype=torch.uint8,
                            device=engine.device)
        rfs, _ = train_stream_batch(engine, rfs, teach=teach_b,
                                    ltp_prob=ltp_prob,
                                    intensities=x.expand((b,) + x.shape),
                                    seeds=seeds, n_steps=n_steps)
    else:
        trains = as_words(spike_trains, engine.device)
        rfs, _ = train_stream_batch(engine, rfs,
                                    trains.expand((b,) + trains.shape),
                                    teach_b, ltp_prob=ltp_prob)
    return rfs.weights.reshape(n, w)
