"""RV-SNN granularity on the port: the fused SNNU step against the
unfused SPU -> NU -> SU chain, and the time axis on top: the window
kernel against T separate step launches.

The counterpart of the JAX package's ``benchmarks/kernels_bench.py``:
the same rows, by the same names, with the same analytic fields, on the
port's :mod:`~repro_torch.kernels.ops` on ``device`` (``cuda`` by
default: the CUDA kernels; ``cpu``: their plain versions).  Each row
reports the wall time of a call on the device (synchronized; median of
5) and the structural metric that does not depend on the device: the
analytic minimum bytes a call must move.

Four levels of scale-out, each against its sequential baseline:
  * fused step vs unfused SPU -> NU -> SU chain (one cycle, 3 launches);
  * fused window vs T fused-step launches (weights and LFSR cross
    memory once per window instead of once per cycle);
  * batched training grid vs B sequential window launches;
  * the window ops split over a device grid vs one device
    (``repro_torch.distributed.snn_mesh --bench`` in a process of its
    own; on one card every shard runs there, ``--on cuda:0``, so the
    time shows the cost of the shards' launches, not a speed-up).
Plus the in-kernel encode (input bytes), intensity-resident training
(dataset bytes), two analytic-only rows and the serving latency rows.
The JAX rows ``*-interp-*`` time its Pallas interpreter; here the rows
of those names time the plain versions at the same shapes
(``backend=ref``).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch.bench.common import emit, time_fn
from repro_torch.core import lfsr
from repro_torch.core.bitpack import as_words
from repro_torch.engine import resolve_device
from repro_torch.kernels import ops

_SRC = Path(__file__).resolve().parents[2]

KW = dict(threshold=192, leak=16, w_exp=128, gain=4, ltp_prob=16)

FUSED_SHAPES = ((256, 32), (1024, 64), (4096, 256))           # (n, w)
WINDOW_SHAPES = ((256, 32, 72), (1024, 64, 32), (1024, 64, 128))  # T
BATCH_SHAPES = ((16, 25, 72, 8), (128, 32, 32, 8))            # (.., B)
SHARD = dict(devices=8, n=1024, w=64, t=32, b=8)
ENCODE_SHAPES = ((1024, 64, 32), (1024, 64, 128))
ENCODE_BATCH = 8
INTENSITY_SHAPE = (256, 25, 128, 32)                          # (n, w, T, B)
GRID_2D = dict(data=2, neurons=4, n=1024, w=64, t=32, b=32)
STREAM_ROW = (1024, 64, 2048)
CHUNK_ROW = (1024, 64, 2048, 64)                              # (.., t_chunk)
SERVE = dict(n_req=32, n=64, w=8, t=16)
# the serving rows' wall-clock latencies
LATENCY_FIELDS = ("queue_wait_ms_p50", "queue_wait_ms_p99",
                  "service_ms_p50", "service_ms_p99")
# the fields a row times on its device; every other field of a row
# follows from its shapes or counts, and equals the JAX package's row of
# the same name
TIMED_FIELDS = ("us_per_call", "time_ratio") + LATENCY_FIELDS


def untimed(row: dict) -> dict:
    """``row``'s fields but its name, its timed fields and ``backend``
    (the ``*-interp-*`` rows time the plain versions here, ``ref``,
    where the JAX package's time its Pallas interpreter)."""
    return {k: v for k, v in row.items()
            if k not in TIMED_FIELDS + ("name", "backend")}


# --- analytic fields (bytes a call must move, from the shapes) ----------------

def fused_bytes(n: int, w: int) -> tuple[int, int]:
    """Minimum memory bytes of one cycle: (fused, unfused).
      fused:   W r+w, LFSR r+w, spikes r                (one pass)
      unfused: W r (SPU) + r+w (SU), LFSR r+w, spikes r (SPU) + r (SU),
               counts w+r, V r+w, fired w+r             (3 launches)"""
    wb, sb, nb = n * w * 4, w * 4, n * 4
    return (2 * wb + 2 * wb + sb,
            3 * wb + 2 * wb + 2 * sb + 2 * nb + 2 * nb + 2 * n)


def window_bytes(n: int, w: int, t_steps: int) -> tuple[int, int]:
    """Minimum memory bytes of one window: (T step launches, window).
      per step: every launch round-trips weights + LFSR and reads its
                spike row                     -> T * (4*wb + sb)
      window:   weights + LFSR cross once, the T spike rows stream in,
                the raster and v stream out"""
    wb, sb, nb = n * w * 4, w * 4, n * 4
    return (t_steps * (4 * wb + sb),
            4 * wb + t_steps * sb + t_steps * n + 2 * nb)


# --- the rows -----------------------------------------------------------------

def _operands(n, w, dev, seed=0):
    rng = np.random.default_rng(seed)
    weights = as_words(rng.integers(0, 2**32, (n, w), dtype=np.uint32), dev)
    pre = as_words(rng.integers(0, 2**32, (w,), dtype=np.uint32), dev)
    v = torch.zeros((n,), dtype=torch.int32, device=dev)
    teach = torch.zeros((n,), dtype=torch.int32, device=dev)
    st = lfsr.seed(1, n * w, device=dev).reshape(n, w)
    return weights, pre, v, st, teach


def _ratio(a: float, b: float) -> float:
    return a / max(b, 1e-9)


def _granularity_rows(dev, out: dict) -> None:
    """Fused vs unfused cycle, window vs T step launches, batched grid
    vs B windows."""
    for n, w in FUSED_SHAPES:
        n_syn = w * 32
        weights, pre, v, st, teach = _operands(n, w, dev)

        def fused(*a, n_syn=n_syn):
            return ops.fused_snn_step(*a, n_syn=n_syn, **KW)

        # the unfused path is three separate kernel launches (the
        # fine-grained instruction sequence), each a round trip to memory
        def unfused_chain(weights, pre, v, st, teach, n_syn=n_syn):
            counts = ops.spike_process(pre, weights)
            v2, fired = ops.lif_step(v, counts + teach, KW["threshold"],
                                     KW["leak"])
            w2, s2 = ops.stdp_update(weights, pre, fired, st,
                                     w_exp=KW["w_exp"], gain=KW["gain"],
                                     n_syn=n_syn, ltp_prob=KW["ltp_prob"])
            return w2, v2, fired, s2

        t_f = time_fn(fused, weights, pre, v, st, teach, reps=5,
                      device=dev)
        t_u = time_fn(unfused_chain, weights, pre, v, st, teach, reps=5,
                      device=dev)
        b_f, b_u = fused_bytes(n, w)
        emit(f"kernels/fused-{n}x{n_syn}", t_f, f"min_hbm_bytes={b_f}")
        emit(f"kernels/unfused-{n}x{n_syn}", t_u,
             f"min_hbm_bytes={b_u};bytes_ratio={b_u/b_f:.2f}x;"
             f"time_ratio={_ratio(t_u, t_f):.2f}x")
        out[(n, n_syn)] = {"bytes_ratio": b_u / b_f,
                           "time_ratio": _ratio(t_u, t_f)}

    # --- time axis: window kernel vs T per-step fused launches ----------
    rng = np.random.default_rng(7)
    for n, w, t_steps in WINDOW_SHAPES:
        n_syn = w * 32
        weights, _, v, st, teach = _operands(n, w, dev)
        spk = as_words(rng.integers(0, 2**32, (t_steps, w), dtype=np.uint32),
                       dev)

        def window(*a, n_syn=n_syn):
            return ops.fused_snn_window(*a, n_syn=n_syn, **KW)

        # the per-step path is T separate launches, state round-tripping
        # memory between them (not a CUDA graph: a graph would replay
        # the same launches without the host, measuring something else)
        def step_chain(weights, spk, v, st, teach, n_syn=n_syn):
            for t in range(spk.shape[0]):
                weights, v, _, st = ops.fused_snn_step(
                    weights, spk[t], v, st, teach, n_syn=n_syn, **KW)
            return weights, v, st

        t_w = time_fn(window, weights, spk, v, st, teach, reps=5,
                      device=dev)
        t_s = time_fn(step_chain, weights, spk, v, st, teach, reps=5,
                      device=dev)
        b_steps, b_win = window_bytes(n, w, t_steps)
        emit(f"kernels/window-{n}x{n_syn}xT{t_steps}", t_w,
             f"min_hbm_bytes={b_win};bytes_ratio={b_steps/b_win:.2f}x;"
             f"time_ratio={_ratio(t_s, t_w):.2f}x")
        out[(n, n_syn, t_steps)] = {"bytes_ratio": b_steps / b_win,
                                    "time_ratio": _ratio(t_s, t_w)}

    # --- batch axis: batched training grid vs B sequential windows ------
    for n, w, t_steps, b in BATCH_SHAPES:
        n_syn = w * 32
        rngb = np.random.default_rng(11)
        wts = as_words(rngb.integers(0, 2**32, (b, n, w), dtype=np.uint32),
                       dev)
        spk = as_words(rngb.integers(0, 2**32, (b, t_steps, w),
                                     dtype=np.uint32), dev)
        v = torch.zeros((b, n), dtype=torch.int32, device=dev)
        teach = torch.zeros((b, n), dtype=torch.int32, device=dev)
        st = torch.stack([lfsr.seed(1 + i, n * w, device=dev).reshape(n, w)
                          for i in range(b)])

        def batched(*a, n_syn=n_syn):
            return ops.train_window_batch(*a, n_syn=n_syn, **KW)

        # the sequential baseline is B separate window launches, one per
        # training stream
        def seq_chain(wts, spk, v, st, teach, n_syn=n_syn, b=b):
            return [ops.fused_snn_window(wts[i], spk[i], v[i], st[i],
                                         teach[i], n_syn=n_syn, **KW)
                    for i in range(b)]

        t_b = time_fn(batched, wts, spk, v, st, teach, reps=5, device=dev)
        t_q = time_fn(seq_chain, wts, spk, v, st, teach, reps=5, device=dev)
        emit(f"kernels/train-batch-{n}x{n_syn}xT{t_steps}xB{b}", t_b,
             f"launches=1_vs_{b};time_ratio={_ratio(t_q, t_b):.2f}x")
        out[("train_batch", n, n_syn, t_steps, b)] = {
            "time_ratio": _ratio(t_q, t_b)}


def _grid_bench(dev: torch.device, flags: list[str], prefix: str,
                what: str) -> dict | None:
    """``snn_mesh --bench`` in a process of its own (every shard on the
    card, or the CPU repeated); the ``prefix`` line's fields, or None
    (the row is skipped) where it fails."""
    where = (["--device", "cpu"] if dev.type == "cpu" else
             ["--device", str(dev), "--on", str(dev)])
    env = dict(os.environ)
    env["PYTHONPATH"] = str(_SRC) + os.pathsep + env.get("PYTHONPATH", "")
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.distributed.snn_mesh",
             "--bench", *where, *flags], env=env, capture_output=True,
            text=True, timeout=600)
    except subprocess.TimeoutExpired as e:
        proc = subprocess.CompletedProcess(e.cmd, -1, stdout="",
                                           stderr="timeout after 600s")
    row = next((ln for ln in proc.stdout.splitlines()
                if ln.startswith(prefix + " ")), None)
    if proc.returncode != 0 or row is None:
        print(f"# {what} row skipped (rc={proc.returncode}): "
              f"{proc.stderr.strip()[-400:]}")
        return None
    return dict(p.split("=", 1) for p in row.split()[1:])


def _shard_row(dev, out: dict) -> None:
    """The neuron axis: the window ops over a grid of 8 vs one device."""
    s = SHARD
    n_syn = s["w"] * 32
    kv = _grid_bench(dev, ["--devices", str(s["devices"]), "--neurons",
                           str(s["n"]), "--words", str(s["w"]), "--steps",
                           str(s["t"]), "--batch", str(s["b"])],
                     "BENCH", "window-shard")
    if kv is not None:
        t_1, t_d = float(kv["t_single_us"]), float(kv["t_shard_us"])
        # each device reads only its n/D rows once per launch: the
        # capacity metric that lets populations outgrow one device
        wb = s["n"] * s["w"] * 4
        emit(f"kernels/window-shard-{s['n']}x{n_syn}xD{s['devices']}", t_d,
             f"per_device_weight_bytes={wb // s['devices']};"
             f"bytes_ratio={s['devices']:.2f}x;"
             f"time_ratio={_ratio(t_1, t_d):.2f}x")
        out[("shard", s["n"], n_syn, s["devices"])] = {
            "bytes_ratio": float(s["devices"]),
            "time_ratio": _ratio(t_1, t_d)}


def _grid2d_row(dev, out: dict) -> None:
    """The 2-D grid: the batched training grid on 2 x 4 vs the 1-D grid
    of 8."""
    g = GRID_2D
    n_syn = g["w"] * 32
    kv = _grid_bench(dev, ["--mesh-shape", f"{g['data']},{g['neurons']}",
                           "--neurons", str(g["n"]), "--words", str(g["w"]),
                           "--steps", str(g["t"]), "--batch", str(g["b"])],
                     "BENCH2D", "train-2d")
    if kv is not None:
        t_1d, t_2d = float(kv["t_1d_us"]), float(kv["t_2d_us"])
        # a (d, n) grid gives each device b/d streams x 1/n of every
        # register file: d x fewer window bytes than the 1-D grid, which
        # hands every device all b streams' windows
        emit(f"kernels/train-2d-{g['n']}x{n_syn}xT{g['t']}xB{g['b']}", t_2d,
             f"mesh={g['data']}x{g['neurons']};"
             f"streams_per_device={g['b'] // g['data']};"
             f"bytes_ratio={float(g['data']):.2f}x;"
             f"time_ratio={_ratio(t_1d, t_2d):.2f}x")
        out[("train-2d", g["n"], n_syn, g["t"], g["b"])] = {
            "bytes_ratio": float(g["data"]),
            "time_ratio": _ratio(t_1d, t_2d)}


def _encode_rows(dev, out: dict) -> None:
    """In-kernel encode vs pre-packed windows (serving), and
    intensity-resident training vs host pre-encode."""
    from repro_torch.core.encoder import encode_from_counter_batch

    # the serving input shrinks from the T*w*4-byte packed window to the
    # n_in uint8 intensities it is drawn from; wall time compares end to
    # end from intensities: host counter encode + pre-packed launch vs
    # the one encode launch
    b = ENCODE_BATCH
    for n, w, t_steps in ENCODE_SHAPES:
        n_in = w * 32
        rng_e = np.random.default_rng(13)
        weights = as_words(rng_e.integers(0, 2**32, (n, w), dtype=np.uint32),
                           dev)
        inten = torch.from_numpy(
            rng_e.integers(0, 256, (b, n_in), dtype=np.uint8)).to(dev)
        seeds = torch.arange(1, b + 1, dtype=torch.int32, device=dev)

        def pre(wt, x, s, t=t_steps):
            return ops.infer_window_batch(
                wt, encode_from_counter_batch(s, x, t),
                threshold=KW["threshold"], leak=KW["leak"])

        def enc(wt, x, s, t=t_steps):
            return ops.infer_window_batch_encode(
                wt, x, s, n_steps=t, threshold=KW["threshold"],
                leak=KW["leak"])

        t_pre = time_fn(pre, weights, inten, seeds, reps=5, device=dev)
        t_enc = time_fn(enc, weights, inten, seeds, reps=5, device=dev)
        in_pre = t_steps * w * 4           # packed window bytes a sample
        in_enc = n_in                      # uint8 intensity bytes a sample
        emit(f"kernels/encode-{n}x{n_in}xT{t_steps}", t_enc,
             f"input_bytes={in_enc};bytes_ratio={in_pre/in_enc:.2f}x;"
             f"time_ratio={_ratio(t_pre, t_enc):.2f}x")
        out[("encode", n, n_in, t_steps)] = {
            "bytes_ratio": in_pre / in_enc,
            "time_ratio": _ratio(t_pre, t_enc)}

    # the trainer's ingestion: with encode="kernel" the dataset stays n_in
    # uint8 bytes a sample instead of the T*w*4-byte pre-packed window;
    # wall time: host counter encode + pre-packed batched training vs
    # the one-sample-a-stream encode launch
    n, w, t_steps, b = INTENSITY_SHAPE
    n_in = n_syn = w * 32
    rng_t = np.random.default_rng(17)
    wts = as_words(rng_t.integers(0, 2**32, (b, n, w), dtype=np.uint32), dev)
    inten = torch.from_numpy(
        rng_t.integers(0, 256, (b, n_in), dtype=np.uint8)).to(dev)
    seeds = torch.arange(1, b + 1, dtype=torch.int32, device=dev)
    v = torch.zeros((b, n), dtype=torch.int32, device=dev)
    teach = torch.zeros((b, n), dtype=torch.int32, device=dev)
    st = torch.stack([lfsr.seed(1 + i, n * w, device=dev).reshape(n, w)
                      for i in range(b)])

    def pre_t(wt, x, s, vv, lf, tc):
        return ops.train_window_batch(
            wt, encode_from_counter_batch(s, x, t_steps), vv, lf, tc,
            n_syn=n_syn, **KW)

    def enc_t(wt, x, s, vv, lf, tc):
        return ops.train_window_batch_encode(
            wt, x, s, vv, lf, tc, n_steps=t_steps, n_syn=n_syn, **KW)

    t_pre = time_fn(pre_t, wts, inten, seeds, v, st, teach, reps=5,
                    device=dev)
    t_enc = time_fn(enc_t, wts, inten, seeds, v, st, teach, reps=5,
                    device=dev)
    ds_pre, ds_int = t_steps * w * 4, n_in
    if ds_pre / ds_int < 8.0:
        raise AssertionError(f"dataset-bytes reduction collapsed: "
                             f"{ds_pre}/{ds_int}")
    emit(f"kernels/train-intensity-{n}x{n_in}xT{t_steps}xB{b}", t_enc,
         f"dataset_bytes={ds_int};bytes_ratio={ds_pre/ds_int:.2f}x;"
         f"time_ratio={_ratio(t_pre, t_enc):.2f}x")
    out[("train-intensity", n, n_in, t_steps, b)] = {
        "bytes_ratio": ds_pre / ds_int, "time_ratio": _ratio(t_pre, t_enc)}


def _analytic_and_plain_rows(dev, out: dict) -> None:
    """The two analytic-only rows, and the plain versions at the JAX
    package's interpret-mode shapes."""
    # at T=2048 the pre-packed input stream is 256x the intensity bytes
    n, w, t = STREAM_ROW
    n_in = w * 32
    emit(f"kernels/encode-stream-{n}x{n_in}xT{t}", None,
         f"input_bytes={n_in};bytes_ratio={t * w * 4 / n_in:.2f}x")
    out[("encode-stream", n, n_in, t)] = {"bytes_ratio": t * w * 4 / n_in}
    # a chunked spike stream bounds on-chip memory at unbounded T (the
    # streamed slab is the only T-dependent term)
    n, w, t, tc = CHUNK_ROW
    emit(f"kernels/window-chunk-{n}x{w * 32}xT{t}c{tc}", None,
         f"vmem_spike_bytes={tc * w * 4};vmem_ratio={t / tc:.2f}x")
    out[("chunk", n, t, tc)] = {"vmem_ratio": t / tc}

    # the JAX rows time its Pallas interpreter, which has no counterpart
    # here: these rows time the plain versions at the same shapes
    rng = np.random.default_rng(7)
    n, w, t_steps = 16, 4, 8
    weights, _, v, st, teach = _operands(n, w, dev, seed=3)
    spk = as_words(rng.integers(0, 2**32, (t_steps, w), dtype=np.uint32),
                   dev)
    t_i = time_fn(
        lambda *a: ops.fused_snn_window(*a, n_syn=w * 32, backend="ref",
                                        t_chunk=4, **KW),
        weights, spk, v, st, teach, reps=3, warmup=1, device=dev)
    emit(f"kernels/window-interp-{n}x{w * 32}xT{t_steps}c4", t_i,
         "backend=ref")
    inten = torch.from_numpy(rng.integers(0, 256, (2, w * 32),
                                          dtype=np.uint8)).to(dev)
    t_total = torch.tensor([t_steps, t_steps - 3], dtype=torch.int32,
                           device=dev)
    t_ie = time_fn(
        lambda *a: ops.infer_window_batch_encode(
            *a, n_steps=t_steps, threshold=KW["threshold"],
            leak=KW["leak"], t_total=t_total, t_chunk=4, backend="ref"),
        weights, inten, torch.tensor([1, 2], dtype=torch.int32, device=dev),
        reps=3, warmup=1, device=dev)
    emit(f"kernels/encode-interp-{n}x{w * 32}xT{t_steps}c4", t_ie,
         "backend=ref")


def _serve_rows(dev, out: dict) -> None:
    """End-to-end request latency through ``SNNServingEngine`` (intensity
    requests, ragged T), then the same with the request journal on.  One
    pass warms every window length; the histograms are then cleared so
    the measured pass sees steady-state serving only."""
    from repro_torch.engine import SNNEnginePlan
    from repro_torch.serving import SNNRequest, SNNServingEngine

    n_req, n, w, t_steps = (SERVE[k] for k in ("n_req", "n", "w", "t"))
    rng_l = np.random.default_rng(21)
    s_weights = rng_l.integers(0, 2**32, (n, w), dtype=np.uint32)
    s_inten = rng_l.integers(0, 256, (n_req, w * 32), dtype=np.uint8)
    plan_l = SNNEnginePlan(threshold=192, leak=16, n_syn=w * 32,
                           encode="kernel", cycle_backend="window",
                           max_batch=8, t_chunk=8)

    def requests(base):
        return [SNNRequest(rid=base + i, intensities=s_inten[i],
                           n_steps=t_steps - 4 * (i % 3))
                for i in range(n_req)]

    def measured(eng):
        eng.run(requests(0))               # warm every window length
        eng.queue_wait_hist.reset()
        eng.service_hist.reset()
        eng.run(requests(n_req))           # the measured pass
        return eng.stats()

    s_st = measured(SNNServingEngine(s_weights, plan_l, device=dev))
    emit(f"serve/latency-{n}x{w * 32}xT{t_steps}r{n_req}", None,
         ";".join(f"{k}={s_st[k]:.3f}" for k in LATENCY_FIELDS))
    out[("serve-latency", n, w * 32, t_steps, n_req)] = {
        k: s_st[k] for k in LATENCY_FIELDS}

    # ...with the crash-consistency journal (fsync'd WAL + snapshots)
    jdir = tempfile.mkdtemp(prefix="bench-journal-")
    try:
        j_eng = SNNServingEngine(s_weights, plan_l, journal_dir=jdir,
                                 snapshot_every=4, device=dev)
        j_st = measured(j_eng)
        j_eng.close()
    finally:
        shutil.rmtree(jdir, ignore_errors=True)
    emit(f"serve/latency-journal-{n}x{w * 32}xT{t_steps}r{n_req}", None,
         ";".join(f"{k}={j_st[k]:.3f}" for k in LATENCY_FIELDS)
         + f";journal_syncs={j_st['journal_syncs']}"
         + f";journal_snapshots={j_st['journal_snapshots']}")
    out[("serve-latency-journal", n, w * 32, t_steps, n_req)] = {
        k: j_st[k] for k in LATENCY_FIELDS}


def run(device="cuda") -> dict:
    """Every row, in the JAX module's order; returns the ratios and
    latencies by row key."""
    dev = resolve_device(device)
    out: dict = {}
    _granularity_rows(dev, out)
    _shard_row(dev, out)
    _encode_rows(dev, out)
    _grid2d_row(dev, out)
    _analytic_and_plain_rows(dev, out)
    _serve_rows(dev, out)
    return out


if __name__ == "__main__":
    run()
