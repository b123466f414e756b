"""Device time of the port's kernels, for comparing two checkouts on one
card.

    PYTHONPATH=<checkout>/src python3 src/repro_torch/launch/kernel_times.py

times the kernels of whichever ``repro_torch`` is on the path (its own
``build/`` holds its libraries), so the same script run against a parent
checkout and this one, in turns within one call, compares the two.  It
uses only the ops both sides have; the stream form is timed where it
exists.  Shapes follow ``chip_smoke.py``: phase 3's trainer digits at
784-40 ("train-parallel": B = 4 streams of 10 neurons, T = 72; the
read-only windows one stream; the four step kernels one cycle of the
four streams; the stream form 8 samples shared by the four) and the
synthetic "large" (65,536 inputs, 1,000 neurons, the same B; the SPU, NU
and SU one stream, as phase 3 runs them); phase 3's serving shapes for both serving kernels
("paper": B = 32, 784-40, T = 72, ragged lengths; "canary": T = 8;
"large": B = 16, 65,536 inputs, 1,000 neurons); and phase 9a's six
flash-attention shapes in float32 and bfloat16.  Each time is the
profiler's device time per call of the kernels whose name holds one of
the op's symbols (a kernel renamed between two checkouts is named by
both) over ``--reps`` calls; every output is first held equal to the
plain version (flash: within the dtype's tolerance).  The SPU at large
is timed warm (its bank in the L2) and cold (128 MB written, or read,
before each call).  At both step shapes, 72 cycles of the fused step
and of the unfused chain (SPU -> + teach -> NU -> SU) are each recorded
as one CUDA graph, with every launch after the first a programmatic
dependent of the kernel before (where the checkout's ops take
``dependent``) and serially, and timed per cycle (CUDA events, the
median of ``--reps`` replays); all forms must leave the same state.
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import sys

import numpy as np
import torch


# fresh profiler sessions tried before giving up: the profiler now and
# then records no device time for a while (as chip_smoke.py finds)
_PROFILER_TRIES = 5


def _device_ms(fn, symbols, reps: int) -> float:
    from torch.profiler import ProfilerActivity, profile

    symbols = (symbols,) if isinstance(symbols, str) else symbols

    fn()
    torch.cuda.synchronize()
    for _ in range(_PROFILER_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if any(s in e.key for s in symbols)
                and e.device_time_total > 0]
        if rows:     # each kernel of a call (the encode op may launch two)
            return sum(e.device_time_total / e.count for e in rows) / 1e3
    raise RuntimeError(f"the profiler recorded no {symbols} in "
                       f"{_PROFILER_TRIES} sessions")


def _event_ms(fn, reps: int) -> float:
    """Median time of one call of ``fn`` from CUDA events, after a
    warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _graph_times(ops, o: dict, shape: str, reps: int,
                 t_steps: int = 72) -> dict:
    """ms per cycle of ``t_steps`` cycles recorded as one CUDA graph: the
    fused step and the unfused chain, dependent (where the ops take it)
    and serial, from ``o``'s step operands (one stream at large, as
    phase 3 runs it); every form must leave the same state."""
    chain_dep = "dependent" in inspect.signature(
        ops.spike_process).parameters
    one = (lambda t: t[0]) if shape == "large" else (lambda t: t)
    w0, l0, v0 = (one(o[k]).contiguous() for k in ("weights", "lfsr",
                                                   "v_step"))
    teach = one(o["teach"][:o["b"]]).contiguous()
    lp = o["ltp"][:1] if shape == "large" else o["ltp"]
    kw = o["kw"]
    su = {k: kw[k] for k in ("w_exp", "gain", "n_syn")}
    rng = np.random.default_rng(0x6A9)
    size = (t_steps,) + tuple(one(o["wins"][:, 0]).shape)
    wins = torch.from_numpy(
        (rng.integers(0, 2**32, size, dtype=np.uint32)
         & rng.integers(0, 2**32, size, dtype=np.uint32)).view(np.int32)
    ).to(w0.device)

    def window(fused: bool, dependent: bool):
        # the flag only where it is set: a parent's SPU, NU and SU lack it
        dep = dict(dependent=True) if dependent else {}
        w, v, lanes, raster = w0, v0, l0, []
        for t in range(t_steps):
            first = {} if t == 0 else dep
            if fused:
                w, v, fired, lanes = ops.fused_snn_step(
                    w, wins[t], v, lanes, teach, ltp_prob=lp, **first, **kw)
            else:
                counts = ops.spike_process(wins[t], w, **first) + teach
                v, fired = ops.lif_step(v, counts, kw["threshold"],
                                        kw["leak"], **dep)
                w, lanes = ops.stdp_update(w, wins[t], fired, lanes,
                                           ltp_prob=lp, **dep, **su)
            raster.append(fired)
        return w, v, lanes, torch.stack(raster)

    forms = {"fused_snn_step": (True, True),
             "fused_snn_step serial": (True, False),
             "chain serial": (False, False)}
    if chain_dep:
        forms["chain"] = (False, True)
    out, states = {}, []
    for name, (fused, dependent) in forms.items():
        window(fused, False)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            res = window(fused, dependent)
        out[f"graph {name} @ {shape} per cycle"] = (
            _event_ms(graph.replay, reps) / t_steps)
        states.append([x.clone() for x in res])
        del graph
    for got in states[1:]:
        _same(got, states[0])
    return out


def _operands(shape: str, dev: torch.device) -> dict:
    from repro_torch.core.bitpack import as_words
    from repro_torch.core.encoder import (encode_windows_host,
                                          quantize_intensities)
    from repro_torch.core.stdp import init_weights
    from repro_torch.launch.mnist_stdp import preprocessed_digits

    rng = np.random.default_rng(0x5EED)
    if shape == "large":
        b, n_in, n = 4, 65536, 1000
        weights = as_words(rng.integers(0, 2**32, (b, n, n_in // 32),
                                        dtype=np.uint32))
        inten = rng.integers(0, 256, (8, n_in), dtype=np.uint8)
        inten[rng.random(inten.shape) < 0.6] = 0
        inten = torch.from_numpy(inten)
        labels = rng.integers(0, n, 8)
        kw = dict(threshold=16384, leak=256, w_exp=n_in // 2, gain=4,
                  n_syn=n_in)
    else:
        b, n_in, n = 4, 784, 10
        weights = init_weights(n, 25, dense=True)[None].repeat(b, 1, 1)
        x, labels = preprocessed_digits(8, seed=7)
        inten = quantize_intensities(x)
        kw = dict(threshold=192, leak=16, w_exp=128, gain=4, n_syn=n_in)
    words = weights.shape[2]
    onehot = torch.nn.functional.one_hot(
        torch.as_tensor(labels, dtype=torch.int64) % n, n).to(torch.int32)
    teach = onehot * 64 + (1 - onehot) * -1024           # [8, n]
    lfsr = torch.from_numpy(rng.integers(1, 2**16, (b, n, words))
                            .astype(np.int32))
    seeds = torch.arange(8, dtype=torch.int32) * 7919 - 3
    o = {k: t.to(dev).contiguous() for k, t in dict(
        weights=weights, lfsr=lfsr, inten=inten, teach=teach, seeds=seeds,
        ltp=torch.tensor([16, 1023, 1023, 1023], dtype=torch.int32)).items()}
    o["v"] = torch.zeros((b, n), dtype=torch.int32, device=dev)
    # one cycle's membranes below the threshold, so that some rows fire
    thr = kw["threshold"]
    o["v_step"] = torch.from_numpy(
        rng.integers(thr - 8000 if shape == "large" else 0, thr, (b, n))
        .astype(np.int32)).to(dev)
    o["wins"] = encode_windows_host(o["seeds"][:b], o["inten"][:b], 72, words)
    return dict(o, b=b, n=n, kw=kw)


# (name, B, n_in, n, T, threshold, leak): chip_smoke.py phase 3
_SERVING_SHAPES = (("paper", 32, 784, 40, 72, 192, 16),
                   ("canary", 32, 784, 40, 8, 192, 16),
                   ("large", 16, 65536, 1000, 72, 16384, 256))
# (name, B, Hq, Hkv, D, T, causal, window): chip_smoke.py phase 9a
_FLASH_SHAPES = (
    ("gemma-global", 1, 4, 1, 256, 2048, True, None),
    ("gemma-local", 1, 4, 1, 256, 2048, True, 512),
    ("ragged-37", 1, 4, 1, 256, 37, True, 512),
    ("ragged-1000", 1, 4, 1, 256, 1000, True, 512),
    ("gqa-noncausal", 2, 8, 2, 128, 512, False, None),
    ("starcoder2-3b", 1, 24, 2, 128, 1024, True, None),
)
_FLASH_DTYPES = ((torch.float32, "f32", 1e-4, "flash_fwd_kernel"),
                 (torch.bfloat16, "bf16", 3e-2, "flash_wgmma_kernel"))


def _serving_times(ops, dev, reps: int) -> dict:
    from repro_torch.core.bitpack import as_words
    from repro_torch.core.encoder import encode_windows_host

    out = {}
    for name, b, n_in, n, t, thr, leak in _SERVING_SHAPES:
        rng = np.random.default_rng(0x22A + n)
        words = -(-n_in // 32)
        w = as_words(rng.integers(0, 2**32, (n, words), dtype=np.uint32),
                     dev)
        inten = rng.integers(0, 256, (b, n_in), dtype=np.uint8)
        inten[rng.random((b, n_in)) < 0.6] = 0
        x = torch.from_numpy(inten).to(dev)
        seeds = torch.from_numpy(
            rng.integers(-2**31, 2**31, b).astype(np.int32)).to(dev)
        tt_np = rng.integers(0, t + 1, b).astype(np.int32)
        tt_np[0], tt_np[-1] = 0, t
        tt = torch.from_numpy(tt_np).to(dev)
        wins = encode_windows_host(seeds, x, t, words, tt)
        kw = dict(threshold=thr, leak=leak)
        calls = {
            "infer_window_batch_encode": (
                "infer_window_enc_",
                lambda be: ops.infer_window_batch_encode(
                    w, x, seeds, n_steps=t, t_total=tt, backend=be, **kw)),
            "infer_window_batch": (
                # before and after the kernel took the encode kernel's design
                ("infer_window_kernel", "infer_window_pre_"),
                lambda be: ops.infer_window_batch(w, wins, backend=be, **kw)),
        }
        for kname, (symbol, call) in calls.items():
            _same((call("kernel"),), (call("ref"),))
            out[f"{kname} @ {name}"] = _device_ms(
                lambda: call("kernel"), symbol,
                max(reps // 10, 3) if name == "large" else reps)
    return out


def _flash_times(dev, reps: int) -> dict:
    from repro_torch.kernels.flash_attention import flash_attention

    out = {}
    for name, b, hq, hkv, d, t, causal, window in _FLASH_SHAPES:
        rng = np.random.default_rng(t + d)
        base = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                .to(dev) for s in ((b, hq, t, d), (b, hkv, t, d),
                                   (b, hkv, t, d))]
        for dtype, dname, tol, symbol in _FLASH_DTYPES:
            q, k, v = (x.to(dtype) for x in base)
            kw = dict(causal=causal, window=window)
            got = flash_attention(q, k, v, **kw)
            want = flash_attention(q, k, v, backend="ref", **kw)
            torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                       rtol=tol)
            out[f"flash_attention {dname} @ {name}"] = _device_ms(
                lambda: flash_attention(q, k, v, **kw), symbol, reps)
    return out


def _same(got, want) -> None:
    for a, c in zip(got, want):
        if not torch.equal(a, c):
            raise AssertionError("a kernel differs from its plain version")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("kernel_times: needs a CUDA card")
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    ops.load_kernels()
    out = {}
    for shape in ("train-parallel", "large"):
        o = _operands(shape, dev)
        b, kw = o["b"], o["kw"]
        reps = args.reps if shape != "large" else max(args.reps // 10, 3)
        x, tch = o["inten"][:b], o["teach"][:b]
        calls = {
            "train_window_batch_encode": (
                "train_window_enc_kernel",
                lambda be: ops.train_window_batch_encode(
                    o["weights"], x, o["seeds"][:b], o["v"], o["lfsr"], tch,
                    n_steps=72, ltp_prob=o["ltp"], backend=be, **kw)),
            "train_window_batch": (
                "train_window_kernel",
                lambda be: ops.train_window_batch(
                    o["weights"], o["wins"], o["v"], o["lfsr"], tch,
                    ltp_prob=o["ltp"], backend=be, **kw)),
            "fused_snn_window": (
                "window_infer_kernel",
                lambda be: ops.fused_snn_window(
                    o["weights"][0], o["wins"][0], o["v"][0], o["lfsr"][0],
                    tch[0], ltp_prob=0, train=False, backend=be, **kw)[1:3]),
            "fused_snn_window_encode": (
                "window_infer_enc_kernel",
                lambda be: ops.fused_snn_window_encode(
                    o["weights"][0], x[0], o["seeds"][:1], o["v"][0],
                    o["lfsr"][0], tch[0], n_steps=72, ltp_prob=0,
                    train=False, backend=be, **kw)[1:3]),
            "fused_snn_step": (
                "fused_step_kernel",
                lambda be: ops.fused_snn_step(
                    o["weights"], o["wins"][:, 0].contiguous(), o["v_step"],
                    o["lfsr"], tch, ltp_prob=o["ltp"], backend=be, **kw)),
        }
        # the SPU, NU and SU of one cycle, as phase 3's step shapes run
        # them: the four streams, or stream 0 at large
        one = (lambda t: t[0]) if shape == "large" else (lambda t: t)
        pre, w1, l1, v1 = (one(t).contiguous() for t in (
            o["wins"][:, 0], o["weights"], o["lfsr"], o["v_step"]))
        lp = o["ltp"][:1] if shape == "large" else o["ltp"]
        count = ops.spike_process(pre, w1, backend="ref") + one(tch)
        fired = ops.lif_step(v1, count, kw["threshold"], kw["leak"],
                             backend="ref")[1]
        su = {k: kw[k] for k in ("w_exp", "gain", "n_syn")}
        calls.update({
            # spike_process_kernel before the SPU's redesign;
            # spike_process_short_kernel or spike_process_long_kernel
            # after it
            "spike_process": (
                "spike_process_",
                lambda be: ops.spike_process(pre, w1, backend=be)),
            "lif_step": (
                "lif_kernel",
                lambda be: ops.lif_step(v1, count, kw["threshold"],
                                        kw["leak"], backend=be)),
            # stdp_kernel before the SU's redesign; stdp_short_kernel,
            # stdp_long_kernel or stdp_wide_kernel after it
            "stdp_update": (
                "stdp_",
                lambda be: ops.stdp_update(w1, pre, fired, l1, ltp_prob=lp,
                                           backend=be, **su)),
        })
        if hasattr(ops, "train_stream_batch_encode"):
            calls["train_stream_batch_encode"] = (
                "train_window_enc_kernel",
                lambda be: ops.train_stream_batch_encode(
                    o["weights"], o["inten"][:, None].expand(8, b, -1),
                    o["seeds"], o["lfsr"],
                    o["teach"][:, None].expand(8, b, -1), n_steps=72,
                    ltp_prob=o["ltp"], backend=be, **kw))
        for name, (symbol, call) in calls.items():
            _same(call("kernel"), call("ref"))
            ms = _device_ms(lambda: call("kernel"), symbol, reps)
            out[f"{name} @ {shape}"] = ms
            if name == "train_stream_batch_encode":
                out[f"{name} @ {shape} per sample"] = ms / 8
        if shape == "large":
            # 128 MB through the L2 before each call, so the bank comes
            # from HBM: written (the L2 left dirty: the reads' evictions
            # write back, as chip_smoke.py's cold times do) or read
            flush = torch.empty(32 << 20, dtype=torch.int32, device=dev)
            for name, touch in (("cold", lambda: flush.fill_(1)),
                                ("cold clean", lambda: flush.sum())):
                def cold(touch=touch):
                    touch()
                    return calls["spike_process"][1]("kernel")

                out[f"spike_process @ large {name}"] = _device_ms(
                    cold, "spike_process_", reps)
            del flush
        out.update(_graph_times(ops, o, shape, args.reps))
    out.update(_serving_times(ops, dev, args.reps))
    out.update(_flash_times(dev, max(args.reps // 2, 3)))
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "times_ms": out}), flush=True)


if __name__ == "__main__":
    main()
