#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card.  Phases:

1. Device: requires a CUDA card; prints the card's name and power limit.
2. Build: compiles the serving kernels with ``nvcc`` into ``build/``.
3. Kernels: each CUDA kernel against its plain PyTorch version on the
   card (counts must be equal, ``torch.equal``) at the paper's shape
   (B = 32, 784 inputs, 40 neurons, T = 72, ragged lengths including 0),
   at the canary's shape, and at a large synthetic shape (B = 16, 65,536
   inputs, 1,000 neurons); times each and computes its bound.
4. The slice: Wenquxing 22A intensity requests served through the port's
   ``SNNServingEngine`` on the card; every request must be SERVED, with
   no degradation, and equal to the plain version's counts on the CPU;
   both kernels' launch counts must show the path went through them.
   Prints the time of each serving step.
5. Trace: more requests of the same traffic served under
   ``torch.profiler`` (the card's busy share of the serving wall time,
   and the host's heaviest operations), then under ``cProfile`` (the
   serving loop's host time by function).  Each profiler slows what it
   watches; the step times of both runs are printed beside phase 4's.
6. Prints the kernels' JSON line, then, last,
   ``{"ok": true, "device": {"platform": "gpu", ...}}``.

Any failed phase raises, and the script exits non-zero without the last
line.  It imports only ``repro_torch``, ``torch``, numpy and the
standard library.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SOURCE = "src/repro_torch/kernels/csrc/snn_infer.cu"

# H100 SXM rates (NVIDIA data sheet): HBM3 bandwidth.  Integer
# instruction rates are per SM per clock for compute capability 9.0
# (NVIDIA CUDA documentation, arithmetic instruction throughput): 64 32-bit
# integer add / logic / multiply-add results, 16 population counts.  The
# card's SM count and maximum SM clock are read at run time.
HBM_BYTES_PER_S = 3.35e12
INT32_PER_SM_CLK = 64
POPC_PER_SM_CLK = 16
# u32 operations of one counter-hash draw and its spike test: two
# multiply-adds, three xor-shifts of two operations, two multiplies,
# then mask, compare, shift and or.
HASH_OPS = 14
LIF_OPS = 4          # add, compare, subtract-max, count per neuron-cycle


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi(query: str) -> str:
    proc = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def kernel_ms(fn, symbol: str, reps: int) -> tuple[float, str]:
    """Device time of one launch of the CUDA kernel ``symbol``: the
    profiler's kernel records over ``reps`` calls of ``fn``; where the
    profiler records no device time, CUDA events around ``reps``
    back-to-back calls (which then include any host gap)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if symbol in e.key and e.device_time_total > 0]
    if rows:
        count = sum(e.count for e in rows)
        return sum(e.device_time_total for e in rows) / count / 1e3, \
            "profiler"
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps, "events"


def time_ms(fn, reps: int) -> float:
    """Median time of one call, from CUDA events, after a warm-up."""
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


@dataclasses.dataclass
class Rates:
    int32_per_s: float
    popc_per_s: float

    @classmethod
    def of_card(cls) -> "Rates":
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        mhz = float(nvidia_smi("clocks.max.sm").split()[0])
        per_s = sms * mhz * 1e6
        return cls(INT32_PER_SM_CLK * per_s, POPC_PER_SM_CLK * per_s)


def bound(rates: Rates, *, n: int, words: int, b: int, n_in: int,
          active_cycles: int, encode: bool, t_steps: int
          ) -> tuple[float, str]:
    """Least time (s) the card could take for one call: the bytes each
    input and output must cross HBM once, against the integer work these
    inputs need (``active_cycles`` sample-cycles summed over the batch)."""
    in_bytes = (b * n_in + 8 * b) if encode else b * t_steps * words * 4
    moved = n * words * 4 + in_bytes + b * n * 4
    popc = active_cycles * n * words
    ints = 2 * popc + active_cycles * n * LIF_OPS
    if encode:
        ints += active_cycles * n_in * HASH_OPS
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = max(ints / rates.int32_per_s, popc / rates.popc_per_s)
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))


def phase_kernels(rates: Rates) -> dict:
    """Phase 3: each kernel against its plain version on the card."""
    from repro_torch.core.bitpack import as_words
    from repro_torch.core.encoder import encode_windows_host
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    shapes = (("paper", 32, 784, 40, 72, 192, 16),
              ("canary", 32, 784, 40, 8, 192, 16),
              ("large", 16, 65536, 1000, 72, 16384, 256))
    out = {}
    for name, b, n_in, n, t, thr, leak in shapes:
        rng = np.random.default_rng(0x22A + n)
        words = -(-n_in // 32)
        w = as_words(
            rng.integers(0, 2**32, (n, words), dtype=np.uint32), dev)
        inten = rng.integers(0, 256, (b, n_in), dtype=np.uint8)
        inten[rng.random((b, n_in)) < 0.6] = 0          # sparse strokes
        x = torch.from_numpy(inten).to(dev)
        seeds = torch.from_numpy(
            rng.integers(-2**31, 2**31, b).astype(np.int32)).to(dev)
        tt_np = rng.integers(0, t + 1, b).astype(np.int32)
        tt_np[0], tt_np[-1] = 0, t
        tt = torch.from_numpy(tt_np).to(dev)
        wins = encode_windows_host(seeds, x, t, words, tt)
        kw = dict(threshold=thr, leak=leak)
        reps, plain_reps = (20, 3) if name == "large" else (200, 5)
        calls = {
            "infer_window_batch_encode": (
                lambda be: ops.infer_window_batch_encode(
                    w, x, seeds, n_steps=t, t_total=tt, backend=be, **kw),
                int(tt_np.clip(0, t).sum()), True, "infer_window_enc_kernel"),
            "infer_window_batch": (
                lambda be: ops.infer_window_batch(w, wins, backend=be, **kw),
                b * t, False, "infer_window_kernel"),
        }
        got_by_kernel = {}
        for kname, (call, active, encode, symbol) in calls.items():
            got = call("kernel")
            torch.cuda.synchronize()
            want = call("ref")
            if not torch.equal(got, want):
                fail(f"{kname} at {name} shape differs from its plain "
                     f"version in {int((got != want).sum())} counts")
            err = int((got - want).abs().max())
            got_by_kernel[kname] = got
            ms, how = kernel_ms(lambda: call("kernel"), symbol, reps)
            call_ms = time_ms(lambda: call("kernel"), reps)
            plain_ms = time_ms(lambda: call("ref"), plain_reps)
            b_ms, b_by = bound(rates, n=n, words=words, b=b, n_in=n_in,
                               active_cycles=active, encode=encode,
                               t_steps=t)
            b_ms *= 1e3
            out[(kname, name)] = dict(max_abs_err=err, ms=ms,
                                      call_ms=call_ms, plain_ms=plain_ms,
                                      bound_ms=b_ms, bound_by=b_by)
            print(f"kernel {kname} @ {name} (B={b}, n_in={n_in}, n={n}, "
                  f"T={t}): equal=True spikes={int(got.sum())} "
                  f"ms={ms} ({how}) call_ms={call_ms} plain_ms={plain_ms} "
                  f"bound_ms={b_ms} ({b_by})", flush=True)
        if not torch.equal(got_by_kernel["infer_window_batch_encode"],
                           got_by_kernel["infer_window_batch"]):
            fail(f"in-kernel encode and host encode disagree at {name}")
    return out


def slice_setup(n_req: int, rid0: int = 0):
    """The slice's engine inputs and ``n_req`` digit requests (ragged
    lengths 72, 68, 64), request ids from ``rid0``."""
    from repro_torch.configs.wenquxing_snn import WENQUXING_22A
    from repro_torch.core.encoder import quantize_intensities
    from repro_torch.core.stdp import init_weights
    from repro_torch.data.digits import make_digits
    from repro_torch.engine import plan_from_config
    from repro_torch.serving import SNNRequest

    cfg = dataclasses.replace(WENQUXING_22A, encode="kernel")
    plan = dataclasses.replace(plan_from_config(cfg), max_batch=32)
    weights = init_weights(cfg.n_neurons, cfg.words, dense=False)
    neuron_class = np.tile(np.arange(cfg.n_classes), cfg.n_blocks)
    imgs, _ = make_digits(n_req, seed=rid0)
    inten = quantize_intensities(imgs).numpy()
    lengths = [(72, 68, 64)[i % 3] for i in range(n_req)]
    reqs = [SNNRequest(rid=rid0 + i, intensities=inten[i],
                       n_steps=lengths[i]) for i in range(n_req)]
    return plan, weights, neuron_class, reqs


def serve_steps(eng, reqs) -> list[float]:
    """Submit ``reqs`` and step the engine until its queue is empty;
    the wall time of each step in ms (``SNNServingEngine.run`` without
    the bookkeeping)."""
    for r in reqs:
        eng.submit(r)
    times = []
    while eng.queue:
        eng.step()
        times.append(1e3 * eng.last_step_seconds)
    torch.cuda.synchronize()
    return times


def step_summary(times: list[float]) -> str:
    rest = times[1:] or times
    return (f"first {times[0]} ms, median of the rest "
            f"{statistics.median(rest)} ms (min {min(rest)}, max "
            f"{max(rest)}), steps {len(times)}")


def phase_slice():
    """Phase 4: Wenquxing 22A intensity requests served on the card."""
    from repro_torch.kernels import ops
    from repro_torch.serving import SNNServingEngine, SNNServingPolicy

    n_req = 256
    plan, weights, neuron_class, reqs = slice_setup(n_req)
    eng = SNNServingEngine(weights, plan, neuron_class=neuron_class,
                           policy=SNNServingPolicy(canary_every=2),
                           device="cuda")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    step_ms = serve_steps(eng, reqs)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()

    bad = [r.rid for r in reqs if r.status != "SERVED"]
    if bad:
        fail(f"{len(bad)} requests not SERVED, first {bad[:5]}: "
             f"{reqs[bad[0]].error}")
    st = eng.stats()
    for key in ("degraded", "failed", "integrity_failures",
                "canary_failures"):
        if st[key]:
            fail(f"serving counted {key}={st[key]} "
                 f"({list(eng.degradation_events)[:2]})")
    if not st["canary_checks"]:
        fail("no canary check ran")
    if launches["infer_window_batch_encode"] != eng.batches:
        fail(f"encode kernel launched {launches['infer_window_batch_encode']}"
             f" times for {eng.batches} batches")
    if launches["infer_window_batch"] < st["canary_checks"]:
        fail(f"pre-packed kernel launched {launches['infer_window_batch']} "
             f"times for {st['canary_checks']} canary checks")

    # the plain version on the CPU, one launch over every request
    lengths = [r.n_steps for r in reqs]
    want = ops.infer_window_batch_encode(
        weights, torch.from_numpy(np.stack([r.intensities for r in reqs])),
        torch.tensor([r.seed for r in reqs], dtype=torch.int64),
        n_steps=max(lengths), threshold=plan.threshold, leak=plan.leak,
        t_total=torch.tensor(lengths, dtype=torch.int32)).numpy()
    got = np.stack([r.counts for r in reqs])
    if not np.array_equal(got, want):
        fail(f"served counts differ from the CPU plain version in "
             f"{int((got != want).any(axis=1).sum())} requests")
    preds = neuron_class[want.argmax(axis=1)]
    if [r.pred for r in reqs] != preds.tolist():
        fail("served predictions differ from the CPU plain version")
    if not got.any():
        fail("no neuron fired in the whole run")
    print(f"slice: {n_req} requests SERVED in {eng.batches} steps, "
          f"{n_req / wall} requests/s, mean step "
          f"{1e3 * eng.step_seconds / eng.batches} ms, canary_checks="
          f"{st['canary_checks']}, launches={launches}, "
          f"spikes={int(got.sum())}", flush=True)
    print(f"slice steps: {step_summary(step_ms)}; all ms {step_ms}",
          flush=True)
    return launches, eng


def phase_trace(eng, n_req: int = 512) -> None:
    """Phase 5: the same traffic on the same engine under each profiler.
    Nothing here is checked; it shows where a serving step's time goes."""
    import cProfile
    import pstats
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, _, _, reqs = slice_setup(n_req, rid0=10_000)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_ms = serve_steps(eng, reqs)
        wall_us = 1e6 * (time.perf_counter() - t0)
    rows = prof.key_averages()
    dev = [e for e in rows if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in dev)
    print(f"trace (torch.profiler): {len(step_ms)} steps in {wall_us} us; "
          f"{step_summary(step_ms)}", flush=True)
    if dev_us > 0:
        print(f"trace: card busy {dev_us} us = {dev_us / wall_us} of the "
              f"wall time; device work: " + "; ".join(
                  f"{e.key} {e.count}x {e.self_device_time_total} us"
                  for e in sorted(dev, key=lambda e:
                                  -e.self_device_time_total)[:6]),
              flush=True)
    else:
        print("trace: the profiler recorded no device time: card busy "
              "share not measured", flush=True)
    host = sorted((e for e in rows if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    host_us = sum(e.self_cpu_time_total for e in host)
    print(f"trace: host in torch operations {host_us} us of {wall_us}; "
          "heaviest: " + "; ".join(
              f"{e.key} {e.count}x {e.self_cpu_time_total} us"
              for e in host[:8]), flush=True)

    _, _, _, reqs = slice_setup(n_req, rid0=20_000)
    prof = cProfile.Profile()
    prof.enable()
    step_ms = serve_steps(eng, reqs)
    prof.disable()
    stats = pstats.Stats(prof)
    total = stats.total_tt
    funcs = sorted(((tt, ct, f"{Path(fn).name}:{name}")
                    for (fn, _, name), (_, _, tt, ct, _)
                    in stats.stats.items()), reverse=True)
    print(f"trace (cProfile): {len(step_ms)} steps, {total} s profiled; "
          f"{step_summary(step_ms)}", flush=True)
    print("trace: own s (cumulative s) by function: " + "; ".join(
        f"{name} {tt} ({ct})" for tt, ct, name in funcs[:16]), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import build, ops
    except ImportError as e:
        fail(f"repro_torch not found beside chip_smoke.py ({e})")

    # phase 1: device
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # phase 2: build
    t0 = time.perf_counter()
    ops.load_kernels()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    log = build.library_path("snn_infer").with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas: {line.strip()}", flush=True)

    # phase 3: kernels against their plain versions
    rates = Rates.of_card()
    print(f"rates: int32 {rates.int32_per_s:.4g}/s, popc "
          f"{rates.popc_per_s:.4g}/s, hbm {HBM_BYTES_PER_S:.4g} B/s",
          flush=True)
    timings = phase_kernels(rates)

    # phase 4: the slice
    launches, eng = phase_slice()

    # phase 5: where a serving step's time goes
    phase_trace(eng)

    kernels = []
    for kname, shape, line in (
            ("infer_window_batch_encode", "paper", 842),
            ("infer_window_batch", "canary", 580)):
        main_t, large = timings[(kname, shape)], timings[(kname, "large")]
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCE,
            "replaces": f"src/repro/kernels/snn_kernels.py:{line}",
            "launches": launches[kname],
            "max_abs_err": max(main_t["max_abs_err"], large["max_abs_err"]),
            "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
            "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
            "library_ms": None, "shape": shape,
            "call_ms": main_t["call_ms"],
            "large": {k: large[k] for k in ("ms", "call_ms", "plain_ms",
                                            "bound_ms", "bound_by")}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
