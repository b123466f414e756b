#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card.  Phases:

1. Device: requires a CUDA card; prints the card's name and power limit.
2. Build: compiles the kernel libraries with ``nvcc`` into ``build/``
   (``snn_infer.cu``, ``snn_train.cu``, ``snn_step.cu`` and
   ``flash_attn.cu``, one compiler each, at once) and prints their ptxas
   lines; the serving GEMM regime's two sums kernels must not spill.
3. Kernels: each CUDA kernel against its plain PyTorch version on the
   card (every output ``torch.equal``), then timed, with its bound.
   Serving kernels: the paper's shape (B = 32, 784 inputs, 40 neurons,
   T = 72, ragged lengths including 0), the canary's, and a large
   synthetic one (B = 16, 65,536 inputs, 1,000 neurons); each serving
   kernel's regime at each is printed (window at the first two, GEMM at
   large) and each is timed over all the kernels a call launches; the
   pre-packed kernel equals the encode kernel at every shape, and its
   plain version at threshold 0 too and on a 32,768-word bank.  Training
   kernels: "train-parallel" (B = 4 streams of 10 neurons, 784 inputs,
   T = 72, ltp_prob [16, 1023, 1023, 1023]: the trainer's parallel
   launch at 784-40), "train-active" (B = 1: active mode's launch) and
   "large" (B = 4, 65,536 inputs, 1,000 neurons, T = 72); the stream form
   of the in-kernel encode kernel (``train_stream_batch_encode``, N
   samples a launch: 8 at the paper's shapes, the trainer's own digits
   shared by every block, 2 at large), timed per launch and per sample;
   the read-only windows at "train-active" and "large" with B = 1.  Step
   kernels (one
   RV-SNN instruction cycle each): "step-parallel" (one cycle of the
   trainer's parallel launch, B = 4 streams of 10 neurons, 784 inputs),
   "step-active" (one stream), "step-infer" (B = 32 samples against one
   shared 40-neuron bank, SU idle), "large" (1,000 neurons of 65,536
   inputs) and the quickstart's (n = 40, w = 25); the unfused
   SPU -> NU -> SU chain must equal the fused step; at "large" the SPU,
   SU and fused step also timed cold (128 MB written before each launch,
   so the bank comes from HBM, not the L2); at "step-parallel",
   "step-infer" and "large" 72 cycles recorded as one CUDA graph in two
   forms, the fused step and the unfused chain (``snn.ls -> snn.sp ->
   + teach -> snn.nu -> snn.su``), each with dependent launches (as the
   engine records a window) and without, timed per cycle, all four held
   equal (weights, v, LFSR, rasters).
4. The serving slice: Wenquxing 22A intensity requests served through
   the port's ``SNNServingEngine`` on the card; every request must be
   SERVED, with no degradation, and equal to the plain version's counts
   on the CPU; both serving kernels' launch counts must show the path
   went through them.  Prints the time of each serving step.
5. Trace: more requests of the same traffic served under
   ``torch.profiler`` (the card's busy share of the serving wall time,
   and the host's heaviest operations), then under ``cProfile`` (the
   serving loop's host time by function).
6. The training slice: ``WENQUXING_22A_INTENSITY`` (784-40, T = 72)
   trained through the port's ``train()`` on the card, one epoch of
   procedural digits in each train mode, a short ``encode="host"`` run,
   and a read-only pass (an inference-only plan's ``train`` verb), with
   the launch counts set to 0 before and read after; then the same runs
   with the plain versions on the CPU, which must give equal weights
   and class maps.  Prints samples/s, ms per sample, the trainer's
   presentations (samples x blocks) and ms per presentation, the
   training launches (one stream launch an epoch of a block, or of all
   blocks in parallel mode), the test accuracy on 200 digits (not gated)
   and the launch counts, then one parallel-mode run under
   ``torch.profiler``.
7. The step slice: the same training at 784-40 (``WENQUXING_22A``,
   host encode, one epoch of 256 digits, both train modes) with
   ``cycle_backend="step"`` (one fused RV-SNN step launch per cycle),
   held bit-equal to the window path on the card (weights, class maps,
   predictions on 200 test digits), with the launch counts set to 0
   before and read after and every plain version watched; one
   presentation through the fine-grained instructions (``snn.sp``,
   ``snn.nu``, ``snn.su``, each after the first cycle a programmatic
   dependent launch, 72 launches of each kernel) held equal to
   ``snn.step``.  The step path
   replays one CUDA graph per window key (at least one replay required).
   Prints each mode's times beside the window path's, the graphs recorded
   and replayed, traces a short step-path run under ``torch.profiler``
   (the card's busy share), and runs ``launch/quickstart.py`` on the
   card.
8. The serving stack, at the paper's configuration (784-40, threshold
   192, leak 16, T 72, ``max_batch`` 32) on the card, with the launch
   counts set to 0 before and read after its in-process parts (printed,
   and as ``stack_launches`` in the kernels' JSON): (a) one ragged list
   (T 24 to 72, every fifth request pre-packed) through a window plan
   and a step plan (``cycle_backend="step"``: ``fused_snn_step``
   launches required), the same statuses and counts, each equal to the
   plain oracle; (b) a seeded ``FaultInjector`` storm (launch failures,
   corrupted counts, stalls): every request terminal, every SERVED count
   equal to the oracle, ``retried``, ``degraded`` and ``canary_checks``
   above 0, ``per_status()`` printed; (c) train-while-serving: an
   ``SNNWeightRefresher`` over 256 digits (one refresh a step, 4 cycles,
   the stream kernel training each candidate), a ``state_dir``, a
   ``FaultSpec`` that corrupts a candidate (rejected at the fingerprint
   gate), at least one promotion, counts exact under the version each
   batch pinned, a second engine over the ``state_dir`` restoring the
   newest version (same fingerprint); ms per refresh cycle printed;
   (d) both committed load traces (``smoke_50k``; ``overload_50k`` at 5x
   with ``--overload --slowdown-p 0.02``) replayed twice on the virtual
   clock through the engine ``launch/loadgen.py`` builds: per-status
   totals, histogram buckets and a SHA-256 over every SERVED request's
   counts in rid order bit-identical between the two runs and equal to
   the same replay through the plain engine on the CPU (a process of its
   own, run beside (a)-(c)); the journal's cost, 10,000 rows of the smoke
   trace with and without a journal (two WAL fsyncs and one ledger fsync
   a step), ms a step and a fsync printed; (e) ``launch/serve.py --chaos
   --chaos-crashes 3`` on a 4,000-request trace, its children on the card
   (``os._exit(73)`` at each crash; run beside (a)-(d)): exit 0 and the
   exactly-once audit; (f), once no other process of the phase is left,
   ``launch/loadgen.py --mode wall`` at the paper's width (20,000
   Poisson requests at 20,000 requests/s, SLO 50 ms), then ``--sweep 1000
   64000 --slo-floor 0.99``: offered and achieved rate, latency from the
   intended arrival (p50/p99/p99.9), attainment and the sustained rate
   printed, not gated, and the card's busy share of the replay traced
   under ``torch.profiler``.  Prints the phase's wall time.
9. The LM slice: both flash kernels' builds checked (ptxas's line for
   each head dim, no spills; tensor-core instructions counted in the
   SASS, ``cuobjdump -sass``: ``HMMA`` in the float32 kernel, ``HGMMA``
   in the bfloat16 one), then the flash-attention kernels
   (``flash_attn.cu``: ``flash_fwd_kernel`` for float32 in split TF32 on
   ``mma.sync``, ``flash_wgmma_kernel`` for bfloat16 on ``wgmma``)
   against their plain version in float32 (atol = rtol = 1e-4) and
   bfloat16 (3e-2) at gemma3-1b's shapes (B 1, Hq 4, Hkv 1, D 256, T 2,048,
   causal, global and with the 512 window; T 37 and 1,000 with the
   window), GQA non-causal (B 2, Hq 8, Hkv 2, D 128, T 512) and the
   starcoder2-3b width (Hq 24, Hkv 2, D 128, T 1,024, causal); in
   bfloat16 also within 1e-2 of the output's largest magnitude and
   ||kernel - plain|| within 1e-2 of ||plain||; q, k and v as views of
   one fused projection give the same output as contiguous ones.  Timed
   beside its bound, its plain version and
   ``scaled_dot_product_attention`` (the yardstick: the port never calls
   it), all three as device time from the profiler (the kernel by its
   own dtype's symbol, the other two every kernel and copy of a call),
   with the achieved TFLOP/s and kernel/bound (the float32 bound: three
   TF32 products at the tensor cores' rate).  Then gemma3-1b at full
   width in bfloat16, random weights from a seed, served by
   ``ServingEngine(n_slots=4, max_len=4096)``: 8 greedy requests of 37
   to 2,048 prompt tokens, 32 new tokens each, with the launch counts set
   to 0 before and read after (flash launches must be 26 x 8) and every
   plain attention function watched; prints prefill ms by prompt length,
   decode step ms, tokens/s and the card's busy share of a traced
   prefill and decode step.  Last, a 1,000-token prefill of that bf16
   model through the kernel and through the plain attention give the
   same greedy token, and logits no farther apart than twice the plain
   bf16 prefill's distance from the float32 one; and a float32 copy of
   the weights (TF32 off): the same prefill through the kernel and
   through the plain attention agree within 1e-3 of the logits' largest
   magnitude with the same greedy token, and 8 decode steps after a
   600-token prefill (the 512-slot rings wrap) match the prefill logits
   of the prompt plus the tokens so far within the same tolerance.
10. The paper's evaluation: ``repro_torch.bench.run`` in process on the
   card at the full paper setting (2,000 training and 1,000 test digits,
   T 72, 2 epochs: 784-40 for Table 1, Fig. 4 on 1,000 and 200 digits,
   784-{10, 20, 40} for Fig. 5, w_exp {128, 256, 512} at 784-40), with
   the launch counts set to 0 before and read after (the encode serving
   kernel, the pre-packed one and the stream training kernel required;
   ``paper_launches`` in the kernels' JSON) and every plain version
   watched; every row, and each training's wall time beside the card's
   name and power limit, printed; Table 1's model counts the 1,000 test
   digits through the encode kernel and through the pre-packed kernel
   on their materialized windows, which must be equal; a reduced run
   (Fig. 4's and Table 1's logic, 784-40, 256 training and 200 test
   digits, T 72, 1 epoch) must equal the same run with the plain
   versions on the CPU (a process of its own, run beside the card's
   part): weights, class maps, correct count, event counts and both
   modeled energy dicts.  Accuracy and the modeled energy ratio are
   printed, not gated.  Prints the phase's wall time.
11. Placement and the benchmark harness: (a) ``snn_mesh --check`` with
   every shard on ``cuda:0``, on the 1-D grid of 8 and the 2-D grids
   2,4, 4,2 and 8,1 (every wrapper's outputs ``torch.equal`` to the
   unsharded kernel op: counts, weights, v, rasters, LFSR);
   ``WENQUXING_22A_MESH2D`` (784-40, T 72, parallel mode) trained on the
   phase-6 digits (1 epoch) on its (2, 4) grid on the card, weights and
   class map equal to the local ``WENQUXING_22A_INTENSITY`` parallel run
   on the card (phase 6 holds that one equal to the CPU), one stream
   launch a shard; 64 intensity requests served through a meshed plan,
   counts equal to the local engine's, one encode launch a shard a
   batch; each meshed call's launches read just before and just after
   it, every wrapper of ``--check`` held to one launch a shard for each
   launch of the unsharded op, the unsharded and local reference runs
   left out (``mesh_launches`` in the kernels' JSON); (b)
   ``repro_torch.bench.run kernels_bench loadgen_bench`` in process on
   the card, every row printed, gated against ``BENCH_torch.json`` (the
   verdict printed, not required), every untimed field of the kernel and
   serving rows and every field of the virtual-clock load rows
   (``virtual``, ``sweep``, ``overload-1x/5x``) equal to the JAX
   package's ``BENCH_kernels.json`` (read, not copied), every kernel the
   rows call launched (``harness_launches``).  Prints the phase's wall
   time.
12. Prints the kernels' JSON line, then, last,
   ``{"ok": true, "device": {"platform": "gpu", ...}}``.

Device times are the profiler's; where it records none in 5 fresh
sessions, the time comes from CUDA events around the calls (host
dispatch gaps included), and a line says so.  Any failed phase raises, and the script exits
non-zero without the last line.  It imports only ``repro_torch``,
``torch``, numpy and the standard library.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SOURCE = "src/repro_torch/kernels/csrc/snn_infer.cu"
# the encode serving op's kernels: the window regime's one, or the GEMM
# regime's draw and sums; the pre-packed op's: its window regime's, or
# its GEMM regime's sums
ENCODE_SYMBOL = "infer_window_enc_"
PREPACKED_SYMBOL = "infer_window_pre_"
# the GEMM regime's sums kernels, whose builds must not spill
SUMS_SYMBOLS = ("infer_window_enc_sums_kernel", "infer_window_pre_sums_kernel")
TRAIN_SOURCE = "src/repro_torch/kernels/csrc/snn_train.cu"
STEP_SOURCE = "src/repro_torch/kernels/csrc/snn_step.cu"
PALLAS = "src/repro/kernels/snn_kernels.py"

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
# u32 operations of the STDP update of one word of a fired row: two LFSR
# steps (three shifts, three xors, mask, shift, or, mask each), the LTP
# compare, select and or, the LTD compare, and and select, the popcount
# sum, the loads and stores of the weight and LFSR words.
SU_OPS = 30


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi(query: str) -> str:
    proc = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


# fresh profiler sessions a device time is sought in before the time is
# taken from CUDA events instead (the profiler now and then records no
# device time for a while, and on some runs not again in the process)
PROFILER_TRIES = 5
# the range each call of ``call_device_ms`` runs in
CALL_LABEL = "chip_smoke.call"


def profiled_ms(fn, reps: int, what: str, read, cpu: bool = False
                ) -> float:
    """``read(prof)`` of the first profiler session over ``reps`` calls
    of ``fn`` (after one warm-up call) that gives a time, in up to
    ``PROFILER_TRIES`` fresh sessions; where none does, the time of one
    call from CUDA events around ``reps`` calls back to back (host
    dispatch gaps included), said so on a line of its own.  ``cpu``
    records the host's operations too."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                            if cpu else [])
    for attempt in range(PROFILER_TRIES):
        if attempt:
            time.sleep(0.5)
        with profile(activities=activities) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ms = read(prof)
        if ms is not None:
            return ms
    ms = events_ms(fn, reps)
    print(f"timing: the profiler recorded no device time of {what} in "
          f"{PROFILER_TRIES} sessions; {ms} ms a call from CUDA events "
          f"over {reps} calls back to back instead", flush=True)
    return ms


def events_ms(fn, reps: int) -> float:
    """Time of one call of ``fn`` from CUDA events around ``reps`` calls
    back to back, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_ms(fn, symbol: str, reps: int) -> float:
    """Device time of one call of ``fn`` in the CUDA kernels whose name
    holds ``symbol``, over ``reps`` calls: each kernel's profiler records
    over the number of records the profiler kept of it, summed over the
    kernels (one, or those one call launches in turn, as the encode
    serving op's GEMM regime launches a draw and then the sums)."""
    def read(prof):
        rows = [e for e in prof.key_averages()
                if symbol in e.key and e.device_time_total > 0]
        if rows:
            return sum(e.device_time_total / e.count for e in rows) / 1e3

    return profiled_ms(fn, reps, symbol, read)


def call_device_ms(fn, reps: int, what: str) -> float:
    """Device time of one call of ``fn``: every CUDA kernel and copy the
    call launched, summed (host dispatch between them left out, as
    ``kernel_ms`` leaves it out), over the calls the profiler kept whole
    (those of the ``reps`` with the most device records)."""
    from torch.autograd import DeviceType
    from torch.profiler import record_function

    def call():
        with record_function(CALL_LABEL):
            fn()

    def subtree(e):
        yield e
        for c in e.cpu_children:
            yield from subtree(c)

    def device_work(e) -> tuple[int, float]:
        # (records, us) of the kernels and copies under event e, each
        # once: the profiler lists an operation's kernels again under
        # any event of the same id ("Activity Buffer Request"), and may
        # list the range itself among them
        by_id = {s.id: [k.duration for k in s.kernels if k.name != CALL_LABEL]
                 for s in subtree(e)}
        us = [d for ks in by_id.values() for d in ks]
        return len(us), sum(us)

    def read(prof):
        calls = [device_work(e) for e in prof.events()
                 if e.name == CALL_LABEL and e.device_type == DeviceType.CPU]
        most = max((n for n, _ in calls), default=0)
        if most:
            kept = [us for n, us in calls if n == most]
            return sum(kept) / len(kept) / 1e3

    return profiled_ms(call, reps, what, read, cpu=True)


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


def roofline(rates: Rates, moved: float, ints: float, popc: float
             ) -> tuple[float, str]:
    """The larger of the time to move ``moved`` bytes over HBM and the
    time for the integer work, and which of the two it is."""
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = max(ints / rates.int32_per_s, popc / rates.popc_per_s)
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))


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
    return roofline(rates, moved, ints, popc)


def outputs_of(result) -> tuple:
    return result if isinstance(result, tuple) else (result,)


def max_abs_err(got, want) -> int:
    """Largest difference over every output (bit patterns and rasters
    as int64)."""
    return max((int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                if a.numel() else 0)
               for a, b in zip(outputs_of(got), outputs_of(want)))


def hold_and_time(kname: str, shape: str, call, symbol: str, reps: int,
                  plain_reps: int, bound_of) -> tuple[dict, tuple]:
    """Hold ``call("kernel")`` against ``call("ref")`` on the card (every
    output ``torch.equal``), then time both; ``bound_of(outputs)`` gives
    the bound from this run's own outputs.  Returns (timings, kernel
    outputs)."""
    got = outputs_of(call("kernel"))
    torch.cuda.synchronize()
    want = outputs_of(call("ref"))
    for i, (a, b) in enumerate(zip(got, want)):
        if a.dtype != b.dtype or not torch.equal(a, b):
            fail(f"{kname} at {shape} shape: output {i} differs from its "
                 f"plain version in {int((a != b).sum())} places")
    err = max_abs_err(got, want)
    ms = kernel_ms(lambda: call("kernel"), symbol, reps)
    call_ms = time_ms(lambda: call("kernel"), reps)
    plain_ms = time_ms(lambda: call("ref"), plain_reps)
    b_s, b_by = bound_of(got)
    out = dict(max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
               bound_ms=1e3 * b_s, bound_by=b_by)
    print(f"kernel {kname} @ {shape}: equal=True ms={ms} "
          f"call_ms={call_ms} plain_ms={plain_ms} bound_ms={1e3 * b_s} "
          f"({b_by})", flush=True)
    return out, got


def phase_kernels(rates: Rates) -> dict:
    """Phase 3, serving kernels against their plain versions."""
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
                int(tt_np.clip(0, t).sum()), True, ENCODE_SYMBOL),
            "infer_window_batch": (
                lambda be: ops.infer_window_batch(w, wins, backend=be, **kw),
                b * t, False, PREPACKED_SYMBOL),
        }
        for kname in calls:
            print_plan(kname, name, ops.encode_plan(
                b, n, words, t, encode=kname == "infer_window_batch_encode"))
        got_by_kernel = {}
        for kname, (call, active, encode, symbol) in calls.items():
            timing, got = hold_and_time(
                kname, f"{name} (B={b}, n_in={n_in}, n={n}, T={t})", call,
                symbol, reps, plain_reps,
                lambda _, active=active, encode=encode: bound(
                    rates, n=n, words=words, b=b, n_in=n_in,
                    active_cycles=active, encode=encode, t_steps=t))
            out[(kname, name)] = timing
            got_by_kernel[kname] = got[0]
            print(f"kernel {kname} @ {name}: spikes={int(got[0].sum())}",
                  flush=True)
        if not torch.equal(got_by_kernel["infer_window_batch_encode"],
                           got_by_kernel["infer_window_batch"]):
            fail(f"in-kernel encode and host encode disagree at {name}")
        # threshold 0: every cycle fires, the zero-masked tail included
        hold_prepacked(f"{name}, threshold 0", w, wins, 0, leak)
    # a 32,768-word bank (a row of 128 KiB): the GEMM regime
    rng = np.random.default_rng(0x8000)
    b, n, words, t = 4, 16, 32768, 8
    w = as_words(rng.integers(0, 2**32, (n, words), dtype=np.uint32), dev)
    wins = as_words(rng.integers(0, 2**32, (b, t, words), dtype=np.uint32)
                    & rng.integers(0, 2**32, (b, t, words), dtype=np.uint32),
                    dev)
    print_plan("infer_window_batch", "bank-32768",
               ops.encode_plan(b, n, words, t, encode=False))
    for thr in (0, 1, 8 * words):
        hold_prepacked(f"bank-32768 (B={b}, n={n}, w={words}, T={t}), "
                       f"threshold {thr}", w, wins, thr, 3)
    return out


def print_plan(kname: str, shape: str, plan) -> None:
    print(f"{kname} @ {shape}: {plan.regime} regime, a cluster of "
          f"{plan.cluster} blocks a "
          f"{'sample' if plan.regime == 'window' else '(tile, sample)'}, "
          f"{plan.smem_bytes} shared bytes a block", flush=True)


def hold_prepacked(what: str, w, wins, threshold: int, leak: int) -> None:
    """The pre-packed kernel ``torch.equal`` to its plain version."""
    from repro_torch.kernels import ops

    kw = dict(threshold=threshold, leak=leak)
    got = ops.infer_window_batch(w, wins, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, ops.infer_window_batch(w, wins, backend="ref",
                                                   **kw)):
        fail(f"infer_window_batch at {what} differs from its plain version")
    print(f"kernel infer_window_batch @ {what}: equal=True "
          f"spikes={int(got.sum())}", flush=True)


def train_bound(rates: Rates, *, b: int, n: int, words: int, n_in: int,
                t_steps: int, fired: int, learn: bool, encode: bool
                ) -> tuple[float, str]:
    """Least time (s) of one training or read-only window launch: each
    input and output crosses HBM once (weights, LFSR, v, teach, the
    spike rows or intensities, the raster), against the integer work of
    this run: SPU and LIF for every (stream, cycle, neuron), one draw
    per (stream, cycle, input) when encoding, and the STDP pass over the
    words of each of the ``fired`` (row, cycle) pairs."""
    state = b * n * words * 4
    moved = state * (4 if learn else 1)   # weights (+ weights', LFSR, LFSR')
    moved += (b * n_in + 4 * b) if encode else b * t_steps * words * 4
    moved += 3 * b * n * 4 + b * t_steps * n + (4 * b if learn else 0)
    cycles = b * t_steps
    popc = cycles * n * words
    ints = 2 * popc + cycles * n * (LIF_OPS + 1)
    if encode:
        ints += cycles * n_in * HASH_OPS
    if learn:
        popc += fired * words
        ints += fired * words * SU_OPS
    return roofline(rates, moved, ints, popc)


def stream_bound(rates: Rates, *, b: int, n: int, words: int, n_in: int,
                 t_steps: int, n_samples: int, fired: int, draws: int,
                 per_sample_bytes: int) -> tuple[float, str]:
    """Least time (s) of one stream-kernel launch: B streams of N samples.
    The state (weights and LFSR in and out, v out) crosses HBM once, and
    ``per_sample_bytes`` of intensities, seeds, teacher currents and
    counts for each sample, against the integer work of this run: SPU and
    LIF for every (sample, stream, cycle, neuron), one hash per input of
    each of the ``draws`` distinct (sample, stream) windows and cycle
    (streams that share a sample's intensities and seed share its
    window), and the STDP pass over the words of each of the ``fired``
    (row, cycle) pairs."""
    moved = 4 * b * n * words * 4 + b * n * 4 + 4 * b
    moved += n_samples * per_sample_bytes
    cycles = n_samples * b * t_steps
    popc = cycles * n * words + fired * words
    ints = (2 * cycles * n * words + cycles * n * (LIF_OPS + 1)
            + draws * t_steps * n_in * HASH_OPS + fired * words * SU_OPS)
    return roofline(rates, moved, ints, popc)


def stream_operands(o: dict, n_samples: int, shape: str) -> dict:
    """N samples for the stream kernel at one of phase 3's shapes: at the
    paper's width the trainer's own stream (preprocessed digits, one
    sample and seed shared by every block: a stream stride of 0, teacher
    currents from the labels); "large" synthetic, per stream."""
    from repro_torch.core.encoder import quantize_intensities, sample_seeds
    from repro_torch.launch.mnist_stdp import preprocessed_digits

    b, n, n_in = o["b"], o["n"], o["n_in"]
    dev = o["weights"].device
    if shape == "large":
        rng = np.random.default_rng(0x57EA)
        inten = rng.integers(0, 256, (n_samples, b, n_in), dtype=np.uint8)
        inten[rng.random(inten.shape) < 0.6] = 0
        inten = torch.from_numpy(inten)
        labels = torch.from_numpy(rng.integers(0, n, (n_samples, b)))
        seeds = torch.from_numpy(rng.integers(-2**31, 2**31, (n_samples, b))
                                 .astype(np.int32))
        shared = False
    else:
        x, labels = preprocessed_digits(n_samples, seed=9)
        inten = quantize_intensities(x)[:, None].expand(n_samples, b, n_in)
        labels = torch.as_tensor(labels)[:, None].expand(n_samples, b)
        seeds = sample_seeds(0x22A, n_samples)
        shared = True
    onehot = torch.nn.functional.one_hot(labels.to(torch.int64) % n,
                                         n).to(torch.int32)
    teach = onehot * 64 + (1 - onehot) * -1024
    if shared:                      # one copy on the card, read by every block
        inten = inten[:, :1].to(dev).expand(n_samples, b, n_in)
        teach = teach[:, :1].to(dev).expand(n_samples, b, n)
    else:
        inten, teach = inten.to(dev), teach.to(dev)
    streams = 1 if shared else b
    return dict(inten=inten, teach=teach, seeds=seeds.to(dev),
                n_samples=n_samples, draws=n_samples * streams,
                per_sample_bytes=streams * (n_in + 4 * n)
                + seeds[0].numel() * 4 + b * n * 4)


def train_operands(shape: str, dev: torch.device) -> dict:
    """Inputs of the training kernels at one of phase 3's shapes.  The
    paper shapes start where the trainer starts (all-ON rows, LFSR lanes
    from the block seeds, preprocessed digits, teacher currents from the
    labels); "large" is synthetic."""
    from repro_torch.core.bitpack import as_words
    from repro_torch.core.encoder import (encode_windows_host,
                                          quantize_intensities,
                                          sample_seeds)
    from repro_torch.core.rvsnn import snn_regfile_batch
    from repro_torch.core.stdp import init_weights
    from repro_torch.launch.mnist_stdp import preprocessed_digits

    if shape == "large":
        b, n_in, n, t = 4, 65536, 1000, 72
        rng = np.random.default_rng(0x5EED)
        words = n_in // 32
        weights = as_words(rng.integers(0, 2**32, (b, n, words),
                                        dtype=np.uint32))
        inten = rng.integers(0, 256, (b, n_in), dtype=np.uint8)
        inten[rng.random((b, n_in)) < 0.6] = 0
        inten = torch.from_numpy(inten)
        labels = rng.integers(0, 10, b)
        kw = dict(threshold=16384, leak=256, w_exp=n_in // 2, gain=4,
                  n_syn=n_in)
    else:
        b = 4 if shape == "train-parallel" else 1
        n_in, n, t = 784, 10, 72
        words = -(-n_in // 32)
        weights = init_weights(n, words, dense=True)[None].repeat(b, 1, 1)
        x, labels = preprocessed_digits(b, seed=7)
        inten = quantize_intensities(x)
        kw = dict(threshold=192, leak=16, w_exp=128, gain=4, n_syn=n_in)
    rf = snn_regfile_batch(weights, [0x22A + 0x9E37 * i for i in range(b)])
    onehot = torch.nn.functional.one_hot(
        torch.as_tensor(labels, dtype=torch.int64) % n, n).to(torch.int32)
    teach = onehot * 64 + (1 - onehot) * -1024
    ltp = [16, 1023, 1023, 1023][:b]
    on = {k: v.to(dev).contiguous() for k, v in dict(
        weights=rf.weights, lfsr=rf.lfsr, v=rf.v, teach=teach,
        inten=inten, seeds=sample_seeds(0x22A, b),
        ltp=torch.tensor(ltp, dtype=torch.int32)).items()}
    on["wins"] = encode_windows_host(on["seeds"], on["inten"], t, words)
    return dict(on, b=b, n=n, n_in=n_in, t=t, words=words, kw=kw)


def phase_train_kernels(rates: Rates) -> dict:
    """Phase 3, training and read-only window kernels against their
    plain versions."""
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    out = {}
    for shape in ("train-parallel", "train-active", "large"):
        o = train_operands(shape, dev)
        b, n, n_in, t, words, kw = (o[k] for k in ("b", "n", "n_in", "t",
                                                    "words", "kw"))
        reps, plain_reps = (20, 3) if shape == "large" else (200, 5)
        what = f"{shape} (B={b}, n_in={n_in}, n={n}, T={t})"

        def learn_bound(got, encode, b=b, n=n, words=words, n_in=n_in,
                        t=t):
            return train_bound(rates, b=b, n=n, words=words, n_in=n_in,
                               t_steps=t, fired=int(got[2].sum()),
                               learn=True, encode=encode)

        calls = {
            "train_window_batch": (
                lambda be: ops.train_window_batch(
                    o["weights"], o["wins"], o["v"], o["lfsr"], o["teach"],
                    ltp_prob=o["ltp"], backend=be, **kw),
                "train_window_kernel", False),
            "train_window_batch_encode": (
                lambda be: ops.train_window_batch_encode(
                    o["weights"], o["inten"], o["seeds"], o["v"], o["lfsr"],
                    o["teach"], n_steps=t, ltp_prob=o["ltp"], backend=be,
                    **kw),
                "train_window_enc_kernel", True),
        }
        rasters = {}
        for kname, (call, symbol, encode) in calls.items():
            timing, got = hold_and_time(
                kname, what, call, symbol, reps, plain_reps,
                lambda g, encode=encode: learn_bound(g, encode))
            timing["fired"] = int(got[2].sum())
            out[(kname, shape)] = timing
            rasters[kname] = got
        for a, c in zip(rasters["train_window_batch"],
                        rasters["train_window_batch_encode"]):
            if not torch.equal(a, c):
                fail(f"in-kernel encode and host encode training windows "
                     f"disagree at {shape}")
        print(f"train kernels @ {shape}: fired (row, cycle) pairs "
              f"{out[('train_window_batch', shape)]['fired']}", flush=True)
        # the stream form: N samples per launch, weights and LFSR resident
        s = stream_operands(o, 2 if shape == "large" else 8, shape)
        timing, _ = hold_and_time(
            "train_stream_batch_encode",
            f"{shape} (N={s['n_samples']}, B={b}, n_in={n_in}, n={n}, "
            f"T={t})",
            lambda be, s=s: ops.train_stream_batch_encode(
                o["weights"], s["inten"], s["seeds"], o["lfsr"], s["teach"],
                n_steps=t, ltp_prob=o["ltp"], backend=be, **kw),
            "train_window_enc_kernel", 20 if shape == "large" else 100, 2,
            lambda g, s=s, b=b, n=n, words=words, n_in=n_in, t=t:
            stream_bound(rates, b=b, n=n, words=words, n_in=n_in,
                         t_steps=t, n_samples=s["n_samples"],
                         fired=int(g[2].sum()), draws=s["draws"],
                         per_sample_bytes=s["per_sample_bytes"]))
        timing.update(samples=s["n_samples"],
                      ms_per_sample=timing["ms"] / s["n_samples"],
                      bound_ms_per_sample=timing["bound_ms"]
                      / s["n_samples"])
        out[("train_stream_batch_encode", shape)] = timing
        print(f"stream kernel @ {shape}: {timing['ms_per_sample']} ms per "
              f"sample (one-sample launch "
              f"{out[('train_window_batch_encode', shape)]['ms']} ms)",
              flush=True)
        if shape == "train-parallel":
            continue
        # the read-only windows: one stream, SU idle
        w1, v1, t1, l1 = (o[k][0] for k in ("weights", "v", "teach",
                                            "lfsr"))
        ro = dict(kw, ltp_prob=0, train=False)
        ro_calls = {
            "fused_snn_window": (
                lambda be: ops.fused_snn_window(w1, o["wins"][0], v1, l1, t1,
                                                backend=be, **ro)[1:3],
                "window_infer_kernel", False),
            "fused_snn_window_encode": (
                lambda be: ops.fused_snn_window_encode(
                    w1, o["inten"][0], o["seeds"][:1], v1, l1, t1,
                    n_steps=t, backend=be, **ro)[1:3],
                "window_infer_enc_kernel", True),
        }
        for kname, (call, symbol, encode) in ro_calls.items():
            timing, _ = hold_and_time(
                kname, f"{shape} (B=1, n_in={n_in}, n={n}, T={t})", call,
                symbol, reps, plain_reps,
                lambda g, encode=encode: train_bound(
                    rates, b=1, n=n, words=words, n_in=n_in, t_steps=t,
                    fired=0, learn=False, encode=encode))
            out[(kname, shape)] = timing
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


TRAIN_KERNELS = ("train_window_batch", "train_window_batch_encode",
                 "fused_snn_window", "fused_snn_window_encode")


def train_runs(device, x, labels, tx, tlabels, n_host: int) -> dict:
    """The training slice on ``device``: one epoch of 784-40, T = 72 in
    each train mode (intensity-resident, in-kernel encode), a short
    host-encode run, and a read-only pass of block 0 over the test set.
    Returns each run's model, wall time and test accuracy, and the
    read-only counts."""
    from repro_torch.configs.wenquxing_snn import WENQUXING_22A_INTENSITY
    from repro_torch.core.encoder import quantize_intensities, sample_seeds
    from repro_torch.core.rvsnn import snn_regfile
    from repro_torch.core.trainer import accuracy, train
    from repro_torch.engine import SNNEngine, train_stream
    from repro_torch.kernels import ops

    cfg = dataclasses.replace(WENQUXING_22A_INTENSITY, epochs=1)
    tinten = quantize_intensities(tx).to(device)
    tseeds = sample_seeds(0x7E57, len(tx), device=device)
    runs = {}
    for name, c, n in (
            ("parallel", dataclasses.replace(cfg, train_mode="parallel"),
             len(x)),
            ("active", cfg, len(x)),
            ("host", dataclasses.replace(cfg, encode="host"), n_host)):
        before = ops.launch_counts()
        t0 = time.perf_counter()
        model = train(c, x[:n], labels[:n], device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # presentations are (sample, block) pairs, counted by the
        # trainer; a stream launch presents a whole epoch
        launches = sum(ops.launch_counts()[k] - before[k]
                       for k in TRAIN_KERNELS[:2])
        acc = (accuracy(model, labels=tlabels, intensities=tinten,
                        seeds=tseeds) if c.encode == "kernel" else None)
        runs[name] = dict(model=model, wall=wall, acc=acc, n=n,
                          presented=model.presentations, launches=launches)
    # read-only pass: block 0 of the parallel model, SU idle, no teacher;
    # its window counts must equal the infer verb's
    model = runs["parallel"]["model"]
    plan = dataclasses.replace(model.cfg.plan(), w_exp=None)
    block0 = model.weights[:cfg.n_classes]
    counts = {}
    for encode in ("kernel", "host"):
        eng = SNNEngine(dataclasses.replace(plan, encode=encode),
                        device=device)
        _, counts[encode] = train_stream(eng, snn_regfile(block0),
                                         intensities=tinten, seeds=tseeds,
                                         n_steps=cfg.n_steps)
    counts["infer"] = SNNEngine(plan, device=device).infer(
        block0, intensities=tinten, seeds=tseeds, n_steps=cfg.n_steps)
    runs["read-only"] = counts
    return runs


def phase_train():
    """Phase 6: the training slice on the card, then on the CPU."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mnist_stdp import preprocessed_digits

    n_train, n_test, n_host = 256, 200, 32
    x, labels = preprocessed_digits(n_train, seed=1)
    tx, tlabels = preprocessed_digits(n_test, seed=2)
    dev = torch.device("cuda")
    ops.reset_launch_counts()
    card = train_runs(dev, x, labels, tx, tlabels, n_host)
    launches = ops.launch_counts()
    for k in TRAIN_KERNELS + ("infer_window_batch_encode",
                              "infer_window_batch"):
        if not launches[k]:
            fail(f"the training slice never launched {k}: {launches}")
    ro = card["read-only"]
    if not (torch.equal(ro["kernel"], ro["infer"])
            and torch.equal(ro["host"], ro["infer"])):
        fail("read-only windows disagree with the infer verb's counts")

    t0 = time.perf_counter()
    host = train_runs(torch.device("cpu"), x, labels, tx, tlabels, n_host)
    cpu_s = time.perf_counter() - t0
    for name in ("parallel", "active", "host"):
        a, b = card[name]["model"], host[name]["model"]
        if not (torch.equal(a.weights.cpu(), b.weights)
                and torch.equal(a.neuron_class.cpu(), b.neuron_class)):
            fail(f"{name} training on the card differs from the CPU "
                 f"plain run")
        if card[name]["acc"] != host[name]["acc"]:
            fail(f"{name} test accuracy differs: {card[name]['acc']} on "
                 f"the card, {host[name]['acc']} on the CPU")
    for k in ("kernel", "host", "infer"):
        if not torch.equal(ro[k].cpu(), host["read-only"][k]):
            fail(f"read-only pass ({k}) differs from the CPU plain run")

    for name in ("parallel", "active", "host"):
        r = card[name]
        blocks = r["model"].weights.shape[0] // 10
        print(f"train {name}: {r['n']} samples x 1 epoch in {r['wall']} s "
              f"= {r['n'] / r['wall']} samples/s, {1e3 * r['wall'] / r['n']}"
              f" ms per sample; {r['presented']} presentations (samples x "
              f"blocks, from the trainer) = {r['presented'] / r['wall']} "
              f"per s, {1e3 * r['wall'] / r['presented']} ms each; "
              f"{r['launches']} training launches; {blocks} blocks; test "
              f"accuracy {r['acc']} (CPU plain run {host[name]['wall']} s)",
              flush=True)
    print(f"train: launches {launches}; CPU plain runs {cpu_s} s; "
          f"read-only spikes {int(ro['infer'].sum())}; equal to the CPU "
          f"plain runs: weights, class maps, accuracy, read-only counts",
          flush=True)
    return launches, card


def phase_train_trace(x, labels, cycle_backend: str = "window") -> None:
    """Where a training run's time goes: one parallel-mode epoch of
    ``x`` on one cycle path (the window path with in-kernel encode, or
    the step path with host encode) under ``torch.profiler``: the card's
    busy share of the wall time, kernel time by name, and the host's
    heaviest operations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.wenquxing_snn import (WENQUXING_22A,
                                                   WENQUXING_22A_INTENSITY)
    from repro_torch.core.trainer import train

    base = (WENQUXING_22A_INTENSITY if cycle_backend == "window"
            else WENQUXING_22A)
    cfg = dataclasses.replace(base, epochs=1, train_mode="parallel",
                              cycle_backend=cycle_backend)
    dev = torch.device("cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train(cfg, x, labels, device=dev)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    rows = prof.key_averages()
    devs = [e for e in rows if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in devs)
    print(f"train trace (torch.profiler, parallel, {cycle_backend} path, "
          f"{len(x)} samples): "
          f"wall {wall_us} us, card busy {dev_us} us = "
          f"{dev_us / wall_us if wall_us else 0} of the wall time; device "
          f"work: " + "; ".join(
              f"{e.key} {e.count}x {e.self_device_time_total} us"
              for e in sorted(devs, key=lambda e:
                              -e.self_device_time_total)[:6]), flush=True)
    host = sorted((e for e in rows if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    print(f"train trace ({cycle_backend} path): host heaviest: " + "; ".join(
        f"{e.key} {e.count}x {e.self_cpu_time_total} us"
        for e in host[:8]), flush=True)
    if cycle_backend == "step":
        # the host's time by Python function: one launch per cycle
        import cProfile
        import pstats

        prof = cProfile.Profile()
        prof.enable()
        train(cfg, x, labels, device=dev)
        torch.cuda.synchronize()
        prof.disable()
        stats = pstats.Stats(prof)
        funcs = sorted(((tt, ct, n, f"{Path(fn).name}:{name}")
                        for (fn, _, name), (_, n, tt, ct, _)
                        in stats.stats.items()), reverse=True)
        print(f"train trace (cProfile, step path): {stats.total_tt} s; own "
              f"s (cumulative s) x calls by function: " + "; ".join(
                  f"{name} {tt} ({ct}) x{n}" for tt, ct, n, name
                  in funcs[:14]), flush=True)


# --- the per-cycle RV-SNN step kernels and the step slice -------------------

STEP_KERNELS = ("fused_snn_step", "spike_process", "lif_step", "stdp_update")
STEP_SYMBOLS = {"fused_snn_step": "fused_step_kernel",
                # spike_process_short_kernel (<= 128 words) or
                # spike_process_long_kernel, by the row's width
                "spike_process": "spike_process_",
                "lif_step": "lif_kernel",
                # stdp_short_kernel, stdp_long_kernel or stdp_wide_kernel,
                # by the row's width
                "stdp_update": "stdp_"}
# the graph timings of phase 3 (ms per cycle): the fused step's window
# and the unfused chain's, with dependent launches and serial
GRAPH_KEYS = ("graph_step_ms", "graph_step_ms_serial", "chain_graph_ms",
              "chain_graph_ms_serial")
# bytes written between two timed launches to evict the 50 MB L2, so
# that a "cold" time reads its inputs from HBM
FLUSH_BYTES = 128 << 20


def step_bound(rates: Rates, kname: str, *, b: int, n: int, words: int,
               banks: int, fired: int, train: bool = True
               ) -> tuple[float, str]:
    """Least time (s) of one step-kernel launch over ``b`` streams of
    ``n`` neurons against ``banks`` weight banks (1 when shared): each
    input and output crosses HBM once, against this call's integer work:
    SPU popcounts per (stream, neuron, word), LIF per (stream, neuron),
    and the STDP pass over the words of each of the ``fired`` rows."""
    bank, out_bank = banks * n * words * 4, b * n * words * 4
    neurons, pre = b * n, b * words * 4
    spu_ints, spu_popc = 2 * neurons * words, neurons * words
    # weights and LFSR in, weights' and LFSR' out, ltp_prob
    su_bytes = 2 * bank + 2 * out_bank + 4 * b
    su_ints, su_popc = fired * words * SU_OPS, fired * words
    if kname == "spike_process":
        return roofline(rates, bank + pre + 4 * neurons, spu_ints, spu_popc)
    if kname == "lif_step":          # v, count in; v', fired out
        return roofline(rates, 13 * neurons, LIF_OPS * neurons, 0)
    if kname == "stdp_update":
        return roofline(rates, su_bytes + pre + neurons, su_ints, su_popc)
    # fused: v, teach in; v', fired out
    moved = (su_bytes if train else bank) + pre + 13 * neurons
    ints = spu_ints + neurons * (LIF_OPS + 1) + (su_ints if train else 0)
    return roofline(rates, moved, ints, spu_popc + (su_popc if train else 0))


def step_operands(shape: str, dev: torch.device) -> dict:
    """Inputs of the step kernels at one of phase 3's shapes: one cycle
    of the trainer's parallel launch ("step-parallel", B = 4 streams of
    10 neurons) and of its active launch ("step-active", one stream),
    one serving-width inference cycle ("step-infer", B = 32 samples, 40
    neurons, one shared bank, SU idle), a synthetic "large" one (1,000
    neurons of 65,536 inputs) and the quickstart's (n = 40, w = 25).
    Membranes start below the threshold so that some rows fire."""
    from repro_torch.core.bitpack import as_words
    from repro_torch.core.encoder import (encode_windows_host,
                                          quantize_intensities,
                                          sample_seeds)
    from repro_torch.core.rvsnn import snn_regfile
    from repro_torch.core.stdp import init_weights
    from repro_torch.launch import quickstart
    from repro_torch.launch.mnist_stdp import preprocessed_digits

    rng = np.random.default_rng(0x57E9)
    if shape == "quickstart":
        w, pre, v, lanes, teach = quickstart.step_operands(dev)
        kw = dict(quickstart.STEP_PARAMS)
        ltp = torch.tensor([kw.pop("ltp_prob")], dtype=torch.int32,
                           device=dev)
        return dict(weights=w, pre=pre, v=v, lfsr=lanes, teach=teach,
                    ltp=ltp, kw=kw, b=1, n=w.shape[0], words=w.shape[1],
                    banks=1, train=True)
    if shape == "step-infer":
        b, n, words = 32, 40, 25
        weights = init_weights(n, words, dense=False, device=dev)
        x, _ = preprocessed_digits(b, seed=5)
        wins = encode_windows_host(sample_seeds(0x22A, b, device=dev),
                                   quantize_intensities(x).to(dev), 72,
                                   words)
        v = torch.from_numpy(rng.integers(0, 192, (b, n)).astype(np.int32))
        return dict(weights=weights, pre=wins[:, 36].contiguous(),
                    v=v.to(dev), lfsr=snn_regfile(weights).lfsr,
                    teach=None, ltp=torch.zeros(b, dtype=torch.int32,
                                                device=dev),
                    kw=dict(threshold=192, leak=16, w_exp=0, gain=0,
                            n_syn=1),
                    b=b, n=n, words=words, banks=1, train=False)
    o = train_operands({"step-parallel": "train-parallel",
                        "step-active": "train-active",
                        "large": "large"}[shape], dev)
    thr = o["kw"]["threshold"]
    lo = thr - 8000 if shape == "large" else 0
    v = torch.from_numpy(rng.integers(lo, thr, (o["b"], o["n"]))
                         .astype(np.int32)).to(dev)
    ops_in = dict(weights=o["weights"], pre=o["wins"][:, 0].contiguous(),
                  v=v, lfsr=o["lfsr"], teach=o["teach"], ltp=o["ltp"])
    b = o["b"]
    if shape != "step-parallel":     # one stream: the unbatched operands
        ops_in = {k: t[0] for k, t in ops_in.items()}
        ops_in["ltp"] = o["ltp"][:1]
        b = 1
    return dict(ops_in, kw=o["kw"], b=b, n=o["n"], words=o["words"],
                banks=b, train=True)


def step_graph_ms(o: dict, t_steps: int = 72) -> dict:
    """Device time per cycle of ``t_steps`` cycles at one of phase 3's
    step shapes in two forms, each recorded as one CUDA graph as the
    engine records a window: the fused step (``snn.step``, one launch a
    cycle) and the unfused chain (``snn.ls -> snn.sp -> + teach ->
    snn.nu -> snn.su``; no add where the shape has no teacher current,
    no SU where its SU is idle).  Each is recorded once with every
    launch after the first a programmatic dependent of the kernel before
    it and once with every launch serial; all four must leave equal
    weights, v, LFSR and rasters.  CUDA events around each replay, the
    median of 50, over ``t_steps``."""
    from repro_torch.core import rvsnn
    from repro_torch.core.lif import LIFParams
    from repro_torch.core.stdp import STDPParams

    dev = o["weights"].device
    rng = np.random.default_rng(0x6A9)
    shape = (t_steps,) + tuple(o["pre"].shape)
    wins = torch.from_numpy(
        (rng.integers(0, 2**32, shape, dtype=np.uint32)
         & rng.integers(0, 2**32, shape, dtype=np.uint32)).view(np.int32)
    ).to(dev)
    kw, teach = o["kw"], o["teach"]
    lif = LIFParams(kw["threshold"], kw["leak"])
    su = (STDPParams(kw["w_exp"], kw["gain"], kw["n_syn"], o["ltp"])
          if o["train"] else None)

    def window(fused: bool, dependent: bool):
        rf = rvsnn.SnnRegFile(spike=o["pre"], v=o["v"], lfsr=o["lfsr"],
                              weights=o["weights"])
        raster = []
        for t in range(t_steps):
            after_first = dependent and t > 0
            if fused:
                rf, fired = rvsnn.snn_step(rf, wins[t], lif, su, teach,
                                           dependent=after_first)
            else:
                rf = rvsnn.snn_ls(rf, wins[t])
                counts = rvsnn.snn_sp(rf, dependent=after_first)
                if teach is not None:
                    counts = counts + teach
                rf, fired = rvsnn.snn_nu(rf, counts, lif, dependent=dependent)
                if su is not None:
                    rf = rvsnn.snn_su(rf, fired, su, dependent=dependent)
            raster.append(fired)
        return rf.weights, rf.v, rf.lfsr, torch.stack(raster)

    out, states = {}, {}
    for key in GRAPH_KEYS:
        fused, dependent = key.startswith("graph"), not key.endswith("serial")
        window(fused, False)              # warm-up outside the graph
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            res = window(fused, dependent)
        out[key] = time_ms(graph.replay, 50) / t_steps
        states[key] = [x.clone() for x in res]
        del graph
    want = states[GRAPH_KEYS[0]]
    for key, got in states.items():
        for name, a, c in zip(("weights", "v", "LFSR", "raster"), got, want):
            if not torch.equal(a, c):
                fail(f"{key}: the {t_steps}-cycle graph leaves other {name} "
                     f"than the fused step's graph with dependent launches")
    return out


def cold_kernel_ms(fn, symbol: str, reps: int, dev: torch.device) -> float:
    """``kernel_ms`` of ``fn`` with ``FLUSH_BYTES`` written before each
    call, so that its inputs come from HBM, not the L2."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)

    def call():
        flush.fill_(1)
        return fn()

    return kernel_ms(call, symbol, reps)


def phase_step_kernels(rates: Rates) -> dict:
    """Phase 3, the per-cycle RV-SNN step kernels against their plain
    versions (the SPU, SU and fused step at "large" also cold), the
    unfused SPU -> NU -> SU chain against the fused step, and both as
    72-cycle CUDA graphs with and without dependent launches."""
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    out = {}
    for shape in ("step-parallel", "step-active", "step-infer", "large",
                  "quickstart"):
        o = step_operands(shape, dev)
        w, pre, v, lanes, teach, ltp = (o[k] for k in (
            "weights", "pre", "v", "lfsr", "teach", "ltp"))
        kw, train = o["kw"], o["train"]
        su = {k: kw[k] for k in ("w_exp", "gain", "n_syn")}
        reps, plain_reps = (20, 3) if shape == "large" else (200, 5)
        what = (f"{shape} (B={o['b']}, n={o['n']}, w={o['words']}, "
                f"{'shared bank, ' if o['banks'] < o['b'] else ''}"
                f"train={train})")
        state = {}      # the chain's kernel outputs: SPU counts, NU fired

        # in chain order: SPU, NU, SU, then the fused step
        calls = {}
        if shape != "quickstart":
            calls["spike_process"] = lambda be: ops.spike_process(
                pre, w, backend=be)
            calls["lif_step"] = lambda be: ops.lif_step(
                v, state["count"], kw["threshold"], kw["leak"], backend=be)
            if train:
                calls["stdp_update"] = lambda be: ops.stdp_update(
                    w, pre, state["fired"], lanes, ltp_prob=ltp,
                    backend=be, **su)
        calls["fused_snn_step"] = lambda be: ops.fused_snn_step(
            w, pre, v, lanes, teach, ltp_prob=ltp, train=train, backend=be,
            **kw)

        def bound_of(kname, o=o, train=train, state=state):
            def of(outputs):
                fired = (int(outputs[2].sum()) if kname == "fused_snn_step"
                         else int(state["fired"].sum())
                         if kname == "stdp_update" else 0)
                return step_bound(rates, kname, b=o["b"], n=o["n"],
                                  words=o["words"], banks=o["banks"],
                                  fired=fired, train=train)
            return of

        got = {}
        for kname, call in calls.items():
            out[(kname, shape)], got[kname] = hold_and_time(
                kname, what, call, STEP_SYMBOLS[kname], reps, plain_reps,
                bound_of(kname))
            if shape == "large" and kname != "lif_step":
                t = out[(kname, shape)]
                t["ms_cold"] = cold_kernel_ms(
                    lambda: call("kernel"), STEP_SYMBOLS[kname], reps, dev)
                print(f"kernel {kname} @ {what}: cold (L2 flushed before "
                      f"each launch) ms={t['ms_cold']}, warm ms={t['ms']}",
                      flush=True)
            if kname == "spike_process":
                counts = got[kname][0]
                state["count"] = counts if teach is None else counts + teach
            elif kname == "lif_step":
                state["fired"] = got[kname][1]
        fused = got["fused_snn_step"]
        if "lif_step" in got:
            chain = (got["stdp_update"][0] if train else w,
                     got["lif_step"][0], got["lif_step"][1],
                     got["stdp_update"][1] if train else lanes)
            for i, (a, c) in enumerate(zip(fused, chain)):
                if not torch.equal(a, c):
                    fail(f"the unfused SPU -> NU -> SU chain differs from "
                         f"fused_snn_step at {shape} (output {i})")
        print(f"step kernels @ {shape}: fired rows {int(fused[2].sum())}"
              + ("; unfused chain == fused step" if "lif_step" in got
                 else ""), flush=True)
        if shape in ("step-parallel", "step-infer", "large"):
            g = step_graph_ms(o)
            out[("fused_snn_step", shape)].update(g)
            chain = ("snn.sp" + (" -> + teach" if teach is not None else "")
                     + " -> snn.nu" + (" -> snn.su" if train else ""))
            print(f"step graphs @ {what}: 72 cycles as one CUDA graph, us "
                  f"per cycle: fused step {1e3 * g['graph_step_ms']} "
                  f"dependent, {1e3 * g['graph_step_ms_serial']} serial; "
                  f"unfused chain ({chain}) {1e3 * g['chain_graph_ms']} "
                  f"dependent, {1e3 * g['chain_graph_ms_serial']} serial "
                  f"(equal weights, v, LFSR, rasters)", flush=True)
    return out


@contextlib.contextmanager
def counting_plain_versions():
    """Counts, by name, every call of a plain version made while the
    block runs: those of ``repro_torch.kernels.ref``, the flash kernel's
    (``flash_attention_ref``) and the prefill's plain attention
    (``attention.chunked_attention``)."""
    from repro_torch.kernels import flash_attention, ref
    from repro_torch.models.layers import attention

    calls = collections.Counter()
    saved = [(mod, name, fn) for mod in (ref, flash_attention)
             for name, fn in vars(mod).items()
             if name.endswith("_ref") and callable(fn)]
    saved.append((attention, "chunked_attention",
                  attention.chunked_attention))

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    for mod, name, fn in saved:
        setattr(mod, name, counted(name, fn))
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def step_slice_runs(cycle_backend: str, x, labels, test_windows) -> dict:
    """One epoch of ``WENQUXING_22A`` (784-40, T = 72, host encode) on
    the card in each train mode on one cycle path, then the model's
    predictions on ``test_windows``: each run's model, wall time,
    predictions, and the launches of training and of the predictions."""
    from repro_torch.configs.wenquxing_snn import WENQUXING_22A
    from repro_torch.core.trainer import classify, train
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    cfg = dataclasses.replace(WENQUXING_22A, epochs=1,
                              cycle_backend=cycle_backend)
    runs = {}
    for mode in ("parallel", "active"):
        before = ops.launch_counts()
        t0 = time.perf_counter()
        model = train(dataclasses.replace(cfg, train_mode=mode), x, labels,
                      device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        trained = ops.launch_counts()
        pred = classify(model, test_windows)
        after = ops.launch_counts()
        runs[mode] = dict(
            model=model, wall=wall, pred=pred,
            trained={k: trained[k] - before[k] for k in trained},
            classify={k: after[k] - trained[k] for k in after})
    return runs


def rvsnn_program(model, window: torch.Tensor, label: int) -> int:
    """One presentation of ``window`` to the trained 784-40 population
    through the RV-SNN instructions one at a time (``snn.ls``, ``snn.sp``
    + teach, ``snn.nu``, ``snn.su``: three kernel launches a cycle, each
    after the first cycle a programmatic dependent of the kernel before
    it), then through ``snn.step`` (one launch a cycle); fails unless the
    register files and rasters are equal.  Returns the rows fired."""
    from repro_torch.core import rvsnn
    from repro_torch.kernels import ops

    cfg = model.cfg
    teach = torch.where(model.neuron_class == label, cfg.teach_pos,
                        cfg.teach_neg).to(torch.int32)
    lif, su = cfg.lif(), cfg.stdp()
    # ltp_prob on the card once, so that no host copy sits in the chain
    su = su._replace(ltp_prob=ops.seed_vector(su.ltp_prob, 1, teach.device))
    fine = fused = rvsnn.snn_regfile(model.weights, seed=0x22A)
    rasters = ([], [])
    for t, words in enumerate(window):
        dep = t > 0
        fine = rvsnn.snn_ls(fine, words)
        counts = rvsnn.snn_sp(fine, dependent=dep) + teach
        fine, fired = rvsnn.snn_nu(fine, counts, lif, dependent=dep)
        fine = rvsnn.snn_su(fine, fired, su, dependent=dep)
        rasters[0].append(fired)
    for words in window:
        fused, fired = rvsnn.snn_step(fused, words, lif, su, teach)
        rasters[1].append(fired)
    fine_r, fused_r = (torch.stack(r) for r in rasters)
    if not torch.equal(fine_r, fused_r):
        t = int((fine_r != fused_r).flatten(1).any(1).nonzero()[0])
        fail(f"snn.sp/nu/su and snn.step fire differently at cycle {t}")
    for name, a, b in zip(fine._fields, fine, fused):
        if not torch.equal(a, b):
            fail(f"snn.sp/nu/su and snn.step leave different {name}")
    return int(fine_r.sum())


def phase_step_slice() -> dict:
    """Phase 7: the step slice at full width on the card.  The window
    path's runs come first, outside the counted run; then, with the
    launch counts set to 0 and every plain version watched, the step
    path's runs and one RV-SNN program.  The step path must equal the
    window path bit for bit, launch ``fused_snn_step`` 72 times per
    presentation and per classification, and reach no plain version."""
    from repro_torch.core.encoder import poisson_encode_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.mnist_stdp import preprocessed_digits

    n_train, n_test, t_steps, n_classes, n_blocks = 256, 200, 72, 10, 4
    x, labels = preprocessed_digits(n_train, seed=1)
    tx, tlabels = preprocessed_digits(n_test, seed=2)
    tst = poisson_encode_batch(torch.Generator().manual_seed(99),
                               torch.from_numpy(tx), t_steps).cuda()
    from repro_torch.engine.engine import step_graph_stats

    window = step_slice_runs("window", x, labels, tst)
    graphs = step_graph_stats()
    ops.reset_launch_counts()
    with counting_plain_versions() as plain:
        step = step_slice_runs("step", x, labels, tst)
        before = ops.launch_counts()
        program_fired = rvsnn_program(step["parallel"]["model"], tst[0],
                                      int(tlabels[0]))
        program = {k: v - before[k] for k, v in ops.launch_counts().items()}
    launches = ops.launch_counts()
    graphs = {k: v - graphs.get(k, 0) for k, v in step_graph_stats().items()}
    if sum(plain.values()):
        fail(f"the step slice reached plain versions: {dict(plain)}")
    if not graphs["replays"]:
        fail(f"the step slice replayed no CUDA graph: {graphs}")

    def only(counts: dict, **want) -> bool:
        """Whether exactly the kernels in ``want`` launched, as often."""
        return {k: v for k, v in counts.items() if v} == want

    if not only(program, fused_snn_step=t_steps, spike_process=t_steps,
                lif_step=t_steps, stdp_update=t_steps):
        fail(f"the RV-SNN program launched {program}")

    for mode in ("parallel", "active"):
        s, w = step[mode], window[mode]
        if not (torch.equal(s["model"].weights, w["model"].weights)
                and torch.equal(s["model"].neuron_class,
                                w["model"].neuron_class)
                and torch.equal(s["pred"], w["pred"])):
            fail(f"{mode}: the step path's weights, class map or test "
                 f"predictions differ from the window path's")
        presented = w["trained"]["train_window_batch"]
        classified = w["trained"]["infer_window_batch"]
        blocks = s["model"].weights.shape[0] // n_classes
        want_cls = (0 if mode == "parallel" else
                    blocks if blocks < n_blocks else n_blocks - 1)
        if not presented or classified != want_cls:
            fail(f"{mode}: the window run presented {presented} samples "
                 f"and classified {classified} times ({w['trained']})")
        if not only(s["trained"], fused_snn_step=t_steps * (presented
                                                            + classified)):
            fail(f"{mode}: step training launched {s['trained']} for "
                 f"{presented} presentations and {classified} "
                 f"classifications of {t_steps} cycles")
        if not (only(s["classify"], fused_snn_step=t_steps)
                and only(w["classify"], infer_window_batch=1)):
            fail(f"{mode}: test predictions launched {s['classify']} "
                 f"(step) and {w['classify']} (window)")
        acc = float((s["pred"].cpu().numpy() == tlabels).mean())
        ms = {k: 1e3 * r[mode]["wall"] / presented
              for k, r in (("step", step), ("window", window))}
        print(f"step slice {mode}: {n_train} samples x 1 epoch, {presented}"
              f" presentations ({blocks} blocks); step path {s['wall']} s ="
              f" {n_train / s['wall']} samples/s, {ms['step']} ms per "
              f"presentation, {s['trained']['fused_snn_step']} fused step "
              f"launches; window path {w['wall']} s = "
              f"{n_train / w['wall']} samples/s, {ms['window']} ms per "
              f"presentation, {presented + classified} window launches; "
              f"step/window {ms['step'] / ms['window']}; test accuracy "
              f"{acc}; equal: weights, class map, predictions", flush=True)
    print(f"step slice: launches {launches}; window graphs recorded "
          f"{graphs['recorded']}, replayed {graphs['replays']} times (kept "
          f"{step_graph_stats()['kept']}); RV-SNN program (sp/nu/su vs "
          f"step, one presentation) equal, {program_fired} (row, cycle) "
          f"pairs fired; plain versions reached: 0", flush=True)
    return launches


def phase_quickstart() -> None:
    """The quickstart launcher on the card, in a process of its own."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.quickstart"],
        capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    for line in proc.stdout.splitlines():
        print(f"quickstart: {line}", flush=True)
    if proc.returncode != 0 or not re.search(
            r"bit-exact .*: True$", proc.stdout, re.MULTILINE):
        fail(f"quickstart exited {proc.returncode}: {proc.stderr[-2000:]}")


# --- the serving stack: step plans, faults, refresh, journal, load ---------

# the load harness's committed traces, replayed in part (d)
STACK_TRACES = (("smoke_50k", 1.0, False, 0.0),
                ("overload_50k", 5.0, True, 0.02))
CPU_REPLAY_FLAG = "--stack-cpu-replay"


def stack_setup(n_req: int, seed: int = 0):
    """The paper's configuration (784-40, threshold 192, leak 16, T 72,
    max_batch 32), its weights, class map and ``n_req`` ragged digit
    requests (T from 24 to 72, every fifth one pre-packed)."""
    from repro_torch.configs.wenquxing_snn import WENQUXING_22A
    from repro_torch.core.encoder import (encode_windows_host,
                                          quantize_intensities)
    from repro_torch.core.stdp import init_weights
    from repro_torch.data.digits import make_digits
    from repro_torch.engine import plan_from_config

    cfg = dataclasses.replace(WENQUXING_22A, encode="kernel")
    plan = dataclasses.replace(plan_from_config(cfg), max_batch=32)
    weights = init_weights(cfg.n_neurons, cfg.words, dense=False)
    neuron_class = np.tile(np.arange(cfg.n_classes), cfg.n_blocks)
    imgs, _ = make_digits(n_req, seed=seed)
    inten = quantize_intensities(imgs).numpy()
    rows = []
    for i in range(n_req):
        t = 24 + 8 * (i % 7)
        if i % 5 == 4:
            win = encode_windows_host(0x5A + i, torch.from_numpy(inten[i])[
                None], t, cfg.words)[0]
            rows.append(dict(rid=i, window=win.numpy().view(np.uint32)))
        else:
            rows.append(dict(rid=i, intensities=inten[i], n_steps=t))
    return cfg, plan, weights, neuron_class, rows


def stack_oracle(bank, reqs, plan) -> np.ndarray:
    """The plain pre-packed version's counts for every request, on the
    CPU under ``bank``: one launch over all of them, windows padded."""
    from repro_torch.core.bitpack import as_words
    from repro_torch.core.encoder import encode_windows_host
    from repro_torch.kernels import ops

    words = bank.shape[1]
    t_max = max(r.window.shape[0] if r.window is not None else r.n_steps
                for r in reqs)
    wins = np.zeros((len(reqs), t_max, words), np.uint32)
    for i, r in enumerate(reqs):
        w = (r.window if r.window is not None else encode_windows_host(
            r.seed, torch.from_numpy(r.intensities)[None], r.n_steps,
            words)[0].numpy().view(np.uint32))
        wins[i, :w.shape[0]] = w
    return ops.infer_window_batch(as_words(bank).cpu(), as_words(wins),
                                  threshold=plan.threshold, leak=plan.leak,
                                  backend="ref").numpy()


def replay_trace(name: str, scale: float, overload: bool, slowdown_p: float,
                 device: str) -> dict:
    """One virtual-clock replay of a committed trace through the engine
    ``launch/loadgen.py`` builds (``--scale``, ``--overload``,
    ``--slowdown-p``): per-status totals, both histograms' buckets and a
    SHA-256 over every SERVED request's counts in rid order."""
    import hashlib

    from repro_torch.launch import loadgen
    from repro_torch.loadgen import WorkloadSpec, read_trace, scale_rows
    from repro_torch.loadgen.runner import run_rows

    path = str(ROOT / "benchmarks" / "traces" / f"{name}.json")
    argv = ["--trace", path, "--mode", "virtual", "--device", device]
    if overload:
        argv.append("--overload")
    if slowdown_p:
        argv += ["--slowdown-p", str(slowdown_p)]
    args = loadgen.build_parser().parse_args(argv)
    header, rows = read_trace(path)
    workload = WorkloadSpec.from_dict(header["workload"])
    args.overload_base_rps = float(header["arrivals"]["rate_rps"])
    if scale != 1.0:
        rows = scale_rows(rows, scale)
    eng = loadgen.make_engine(args, workload, "virtual")
    reqs = []
    submit = eng.submit

    def keep(req):
        reqs.append(req)
        return submit(req)
    eng.submit = keep
    t0 = time.perf_counter()
    rep = run_rows(eng, workload, rows, slo_ms=args.slo_ms,
                   keep_payloads=True)
    wall = time.perf_counter() - t0
    h = hashlib.sha256()
    for r in sorted(reqs, key=lambda r: r.rid):
        if r.status == "SERVED":
            h.update(np.ascontiguousarray(r.counts, np.int32).tobytes())
    return {"per_status": eng.per_status(), "report": rep.to_dict(),
            "service_hist": eng.service_hist.to_dict(),
            "queue_wait_hist": eng.queue_wait_hist.to_dict(),
            "counts_sha256": h.hexdigest(), "steps": eng.steps,
            "wall_s": wall}


def cpu_replays(out: str) -> None:
    """Part (d)'s twin on the CPU (a process of its own): every trace
    replayed through the port's plain engine, written to ``out``."""
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(4)
    res = {name: replay_trace(name, scale, ov, sp, "cpu")
           for name, scale, ov, sp in STACK_TRACES}
    Path(out).write_text(json.dumps(res))


def check_served(what: str, reqs, want: np.ndarray) -> None:
    bad = [r.rid for r, w in zip(reqs, want)
           if r.status == "SERVED" and not np.array_equal(r.counts, w)]
    if bad:
        fail(f"{what}: served counts differ from the plain oracle for "
             f"rids {bad[:8]}")


def stack_step_plan(plan, weights, rows) -> None:
    """(a) One ragged list through a window plan and a step plan."""
    from repro_torch.kernels import ops
    from repro_torch.serving import SNNRequest, SNNServingEngine

    out = {}
    for name, p in (("window", plan),
                    ("step", dataclasses.replace(plan, cycle_backend="step",
                                                 encode="host"))):
        before = ops.launch_counts()
        eng = SNNServingEngine(weights, p, device="cuda")
        t0 = time.perf_counter()
        reqs = eng.run([SNNRequest(**r) for r in rows])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[name] = (reqs, {k: v - before[k] for k, v in
                            ops.launch_counts().items() if v - before[k]},
                     wall, eng)
    (wreqs, wl, ww, weng), (sreqs, sl, sw, seng) = out["window"], out["step"]
    if [r.status for r in sreqs] != [r.status for r in wreqs] or any(
            r.status != "SERVED" for r in sreqs):
        fail("(a) step and window plans gave different statuses: "
             f"{collections.Counter(r.status for r in sreqs)} vs "
             f"{collections.Counter(r.status for r in wreqs)}")
    want = stack_oracle(weights, sreqs, plan)
    check_served("(a) step plan", sreqs, want)
    check_served("(a) window plan", wreqs, want)
    if not sl.get("fused_snn_step"):
        fail(f"(a) the step plan launched {sl}")
    print(f"stack (a) step plan: {len(rows)} requests (T 24-72, "
          f"{sum('window' in r for r in rows)} pre-packed) SERVED on both "
          f"plans, counts equal to each other and to the plain oracle; "
          f"window plan {weng.batches} batches {ww} s, "
          f"launches {wl}; step plan {seng.batches} batches {sw} s, "
          f"launches {sl}", flush=True)


def stack_fault_storm(plan, weights, neuron_class, rows) -> None:
    """(b) A seeded storm of launch failures, corrupted counts and
    stalls on the card."""
    from repro_torch.serving import (FaultInjector, FaultSpec, SNNRequest,
                                     SNNServingEngine, SNNServingPolicy)

    inj = FaultInjector(FaultSpec(p_launch_error=0.25, p_corrupt=0.5,
                                  p_stall=0.2, stall_ms=1.0, error_burst=2,
                                  seed=0))
    eng = SNNServingEngine(weights, plan, neuron_class=neuron_class,
                           policy=SNNServingPolicy(max_retries=2,
                                                   canary_every=1,
                                                   reprobe_after=2),
                           on_launch=inj, device="cuda")
    reqs = eng.run([SNNRequest(**r) for r in rows])
    if not all(r.terminal for r in reqs):
        fail("(b) a request did not reach a terminal status")
    check_served("(b) fault storm", reqs,
                 stack_oracle(weights, reqs, plan))
    st = eng.stats()
    for key in ("retried", "degraded", "canary_checks"):
        if not st[key]:
            fail(f"(b) the storm counted {key}=0 ({inj.stats()})")
    print(f"stack (b) fault storm: per_status {eng.per_status()}; retried "
          f"{st['retried']}, degraded {st['degraded']}, integrity_failures "
          f"{st['integrity_failures']}, canary_checks {st['canary_checks']}"
          f" (failures {st['canary_failures']}), breakers "
          f"{st['breaker_states']}; injector {inj.stats()}", flush=True)


def stack_refresh(cfg, plan, weights, neuron_class, rows) -> None:
    """(c) Train-while-serving on the card, with a state_dir and a
    corrupted candidate."""
    import tempfile

    from repro_torch.core.encoder import quantize_intensities
    from repro_torch.data.digits import make_digits
    from repro_torch.serving import (FaultInjector, FaultSpec,
                                     SNNRefreshPolicy, SNNRequest,
                                     SNNServingEngine, SNNServingPolicy,
                                     SNNWeightRefresher)

    ref_imgs, ref_labels = make_digits(256, seed=1)
    probe_imgs, probe_labels = make_digits(32, seed=2)
    rf = SNNWeightRefresher(
        plan, quantize_intensities(ref_imgs).numpy(), ref_labels,
        n_classes=cfg.n_classes,
        probe_intensities=quantize_intensities(probe_imgs).numpy(),
        probe_labels=probe_labels, neuron_class=neuron_class,
        n_steps=cfg.n_steps, teach_pos=cfg.teach_pos,
        teach_neg=cfg.teach_neg, device="cuda",
        policy=SNNRefreshPolicy(refresh_every=1, probe_size=32,
                                refresh_samples=32))
    inj = FaultInjector(FaultSpec(p_refresh_corrupt=0.3, seed=2))
    with tempfile.TemporaryDirectory() as sd:
        eng = SNNServingEngine(weights, plan, neuron_class=neuron_class,
                               refresher=rf, state_dir=sd, keep_versions=64,
                               policy=SNNServingPolicy(canary_every=2),
                               on_launch=inj, device="cuda")
        cycle_ms = []
        cycle = eng._refresh_cycle

        def timed_cycle():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cycle()
            torch.cuda.synchronize()
            cycle_ms.append(1e3 * (time.perf_counter() - t0))
        eng._refresh_cycle = timed_cycle
        reqs = eng.run([SNNRequest(**r) for r in rows])
        st = eng.stats()
        if st["versions_promoted"] < 1 or st["refresh_corrupt"] < 1:
            fail(f"(c) promoted {st['versions_promoted']}, rejected "
                 f"{st['refresh_corrupt']} corrupt candidates "
                 f"({list(eng.refresh_events)})")
        if st["refresh_corrupt"] != inj.refresh_corruptions:
            fail("(c) a corrupted candidate passed the fingerprint gate")
        if not all(r.status == "SERVED" for r in reqs) or \
                st["version_violations"]:
            fail(f"(c) statuses {eng.per_status()}, version violations "
                 f"{st['version_violations']}")
        for v in sorted({r.served_version for r in reqs}):
            mine = [r for r in reqs if r.served_version == v]
            check_served(f"(c) version {v}", mine, stack_oracle(
                eng.store.get(v).weights, mine, plan))
        again = SNNServingEngine(np.zeros_like(weights.numpy()), plan,
                                 state_dir=sd, device="cuda")
        if (again.store.serving.version != eng.store.serving.version
                or again.store.serving.fingerprint
                != eng.store.serving.fingerprint):
            fail("(c) a second engine over the state_dir restored version "
                 f"{again.store.serving.version}, not "
                 f"{eng.store.serving.version}")
    print(f"stack (c) train-while-serving: {len(rows)} requests over "
          f"versions {sorted({r.served_version for r in reqs})}, counts "
          f"equal to each version's plain oracle; refresh_runs "
          f"{st['refresh_runs']}, promoted {st['versions_promoted']}, "
          f"rejected {st['versions_rejected']} (corrupt "
          f"{st['refresh_corrupt']}, probe gate {st['refresh_rejected']}), "
          f"rollbacks {st['rollbacks']}, probe accuracy "
          f"{rf.probe(weights)} -> {st['probe_accuracy']}; ms per refresh "
          f"cycle {cycle_ms}; restart restored version "
          f"{again.store.serving.version} (same fingerprint)", flush=True)


def stack_journal_cost(tmp: Path, n_rows: int = 10_000) -> None:
    """(d) The journal's cost on the card: the first ``n_rows`` of the
    smoke trace on the virtual clock with and without ``--journal-dir``
    (group commit: two WAL fsyncs and one ledger fsync a serving step),
    host clock around each run; the journaled run must end with the same
    per-status totals and a ledger entry for every row."""
    from repro_torch.launch import loadgen
    from repro_torch.loadgen import WorkloadSpec, read_trace
    from repro_torch.loadgen.runner import run_rows
    from repro_torch.serving import RequestJournal

    path = str(ROOT / "benchmarks" / "traces" / "smoke_50k.json")
    header, rows = read_trace(path)
    rows = rows[:n_rows]
    workload = WorkloadSpec.from_dict(header["workload"])
    runs = {}
    for name, extra in (("bare", []),
                        ("journaled", ["--journal-dir", str(tmp / "jcost")])):
        args = loadgen.build_parser().parse_args(
            ["--trace", path, "--device", "cuda", *extra])
        eng = loadgen.make_engine(args, workload, "virtual")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_rows(eng, workload, rows)
        eng.close()
        runs[name] = (time.perf_counter() - t0, eng)
    (bare_s, bare), (jour_s, jour) = runs["bare"], runs["journaled"]
    ledger = RequestJournal(tmp / "jcost").read_ledger()
    if (jour.per_status() != bare.per_status()
            or sorted(r["rid"] for r in ledger) != list(range(n_rows))):
        fail(f"(d) the journaled run ended {jour.per_status()} with "
             f"{len(ledger)} ledger entries, the bare run "
             f"{bare.per_status()}")
    st = jour.stats()
    extra_ms = 1e3 * (jour_s - bare_s)
    print(f"stack (d) journal cost: {n_rows} rows in {bare.steps} steps; "
          f"bare {bare_s} s ({1e3 * bare_s / bare.steps} ms a step), "
          f"journaled {jour_s} s ({1e3 * jour_s / jour.steps} ms a step), "
          f"{extra_ms / jour.steps} ms a step more; {st['journal_syncs']} "
          f"WAL fsyncs and {st['journal_records']} records "
          f"({extra_ms / st['journal_syncs']} ms a WAL fsync with its "
          f"ledger share), {st['journal_snapshots']} snapshots", flush=True)


def stack_chaos(tmp: Path) -> subprocess.Popen:
    """(e), started: the kill-restart chaos harness on the card over a
    4,000-request trace, as a process of its own."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    trace = tmp / "chaos_trace.json"
    subprocess.run([sys.executable, "-m", "repro_torch.launch.loadgen",
                    "--record", str(trace), "--compact", "--n", "4000",
                    "--rate", "20000"], check=True, env=env, cwd=ROOT,
                   capture_output=True, timeout=120)
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "wenquxing-snn", "--chaos", "--chaos-crashes", "3", "--trace",
         str(trace), "--state-dir", str(tmp / "chaos")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT)


def stack_load() -> None:
    """(f) Wall-clock load at the paper's width: one replay of 20,000
    Poisson requests at 20,000 requests/s, then the sweep, then the
    card's busy share of a traced second of the same stream."""
    import contextlib as ctx
    import io

    from repro_torch.launch import loadgen
    from repro_torch.loadgen import generate_rows

    common = ["--mode", "wall", "--inputs", "784", "--neurons", "40",
              "--threshold", "192", "--leak", "16", "--t-choices", "72",
              "--max-batch", "32", "--slo-ms", "50", "--n", "20000",
              "--device", "cuda"]
    for what, argv in (("replay", common + ["--rate", "20000"]),
                       ("sweep", common + ["--sweep", "1000", "64000",
                                           "--slo-floor", "0.99"])):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with ctx.redirect_stdout(buf):
            status = loadgen.main(argv)
        for line in buf.getvalue().splitlines():
            print(f"stack (f) {what}: {line} (wall "
                  f"{time.perf_counter() - t0} s)", flush=True)
        if what == "replay" and status:
            print(f"stack (f) replay: loadgen exited {status} (printed, "
                  "not gated)", flush=True)
    args = loadgen.build_parser().parse_args(common + ["--rate", "20000"])
    arrivals, workload = loadgen.build_specs(args)
    rows = generate_rows(arrivals, workload)
    wall_us, share, top = busy_share(
        lambda: loadgen.run_once(args, workload, rows))
    print(f"stack (f) traced second: {len(rows)} requests in {wall_us} us "
          f"under torch.profiler, card busy {share} of it; device work: "
          f"{top}", flush=True)


def phase_serving_stack() -> dict:
    """Phase 8: the serving stack on the card, parts (a)-(f); returns
    the launch counts of its in-process parts."""
    import tempfile

    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    cfg, plan, weights, neuron_class, rows = stack_setup(160)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_stack_"))
    procs = []
    try:
        # the CPU's half of (d) and all of (e) run in processes of their
        # own beside (a)-(c)
        cpu_out = tmp / "cpu_replays.json"
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), CPU_REPLAY_FLAG,
             str(cpu_out)], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
        chaos = stack_chaos(tmp)
        procs.append(chaos)
        ops.reset_launch_counts()
        stack_step_plan(plan, weights, rows[:96])
        stack_fault_storm(plan, weights, neuron_class, rows)
        stack_refresh(cfg, plan, weights, neuron_class, rows[:160])

        # (d) the committed traces, each replayed twice on the card
        card = {}
        for name, scale, ov, sp in STACK_TRACES:
            a = replay_trace(name, scale, ov, sp, "cuda")
            b = replay_trace(name, scale, ov, sp, "cuda")
            for k in ("per_status", "service_hist", "queue_wait_hist",
                      "counts_sha256", "report"):
                if a[k] != b[k]:
                    fail(f"(d) {name}: two replays on the card differ in "
                         f"{k}")
            card[name] = a
        out, _ = procs[0].communicate(timeout=900)
        if procs[0].returncode:
            fail(f"(d) the CPU replays exited {procs[0].returncode}: "
                 f"{out[-2000:]}")
        cpu = json.loads(cpu_out.read_text())
        for name, scale, ov, sp in STACK_TRACES:
            a, c = card[name], cpu[name]
            for k in ("per_status", "service_hist", "queue_wait_hist",
                      "counts_sha256", "report"):
                if a[k] != c[k]:
                    fail(f"(d) {name}: the card's replay differs from the "
                         f"CPU plain engine's in {k}")
            rep = a["report"]
            print(f"stack (d) {name} x{scale}{' --overload' if ov else ''}"
                  f"{f' --slowdown-p {sp}' if sp else ''}: replayed twice "
                  f"on the card, bit-identical, and equal to the CPU plain "
                  f"engine's replay (per_status {a['per_status']}, "
                  f"histogram buckets, counts sha256 "
                  f"{a['counts_sha256'][:16]}); steps {a['steps']}, wall "
                  f"{a['wall_s']} s on the card vs {c['wall_s']} s on the "
                  f"CPU; virtual achieved_rps {rep['achieved_rps']}, e2e "
                  f"p99 {rep['e2e_ms_p99']} ms, attainment "
                  f"{rep['slo_attainment']}", flush=True)

        stack_journal_cost(tmp)

        # (e) the chaos harness's result; it has ended before (f) starts,
        # so no other process shares the card or the host with (f)
        out, _ = chaos.communicate(timeout=900)
        for line in out.splitlines():
            if line.startswith(("chaos", "loadgen: resuming")):
                print(f"stack (e) {line}", flush=True)
        if chaos.returncode or "chaos-audit: ok" not in out:
            fail(f"(e) the chaos harness exited {chaos.returncode}: "
                 f"{out[-3000:]}")

        # (f) wall-clock load at the paper's width, measured alone
        stack_load()
        launches = ops.launch_counts()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"stack: launches {launches}; phase wall "
          f"{time.perf_counter() - t_phase} s", flush=True)
    return launches


# --- the LM slice: flash attention and gemma3-1b served at full width -------

FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attn.cu"
FLASH_PALLAS = "src/repro/kernels/flash_attention.py:114"
# H100 SXM dense peaks (NVIDIA data sheet): bf16 on the tensor cores; for
# float32, the tensor cores' TF32 rate over three: the least time for
# f32-accurate products is three TF32 products (big.big, big.small,
# small.big of each operand split into two TF32 halves), which beats the
# CUDA cores' full-f32 67 TFLOP/s
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 494.7e12 / 3
# (name, B, Hq, Hkv, D, T, causal, window)
FLASH_SHAPES = (
    ("gemma-global", 1, 4, 1, 256, 2048, True, None),
    ("gemma-local", 1, 4, 1, 256, 2048, True, 512),
    ("ragged-37", 1, 4, 1, 256, 37, True, 512),
    ("ragged-1000", 1, 4, 1, 256, 1000, True, 512),
    ("gqa-noncausal", 2, 8, 2, 128, 512, False, None),
    ("starcoder2-3b", 1, 24, 2, 128, 1024, True, None),
)
# (dtype, name, atol = rtol, the kernel that runs it): f32 in split TF32
# (mma.sync), bf16 with wgmma and TMA, both on the tensor cores
FLASH_DTYPES = ((torch.float32, "f32", 1e-4, "flash_fwd_kernel"),
                (torch.bfloat16, "bf16", 3e-2, "flash_wgmma_kernel"))
# each kernel's tensor-core instruction in the SASS
FLASH_TENSOR_OP = {"f32": "HMMA", "bf16": "HGMMA"}
FLASH_HEAD_DIMS = (32, 64, 128, 256)
# bf16 also within this share of the output's largest magnitude: about
# one bf16 rounding of the largest output (2**-8 of it), so a fault in
# the bf16 loads or stores alone fails where 3e-2 would pass it
FLASH_BF16_REL = 1e-2
# and ||kernel - plain|| / ||plain|| within this: p and o each rounded to
# bf16 once (2**-9 relative each) read a few 2**-9, so a fault confined
# to a few rows or tiles (a dropped KV tile on long rows) fails here
FLASH_BF16_NORM = 1e-2
LM_PROMPTS = (37, 300, 511, 512, 513, 1000, 1536, 2048)
LM_NEW_TOKENS = 32
LM_TOL = 1e-3         # of the logits' largest magnitude, float32


def unmasked_pairs(tq: int, tk: int, causal: bool, window) -> int:
    """(query, key) pairs the masks leave, queries the last tq of tk."""
    pos = np.arange(tq) + (tk - tq)
    hi = np.minimum(pos, tk - 1) if causal else np.full(tq, tk - 1)
    lo = (np.maximum(pos - window + 1, 0) if window
          else np.zeros(tq, np.int64))
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_flops(b, hq, d, t, causal, window) -> int:
    """4 B Hq D flops per unmasked (query, key) pair: both products."""
    return 4 * b * hq * d * unmasked_pairs(t, t, causal, window)


def flash_bound(b, hq, hkv, d, t, causal, window, dtype
                ) -> tuple[float, str]:
    """Least time (s) of one call: the flops at the card's peak for the
    dtype, against q, k, v and o crossing HBM once."""
    flops = flash_flops(b, hq, d, t, causal, window)
    rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
    moved = (torch.finfo(dtype).bits // 8) * d * (2 * b * hq * t
                                                 + 2 * b * hkv * t)
    t_ops, t_bytes = flops / rate, moved / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sdpa_call(q, k, v, causal: bool, window):
    """One ``scaled_dot_product_attention`` call computing the kernel's
    function (square shapes): the library yardstick."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window is None:
        return lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True)
    pos = torch.arange(q.shape[2], device=q.device)[:, None]
    kpos = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = kpos > pos - window
    if causal:
        mask &= kpos <= pos
    return lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True)


def fused_views(q, k, v):
    """q, k, v copied into one [B, T, (Hq + 2 Hkv) D] tensor and taken
    back as the transposed views the model's fused projection gives
    (``models/layers/attention.py``)."""
    b, hq, t, d = q.shape
    hkv = k.shape[1]
    qkv = torch.cat([x.transpose(1, 2).reshape(b, t, -1) for x in (q, k, v)],
                    dim=-1)
    q2, k2, v2 = qkv.split([hq * d, hkv * d, hkv * d], dim=-1)
    return (q2.reshape(b, t, hq, d).transpose(1, 2),
            k2.reshape(b, t, hkv, d).transpose(1, 2),
            v2.reshape(b, t, hkv, d).transpose(1, 2))


def ptxas_report(source: str) -> dict[str, str]:
    """ptxas's spill and register lines of each kernel of ``source``'s
    build, by mangled name."""
    from repro_torch.kernels import build

    props, fn = {}, None
    log = build.library_path(source).with_suffix(".log")
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and ("spill" in line or "registers" in line):
            props.setdefault(fn, []).append(line.split(":", 1)[-1].strip()
                                            if "registers" in line
                                            else line.strip())
    return {f: "; ".join(v) for f, v in props.items()}


def spills(line: str) -> bool:
    return re.search(r"[1-9]\d* bytes spill", line) is not None


def check_sums_build() -> None:
    """The GEMM regime's sums kernels as built: ptxas's register and
    spill line of each (any spill fails: the ring of three blocks an SM
    caps a thread at 80 registers)."""
    report = ptxas_report("snn_infer")
    for symbol in SUMS_SYMBOLS:
        lines = [line for f, line in report.items() if symbol in f]
        print(f"ptxas {symbol}: {lines}", flush=True)
        if len(lines) != 1:
            fail(f"ptxas reported {len(lines)} builds of {symbol}")
        if spills(lines[0]):
            fail(f"{symbol} spills registers")


def check_flash_build() -> None:
    """Both flash kernels as built, at every head dim: ptxas's register
    and spill line (any spill fails), and their tensor-core instructions
    counted in the library's SASS (``cuobjdump -sass``: ``HGMMA`` in the
    bf16 ``wgmma`` kernel, ``HMMA`` in the f32 split-TF32 ``mma.sync``
    kernel; none at some head dim fails)."""
    from repro_torch.kernels import build

    lib = build.library_path("flash_attn")
    report = ptxas_report("flash_attn")
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    ops = collections.Counter()
    fn = None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
        elif fn:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\b", line):
                    ops[fn, op] += 1
    for _, dname, _, symbol in FLASH_DTYPES:
        dims = {int(re.search(r"ILi(\d+)E", f).group(1)): line
                for f, line in report.items() if symbol in f}
        for d in FLASH_HEAD_DIMS:
            print(f"ptxas {symbol}<{d}>: {dims.get(d)}", flush=True)
        if sorted(dims) != list(FLASH_HEAD_DIMS):
            fail(f"ptxas reported {symbol} at head dims {sorted(dims)}, "
                 f"expected {FLASH_HEAD_DIMS}")
        spilled = [d for d, line in dims.items() if spills(line)]
        if spilled:
            fail(f"{symbol} spills registers at head dims {spilled}")
        op = FLASH_TENSOR_OP[dname]
        per_dim = {d: sum(c for (f, o), c in ops.items()
                          if o == op and f"{symbol}ILi{d}E" in f)
                   for d in FLASH_HEAD_DIMS}
        print(f"sass: {op} instructions in {symbol} by head dim {per_dim}",
              flush=True)
        if not all(per_dim.values()):
            fail(f"{symbol} has no {op} instruction at some head dim: "
                 f"{per_dim}")


def phase_flash_kernel() -> dict:
    """Phase 9a: the bf16 kernel's build checked, then the flash kernels
    against their plain version on the card at each shape in both dtypes,
    then timed (each dtype by its own kernel's profiler records) beside
    the bound, the plain version and SDPA."""
    from repro_torch.kernels.flash_attention import flash_attention

    check_flash_build()
    dev = torch.device("cuda")
    out = {}
    for name, b, hq, hkv, d, t, causal, window in FLASH_SHAPES:
        rng = np.random.default_rng(t + d)
        base = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                .to(dev) for s in ((b, hq, t, d), (b, hkv, t, d),
                                   (b, hkv, t, d))]
        for dtype, dname, tol, symbol in FLASH_DTYPES:
            q, k, v = (x.to(dtype) for x in base)
            kw = dict(causal=causal, window=window)
            got = flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            want = flash_attention(q, k, v, backend="ref", **kw)
            err = float((got.float() - want.float()).abs().max())
            top = float(want.float().abs().max())
            norm = float(torch.linalg.vector_norm(got.float() - want.float())
                         / torch.linalg.vector_norm(want.float()))
            if not torch.allclose(got.float(), want.float(), atol=tol,
                                  rtol=tol):
                fail(f"flash_attention at {name} {dname}: max |kernel - "
                     f"plain| {err} exceeds atol = rtol = {tol}")
            if dtype == torch.bfloat16 and err > FLASH_BF16_REL * top:
                fail(f"flash_attention at {name} {dname}: max |kernel - "
                     f"plain| {err} exceeds {FLASH_BF16_REL} of the "
                     f"output's largest magnitude {top}")
            if dtype == torch.bfloat16 and norm > FLASH_BF16_NORM:
                fail(f"flash_attention at {name} {dname}: ||kernel - plain||"
                     f" / ||plain|| = {norm} exceeds {FLASH_BF16_NORM}")
            if not torch.equal(flash_attention(*fused_views(q, k, v), **kw),
                               got):
                fail(f"flash_attention at {name} {dname}: the views of a "
                     f"fused projection give another output than "
                     f"contiguous q, k, v")
            lib = sdpa_call(q, k, v, causal, window)
            lib_err = float((lib().float() - want.float()).abs().max())
            ms = kernel_ms(lambda: flash_attention(q, k, v, **kw), symbol, 20)
            plain = functools.partial(flash_attention, q, k, v,
                                      backend="ref", **kw)
            plain_ms = call_device_ms(plain, 5, f"the plain flash_attention "
                                      f"at {name} {dname}")
            library_ms = call_device_ms(lib, 20, f"sdpa at {name} {dname}")
            plain_call_ms, library_call_ms = time_ms(plain, 5), \
                time_ms(lib, 20)
            b_s, b_by = flash_bound(b, hq, hkv, d, t, causal, window, dtype)
            shape = (f"B={b} Hq={hq} Hkv={hkv} D={d} T={t} causal={causal} "
                     f"window={window} {dname}")
            print(f"kernel flash_attention @ {name} ({shape}): within "
                  f"{tol} max_abs_err={err} (largest |plain| {top}; "
                  f"||kernel - plain|| / ||plain|| {norm}; views of a fused "
                  f"projection equal) "
                  f"ms={ms} plain_ms={plain_ms} ({plain_call_ms} a call "
                  f"with its host dispatch) library_ms={library_ms} "
                  f"({library_call_ms} a call; sdpa, max |sdpa - plain| "
                  f"{lib_err}) bound_ms={1e3 * b_s} ({b_by}); {symbol} "
                  f"{flash_flops(b, hq, d, t, causal, window) / ms / 1e9} "
                  f"TFLOP/s, kernel/bound {ms / (1e3 * b_s)}, kernel/sdpa "
                  f"{ms / library_ms}", flush=True)
            out[f"{name}-{dname}"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=1e3 * b_s, bound_by=b_by, library_ms=library_ms)
    return out


def busy_share(fn) -> tuple[float, float, str]:
    """(wall us, card busy share, heaviest device work) of one call of
    ``fn`` under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    devs = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in devs)
    top = "; ".join(f"{e.key[:90]} {e.count}x {e.self_device_time_total} us"
                    for e in sorted(devs, key=lambda e:
                                    -e.self_device_time_total)[:5])
    return wall_us, dev_us / wall_us, top


def phase_lm_slice():
    """Phase 9b: gemma3-1b at full width in bfloat16 served on the card,
    the launch counts set to 0 before and read after, every plain
    attention function watched.  Returns (launches, model)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import Model
    from repro_torch.serving import Request, ServingEngine

    cfg = get_config("gemma3-1b")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"lm slice: {cfg.name} at full width ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.hd}, window {cfg.window} on {cfg.swa_period - 1} of every "
          f"{cfg.swa_period} layers), {n_params} parameters in "
          f"{model.dtype}, drawn in {time.perf_counter() - t0} s", flush=True)
    # warm-up outside the counted run (cuBLAS handles, allocator)
    ServingEngine(model, n_slots=4, max_len=4096).run(
        [Request(rid=-1, prompt=[1, 2, 3, 4, 5], max_new_tokens=2)])

    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in LM_PROMPTS]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=LM_NEW_TOKENS)
            for i, p in enumerate(prompts)]
    eng = ServingEngine(model, n_slots=4, max_len=4096)
    prefill_ms, decode_ms = {}, []

    def timed(fn, record):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            result = fn(*args, **kwargs)
            torch.cuda.synchronize()
            record(args, 1e3 * (time.perf_counter() - t))
            return result
        return call

    model.prefill = timed(model.prefill, lambda a, ms: prefill_ms.__setitem__(
        a[0].shape[1], ms))
    model.decode_step = timed(model.decode_step,
                              lambda a, ms: decode_ms.append(ms))
    ops.reset_launch_counts()
    with counting_plain_versions() as plain:
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    del model.prefill, model.decode_step
    if sum(plain.values()):
        fail(f"the LM slice reached plain versions: {dict(plain)}")
    for r in reqs:
        if not (r.done and len(r.output) == LM_NEW_TOKENS
                and all(0 <= x < cfg.vocab_size for x in r.output)):
            fail(f"request {r.rid} ({len(r.prompt)} prompt tokens) ended "
                 f"done={r.done} with {len(r.output)} tokens")
    want = {k: 0 for k in launches}
    want["flash_attention"] = cfg.n_layers * len(reqs)
    if launches != want:
        fail(f"the LM slice launched {launches}, expected {want}")
    print(f"lm slice: {len(reqs)} requests x {LM_NEW_TOKENS} tokens done in "
          f"{wall} s = {eng.tokens_out / wall} tokens/s ({eng.steps} engine "
          f"steps); flash_attention launches {launches['flash_attention']} ="
          f" {cfg.n_layers} layers x {len(reqs)} prefills; plain attention "
          f"reached: 0", flush=True)
    print("lm slice: prefill ms by prompt length: " + "; ".join(
        f"{n} {prefill_ms[n]}" for n in LM_PROMPTS), flush=True)
    print(f"lm slice: decode step ms (4 slots): {step_summary(decode_ms)}",
          flush=True)

    with torch.inference_mode():
        toks = torch.tensor([prompts[-1]], device=dev)
        wall_us, share, top = busy_share(lambda: model.prefill(toks, 4096))
        print(f"lm trace: prefill of {toks.shape[1]} tokens: wall {wall_us} "
              f"us, card busy {share} of it; device work: {top}",
              flush=True)
        last = torch.from_numpy(eng.last_token[:, None]).to(dev)
        clen = torch.from_numpy(eng.cache_len).to(dev)
        wall_us, share, top = busy_share(
            lambda: model.decode_step(last, eng.cache, clen))
        print(f"lm trace: decode step (4 slots): wall {wall_us} us, card "
              f"busy {share} of it; device work: {top}", flush=True)
    return launches, model


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def phase_lm_correctness(model) -> None:
    """Phase 9c: the slice's own bf16 model, the kernel's prefill against
    the plain attention's: the same greedy token, and within twice what
    bf16 itself moves the logits (the plain bf16 prefill against the
    float32 one).
    Then a float32 copy of the weights, TF32 off: the kernel's prefill
    against the plain attention's, and teacher-forced decode against
    prefill, within ``LM_TOL``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(15)
    dev = torch.device("cuda")
    prompt = torch.from_numpy(rng.integers(0, vocab, (1, 1000))).to(dev)

    def prefill_both(m):
        """Last-token logits of the prompt through the kernel, then
        through the plain attention."""
        kern, _, _ = m.prefill(prompt, 1024)
        m.attn_backend = "ref"
        plain, _, _ = m.prefill(prompt, 1024)
        m.attn_backend = "kernel"
        return kern.float(), plain.float()

    with torch.inference_mode():
        kern16, plain16 = prefill_both(model)
        m32 = model.cast(torch.float32)
        kern, plain = prefill_both(m32)

        def dist(a, b) -> float:
            return float((a - b).abs().max() / plain.abs().max())

        # bf16's own reach is how far the plain bf16 prefill lies from
        # the f32 one.  A kernel whose bf16 prefill lies no farther from
        # the f32 one is within twice that of the plain bf16 prefill (the
        # triangle inequality): that is the limit.
        err16, bf16_err = dist(kern16, plain16), dist(plain16, plain)
        same16 = int(kern16.argmax()) == int(plain16.argmax())
        top2 = plain16[0].topk(2).values
        print(f"lm check: bf16 prefill of 1000 tokens, kernel vs plain "
              f"attention: max |diff| / max |f32 logit| = {err16} (limit "
              f"twice the plain bf16 prefill's from the f32 one, "
              f"{bf16_err}; the kernel's from the f32 one "
              f"{dist(kern16, plain)}), greedy token equal: {same16} "
              f"(plain's top two logits {top2.tolist()})", flush=True)
        if err16 > 2 * bf16_err or not same16:
            fail("the bf16 prefill through the kernel differs from the "
                 "plain attention's by more than bf16's own rounding allows")
        err = rel_err(kern, plain)
        same = int(kern.argmax()) == int(plain.argmax())
        print(f"lm check: f32 prefill of 1000 tokens, kernel vs plain "
              f"attention: max |diff| / max |logit| = {err}, greedy token "
              f"equal: {same}", flush=True)
        if err > LM_TOL or not same:
            fail("the f32 prefill through the kernel differs from the plain "
                 "attention's")

        toks = torch.from_numpy(rng.integers(0, vocab, (1, 600))).to(dev)
        logits, cache, clen = m32.prefill(toks, 1024)
        errs, agree = [], 0
        for _ in range(8):
            nxt = logits.argmax(dim=-1)[:, None]
            toks = torch.cat([toks, nxt], dim=1)
            logits, cache = m32.decode_step(nxt, cache, clen)
            clen += 1
            want, _, _ = m32.prefill(toks, 1024)
            errs.append(rel_err(logits, want))
            agree += int(logits.argmax()) == int(want.argmax())
        print(f"lm check: teacher-forced decode after a 600-token prefill "
              f"(512-slot rings wrap), 8 steps vs prefill of the prompt "
              f"plus the tokens so far: max |diff| / max |logit| per step "
              f"{errs}; greedy equal on {agree} of 8", flush=True)
        if max(errs) > LM_TOL:
            fail("teacher-forced decode differs from prefill")
    del m32
    torch.cuda.empty_cache()


# --- the paper's evaluation: Table 1, Fig. 4, Fig. 5, the w_exp sweep ------

PAPER_CPU_FLAG = "--paper-eval-cpu"
# the kernels the evaluation's path must launch: the classify from
# intensities (row 1), the materialized test windows (row 2), an epoch
# of a block's training (row 4)
PAPER_KERNELS = ("infer_window_batch_encode", "infer_window_batch",
                 "train_window_batch_encode")


def paper_reduced(ds, device: str) -> dict:
    """Fig. 4's and Table 1's logic at 784-40, T 72, one epoch, on
    ``device`` over the dataset ``ds`` (256 training and 200 test
    digits).  Returns what the card's run must equal on the CPU: both
    models, the correct count, the event counts and both energy dicts."""
    from repro_torch.bench import fig4_energy, table1_accuracy

    f4 = fig4_energy.run(ds, epochs=1, device=device)
    t1 = table1_accuracy.run(ds, epochs=1, device=device)
    return {"fig4_weights": f4["model"].weights.cpu(),
            "fig4_classes": f4["model"].neuron_class.cpu(),
            "table1_weights": t1["model"].weights.cpu(),
            "table1_classes": t1["model"].neuron_class.cpu(),
            "correct": t1["correct"], "in_spikes": f4["in_spikes"],
            "post": f4["post"], "energy": f4["energy"],
            "events": {m: dataclasses.asdict(ev)
                       for m, ev in f4["events"].items()}}


def paper_cpu(data: str, out: str) -> None:
    """Phase 10's reduced run with the plain versions on the CPU (a
    process of its own) over the dataset saved in ``data`` (the card's
    process preprocesses it once, so both runs see the same floats),
    saved to ``out``."""
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(4)
    with np.load(data) as f:
        ds = tuple(f[k] for k in ("tr", "tr_lab", "te", "te_lab"))
    torch.save(paper_reduced(ds, "cpu"), out)


def phase_paper_eval(card: str) -> dict:
    """Phase 10: the paper's evaluation (``repro_torch.bench.run``) at
    its full setting on the card, rows 1 and 2 held equal on the 1,000
    test digits, and a reduced run held equal to the CPU plain run.
    Returns the launch counts of the full run."""
    import tempfile

    from repro_torch.bench import common, run, table1_accuracy
    from repro_torch.core import network
    from repro_torch.core.encoder import encode_from_counter_batch
    from repro_torch.engine import SNNEngine
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_paper_"))
    cpu_data, cpu_out = tmp / "paper_digits.npz", tmp / "paper_cpu.pt"
    small = common.digits_dataset(n_train=256, n_test=200)
    np.savez(cpu_data, **dict(zip(("tr", "tr_lab", "te", "te_lab"), small)))
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), PAPER_CPU_FLAG,
         str(cpu_data), str(cpu_out)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        with counting_plain_versions() as plain:
            common.digits_dataset()                 # set-up, not timed
            common.digits_dataset(n_train=1000, n_test=200)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            res = run.run_modules(run.PAPER_MODULES, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = ops.launch_counts()
            for k in PAPER_KERNELS:
                if not launches[k]:
                    fail(f"the paper's evaluation never launched {k}: "
                         f"{launches}")

            # rows 1 and 2 on the 1,000 test digits: Table 1's model
            model = res["table1_accuracy"]["model"]
            cfg = model.cfg
            _, _, te, _ = common.digits_dataset()
            inten, seeds = common.encode_test_set(
                te, table1_accuracy.TEST_SEED, "cuda")
            enc = SNNEngine(cfg.plan(), device="cuda").infer(
                model.weights, intensities=inten, seeds=seeds,
                n_steps=cfg.n_steps)
            pre = network.infer_batch(
                model.weights,
                encode_from_counter_batch(seeds, inten, cfg.n_steps),
                cfg.lif())
            if not torch.equal(enc, pre):
                fail("the paper's test counts through the encode kernel "
                     "differ from the pre-packed kernel's")

            reduced = paper_reduced(small, "cuda")
        if sum(plain.values()):
            fail(f"the paper's evaluation called plain versions on the "
                 f"card: {dict(plain)}")
        out, _ = proc.communicate(timeout=900)
        if proc.returncode:
            fail(f"the paper's CPU plain run exited {proc.returncode}: "
                 f"{out[-2000:]}")
        cpu = torch.load(cpu_out)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    for k in ("fig4_weights", "fig4_classes", "table1_weights",
              "table1_classes"):
        if not torch.equal(reduced[k], cpu[k]):
            fail(f"the paper's reduced run: {k} on the card differ from "
                 f"the CPU plain run")
    for k in ("correct", "in_spikes", "post", "energy", "events"):
        if reduced[k] != cpu[k]:
            fail(f"the paper's reduced run: {k} on the card "
                 f"{reduced[k]} differ from the CPU plain run's {cpu[k]}")

    for name, t in (
            ("table1 784-40", res["table1_accuracy"]["train_s"]),
            ("fig4 784-40 (1,000 digits)", res["fig4_energy"]["train_s"]),
            *((f"fig5 784-{n}", t) for n, t in
              res["fig5_neurons"]["train_s"].items()),
            *((f"wexp {w} 784-40", r["train_s"]) for w, r in
              res["wexp_sweep"].items())):
        print(f"paper: training {name}: {t} s wall on the card ({card})",
              flush=True)
    t1, f5, f4 = (res["table1_accuracy"], res["fig5_neurons"],
                  res["fig4_energy"])
    sweep = {w: {k: r[k] for k in ("acc", "dead", "mean_on")}
             for w, r in res["wexp_sweep"].items()}
    print(f"paper: Table 1 784-40 CA {t1['accuracy']} (oracle ceiling "
          f"{t1['ceiling']}); Fig. 5 CA {f5['accuracy']}, monotone "
          f"{f5['monotone']}; Fig. 4 modeled (FPGA model) energy ratio "
          f"{f4['ratio']} (paper 5.13), in_spikes {f4['in_spikes']}, post "
          f"{f4['post']}; w_exp sweep {sweep}", flush=True)
    print(f"paper: full setting {wall} s on the card; launches "
          f"{ {k: launches[k] for k in PAPER_KERNELS} }; no plain version "
          f"called; rows 1 and 2 equal on {len(te)} test digits; reduced "
          f"run (784-40, 256 digits, 1 epoch) equal to the CPU plain run: "
          f"weights, class maps, correct {reduced['correct']}, events, "
          f"energy; phase wall {time.perf_counter() - t_phase} s",
          flush=True)
    return launches


# --- placement on a device grid, and the benchmark harness -----------------

# the kernels the placement part must launch: every window op (the
# ``--check`` runs each wrapper), the meshed trainer's stream kernel and
# the meshed serving's encode kernel and canary
MESH_KERNELS = ("infer_window_batch_encode", "infer_window_batch",
                "train_window_batch", "train_window_batch_encode",
                "fused_snn_window", "fused_snn_window_encode")
# the kernels the harness's rows call in this process (the grid rows run
# in processes of their own, their launches counted there)
HARNESS_KERNELS = ("infer_window_batch_encode", "infer_window_batch",
                   "train_window_batch", "train_window_batch_encode",
                   "fused_snn_step", "spike_process", "lif_step",
                   "stdp_update")
# the JAX package's committed rows, whose deterministic fields the
# port's rows must equal, and the port's committed baseline
JAX_BENCH = ROOT / "BENCH_kernels.json"
TORCH_BENCH = ROOT / "BENCH_torch.json"
VIRTUAL_ROWS = ("loadgen/virtual-50k@20000", "loadgen/sweep-5k",
                "loadgen/overload-1x-50k@30000",
                "loadgen/overload-5x-50k@150000")


def phase_placement() -> dict:
    """Phase 11 (a): ``snn_mesh --check`` with every shard on ``cuda:0``
    (the 1-D grid of 8 and the 2-D grids 2,4, 4,2 and 8,1), the meshed
    trainer at full width against the local one, and 64 requests served
    through a meshed plan against the local engine.  Returns the launches
    of the meshed calls alone: each wrapper's in ``--check`` (held there
    to one a shard for each launch of the unsharded op), the meshed
    trainer's and the meshed serving engine's; the unsharded and local
    reference runs are left out."""
    from repro_torch.configs.wenquxing_snn import (WENQUXING_22A_INTENSITY,
                                                   WENQUXING_22A_MESH2D)
    from repro_torch.core.trainer import train
    from repro_torch.distributed import snn_mesh
    from repro_torch.kernels import ops
    from repro_torch.launch.mnist_stdp import preprocessed_digits
    from repro_torch.serving import SNNServingEngine, SNNServingPolicy

    dev = torch.device("cuda", 0)
    launches = dict.fromkeys(ops.launch_counts(), 0)

    def add(counts: dict) -> None:
        for k, v in counts.items():
            launches[k] += v

    for argv in (["--devices", "8"],
                 ["--mesh-shape", "2,4", "--mesh-shape", "4,2",
                  "--mesh-shape", "8,1"]):
        try:
            add(snn_mesh.check(snn_mesh.parse_args(
                ["--check", "--on", "cuda:0", *argv])))
        except AssertionError as e:
            fail(f"snn_mesh --check {' '.join(argv)} on the card: {e}")

    # WENQUXING_22A_MESH2D at full width (784-40, T 72, parallel mode) on
    # the phase-6 digits, its (2, 4) grid on the one card
    x, labels = preprocessed_digits(256, seed=1)
    grid = snn_mesh.snn_mesh2d(2, 4, devices=[dev] * 8)
    before = ops.launch_counts()["train_window_batch_encode"]
    t0 = time.perf_counter()
    meshed = train(dataclasses.replace(WENQUXING_22A_MESH2D, epochs=1), x,
                   labels, device=dev, mesh=grid)
    torch.cuda.synchronize()
    t_mesh = time.perf_counter() - t0
    stream = ops.launch_counts()["train_window_batch_encode"] - before
    add({"train_window_batch_encode": stream})
    t0 = time.perf_counter()
    local = train(dataclasses.replace(WENQUXING_22A_INTENSITY, epochs=1,
                                      train_mode="parallel"), x, labels,
                  device=dev)
    torch.cuda.synchronize()
    t_local = time.perf_counter() - t0
    if not (torch.equal(meshed.weights, local.weights)
            and torch.equal(meshed.neuron_class, local.neuron_class)):
        fail("the meshed trainer's weights or class map differ from the "
             "local parallel run")
    if stream != grid.size:
        fail(f"the meshed trainer launched the stream kernel {stream} "
             f"times, not one a shard ({grid.size})")

    # 64 intensity requests through a meshed plan and the local one
    served = {}
    for name in ("local", "grid"):
        plan, weights, neuron_class, reqs = slice_setup(64, rid0=4096)
        if name == "grid":
            plan = dataclasses.replace(plan, mesh=grid)
        eng = SNNServingEngine(weights, plan, neuron_class=neuron_class,
                               policy=SNNServingPolicy(canary_every=2),
                               device=dev)
        before = ops.launch_counts()
        serve_steps(eng, reqs)
        after = ops.launch_counts()
        st = eng.stats()
        bad = [r.rid for r in reqs if r.status != "SERVED"]
        if bad or st["degraded"] or st["canary_failures"]:
            fail(f"meshed serving ({name}): not SERVED {bad[:5]}, "
                 f"degraded {st['degraded']}, canary failures "
                 f"{st['canary_failures']}")
        served[name] = (np.stack([r.counts for r in reqs]), eng.batches,
                        st["canary_checks"],
                        {k: after[k] - before[k] for k in after})
    (lc, _, _, _), (gc, batches, canaries, grid_l) = (served["local"],
                                                      served["grid"])
    add(grid_l)
    if not np.array_equal(gc, lc):
        fail("counts served through the meshed plan differ from the "
             "local engine's")
    if grid_l["infer_window_batch_encode"] != grid.size * batches:
        fail(f"meshed serving launched the encode kernel "
             f"{grid_l['infer_window_batch_encode']} times for {batches} "
             f"batches on {grid.size} shards")
    if grid_l["infer_window_batch"] < grid.size * canaries:
        fail(f"meshed canary launched the pre-packed kernel "
             f"{grid_l['infer_window_batch']} times for {canaries} checks")
    for k in MESH_KERNELS:
        if not launches[k]:
            fail(f"the placement part never launched {k}: {launches}")
    print(f"placement: --check equal on the 1-D grid of 8 and the 2-D "
          f"grids 2,4 4,2 8,1 (all shards on {dev}); WENQUXING_22A_MESH2D "
          f"784-40 T 72 on 256 digits, 1 epoch: {stream} stream launches "
          f"(one a shard), {t_mesh} s against {t_local} s local, weights "
          f"and class map equal to the local parallel run; 64 requests "
          f"through the (2, 4) plan in {batches} batches equal to the local "
          f"engine's counts, {grid_l['infer_window_batch_encode']} encode "
          f"launches; mesh_launches {launches}", flush=True)
    return launches


def phase_harness(card: str) -> dict:
    """Phase 11 (b): ``repro_torch.bench.run kernels_bench loadgen_bench``
    in process on the card, gated against ``BENCH_torch.json`` (the
    verdict printed, not required), its deterministic fields held equal
    to the JAX package's ``BENCH_kernels.json``.  Returns the launch
    counts of the run."""
    import shutil
    import tempfile

    from repro_torch.bench import common, kernels_bench, run
    from repro_torch.kernels import ops

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_bench_"))
    out = tmp / "rows.json"
    if TORCH_BENCH.exists():
        shutil.copy(TORCH_BENCH, out)
    common.RECORDS.clear()                  # the paper phase's rows
    ops.reset_launch_counts()
    try:
        rc = run.main(["kernels_bench", "loadgen_bench", "--device", "cuda",
                       f"--json={out}", "--gate"])
        rows = json.loads(out.read_text())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = ops.launch_counts()
    print(f"harness: gate exit {rc} against BENCH_torch.json "
          f"({'committed' if TORCH_BENCH.exists() else 'absent'}; printed, "
          f"not required); card {card}", flush=True)
    for k in HARNESS_KERNELS:
        if not launches[k]:
            fail(f"the harness never launched {k}: {launches}")
    ref = json.loads(JAX_BENCH.read_text())
    missing = sorted(n for n in ref if n.startswith(
        ("kernels/", "serve/", "loadgen/")) and n not in rows)
    if missing:
        fail(f"the harness lacks rows of BENCH_kernels.json: {missing}")
    for name in ref:
        if name.startswith(("kernels/", "serve/")):
            got, want = (kernels_bench.untimed(r[name]) for r in (rows, ref))
            if got != want:
                fail(f"{name}: its untimed fields {got} differ from "
                     f"BENCH_kernels.json's {want}")
    for name in VIRTUAL_ROWS:
        got = {k: v for k, v in rows[name].items() if k != "us_per_call"}
        want = {k: v for k, v in ref[name].items() if k != "us_per_call"}
        if got != want:
            fail(f"{name} differs from BENCH_kernels.json: {got} against "
                 f"{want}")
    print(f"harness: {len(rows) - 1} rows; every untimed field of the "
          f"kernel and serving rows (all but {kernels_bench.TIMED_FIELDS}) "
          f"and the "
          f"virtual-clock rows {list(VIRTUAL_ROWS)} equal to "
          f"BENCH_kernels.json; harness_launches {launches}", flush=True)
    return launches


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

    # phase 2: build (one nvcc per source, all at once)
    t0 = time.perf_counter()
    ops.load_kernels()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for source in ("snn_infer", "snn_train", "snn_step", "flash_attn"):
        log = build.library_path(source).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas {source}: {line.strip()}", flush=True)
    check_sums_build()

    # phase 3: kernels against their plain versions
    rates = Rates.of_card()
    print(f"rates: int32 {rates.int32_per_s:.4g}/s, popc "
          f"{rates.popc_per_s:.4g}/s, hbm {HBM_BYTES_PER_S:.4g} B/s",
          flush=True)
    timings = phase_kernels(rates)
    timings.update(phase_train_kernels(rates))
    timings.update(phase_step_kernels(rates))

    # phase 4: the serving slice
    serve_launches, eng = phase_slice()

    # phase 5: where a serving step's time goes
    phase_trace(eng)

    # phase 6: the training slice, and where its time goes
    train_launches, _ = phase_train()
    from repro_torch.launch.mnist_stdp import preprocessed_digits
    phase_train_trace(*preprocessed_digits(64, seed=3))

    # phase 7: the step slice (one fused step launch per cycle), and the
    # quickstart
    step_launches = phase_step_slice()
    phase_train_trace(*preprocessed_digits(16, seed=3), "step")
    phase_quickstart()

    # phase 8: the serving stack (step plans, faults, refresh, journal,
    # load harness) at the paper's width
    stack_launches = phase_serving_stack()

    # phase 9: the LM slice (flash attention), gemma3-1b at full width
    flash = phase_flash_kernel()
    lm_launches, model = phase_lm_slice()
    phase_lm_correctness(model)
    del model
    torch.cuda.empty_cache()

    # phase 10: the paper's evaluation (Table 1, Fig. 4, Fig. 5, w_exp)
    paper_launches = phase_paper_eval(card)

    # phase 11: placement on a device grid, then the benchmark harness
    t_phase = time.perf_counter()
    mesh_launches = phase_placement()
    harness_launches = phase_harness(card)
    print(f"phase 11: wall {time.perf_counter() - t_phase} s", flush=True)

    # phase 12: the kernels' JSON line, then the last line

    kernels = []
    for kname, source, shape, line, launches in (
            ("infer_window_batch_encode", SOURCE, "paper", 842,
             serve_launches),
            ("infer_window_batch", SOURCE, "canary", 580, serve_launches),
            ("train_window_batch", TRAIN_SOURCE, "train-parallel", 410,
             train_launches),
            ("train_window_batch_encode", TRAIN_SOURCE, "train-parallel",
             747, train_launches),
            ("fused_snn_window", TRAIN_SOURCE, "train-active", 497,
             train_launches),
            ("fused_snn_window_encode", TRAIN_SOURCE, "train-active", 793,
             train_launches)):
        main_t = timings[(kname, shape)]
        entry = {
            "name": kname, "route": "cuda", "source": source,
            "replaces": f"{PALLAS}:{line}",
            "launches": launches[kname],
            "max_abs_err": max(t["max_abs_err"] for (k, _), t in
                               timings.items() if k == kname),
            "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
            "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
            "library_ms": None, "shape": shape,
            "call_ms": main_t["call_ms"],
            # every other shape of phase 3
            **{other: {k: t[k] for k in ("ms", "call_ms", "plain_ms",
                                         "bound_ms", "bound_by")}
               for (k, other), t in timings.items()
               if k == kname and other != shape}}
        if launches is serve_launches:
            entry["train_launches"] = train_launches[kname]
        entry["stack_launches"] = stack_launches[kname]
        entry["paper_launches"] = paper_launches[kname]
        entry["mesh_launches"] = mesh_launches[kname]
        entry["harness_launches"] = harness_launches[kname]
        if kname == "train_window_batch_encode":
            # the trainer's launches are the stream form: its time per
            # launch of 8 samples leads, the one-sample launch beside it
            keys = ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                    "samples", "ms_per_sample", "bound_ms_per_sample")
            stream = {shape: {k: t[k] for k in keys}
                      for (k, shape), t in timings.items()
                      if k == "train_stream_batch_encode"}
            entry["window"] = {k: entry.pop(k) for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "call_ms")}
            entry.update({k: stream[shape][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "call_ms",
                "samples", "ms_per_sample", "bound_ms_per_sample")})
            entry["max_abs_err"] = max(
                [entry["max_abs_err"]] + [t["max_abs_err"] for (k, _), t in
                                          timings.items()
                                          if k == "train_stream_batch_encode"])
            entry["stream"] = {sh: v for sh, v in stream.items()
                               if sh != shape}
        kernels.append(entry)
    for kname, line in zip(STEP_KERNELS, (295, 160, 189, 244)):
        shapes = {shape: t for (k, shape), t in timings.items()
                  if k == kname}
        main_t = shapes["step-parallel"]
        kernels.append({
            "name": kname, "route": "cuda", "source": STEP_SOURCE,
            "replaces": f"{PALLAS}:{line}",
            "launches": step_launches[kname],
            "max_abs_err": max(t["max_abs_err"] for t in shapes.values()),
            "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
            "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
            "library_ms": None, "shape": "step-parallel",
            "call_ms": main_t["call_ms"],
            "stack_launches": stack_launches[kname],
            "mesh_launches": mesh_launches[kname],
            "harness_launches": harness_launches[kname],
            **{k: main_t[k] for k in GRAPH_KEYS if k in main_t},
            **{shape: {k: t[k] for k in ("ms", "call_ms", "plain_ms",
                                         "bound_ms", "bound_by", "ms_cold")
                       + GRAPH_KEYS if k in t}
               for shape, t in shapes.items() if shape != "step-parallel"}})
    main_t = flash["gemma-global-bf16"]
    kernels.append({
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_PALLAS,
        "launches": lm_launches["flash_attention"],
        "stack_launches": stack_launches["flash_attention"],
        "mesh_launches": mesh_launches["flash_attention"],
        "harness_launches": harness_launches["flash_attention"],
        "max_abs_err": max(t["max_abs_err"] for t in flash.values()),
        **{k: main_t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")},
        "shape": "gemma-global-bf16",
        **{shape: t for shape, t in flash.items()
           if shape != "gemma-global-bf16"}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == CPU_REPLAY_FLAG:
        cpu_replays(sys.argv[2])
    elif len(sys.argv) == 4 and sys.argv[1] == PAPER_CPU_FLAG:
        paper_cpu(sys.argv[2], sys.argv[3])
    else:
        main()
