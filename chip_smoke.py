#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card.  Phases:

1. Device: requires a CUDA card; prints the card's name and power limit.
2. Build: compiles the kernel libraries with ``nvcc`` into ``build/``
   (``snn_infer.cu``, ``snn_train.cu``, ``snn_step.cu``, ``flash_attn.cu``
   and ``decode_attn.cu``, one compiler each, at once) and prints their ptxas
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
   window), GQA non-causal (B 2, Hq 8, Hkv 2, D 128, T 512), the
   starcoder2-3b width (Hq 24, Hkv 2, D 128, T 1,024, causal) and the
   LM families' (phase 12): mixtral (Hq 48, Hkv 8, D 128, T 4,608,
   window 4,096), whisper's encoder (Hq = Hkv = 12, D 64, T 1,500,
   non-causal) and cross-attention (Tq 64, Tk 1,500, non-causal, k and
   v views of a projection of their own) and jamba (Hq 64, Hkv 8, D 128,
   T 1,024, causal); in
   bfloat16 also within 1e-2 of the output's largest magnitude and
   ||kernel - plain|| within 1e-2 of ||plain||; q, k and v as views of
   one fused projection give the same output as contiguous ones.  Timed
   beside its bound, its plain version and
   ``scaled_dot_product_attention`` (the yardstick: the port never calls
   it), all three as device time from the profiler (the kernel by its
   own dtype's symbol, the other two every kernel and copy of a call),
   with the achieved TFLOP/s and kernel/bound (the float32 bound: three
   TF32 products at the tensor cores' rate).  Then the decode-attention
   kernel (``decode_attn.cu``; ptxas lines printed) against its plain
   version in float32 (atol = rtol = 1e-4) and bfloat16 (1e-2) at the
   benchmark's cells' shapes (Hq 48, Hkv 8, D 128: 256 slots of 2,600
   with lengths 64-2,560 and the 4,096 window, 64 of 4,096 with lengths
   128-4,096, 4 of 8,192 with lengths 4,096-8,064), timed in bfloat16
   beside its bound (the live k and v, q and the output at 3.35 TB/s),
   its plain version and ``scaled_dot_product_attention`` with the same
   mask (the yardstick), all device time from the profiler.  Then
   gemma3-1b at full width in bfloat16, random weights from a seed,
   served by ``ServingEngine(n_slots=4, max_len=4096)``: 8 greedy
   requests of 37 to 2,048 prompt tokens, 32 new tokens each, with the
   launch counts set to 0 before and read after (flash launches must be
   26 x 8, decode-attention launches 26 a decode step) and every plain
   attention function watched; prints prefill ms by prompt length,
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
12. The LM families, each at full width in bfloat16 (random weights from
   a seed, depth cut and printed, each model freed before the next),
   with the launch counts set to 0 before and read after each counted
   run (flash launches exactly one per attention layer, encoder layer
   and cross-attention of each prefill, decode-attention launches one per
   decoder attention layer and cross-attention of each decode step; every
   plain version watched):
   (a) mixtral-8x22b at 4 layers (all windowed, all MoE) served by
   ``ServingEngine(n_slots=4, max_len=8192)``, 8 greedy requests of 37
   to 4,608 prompt tokens (the last two wrap the 4,096-slot rings), 16
   new tokens each (32 flash launches); prefill ms by prompt length,
   decode step ms, tokens/s, the card's busy share of a traced prefill
   and decode step, and one layer's time split into attention (flash
   inside it) and MoE (expert products against dispatch); then a float32
   copy (TF32 off): a 1,000-token prefill through the kernel and through
   the plain attention within 1e-3 of the logits' largest magnitude with
   the same greedy token (tokens routed to another expert set printed),
   and 8 teacher-forced decode steps after a 4,200-token prefill against
   the prefill of the prompt plus the tokens so far, within 1e-3.  (b)
   grok-1-314b at 2 layers, 2 requests through the engine; (c)
   jamba-1.5-large-398b at 5 layers (Mamba at 0-3, attention at 4, MoE
   at 1 and 3), 4 requests of up to 1,024 prompt tokens; (d) rwkv6-7b at
   full depth, 4 requests of up to 512 (the blocked prefill where 64
   divides the prompt), then at 2 layers the per-token recurrence
   (``rwkv_chunk`` 0): a prefill of 32,768 tokens at B 1 and one
   training step (loss and backward) at B 1, T 2,048, each with its wall
   time and peak memory allocated, held against the same run in the
   chunk-64 form (last-token logits within 2^-5 of their largest
   magnitude, layer 0's final state within 1e-3, each gradient within
   2^-5 in norm); (e) whisper-small at full depth, one batch of
   1,500 frames, a prefill and 16 decode steps through ``Model`` (36
   flash launches), its cross-attention k and v checked against TMA's
   alignment rule; (f) internvl2-26b at 2 layers, 256 patches before a
   64-token prompt, a prefill and 16 decode steps.  For (c)-(f) the
   prefill through the kernel and through the plain attention give the
   same greedy token.  Prints the phase's wall time.
13. LM training, with the launch counts set to 0 before and read after
   each counted run (flash launches must be 0 in every training run):
   (a) gemma3-1b at full width and depth (26 layers, d 1,152, vocab
   262,144, the 512 window on five of every six layers), params in bf16
   and AdamW states in float32, B 4, T 1,024, ``loss_chunk`` 256, remat
   on, ``SyntheticTokens(seed=0)`` through ``ShardedLoader``, 8 steps
   through ``TrainLoop`` with a checkpoint every 4 (under ``build/``,
   removed after), under deterministic algorithms: ms per step, tokens/s,
   model FLOP/s as 6 N tokens / step beside the dense bf16 peak, peak
   memory allocated, one step's forward / backward / optimizer split and
   the card's busy share of a traced step printed; the loss finite and
   falling; (b) the same 8 steps from the same weights with a
   ``SimulatedFailure`` at the start of step 6: one restart, final params
   and AdamW state bit-equal to (a)'s; (c) the trained weights' 1,000-token
   prefill through the flash kernel (26 launches) and through the plain
   attention: the same greedy token; (d) each of the ten LM configs
   ``reduced()`` in float32, TF32 off: three steps on the card and on the
   CPU from the same weights, losses within 1e-4 relative; (e)
   ``flash_attention`` with a grad-requiring q under grad mode raises,
   launching nothing.  Prints the phase's wall time.
14. The LM's distribution side and the dry run: (d) first, on the host,
   ``launch.dryrun`` of gemma3-1b ``train_4k`` on the pod (32 x 8) and
   the multi-pod (2 x 32 x 8) mesh, each in a fake process group of
   256 / 512 ranks (wall time, per-device bytes traced and estimated,
   ``fits_80GB`` and the roofline's dominant term printed; it must fit),
   and of phase 13's shape on a (1, 1) mesh; (a) a process group of one
   rank over NCCL on ``cuda:0`` and a (data 1, model 1) ``DeviceMesh``:
   gemma3-1b at full width in bf16, its params placed by
   ``to_shardings`` under ``use_mesh``, a 1,000-token prefill through
   ``make_prefill_step`` (26 flash launches) and 16 decode steps through
   ``make_serve_step``, each call's logits held against the unsharded
   port's same call from the same weights (``torch.equal`` printed; where
   they differ, the gap and the first layer it shows in; the greedy
   tokens must be equal), then 4 ``make_train_step`` steps at phase 13's
   shape under deterministic algorithms, params and AdamW states
   bit-equal to the unsharded steps, the sharded run's peak memory
   printed beside the dry run's for the same config; then mixtral-8x22b
   (1 layer: attention + MoE) and jamba-1.5-large (2 layers: Mamba +
   MLP, attention + MoE) at full width in bf16, their experts' ``d_ff``
   and Mamba channels on the model axis (``sharding.TensorParallel``),
   each served (a 256-token prefill of 2 sequences and 4 decode steps:
   logits and every cache leaf ``torch.equal``, one flash launch a
   prefill) and trained one step (mixtral's layer, jamba's first; loss
   and params ``torch.equal``) against the unsharded port; a line says
   that a multi-rank run needs the four-card machine; (b) ``pipelined_apply``
   over ``["cuda:0", "cuda:0"]``: gemma3-1b's 26 layers as 2 stages of
   13, 4 microbatches of a B 8, T 512 bf16 prefill forward (104 flash
   launches), ``torch.equal`` to the layers applied in sequence, wall
   times of both; (c) ``launch.dryrun_snn``'s shards of the (32, 8) mesh
   on the card (infer: 512 neurons x 128 samples, T 72, 784 inputs,
   through the pre-packed serving kernel; train: 512 neurons, 8 samples,
   one training window launch a sample), each equal to its plain version
   and timed against its bound; the launches of (a)-(c)
   (``distributed_launches`` in the kernels' JSON).  Prints the phase's
   wall time.
15. Prints the kernels' JSON line, then, last,
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

# phase 13 holds a training run's recovery bit for bit under
# deterministic algorithms, which need cuBLAS's workspace fixed before
# its first call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

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


def first_session(run, read, activities):
    """``read(prof, ran)`` of the first of up to ``PROFILER_TRIES`` fresh
    profiler sessions, each around one call of ``run`` (``ran`` what it
    returned), that gives something other than None; None where none
    does."""
    from torch.profiler import profile

    for attempt in range(PROFILER_TRIES):
        if attempt:
            time.sleep(0.5)
        with profile(activities=activities) as prof:
            ran = run()
        got = read(prof, ran)
        if got is not None:
            return got
    return None


def profiled_ms(fn, reps: int, what: str, read, cpu: bool = False
                ) -> float:
    """``read(prof)`` of the first profiler session over ``reps`` calls
    of ``fn`` (after one warm-up call) that gives a time, in up to
    ``PROFILER_TRIES`` fresh sessions; where none does, the time of one
    call from CUDA events around ``reps`` calls back to back (host
    dispatch gaps included), said so on a line of its own.  ``cpu``
    records the host's operations too."""
    from torch.profiler import ProfilerActivity

    def run():
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                            if cpu else [])
    ms = first_session(run, lambda prof, _: read(prof), activities)
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
    block runs: those of ``repro_torch.kernels.ref``, the flash and decode
    kernels' (``flash_attention_ref``, ``decode_attention_ref``) and the
    prefill's plain attention (``attention.chunked_attention``)."""
    from repro_torch.kernels import decode_attention, flash_attention, ref
    from repro_torch.models.layers import attention

    calls = collections.Counter()
    saved = [(mod, name, fn)
             for mod in (ref, flash_attention, decode_attention)
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
# (name, B, Hq, Hkv, D, Tq, Tk, causal, window)
FLASH_SHAPES = (
    ("gemma-global", 1, 4, 1, 256, 2048, 2048, True, None),
    ("gemma-local", 1, 4, 1, 256, 2048, 2048, True, 512),
    ("ragged-37", 1, 4, 1, 256, 37, 37, True, 512),
    ("ragged-1000", 1, 4, 1, 256, 1000, 1000, True, 512),
    ("gqa-noncausal", 2, 8, 2, 128, 512, 512, False, None),
    ("starcoder2-3b", 1, 24, 2, 128, 1024, 1024, True, None),
    # the LM families' (phase 12): mixtral's window at 48/8 heads over
    # the longest prompt, grok-1's longest prompt, whisper's encoder, its
    # cross-attention (a 64-token prompt over the 1,500 frames) and its
    # decoder's self-attention, jamba's attention layer, internvl2's 256
    # patches before a 64-token prompt
    ("mixtral", 1, 48, 8, 128, 4608, 4608, True, 4096),
    ("grok-1", 1, 48, 8, 128, 1500, 1500, True, None),
    ("whisper-encoder", 1, 12, 12, 64, 1500, 1500, False, None),
    ("whisper-cross", 1, 12, 12, 64, 64, 1500, False, None),
    ("whisper-decoder", 1, 12, 12, 64, 64, 64, True, None),
    ("jamba", 1, 64, 8, 128, 1024, 1024, True, None),
    ("internvl2", 1, 48, 8, 128, 320, 320, True, None),
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


def flash_flops(b, hq, d, tq, tk, causal, window) -> int:
    """4 B Hq D flops per unmasked (query, key) pair: both products."""
    return 4 * b * hq * d * unmasked_pairs(tq, tk, causal, window)


def flash_bound(b, hq, hkv, d, tq, tk, causal, window, dtype
                ) -> tuple[float, str]:
    """Least time (s) of one call: the flops at the card's peak for the
    dtype, against q, k, v and o crossing HBM once."""
    flops = flash_flops(b, hq, d, tq, tk, causal, window)
    rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
    moved = (torch.finfo(dtype).bits // 8) * d * (2 * b * hq * tq
                                                 + 2 * b * hkv * tk)
    t_ops, t_bytes = flops / rate, moved / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sdpa_call(q, k, v, causal: bool, window):
    """One ``scaled_dot_product_attention`` call computing the kernel's
    function (queries the last Tq of the Tk positions): the library
    yardstick."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    tq, tk = q.shape[2], k.shape[2]
    if window is None and (tq == tk or not causal):
        return lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True)
    pos = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
    kpos = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if window is not None:
        mask &= kpos > pos - window
    if causal:
        mask &= kpos <= pos
    return lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True)


def fused_views(q, k, v):
    """q, k, v copied into the [B, T, (Hq + 2 Hkv) D] projections the
    model's attention takes them from (``models/layers/attention.py``),
    and taken back as the transposed views they give: one projection
    for self-attention; for cross-attention (Tq != Tk) q from the
    decoder stream's and k, v from the encoder output's."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]

    def rows(x):
        return x.transpose(1, 2).reshape(b, x.shape[2], -1)

    if tq == tk:
        qkv_q = qkv_kv = torch.cat([rows(q), rows(k), rows(v)], dim=-1)
    else:
        qkv_q = torch.cat([rows(q), q.new_zeros((b, tq, 2 * hkv * d))],
                          dim=-1)
        qkv_kv = torch.cat([k.new_zeros((b, tk, hq * d)), rows(k), rows(v)],
                           dim=-1)
    split = [hq * d, hkv * d, hkv * d]
    q2 = qkv_q.split(split, dim=-1)[0]
    _, k2, v2 = qkv_kv.split(split, dim=-1)
    return (q2.reshape(b, tq, hq, d).transpose(1, 2),
            k2.reshape(b, tk, hkv, d).transpose(1, 2),
            v2.reshape(b, tk, hkv, d).transpose(1, 2))


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


def flash_held(what: str, got, want, tol: float):
    """Holds the flash kernel's output ``got`` against the plain
    version's ``want`` within atol = rtol = ``tol`` and, in bf16, within
    ``FLASH_BF16_REL`` of the output's largest magnitude and
    ``FLASH_BF16_NORM``; fails where it is not.  Returns (max |kernel -
    plain|, largest |plain|, ||kernel - plain|| / ||plain||)."""
    bf16 = got.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    top = float(want.abs().max())
    norm = float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))
    if not torch.allclose(got, want, atol=tol, rtol=tol):
        fail(f"flash_attention at {what}: max |kernel - plain| {err} "
             f"exceeds atol = rtol = {tol}")
    if bf16 and err > FLASH_BF16_REL * top:
        fail(f"flash_attention at {what}: max |kernel - plain| {err} "
             f"exceeds {FLASH_BF16_REL} of the output's largest magnitude "
             f"{top}")
    if bf16 and norm > FLASH_BF16_NORM:
        fail(f"flash_attention at {what}: ||kernel - plain|| / ||plain|| = "
             f"{norm} exceeds {FLASH_BF16_NORM}")
    return err, top, norm


def phase_flash_kernel() -> dict:
    """Phase 9a: the bf16 kernel's build checked, then the flash kernels
    against their plain version on the card at each shape in both dtypes,
    then timed (each dtype by its own kernel's profiler records) beside
    the bound, the plain version and SDPA."""
    from repro_torch.kernels.flash_attention import flash_attention

    check_flash_build()
    dev = torch.device("cuda")
    out = {}
    for name, b, hq, hkv, d, tq, tk, causal, window in FLASH_SHAPES:
        rng = np.random.default_rng(tk + d)
        base = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                .to(dev) for s in ((b, hq, tq, d), (b, hkv, tk, d),
                                   (b, hkv, tk, d))]
        for dtype, dname, tol, symbol in FLASH_DTYPES:
            q, k, v = (x.to(dtype) for x in base)
            kw = dict(causal=causal, window=window)
            got = flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            want = flash_attention(q, k, v, backend="ref", **kw)
            err, top, norm = flash_held(f"{name} {dname}", got, want, tol)
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
            b_s, b_by = flash_bound(b, hq, hkv, d, tq, tk, causal, window,
                                    dtype)
            shape = (f"B={b} Hq={hq} Hkv={hkv} D={d} Tq={tq} Tk={tk} "
                     f"causal={causal} window={window} {dname}")
            print(f"kernel flash_attention @ {name} ({shape}): within "
                  f"{tol} max_abs_err={err} (largest |plain| {top}; "
                  f"||kernel - plain|| / ||plain|| {norm}; views of a fused "
                  f"projection equal) "
                  f"ms={ms} plain_ms={plain_ms} ({plain_call_ms} a call "
                  f"with its host dispatch) library_ms={library_ms} "
                  f"({library_call_ms} a call; sdpa, max |sdpa - plain| "
                  f"{lib_err}) bound_ms={1e3 * b_s} ({b_by}); {symbol} "
                  f"{flash_flops(b, hq, d, tq, tk, causal, window) / ms / 1e9}"
                  f" "
                  f"TFLOP/s, kernel/bound {ms / (1e3 * b_s)}, kernel/sdpa "
                  f"{ms / library_ms}", flush=True)
            out[f"{name}-{dname}"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=1e3 * b_s, bound_by=b_by, library_ms=library_ms)
    return out


DECODE_SOURCE = "src/repro_torch/kernels/csrc/decode_attn.cu"
# (name, B, Hq, Hkv, D, S, lengths' range, window) at the benchmark's
# cells: mixtral-longgen's 256 slots of 2,600 (prompts 64-512, outputs
# 512-2,048: lengths 64-2,560; the 4,096 window past them), mixtral-chat's
# 64-slot ring of 4,096 (some slots full), grok1-longdoc's 4 slots of
# 8,192 (prompts 4,096-8,064: the split path)
DECODE_SHAPES = (
    ("longgen", 256, 48, 8, 128, 2600, (64, 2560), 4096),
    ("chat", 64, 48, 8, 128, 4096, (128, 4096), None),
    ("longdoc", 4, 48, 8, 128, 8192, (4096, 8064), None),
)
# atol = rtol against the plain version: float32 as the flash kernel's;
# bf16 one ulp of one rounding of a float32 result (2**-7 of the value)
DECODE_DTYPES = ((torch.float32, "f32", 1e-4), (torch.bfloat16, "bf16", 1e-2))


def decode_live_bytes(lens, window, b, hq, hkv, d, s, elem) -> int:
    """Bytes the decode kernel must move: each row's live k and v (as the
    plain version masks them), q read and the output written once."""
    n = np.broadcast_to(np.asarray(lens, np.int64), (b,))
    lo = np.maximum(n - window, 0) if window else np.zeros(b, np.int64)
    live = int(np.maximum(np.minimum(n, s) - lo, 0).sum())
    return elem * d * (2 * hkv * live + 2 * b * hq)


def phase_decode_kernel() -> dict:
    """Phase 9d: the decode-attention kernel's build (ptxas lines), then
    the kernel against its plain version at the benchmark's three cells'
    shapes in both dtypes, and timed in bf16 (the served dtype) beside its
    live-bytes bound, the plain version and SDPA (the yardstick)."""
    from repro_torch.kernels.decode_attention import decode_attention

    for fn, line in ptxas_report("decode_attn").items():
        print(f"ptxas {fn}: {line}", flush=True)
    dev = torch.device("cuda")
    out = {}
    for name, b, hq, hkv, d, s, (n0, n1), window in DECODE_SHAPES:
        rng = np.random.default_rng(s + b)
        lens_np = rng.integers(n0, n1 + 1, b)
        lens = torch.from_numpy(lens_np).to(dev)
        base = [torch.from_numpy(rng.standard_normal(sz, dtype=np.float32))
                .to(dev) for sz in ((b, hq, 1, d), (b, hkv, s, d),
                                    (b, hkv, s, d))]
        for dtype, dname, tol in DECODE_DTYPES:
            q, k, v = (x.to(dtype) for x in base)
            kw = dict(window=window)
            got = decode_attention(q, k, v, lens, **kw)
            torch.cuda.synchronize()
            want = decode_attention(q, k, v, lens, backend="ref", **kw)
            err = float((got.float() - want.float()).abs().max())
            if not torch.allclose(got.float(), want.float(), atol=tol,
                                  rtol=tol):
                fail(f"decode_attention at {name} {dname}: max |kernel - "
                     f"plain| {err} exceeds atol = rtol = {tol}")
            del want
            if dtype != torch.bfloat16:
                print(f"kernel decode_attention @ {name} {dname}: within "
                      f"{tol} max_abs_err={err}", flush=True)
                continue
            mask = (torch.arange(s, device=dev)[None, :] < lens[:, None])
            if window:
                mask &= torch.arange(s, device=dev)[None, :] \
                    > lens[:, None] - 1 - window
            mask = mask[:, None, None, :]
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib = functools.partial(sdpa, q, k, v, attn_mask=mask,
                                    enable_gqa=True)
            lib_err = float((lib().float() - got.float()).abs().max())
            ms = kernel_ms(lambda: decode_attention(q, k, v, lens, **kw),
                           "decode_attn", 20)
            plain = functools.partial(decode_attention, q, k, v, lens,
                                      backend="ref", **kw)
            plain_ms = call_device_ms(plain, 5, f"the plain decode_attention "
                                      f"at {name}")
            library_ms = call_device_ms(lib, 20, f"sdpa at {name}")
            moved = decode_live_bytes(lens_np, window, b, hq, hkv, d, s, 2)
            bound_ms = 1e3 * moved / HBM_BYTES_PER_S
            shape = (f"B={b} Hq={hq} Hkv={hkv} D={d} S={s} lengths "
                     f"{n0}-{n1} (mean {lens_np.mean()}) window={window} "
                     f"{dname}")
            print(f"kernel decode_attention @ {name} ({shape}): within {tol} "
                  f"max_abs_err={err} ms={ms} bound_ms={bound_ms} (bytes: "
                  f"{moved} live k, v, q and out at 3.35 TB/s) "
                  f"bound/kernel {bound_ms / ms} plain_ms={plain_ms} "
                  f"library_ms={library_ms} (sdpa with a mask, max |sdpa - "
                  f"kernel| {lib_err}), kernel/sdpa {ms / library_ms}",
                  flush=True)
            out[name] = dict(max_abs_err=err, ms=ms, bound_ms=bound_ms,
                             bound_by="bytes", plain_ms=plain_ms,
                             library_ms=library_ms)
        del base, q, k, v
        torch.cuda.empty_cache()
    return out


def busy_share(fn) -> tuple[float, float, str]:
    """(wall us, card busy share, heaviest device work) of one call of
    ``fn`` under ``torch.profiler``, in the first session that records
    device time (``first_session``; none does: the wall and the share
    are nan, and the work says so)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    def run():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e6 * (time.perf_counter() - t0)

    def read(prof, wall_us):
        # a ``record_function`` range shows as device time spanning its
        # kernels: left out, so nothing is counted twice
        devs = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]
        dev_us = sum(e.self_device_time_total for e in devs)
        if dev_us <= 0:
            return None
        top = "; ".join(
            f"{e.key[:90]} {e.count}x {e.self_device_time_total} us"
            for e in sorted(devs, key=lambda e:
                            -e.self_device_time_total)[:5])
        return wall_us, dev_us / wall_us, top

    torch.cuda.synchronize()
    got = first_session(run, read, [ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
    return got or (float("nan"), float("nan"),
                   f"the profiler recorded no device time in "
                   f"{PROFILER_TRIES} sessions")


def serve_counted(model, eng, reqs):
    """Serve ``reqs`` on ``eng`` with the launch counts set to 0 just
    before and read just after, every plain version watched (any call
    fails), each prefill and decode step timed on the host's clock
    around work that ends in a synchronize.  Returns (launches, wall s,
    prefill ms by prompt length, decode step ms)."""
    from repro_torch.kernels import ops

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
    try:
        ops.reset_launch_counts()
        with counting_plain_versions() as plain:
            t0 = time.perf_counter()
            eng.run(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = ops.launch_counts()
    finally:
        del model.prefill, model.decode_step
    if sum(plain.values()):
        fail(f"serving {model.cfg.name} reached plain versions: "
             f"{dict(plain)}")
    return launches, wall, prefill_ms, decode_ms


def phase_lm_slice():
    """Phase 9b: gemma3-1b at full width in bfloat16 served on the card,
    the launch counts set to 0 before and read after, every plain
    attention function watched.  Returns (launches, model)."""
    from repro_torch.configs.base import get_config
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
    launches, wall, prefill_ms, decode_ms = serve_counted(model, eng, reqs)
    for r in reqs:
        if not (r.done and len(r.output) == LM_NEW_TOKENS
                and all(0 <= x < cfg.vocab_size for x in r.output)):
            fail(f"request {r.rid} ({len(r.prompt)} prompt tokens) ended "
                 f"done={r.done} with {len(r.output)} tokens")
    want = {k: 0 for k in launches}
    want["flash_attention"] = cfg.n_layers * len(reqs)
    want["decode_attention"] = decode_layers(model) * len(decode_ms)
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


def bf16_logits_held(what: str, kern16, plain16, plain32) -> None:
    """A bf16 prefill's logits through the kernel (``kern16``) against
    the plain attention's (``plain16``): the same greedy token, and
    within twice what bf16 itself moves the logits (``plain16`` against
    a float32 copy's plain prefill, ``plain32``), both of the largest
    |f32 logit|.  Printed; fails where it does not hold."""
    def dist(a, b) -> float:
        return float((a - b).abs().max() / plain32.abs().max())

    # bf16's own reach is how far the plain bf16 prefill lies from the
    # f32 one.  A kernel whose bf16 prefill lies no farther from the f32
    # one is within twice that of the plain bf16 prefill (the triangle
    # inequality): that is the limit.
    err16, bf16_err = dist(kern16, plain16), dist(plain16, plain32)
    same16 = int(kern16.argmax()) == int(plain16.argmax())
    top2 = plain16[0].topk(2).values
    print(f"{what}: max |diff| / max |f32 logit| = {err16} (limit twice "
          f"the plain bf16 prefill's from the f32 one, {bf16_err}; the "
          f"kernel's from the f32 one {dist(kern16, plain32)}), greedy "
          f"token equal: {same16} (plain's top two logits "
          f"{top2.tolist()})", flush=True)
    if err16 > 2 * bf16_err or not same16:
        fail(f"{what}: the bf16 prefill through the kernel differs from "
             f"the plain attention's by more than bf16's own rounding "
             f"allows")


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

        bf16_logits_held("lm check: bf16 prefill of 1000 tokens, kernel vs "
                         "plain attention", kern16, plain16, plain)
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


# --- the LM families: MoE, Mamba hybrid, RWKV6, enc-dec, vision prefix -----

# (a) mixtral-8x22b's prompts (the longest two wrap the 4,096-slot ring of
# every layer) and new tokens a request
FAMILY_PROMPTS = (37, 512, 1000, 2048, 3000, 4095, 4097, 4608)
FAMILY_NEW_TOKENS = 16
# (a)'s float32 checks: the kernel-vs-plain prefill's prompt, and the
# prompt teacher-forced decode starts from
FAMILY_CHECK_PROMPT = 1000
FAMILY_DECODE_PROMPT = 4200


def family_model(arch: str, n_layers=None, **kw):
    """``arch`` at full width in bfloat16 on the card, random weights from
    seed 0, its depth cut to ``n_layers`` (None: full depth); prints
    the cut and the layer mix."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import Model

    full = get_config(arch)
    cfg = (full if n_layers is None
           else dataclasses.replace(full, n_layers=n_layers))
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", seed=0, **kw)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    mix = collections.Counter(f"{k.mixer}/{k.ffn}" for k in model.kinds)
    enc = f" + {cfg.encoder_layers} encoder" if cfg.is_enc_dec else ""
    print(f"lm families: {cfg.name} at full width (d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, d_ff "
          f"{cfg.d_ff}, {cfg.n_experts} experts top {cfg.top_k}, window "
          f"{cfg.window}, vocab {cfg.vocab_size}); depth {cfg.n_layers}"
          f"{enc} layers (the config has {full.n_layers}{enc}): layers "
          f"{dict(mix)}; {n_params} parameters, {gb} GB in {model.dtype}, "
          f"drawn in {time.perf_counter() - t0} s", flush=True)
    return model


def flash_layers(model) -> int:
    """Flash launches one prefill makes: one per attention layer, encoder
    layer and cross-attention."""
    kinds = model.kinds + model.enc_kinds
    return (sum(k.mixer.startswith("attn") for k in kinds)
            + sum(k.cross_attn for k in kinds))


def decode_layers(model) -> int:
    """Decode-attention launches one decode step makes: one per decoder
    attention layer and cross-attention."""
    return (sum(k.mixer.startswith("attn") for k in model.kinds)
            + sum(k.cross_attn for k in model.kinds))


@contextlib.contextmanager
def recording_routes():
    """Records the experts (int[N, k]) of every MoE routing made while
    the block runs, in order."""
    from repro_torch.models.layers import moe

    routes = []
    route = moe.route

    def recorded(params, xf, cfg):
        out = route(params, xf, cfg)
        routes.append(out[2])
        return out

    moe.route = recorded
    try:
        yield routes
    finally:
        moe.route = route


def route_flips(a: list, b: list) -> int:
    """Tokens whose set of experts differs between two runs' routings."""
    return sum(int((x.sort(dim=-1).values != y.sort(dim=-1).values)
                   .any(dim=-1).sum()) for x, y in zip(a, b))


def route_drops(model, routes: list) -> int:
    """(token, slot)s past their expert's capacity over ``routes``."""
    from repro_torch.models.layers import moe

    mcfg = model.moe_cfg()
    return sum(int((moe.slots(idx, mcfg.n_experts)[1]
                    >= moe.capacity(idx.shape[0], mcfg)).sum())
               for idx in routes)


def check_tokens(what: str, logits, tokens, vocab: int) -> None:
    if not (torch.isfinite(logits).all() and
            all(0 <= t < vocab for t in tokens)):
        fail(f"{what}: non-finite logits or tokens outside the vocabulary")


@contextlib.contextmanager
def recording_flash():
    """Records (q, k, v, keywords, output) of every flash launch the
    model's attention makes while the block runs, in order."""
    from repro_torch.models.layers import attention

    launches = []
    flash = attention.flash_attention

    def recorded(q, k, v, **kw):
        out = flash(q, k, v, **kw)
        launches.append((q, k, v, kw, out))
        return out

    attention.flash_attention = recorded
    try:
        yield launches
    finally:
        attention.flash_attention = flash


def hold_prefill(model, prompt, max_len: int, f32: bool, **front) -> None:
    """The model's bf16 prefill through the kernel against the plain
    attention's.  Each flash launch of the kernel's prefill is held
    against the plain version on its own inputs (``flash_held``, phase
    9a's bf16 limits).  The last-token logits: with no launch, equal;
    where a float32 copy fits beside the model (``f32``), phase 9c's
    rule (``bf16_logits_held``), and the copy's prefill through the
    kernel against its plain attention's within ``LM_TOL``; else the
    same greedy token.  MoE route differences between runs printed."""
    from repro_torch.kernels.flash_attention import flash_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, vocab = model.cfg.name, model.cfg.vocab_size   # padding cut off
    what = (f"lm families: {name} bf16 prefill of {prompt.shape[1]} "
            f"tokens, kernel vs plain attention")
    tol = {dname: t for _, dname, t, _ in FLASH_DTYPES}["bf16"]
    with torch.inference_mode():
        with recording_routes() as routes, recording_flash() as launches:
            kern = model.prefill(prompt, max_len, **front)[0][:, :vocab]
            n_kern = len(routes)
            model.attn_backend = "ref"
            try:
                plain = model.prefill(prompt, max_len, **front)[0][:, :vocab]
            finally:
                model.attn_backend = "kernel"
        held = [flash_held(f"{name}'s launch {i} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {kw})", out,
                           flash_attention(q, k, v, backend="ref", **kw), tol)
                for i, (q, k, v, kw, out) in enumerate(launches)]
        n_launches = len(launches)
        del launches
        print(f"{what}: each of its {n_launches} flash launches held "
              f"against the plain version on its own inputs within {tol}, "
              f"{FLASH_BF16_REL} of the largest |plain| and "
              f"{FLASH_BF16_NORM} in norm: max |kernel - plain| per launch "
              f"{[e for e, _, _ in held]}, largest ||kernel - plain|| / "
              f"||plain|| {max((n for _, _, n in held), default=0.0)}; "
              f"tokens routed to another expert set "
              f"{route_flips(routes[:n_kern], routes[n_kern:])} of "
              f"{sum(int(r.shape[0]) for r in routes[:n_kern])}", flush=True)
        kern, plain = kern.float(), plain.float()
        if not n_launches:
            same = torch.equal(kern, plain)
            print(f"{what}: no flash launch, logits equal: {same}",
                  flush=True)
            if not same:
                fail(f"{name}: a prefill without attention gives other "
                     f"logits through the kernel than the plain path")
        elif f32:
            m32 = model.cast(torch.float32)
            with recording_routes() as routes:
                kern32 = m32.prefill(prompt, max_len, **front)[0][:, :vocab]
                n_kern = len(routes)
                m32.attn_backend = "ref"
                plain32 = m32.prefill(prompt, max_len, **front
                                      )[0][:, :vocab]
            del m32
            torch.cuda.empty_cache()
            bf16_logits_held(what, kern, plain, plain32)
            # a route that flips between bf16 and f32 moves the logits far
            # more than rounding does (MoE), so the f32 copy's own kernel
            # against its plain attention is held too, as mixtral's is
            err = rel_err(kern32, plain32)
            same = int(kern32.argmax()) == int(plain32.argmax())
            print(f"lm families: {name} f32 prefill of {prompt.shape[1]} "
                  f"tokens, kernel vs plain attention: max |diff| / max "
                  f"|logit| = {err}, greedy token equal: {same}; tokens "
                  f"routed to another expert set "
                  f"{route_flips(routes[:n_kern], routes[n_kern:])}",
                  flush=True)
            if err > LM_TOL or not same:
                fail(f"{name}'s f32 prefill through the kernel differs from "
                     f"the plain attention's")
        else:
            same = int(kern.argmax()) == int(plain.argmax())
            print(f"{what}: greedy token equal: {same}; max |diff| / max "
                  f"|logit| {rel_err(kern, plain)}; plain's top two logits "
                  f"{plain[0].topk(2).values.tolist()}", flush=True)
            if not same:
                fail(f"{name}: the prefill through the kernel gives another "
                     f"greedy token than the plain attention's")


def serve_family(model, lengths, new_tokens: int, n_slots: int,
                 max_len: int, seed: int) -> dict:
    """Greedy requests of ``lengths`` prompt tokens through
    ``ServingEngine``, counted (``serve_counted``); flash launches must
    be ``flash_layers`` a prefill.  Returns (launches, the engine)."""
    from repro_torch.serving import Request, ServingEngine

    cfg = model.cfg
    # warm-up outside the counted run (cuBLAS handles, allocator)
    ServingEngine(model, n_slots=n_slots, max_len=max_len).run(
        [Request(rid=-1, prompt=[1, 2, 3, 4, 5], max_new_tokens=2)])
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                    .tolist(), max_new_tokens=new_tokens)
            for i, n in enumerate(lengths)]
    eng = ServingEngine(model, n_slots=n_slots, max_len=max_len)
    with recording_routes() as routes:
        launches, wall, prefill_ms, decode_ms = serve_counted(model, eng,
                                                              reqs)
    for r in reqs:
        if not (r.done and len(r.output) == new_tokens
                and all(0 <= x < cfg.vocab_size for x in r.output)):
            fail(f"{cfg.name}: request {r.rid} ({len(r.prompt)} prompt "
                 f"tokens) ended done={r.done} with {len(r.output)} tokens")
    want = {k: 0 for k in launches}
    want["flash_attention"] = flash_layers(model) * len(reqs)
    want["decode_attention"] = decode_layers(model) * len(decode_ms)
    if launches != want:
        fail(f"{cfg.name} served with launches {launches}, expected {want}")
    drops = route_drops(model, routes) if cfg.n_experts else 0
    print(f"lm families: {cfg.name} served {len(reqs)} requests x "
          f"{new_tokens} tokens ({n_slots} slots) in {wall} s = "
          f"{eng.tokens_out / wall} tokens/s ({eng.steps} engine steps); "
          f"flash_attention launches {launches['flash_attention']} = "
          f"{flash_layers(model)} x {len(reqs)} prefills; plain attention "
          f"reached: 0; MoE (token, slot)s dropped past capacity: {drops}",
          flush=True)
    print(f"lm families: {cfg.name} prefill ms by prompt length: "
          + "; ".join(f"{n} {prefill_ms[n]}" for n in lengths), flush=True)
    print(f"lm families: {cfg.name} decode step ms ({n_slots} slots): "
          f"{step_summary(decode_ms)}", flush=True)
    return launches, eng


def drive_family(model, prompt, steps: int, max_len: int, **front):
    """A prefill and ``steps`` greedy decode steps through ``Model``,
    counted as ``serve_counted`` counts; flash launches must be
    ``flash_layers``.  Returns (launches, the prefill's cache)."""
    from repro_torch.kernels import ops

    cfg = model.cfg
    decode_ms = []
    with torch.inference_mode():
        model.prefill(prompt, max_len, **front)          # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with counting_plain_versions() as plain:
            t0 = time.perf_counter()
            logits, cache, clen = model.prefill(prompt, max_len, **front)
            torch.cuda.synchronize()
            prefill_ms = 1e3 * (time.perf_counter() - t0)
            enc_out = cache.get("enc_out")
            out = [int(logits.argmax())]
            for _ in range(steps):
                t0 = time.perf_counter()
                logits, cache = model.decode_step(
                    torch.tensor([[out[-1]]], device=prompt.device), cache,
                    clen)
                clen += 1
                out.append(int(logits.argmax()))
                decode_ms.append(1e3 * (time.perf_counter() - t0))
        launches = ops.launch_counts()
    if sum(plain.values()):
        fail(f"{cfg.name} reached plain versions: {dict(plain)}")
    check_tokens(cfg.name, logits, out, cfg.vocab_size)
    want = {k: 0 for k in launches}
    want["flash_attention"] = flash_layers(model)
    want["decode_attention"] = decode_layers(model) * steps
    if launches != want:
        fail(f"{cfg.name} launched {launches}, expected {want}")
    print(f"lm families: {cfg.name} prefill of {clen - steps} positions "
          f"{prefill_ms} ms, then {steps} decode steps (ms): "
          f"{step_summary(decode_ms)}; flash_attention launches "
          f"{launches['flash_attention']}; plain attention reached: 0; "
          f"tokens {out}", flush=True)
    return launches, enc_out


def mixtral_breakdown(model, eng) -> None:
    """Where one mixtral layer's prefill (the longest prompt) and decode
    step (4 slots) spend their time: the flash kernel inside the
    attention layer, and the MoE's expert products (``moe.experts``, the
    function ``moe.forward`` calls) against its dispatch (route, places, scatter, gather,
    combine: the rest of its time).  CUDA events around calls back to
    back (host dispatch gaps included)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.layers import attention as attn
    from repro_torch.models.layers import moe

    block = model.layers[0]
    cfg, mcfg, acfg = model.cfg, model.moe_cfg(), model.attn_cfg(
        model.layers[0].kind)
    t = FAMILY_PROMPTS[-1]
    rng = np.random.default_rng(24)
    dev = model.device
    with torch.inference_mode():
        x = model._embed(torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                       (1, t))).to(dev))
        pos = torch.arange(t, device=dev)
        layer_ms = events_ms(lambda: model._apply_sublayer(
            block, x, positions=pos, cache_max_len=8192), 3)
        h = model._norm_apply(block.ln1, x)
        attn_ms = events_ms(lambda: attn.forward(block.mixer, h, acfg,
                                                 positions=pos), 5)
        q, k, v = attn._split_qkv(block.mixer, h, acfg)
        flash_ms = events_ms(lambda: flash_attention(
            q, k, v, window=acfg.window), 5)
        h2 = model._norm_apply(block.ln2, x)
        moe_ms = events_ms(lambda: moe.forward(block.ffn, h2, mcfg), 5)

        buf = torch.randn((mcfg.n_experts, moe.capacity(t, mcfg),
                           cfg.d_model), device=dev, dtype=model.dtype)
        experts_ms = events_ms(lambda: moe.experts(block.ffn, buf), 5)
        hd = h2[:, -4:].reshape(4, 1, cfg.d_model)
        moe_dec_ms = events_ms(lambda: moe.forward(block.ffn, hd, mcfg), 20)
        bufd = buf[:, :moe.capacity(4, mcfg)]
        experts_dec_ms = events_ms(lambda: moe.experts(block.ffn, bufd),
                                   20)
        kv = {n: c.clone() for n, c in eng.cache["decoder"][0]["kv"].items()}
        clen = torch.from_numpy(eng.cache_len).to(dev)
        dec_attn_ms = events_ms(lambda: attn.decode_step(
            block.mixer, hd, kv, clen, acfg), 20)
    print(f"lm families: mixtral layer 0, prefill of {t} tokens: layer "
          f"{layer_ms} ms = attention {attn_ms} ms (flash_attention "
          f"{flash_ms} ms of it) + MoE {moe_ms} ms (expert products "
          f"{experts_ms} ms over [{mcfg.n_experts}, "
          f"{moe.capacity(t, mcfg)}, {cfg.d_model}], dispatch "
          f"{moe_ms - experts_ms} ms); decode step (4 slots): attention "
          f"{dec_attn_ms} ms, MoE {moe_dec_ms} ms (expert products "
          f"{experts_dec_ms} ms over [{mcfg.n_experts}, "
          f"{moe.capacity(4, mcfg)}, {cfg.d_model}]: every expert's "
          f"weights read; dispatch {moe_dec_ms - experts_dec_ms} ms); CUDA "
          f"events, host dispatch gaps included", flush=True)


def mixtral_f32_checks(m32) -> None:
    """(a)'s float32 copy, TF32 off: a prefill through the kernel against
    the plain attention's within ``LM_TOL`` of the logits' largest
    magnitude with the same greedy token (route differences and drops
    printed), then 8 teacher-forced decode steps after a prefill that
    wraps the rings against the prefill of the prompt plus the tokens
    so far: printed at the published capacity factor, held within
    ``LM_TOL`` at one no expert can overflow."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    vocab = m32.cfg.vocab_size
    rng = np.random.default_rng(25)
    dev = m32.device
    prompt = torch.from_numpy(rng.integers(0, vocab, (1, FAMILY_CHECK_PROMPT))
                              ).to(dev)
    with torch.inference_mode(), recording_routes() as routes:
        kern, _, _ = m32.prefill(prompt, 8192)
        n_kern = len(routes)
        m32.attn_backend = "ref"
        try:
            plain, _, _ = m32.prefill(prompt, 8192)
        finally:
            m32.attn_backend = "kernel"
        err = rel_err(kern, plain)
        same = int(kern.argmax()) == int(plain.argmax())
        print(f"lm families: mixtral f32 prefill of {FAMILY_CHECK_PROMPT} "
              f"tokens, kernel vs plain attention: max |diff| / max |logit| "
              f"= {err}, greedy token equal: {same}; tokens routed to "
              f"another top-2 expert set {route_flips(routes[:n_kern], routes[n_kern:])}"
              f" of {FAMILY_CHECK_PROMPT} x {m32.cfg.n_layers} layers; "
              f"(token, slot)s dropped past capacity {route_drops(m32, routes[:n_kern])}"
              f" / {route_drops(m32, routes[n_kern:])}", flush=True)
        if err > LM_TOL or not same:
            fail("mixtral's f32 prefill through the kernel differs from the "
                 "plain attention's")

        prompt = torch.from_numpy(rng.integers(
            0, vocab, (1, FAMILY_DECODE_PROMPT))).to(dev)

        def teacher_forced():
            """8 decode steps after the prompt's prefill against the
            prefill of the prompt plus the tokens so far: (errors, greedy
            agreements, (token, slot)s each prefill dropped)."""
            toks = prompt
            logits, cache, clen = m32.prefill(toks, 8192)
            errs, agree, drops = [], 0, []
            for _ in range(8):
                nxt = logits.argmax(dim=-1)[:, None]
                toks = torch.cat([toks, nxt], dim=1)
                logits, cache = m32.decode_step(nxt, cache, clen)
                clen += 1
                routes.clear()
                want, _, _ = m32.prefill(toks, 8192)
                drops.append(route_drops(m32, routes))
                errs.append(rel_err(logits, want))
                agree += int(logits.argmax()) == int(want.argmax())
            return errs, agree, drops

        # at the published capacity a prefill drops the (token, slot)s
        # past an expert's capacity, and its capacity grows with the
        # prompt (so earlier tokens' drops move), while a one-token
        # decode step drops none: the two differ wherever a prefill
        # drops, as the JAX package's do.  Printed, not held.
        errs, agree, drops = teacher_forced()
        print(f"lm families: mixtral f32 teacher-forced decode after a "
              f"{FAMILY_DECODE_PROMPT}-token prefill (4,096-slot rings "
              f"wrapped), capacity factor {m32.cfg.capacity_factor}: 8 "
              f"steps vs prefill of the prompt plus the tokens so far: max "
              f"|diff| / max |logit| per step {errs}; greedy equal on "
              f"{agree} of 8; (token, slot)s each prefill dropped past "
              f"capacity {drops} (not held: a prefill that drops differs "
              f"from decode by design)", flush=True)
        # held: the same with a capacity no expert can overflow (E / k:
        # every expert takes all N tokens), where the MoE is per token
        cfg = m32.cfg
        m32.cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k)
        try:
            errs, agree, drops = teacher_forced()
        finally:
            m32.cfg = cfg
        print(f"lm families: mixtral f32 teacher-forced decode, the same "
              f"with capacity factor {cfg.n_experts / cfg.top_k} (no "
              f"drops): max |diff| / max |logit| per step {errs}; greedy "
              f"equal on {agree} of 8; (token, slot)s dropped {drops}",
              flush=True)
        if max(errs) > LM_TOL or any(drops):
            fail("mixtral's teacher-forced decode differs from prefill")


# (d)'s per-token parts: prefill_32k's prompt length and a training
# sequence, rwkv6-7b cut to 2 layers; the per-token form (``rwkv_chunk``
# 0, ``models.layers.scan``) held against the chunk-64 form.  The two
# are one recurrence summed in another order in float32, each layer's
# output then rounded to bf16: a bf16 ulp (2^-8) where the order moves
# it, through 2 layers and the head
RWKV_PREFILL, RWKV_TRAIN_SEQ = 32_768, 2_048
RWKV_LOGIT_TOL = 2 ** -5  # of the chunk-64 logits' largest magnitude
RWKV_STATE_TOL = 1e-3     # layer 0's final state (float32 on equal inputs)
RWKV_GRAD_TOL = 2 ** -5   # ||per-token - chunk-64|| / ||chunk-64||, each


def rwkv_per_token() -> None:
    """(d)'s per-token parts: rwkv6-7b at full width in bf16, 2 layers,
    unchunked: a prefill of a ``RWKV_PREFILL``-token prompt at B 1 and
    one training step (loss and backward) at B 1, T ``RWKV_TRAIN_SEQ``,
    each timed, its peak memory printed, and held against the same run
    in the chunk-64 form; then the card's busy share of a short
    per-token prefill and training step."""
    from repro_torch.kernels import ops

    model = family_model("rwkv6-7b", 2)
    cfg, dev = model.cfg, model.device
    rng = np.random.default_rng(35)

    def run(chunk, fn):
        """``fn()`` with ``rwkv_chunk`` = ``chunk``: (its result, wall s,
        peak bytes allocated)."""
        model.rwkv_chunk = chunk
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()

    def prefill(toks):
        with torch.inference_mode():
            logits, cache, _ = model.prefill(toks, toks.shape[1])
        return (logits[:, :cfg.vocab_size].float(),
                [layer["rwkv"]["state"] for layer in cache["decoder"]])

    def grads(tokens):
        model.zero_grad(set_to_none=True)
        loss = model.loss({"tokens": tokens[:, :-1],
                           "labels": tokens[:, 1:]})
        loss.backward()
        out = (float(loss.detach()),
               {n: p.grad.float() for n, p in model.named_parameters()
                if p.grad is not None})
        model.zero_grad(set_to_none=True)
        return out

    # warm-up of both forms outside the timed runs
    warm = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 129))).to(dev)
    for chunk in (0, 64):
        run(chunk, lambda: (prefill(warm[:, :128]), grads(warm)))
    before = ops.launch_counts()

    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (1, RWKV_PREFILL))).to(dev)
    (tok_l, tok_s), tok_wall, tok_peak = run(0, lambda: prefill(prompt))
    (chk_l, chk_s), chk_wall, chk_peak = run(64, lambda: prefill(prompt))
    logit_gap = rel_err(tok_l, chk_l)
    state_gaps = [rel_err(a, b) for a, b in zip(tok_s, chk_s)]
    print(f"lm families: rwkv6-7b (2 layers) bf16 prefill of {RWKV_PREFILL} "
          f"tokens, B 1: per-token (rwkv_chunk 0) {tok_wall} s, peak "
          f"allocated {tok_peak / 1e9} GB; chunk 64 {chk_wall} s, peak "
          f"{chk_peak / 1e9} GB; max |per-token - chunk-64| / max |logit| "
          f"= {logit_gap} (bound {RWKV_LOGIT_TOL}), greedy token equal: "
          f"{int(tok_l.argmax()) == int(chk_l.argmax())}; final states' "
          f"max |diff| / max |state| by layer {state_gaps} (layer 0 bound "
          f"{RWKV_STATE_TOL})", flush=True)
    if not (torch.isfinite(tok_l).all() and logit_gap <= RWKV_LOGIT_TOL
            and state_gaps[0] <= RWKV_STATE_TOL):
        fail("rwkv6's per-token prefill differs from the chunk-64 prefill")
    del tok_l, tok_s, chk_l, chk_s, prompt

    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, RWKV_TRAIN_SEQ + 1))).to(dev)
    (tok_loss, tok_g), tok_wall, tok_peak = run(0, lambda: grads(tokens))
    (chk_loss, chk_g), chk_wall, chk_peak = run(64, lambda: grads(tokens))
    gaps = {n: float((tok_g[n] - g).norm() / g.norm().clamp_min(1e-30))
            for n, g in chk_g.items()}
    worst = max(gaps, key=gaps.get)
    print(f"lm families: rwkv6-7b (2 layers) bf16 training step (loss and "
          f"backward, remat) at B 1, T {RWKV_TRAIN_SEQ}: per-token "
          f"{tok_wall} s, peak allocated {tok_peak / 1e9} GB, loss "
          f"{tok_loss}; chunk 64 {chk_wall} s, peak {chk_peak / 1e9} GB, "
          f"loss {chk_loss}; {len(gaps)} gradients, largest ||per-token - "
          f"chunk-64|| / ||chunk-64|| {gaps[worst]} ({worst}; bound "
          f"{RWKV_GRAD_TOL})", flush=True)
    if (set(tok_g) != set(chk_g) or gaps[worst] > RWKV_GRAD_TOL
            or not all(torch.isfinite(g).all() for g in tok_g.values())):
        fail("rwkv6's per-token training step's gradients differ from the "
             "chunk-64 step's")
    # where the per-token form's time goes: the card's share of a short
    # prefill and a short training step
    model.rwkv_chunk = 0
    for what, call in (("prefill of 1,024 tokens",
                        lambda: prefill(tokens[:, :1024])),
                       ("training step at T 256",
                        lambda: grads(tokens[:, :257]))):
        wall_us, share, top = busy_share(call)
        print(f"lm families trace: rwkv6-7b (2 layers) per-token {what}: "
              f"wall {wall_us} us, card busy {share} of it; device work: "
              f"{top}", flush=True)
    launched = {k: v - before[k] for k, v in ops.launch_counts().items()
                if v != before[k]}
    print(f"lm families: rwkv6-7b per-token parts launched "
          f"{launched or 'none'} of the port's kernels (no attention)",
          flush=True)
    del model, tok_g, chk_g
    torch.cuda.empty_cache()


def phase_lm_families() -> tuple[dict, dict]:
    """Phase 12: the LM families at full width in bfloat16 on the card,
    depth cut (printed), random weights from a seed; each model freed
    before the next.  Returns (every kernel's launches summed over the
    counted runs, flash launches by model)."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    total, by_model = collections.Counter(), {}

    def add(name, launches):
        total.update(launches)
        by_model[name] = launches["flash_attention"]

    def served(name, model, *args, **kw):
        launches, eng = serve_family(model, *args, **kw)
        add(name, launches)
        return eng

    # (a) mixtral-8x22b, the slice's model: all layers windowed and MoE
    model = family_model("mixtral-8x22b", 4)
    eng = served("mixtral-8x22b", model, FAMILY_PROMPTS, FAMILY_NEW_TOKENS,
                 4, 8192, seed=22)
    dev = model.device
    with torch.inference_mode():
        toks = torch.from_numpy(np.random.default_rng(26).integers(
            0, model.cfg.vocab_size, (1, FAMILY_PROMPTS[-1]))).to(dev)
        wall_us, share, top = busy_share(lambda: model.prefill(toks, 8192))
        print(f"lm families trace: mixtral prefill of {toks.shape[1]} "
              f"tokens: wall {wall_us} us, card busy {share} of it; device "
              f"work: {top}", flush=True)
        last = torch.from_numpy(eng.last_token[:, None]).to(dev)
        clen = torch.from_numpy(eng.cache_len).to(dev)
        cache = {"decoder": [{kind: {n: c.clone() for n, c in t.items()}
                              for kind, t in layer.items()}
                             for layer in eng.cache["decoder"]]}
        wall_us, share, top = busy_share(
            lambda: model.decode_step(last, cache, clen))
        print(f"lm families trace: mixtral decode step (4 slots): wall "
              f"{wall_us} us, card busy {share} of it; device work: {top}",
              flush=True)
        del cache
    mixtral_breakdown(model, eng)
    m32 = model.cast(torch.float32)
    del eng, model
    torch.cuda.empty_cache()
    mixtral_f32_checks(m32)
    del m32
    torch.cuda.empty_cache()

    # (b) grok-1-314b: MoE with full attention
    model = family_model("grok-1-314b", 2)
    served("grok-1-314b", model, (100, 1500), 8, 2, 2048, seed=27)
    hold_prefill(model, torch.from_numpy(np.random.default_rng(34).integers(
        0, model.cfg.vocab_size, (1, 1500))).to(model.device), 2048, f32=True)
    del model
    torch.cuda.empty_cache()

    # (c) jamba-1.5-large-398b: mamba at 0-3, attention at 4, MoE at 1, 3
    model = family_model("jamba-1.5-large-398b", 5)
    dev = model.device
    served("jamba-1.5-large-398b", model, (37, 300, 700, 1024), 8, 4, 2048,
           seed=28)
    rng = np.random.default_rng(29)
    # its float32 copy (96 GB) does not fit on the card: its one launch
    # and greedy token are held
    hold_prefill(model, torch.from_numpy(rng.integers(
        0, model.cfg.vocab_size, (1, 1024))).to(dev), 2048, f32=False)
    del model
    torch.cuda.empty_cache()

    # (d) rwkv6-7b at full depth: no attention; blocked prefill where 64
    # divides the prompt
    model = family_model("rwkv6-7b", rwkv_chunk=64)
    dev = model.device
    served("rwkv6-7b", model, (64, 128, 200, 512), 8, 4, 1024, seed=30)
    rng = np.random.default_rng(31)
    hold_prefill(model, torch.from_numpy(rng.integers(
        0, model.cfg.vocab_size, (1, 512))).to(dev), 1024, f32=False)
    del model
    torch.cuda.empty_cache()
    rwkv_per_token()

    # (e) whisper-small at full depth: one batch of 1,500 frames
    from repro_torch.kernels.flash_attention import _strides
    from repro_torch.models.layers import attention as attn

    model = family_model("whisper-small")
    cfg, dev = model.cfg, model.device
    rng = np.random.default_rng(32)
    frames = torch.from_numpy(rng.standard_normal(
        (1, cfg.frontend_len, cfg.d_model), dtype=np.float32)).to(dev)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 64))
                              ).to(dev)
    launches, enc_out = drive_family(model, prompt, 16, 128, frames=frames)
    add("whisper-small", launches)
    block = model.layers[0]
    with torch.inference_mode():
        _, k, v = attn._split_qkv(block.cross, enc_out,
                                  model.attn_cfg(block.kind, False))
    aligned = all(t.data_ptr() % 16 == 0 and all(s % 8 == 0
                                                 for s in _strides(t))
                  for t in (k, v))
    print(f"lm families: whisper cross-attention k, v: views of the "
          f"encoder output's projection, bases {k.data_ptr() % 16} and "
          f"{v.data_ptr() % 16} bytes off 16, element strides "
          f"{_strides(k)} (TMA: 16-byte bases, strides of whole 16 bytes):"
          f" {aligned}", flush=True)
    if not aligned:
        fail("whisper's cross-attention k, v break the TMA alignment rule")
    hold_prefill(model, prompt, 128, f32=True, frames=frames)
    del model, enc_out, k, v
    torch.cuda.empty_cache()

    # (f) internvl2-26b: 256 patches before a 64-token prompt
    model = family_model("internvl2-26b", 2)
    cfg, dev = model.cfg, model.device
    rng = np.random.default_rng(33)
    patches = torch.from_numpy(rng.standard_normal(
        (1, cfg.frontend_len, cfg.d_model), dtype=np.float32)).to(dev)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 64))
                              ).to(dev)
    launches, _ = drive_family(model, prompt, 16, 512, patches=patches)
    add("internvl2-26b", launches)
    hold_prefill(model, prompt, 512, f32=True, patches=patches)
    del model
    torch.cuda.empty_cache()

    print(f"lm families: flash_attention launches by model {by_model}; "
          f"phase wall {time.perf_counter() - t_phase} s", flush=True)
    return dict(total), by_model


# --- LM training: gemma3-1b at full width, recovery, every family reduced ---

# (a): the batch, the loss's sequence chunk, the steps and the checkpoint
# period; (b): the step whose start fails
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LOSS_CHUNK = 4, 1024, 256
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 8, 4, 6
# (c): the prompt served with the trained weights
TRAIN_PROMPT = 1000
# the card's dense bf16 peak (NVIDIA's data sheet, H100 SXM, 700 W)
BF16_PEAK = 989e12
# (d): the reduced families' steps, batch, sequence and loss tolerance
FAMILY_TRAIN_STEPS, FAMILY_TRAIN_BATCH, FAMILY_TRAIN_SEQ = 3, 4, 64
FAMILY_TRAIN_RTOL = 1e-4


def train_setup(cfg, model, lr: float):
    """(AdamW, step function, batch function) of phase 13 (a): the
    cosine schedule over the steps, ``SyntheticTokens(seed=0)`` through
    ``ShardedLoader``, batches copied to the model's device."""
    from repro_torch.data import ShardedLoader, SyntheticTokens
    from repro_torch.launch.train import make_train_step
    from repro_torch.optim import AdamW, AdamWConfig, cosine_schedule

    opt = AdamW(AdamWConfig(lr=cosine_schedule(lr, 2, TRAIN_STEPS)))
    src = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                          batch_size=TRAIN_BATCH, seed=0)
    loader = ShardedLoader(src.batch, prefetch=2)
    dev = model.device

    def batch_fn(step):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in loader.get(step).items()}

    return opt, make_train_step(model, opt), batch_fn


def train_loop_run(step_fn, batch_fn, state, ckpt_dir: Path,
                   failure_hook=None):
    """``TrainLoop`` over phase 13's steps from ``state``, checkpoints
    under ``ckpt_dir`` (emptied first), the launch counts set to 0 before
    and read after.  Returns (loop, final state, launches, wall s)."""
    import shutil

    from repro_torch.kernels import ops
    from repro_torch.runtime import TrainLoop, TrainLoopConfig

    shutil.rmtree(ckpt_dir, ignore_errors=True)
    loop = TrainLoop(step_fn, TrainLoopConfig(
        total_steps=TRAIN_STEPS, checkpoint_every=TRAIN_CKPT_EVERY,
        keep_checkpoints=2), str(ckpt_dir), batch_fn=batch_fn,
        failure_hook=failure_hook)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    final = loop.run(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return loop, final, ops.launch_counts(), wall


def train_step_split(model, opt, params, opt_state, batch) -> tuple:
    """ms of one training step's forward (the loss), backward (the
    gradients; the remat recomputes each layer here) and optimizer
    (AdamW), each on the host's clock around work that ends in a
    synchronize."""
    from repro_torch.launch.train import bind_params

    bound = bind_params(model, params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = model.loss(batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    grads = torch.autograd.grad(loss, list(bound.values()))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    opt.apply(dict(zip(bound, grads)), opt_state, params)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return 1e3 * (t1 - t0), 1e3 * (t2 - t1), 1e3 * (t3 - t2)


def nondeterministic_grads(model, batch) -> str:
    """Which of the loss's gradients differ between two identical
    backward passes without deterministic algorithms, and whether the
    two scattering backwards on the path (the embedding lookup's
    accumulate, the loss's gather) repeat alone at the loss's shapes."""
    params = dict(model.named_parameters())

    def grads():
        return torch.autograd.grad(model.loss(batch), list(params.values()))

    diff = [n for n, a, b in zip(params, grads(), grads())
            if not torch.equal(a, b)]
    tok = batch["tokens"].long()
    w = model.embed.detach().clone().requires_grad_(True)
    up = torch.randn(*tok.shape, w.shape[1], device=w.device, dtype=w.dtype)
    lookup = [torch.autograd.grad((w[tok] * up).sum(), [w])[0]
              for _ in range(2)]
    logits = torch.randn(tok.shape[0], TRAIN_LOSS_CHUNK, w.shape[0],
                         device=w.device, requires_grad=True)
    y = batch["labels"][:, :TRAIN_LOSS_CHUNK, None].long()
    gather = [torch.autograd.grad(logits.gather(-1, y).sum(), [logits])[0]
              for _ in range(2)]
    return (f"{len(diff)} of {len(params)} gradients differ between two "
            f"backward passes ({diff[:6]}); the embedding lookup's "
            f"backward repeats: {torch.equal(*lookup)}; the gather's: "
            f"{torch.equal(*gather)}")


def same_tree(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
        else same_tree(a[k], b[k]) for k in a)


def lm_train_full() -> tuple[int, dict]:
    """Phase 13 (a)-(c): gemma3-1b at full width and depth in bf16 (AdamW
    states in f32) trained through ``TrainLoop`` on the card, then the
    same steps with a failure, then the trained weights served.  Returns
    (flash launches while training, the model's trained params)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.train import bind_params
    from repro_torch.models.transformer import Model
    from repro_torch.runtime import SimulatedFailure

    cfg = get_config("gemma3-1b")
    dev = torch.device("cuda")
    ckpt = ROOT / "build" / "train_ckpt"
    model = Model(cfg, torch.bfloat16, loss_chunk=TRAIN_LOSS_CHUNK,
                  attn_chunk=512, device=dev, seed=0)
    opt, step_fn, batch_fn = train_setup(cfg, model, 1e-3)
    print(f"lm train: without deterministic algorithms, "
          f"{nondeterministic_grads(model, batch_fn(0))}", flush=True)
    torch.cuda.empty_cache()
    # the recovery below is held bit for bit
    torch.use_deterministic_algorithms(True)
    try:
        params0 = {k: v.detach().clone()
                   for k, v in model.named_parameters()}
        n_params = sum(v.numel() for v in params0.values())
        state0 = (params0, opt.init(params0))
        print(f"lm train: {cfg.name} at full width and depth ({cfg.n_layers}"
              f" layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
              f"window {cfg.window} on {cfg.swa_period - 1} of every "
              f"{cfg.swa_period}), {n_params} parameters in bf16, AdamW "
              f"states in float32; B {TRAIN_BATCH}, T {TRAIN_SEQ}, "
              f"loss_chunk {TRAIN_LOSS_CHUNK}, remat on; {TRAIN_STEPS} steps,"
              f" a checkpoint every {TRAIN_CKPT_EVERY}; deterministic "
              f"algorithms on", flush=True)

        # (a) the uninterrupted run
        torch.cuda.reset_peak_memory_stats()
        loop, final, launches, wall = train_loop_run(step_fn, batch_fn,
                                                     state0, ckpt)
        peak = torch.cuda.max_memory_allocated()
        losses = [m["loss"] for m in loop.metrics_log]
        dts = [1e3 * m["dt"] for m in loop.metrics_log]
        step_ms = statistics.median(dts[1:])
        tokens = TRAIN_BATCH * TRAIN_SEQ
        flops = 6 * n_params * tokens / (step_ms / 1e3)
        print(f"lm train (a): loss by step {losses}; step ms {dts}; median "
              f"after the first {step_ms} ms = {tokens / (step_ms / 1e3)} "
              f"tokens/s, model FLOP/s (6 N tokens / step) {flops} = "
              f"{flops / BF16_PEAK} of the dense bf16 peak; loop wall "
              f"{wall} s (checkpoints included); peak memory allocated "
              f"{peak} B; launches {launches}", flush=True)
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            fail(f"gemma3-1b training: the loss is not finite or did not "
                 f"fall: {losses}")
        if len(losses) != TRAIN_STEPS or launches["flash_attention"]:
            fail(f"gemma3-1b training ran {len(losses)} steps with "
                 f"{launches['flash_attention']} flash launches")
        train_flash = launches["flash_attention"]

        batch = batch_fn(0)
        fwd, bwd, upd = train_step_split(model, opt, *final, batch)
        print(f"lm train (a): one step split: forward {fwd} ms, backward "
              f"(remat recompute included) {bwd} ms, optimizer {upd} ms",
              flush=True)
        wall_us, share, top = busy_share(
            lambda: step_fn(*final, batch, None))
        print(f"lm train trace: one step: wall {wall_us} us, card busy "
              f"{share} of it; device work: {top}", flush=True)

        # (b) the same steps, a failure at the start of one
        failed = []

        def failure_hook(step):
            if step == TRAIN_FAIL_AT and not failed:
                failed.append(step)
                raise SimulatedFailure("node lost")

        loop_b, final_b, launches_b, wall_b = train_loop_run(
            step_fn, batch_fn, state0, ckpt, failure_hook)
        equal = (same_tree(final_b[0], final[0])
                 and same_tree(final_b[1], final[1]))
        print(f"lm train (b): failure at step {TRAIN_FAIL_AT}: restarts "
              f"{loop_b.restarts}, steps run "
              f"{[m['step'] for m in loop_b.metrics_log]}, loop wall {wall_b}"
              f" s; final params and AdamW state bit-equal to (a): {equal};"
              f" launches {launches_b}", flush=True)
        if loop_b.restarts != 1 or not equal or launches_b["flash_attention"]:
            fail("gemma3-1b training did not recover bit-identically from "
                 "the failure")
        train_flash += launches_b["flash_attention"]
        del loop_b, final_b, state0, params0
    finally:
        import shutil

        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ckpt, ignore_errors=True)

    # (c) serve what was trained: one prefill through the kernel, one
    # through the plain attention
    bind_params(model, final[0])
    del final, loop
    torch.cuda.empty_cache()
    prompt = torch.from_numpy(np.random.default_rng(35).integers(
        0, cfg.vocab_size, (1, TRAIN_PROMPT))).to(dev)
    ops.reset_launch_counts()
    kern, _, _ = model.prefill(prompt, 1024)
    torch.cuda.synchronize()
    served = ops.launch_counts()["flash_attention"]
    model.attn_backend = "ref"
    plain, _, _ = model.prefill(prompt, 1024)
    model.attn_backend = "kernel"
    same = int(kern.argmax()) == int(plain.argmax())
    print(f"lm train (c): the trained weights' {TRAIN_PROMPT}-token prefill: "
          f"flash launches {served} ({cfg.n_layers} layers); greedy token "
          f"through the kernel {int(kern.argmax())}, through the plain "
          f"attention {int(plain.argmax())}; max |diff| / max |logit| "
          f"{rel_err(kern, plain)}", flush=True)
    if served != cfg.n_layers or not same:
        fail("the trained gemma3-1b's prefill through the kernel differs "
             "from the plain attention's (or launched the kernel "
             f"{served} times)")
    del model
    torch.cuda.empty_cache()
    return train_flash, served


def lm_train_families() -> int:
    """Phase 13 (d): each registered LM config ``reduced()`` in float32,
    TF32 off: three AdamW steps on the card and on the CPU from the same
    weights and batches, losses within ``FAMILY_TRAIN_RTOL``.  Returns
    the flash launches of the card's steps (all must be 0)."""
    from repro_torch.configs.base import get_config, list_configs, reduced
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import ops
    from repro_torch.launch.train import frontend_inputs, make_train_step
    from repro_torch.models.transformer import Model
    from repro_torch.optim import AdamW, AdamWConfig, cosine_schedule

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flash, worst = 0, {}
    for arch in list_configs():
        cfg = reduced(get_config(arch))
        src = SyntheticTokens(vocab_size=cfg.vocab_size,
                              seq_len=FAMILY_TRAIN_SEQ,
                              batch_size=FAMILY_TRAIN_BATCH, seed=0)
        losses = {}
        for dev in (torch.device("cuda"), torch.device("cpu")):
            model = Model(cfg, torch.float32, loss_chunk=32, attn_chunk=32,
                          device="cpu", seed=5).to(dev)
            opt = AdamW(AdamWConfig(lr=cosine_schedule(1e-3, 1, 3)))
            step = make_train_step(model, opt)
            params = dict(model.named_parameters())
            state = (params, opt.init(params))
            ops.reset_launch_counts()
            out = []
            for i in range(FAMILY_TRAIN_STEPS):
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in src.batch(i).items()}
                batch.update(frontend_inputs(cfg, FAMILY_TRAIN_BATCH, dev))
                p, s, m = step(*state, batch)
                state = (p, s)
                out.append(float(m["loss"]))
            if dev.type == "cuda":
                flash += ops.launch_counts()["flash_attention"]
            losses[dev.type] = out
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                      losses["cpu"]))
        worst[arch] = rel
        print(f"lm train (d): {cfg.name}: loss by step on the card "
              f"{losses['cuda']}, on the CPU {losses['cpu']}; max relative "
              f"difference {rel}", flush=True)
        if not rel <= FAMILY_TRAIN_RTOL:
            fail(f"{cfg.name}: the card's training steps differ from the "
                 f"CPU's by {rel} (limit {FAMILY_TRAIN_RTOL})")
    if flash:
        fail(f"training the reduced families launched flash {flash} times")
    return flash


def phase_lm_train() -> dict:
    """Phase 13: LM training on the card.  Returns the flash launches of
    its parts: training (must be 0) and the trained weights' prefill."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    train_flash, served = lm_train_full()
    train_flash += lm_train_families()

    # (e) the guard: no output cut off from autograd
    q, k, v = (torch.randn(1, 4, 64, 256, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    q.requires_grad_(True)
    ops.reset_launch_counts()
    try:
        flash_attention(q, k, v)
    except ValueError as e:
        print(f"lm train (e): flash_attention with q.requires_grad under "
              f"grad mode raises: {e}", flush=True)
    else:
        fail("flash_attention returned an output cut off from autograd")
    if ops.launch_counts()["flash_attention"]:
        fail("the refused flash_attention call launched the kernel")
    print(f"lm train: flash launches while training {train_flash}, in the "
          f"trained weights' prefill {served}; phase wall "
          f"{time.perf_counter() - t_phase} s", flush=True)
    return {"lm_train_launches": train_flash,
            "lm_trained_prefill_launches": served}


# --- the distribution side: the sharded program, the pipeline, the SNN ----
# --- shards of the production deployment, the dry run ----------------------

# (a): the sharded prefill's prompt, its decode steps and cache, the
# training steps (phase 13's batch and sequence)
DIST_PROMPT, DIST_DECODE, DIST_MAX_LEN, DIST_TRAIN_STEPS = 1000, 16, 1024, 4
# (b): stages, microbatches and the batch they split
PIPE_STAGES, PIPE_MICRO, PIPE_BATCH, PIPE_SEQ = 2, 4, 8, 512


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_dryruns(card: str):
    """Phase 14 (d): the dry run of gemma3-1b ``train_4k`` on the pod and
    the multi-pod mesh (a fake group of 256 / 512 ranks, on the host),
    then of phase 13's shape on a (1, 1) mesh for (a).  Returns that
    last cell."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import SHAPES
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world

    for multi_pod in (False, True):
        t0 = time.perf_counter()
        res = dryrun.lower_cell("gemma3-1b", SHAPES["train_4k"], multi_pod)
        wall = time.perf_counter() - t0
        rl = res["roofline"]
        print(f"dist (d): dryrun gemma3-1b train_4k on {res['mesh']} "
              f"({res['chips']} ranks, {res['rules']}): wall {wall} s on the "
              f"host; per-device traced peak {res['peak_bytes_per_device']} "
              f"B, est_peak {res['est_peak_bytes']} B, fits_80GB "
              f"{res['fits_80GB']} (traced {res['fits_80GB_traced']}); "
              f"dominant {rl['dominant']} (compute {rl['t_compute_s']} s, "
              f"memory {rl['t_memory_s']} s, collective "
              f"{rl['t_collective_s']} s by axis {rl['coll_by_axis']}); "
              f"useful FLOPs {res['useful_flops_frac']}; {card}", flush=True)
        if res["status"] != "ok" or not res["fits_80GB"]:
            fail(f"the dry run of gemma3-1b train_4k on {res['mesh']} "
                 f"failed or does not fit: {res}")
    print("dist (d): llama3-405b train_4k on 2x32x8 traces for ~6 minutes "
          "on a host: a CLI run (python -m repro_torch.launch.dryrun --arch "
          "llama3-405b --shape train_4k --mesh multipod), not this phase",
          flush=True)
    with fake_world(1):
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data",
                                                                "model"))
        return dryrun.lower_cell(
            "gemma3-1b", ShapeSpec("phase13", TRAIN_SEQ, TRAIN_BATCH,
                                   "train"), mesh=mesh)


def full_of(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value on every rank; a plain tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def first_divergence(plain, sharded, params, mesh, rules, prompt) -> str:
    """Where the sharded prefill's hidden state first leaves the
    unsharded one's: the embedding or the first layer whose output
    differs, with the gap there."""
    from repro_torch.distributed import sharding as shd

    full = full_of

    pos = torch.arange(prompt.shape[1], device=prompt.device)
    with torch.no_grad():
        xu = plain._embed(prompt)
        with shd.use_mesh(mesh, rules), shd.replicating():
            xs = sharded._embed(prompt)
            if not torch.equal(full(xs), xu):
                return f"the embedding, gap {float((full(xs) - xu).abs().max())}"
            for i, (bu, bs) in enumerate(zip(plain.layers, sharded.layers)):
                xu = plain._apply_sublayer(bu, xu, positions=pos)[0]
                xs = sharded._apply_sublayer(bs, xs, positions=pos)[0]
                if not torch.equal(full(xs), xu):
                    gap = float((full(xs).float() - xu.float()).abs().max())
                    return f"layer {i} ({bu.kind}), gap {gap}"
    return "no layer output differs (the head)"


def dist_sharded_serving(mesh, card: str) -> int:
    """Phase 14 (a), serving: gemma3-1b at full width in bf16, its params
    placed by ``to_shardings`` under ``use_mesh``, a 1,000-token prefill
    through ``make_prefill_step`` and 16 decode steps through
    ``make_serve_step``, against the unsharded port's same calls from
    the same weights.  Returns the sharded prefill's flash launches."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.specs import place_params
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_prefill_step, make_serve_step
    from repro_torch.models.transformer import Model

    cfg = get_config("gemma3-1b")
    dev = torch.device("cuda")
    rules = shd.use_rules()
    plain = Model(cfg, torch.bfloat16, device=dev, seed=0)
    sharded = Model(cfg, torch.bfloat16, device=dev, seed=0)
    prompt = torch.from_numpy(np.random.default_rng(41).integers(
        0, cfg.vocab_size, (1, DIST_PROMPT))).to(dev)
    def greedy(prefill_step, decode_step):
        """The prefill's and 16 greedy decode steps' logits, the tokens
        fed, and the prefill's and a decode step's wall s."""
        t0 = time.perf_counter()
        logits, cache, n = prefill_step()
        logits = full_of(logits)
        torch.cuda.synchronize()
        walls = [time.perf_counter() - t0]
        out, toks = [logits], []
        t0 = time.perf_counter()
        for i in range(DIST_DECODE):
            toks.append(out[-1].argmax(-1, keepdim=True))
            logits, cache = decode_step(toks[-1], cache, n + i)
            out.append(full_of(logits))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / DIST_DECODE)
        return out, toks, walls

    want, toks_u, _ = greedy(lambda: plain.prefill(prompt, DIST_MAX_LEN),
                             plain.decode_step)
    with shd.use_mesh(mesh, rules):
        params = place_params(sharded, mesh, rules)
        step = make_serve_step(sharded)
        ops.reset_launch_counts()
        got, toks_s, walls = greedy(
            lambda: make_prefill_step(sharded, DIST_MAX_LEN)(
                params, {"tokens": prompt}),
            lambda tok, cache, n: step(params, tok, cache, n))
        flash = ops.launch_counts()["flash_attention"]
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    gaps = [float((a - b).abs().max()) for a, b in zip(got, want)]
    same_tokens = all(torch.equal(a, b) for a, b in zip(toks_s, toks_u))
    print(f"dist (a): gemma3-1b sharded on the (data 1, model 1) mesh, "
          f"placed by to_shardings: a {DIST_PROMPT}-token prefill through "
          f"make_prefill_step ({flash} flash launches, {walls[0]} s), "
          f"{DIST_DECODE} decode steps through make_serve_step ({walls[1]} "
          f"s a step; both on the host's clock); logits torch.equal to the "
          f"unsharded port's: {equal}; largest gap by call {gaps}; greedy "
          f"tokens equal {same_tokens}; {card}", flush=True)
    if not equal:
        print(f"dist (a): the first difference: "
              f"{first_divergence(plain, sharded, params, mesh, rules, prompt)}",
              flush=True)
    if flash != cfg.n_layers or not same_tokens:
        fail(f"the sharded gemma3-1b served other tokens than the unsharded "
             f"one, or launched flash {flash} times ({cfg.n_layers} layers)")
    return flash


def dist_sharded_training(mesh, dry11: dict, card: str) -> None:
    """Phase 14 (a), training: 4 ``make_train_step`` steps at phase 13's
    shape (B 4, T 1,024, remat, AdamW states in f32) under deterministic
    algorithms, sharded on the (1, 1) mesh and unsharded from the same
    weights: params and AdamW states bit-equal.  The sharded run's peak
    memory beside the dry run's of the same config on a (1, 1) mesh."""
    from repro_torch.configs.base import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.specs import place_params
    from repro_torch.kernels import ops
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.transformer import Model
    from repro_torch.optim import AdamW, AdamWConfig, cosine_schedule

    cfg = get_config("gemma3-1b")
    dev = torch.device("cuda")
    src = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                          batch_size=TRAIN_BATCH, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                src.batch(i).items()} for i in range(DIST_TRAIN_STEPS)]

    def run(placed: bool):
        model = Model(cfg, torch.bfloat16, loss_chunk=TRAIN_LOSS_CHUNK,
                      attn_chunk=512, device=dev, seed=0)
        opt = AdamW(AdamWConfig(lr=cosine_schedule(1e-3, 2, TRAIN_STEPS)))
        step = make_train_step(model, opt)
        rules = shd.use_rules()
        ctx = shd.use_mesh(mesh, rules) if placed else contextlib.nullcontext()
        losses, dts = [], []
        with ctx:
            params = (place_params(model, mesh, rules) if placed
                      else dict(model.named_parameters()))
            state = (params, opt.init(params))
            for b in batches:
                t0 = time.perf_counter()
                p, s, m = step(*state, b)
                losses.append(float(m["loss"]))
                dts.append(time.perf_counter() - t0)
                state = (p, s)

        def host(t):
            return full_of(t).detach().cpu()

        p, s = state
        out = ({k: host(v) for k, v in p.items()},
               {mv: {k: host(v) for k, v in s[mv].items()}
                for mv in ("m", "v")})
        return losses, dts, out

    torch.use_deterministic_algorithms(True)
    try:
        losses_u, dts_u, (pu, su) = run(False)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        losses_s, dts_s, (ps, ss) = run(True)
        peak = torch.cuda.max_memory_allocated()
        launches = ops.launch_counts()["flash_attention"]
    finally:
        torch.use_deterministic_algorithms(False)
    equal = (all(torch.equal(ps[k], pu[k]) for k in pu)
             and all(torch.equal(ss[mv][k], su[mv][k]) for mv in su
                     for k in pu))
    worst = max(float((ps[k].float() - pu[k].float()).abs().max())
                for k in pu)
    print(f"dist (a): gemma3-1b training, {DIST_TRAIN_STEPS} steps at B "
          f"{TRAIN_BATCH}, T {TRAIN_SEQ}, remat, deterministic algorithms: "
          f"losses sharded {losses_s}, unsharded {losses_u}; step s sharded "
          f"{dts_s}, unsharded {dts_u}; params and AdamW states bit-equal: "
          f"{equal} (largest param gap {worst}); flash launches {launches}; "
          f"peak memory allocated by the sharded run {peak} B, the dry run's "
          f"(1, 1) cell: est_peak {dry11['est_peak_bytes']} B, traced peak "
          f"{dry11['peak_bytes_per_device']} B; {card}", flush=True)
    if not equal or launches:
        fail("the sharded gemma3-1b training steps are not bit-equal to the "
             "unsharded ones (or launched flash)")


# (a), the tensor-parallel families at full width in bf16, depth cut so
# that a run and its results fit one card: mixtral-8x22b 1 layer
# (attention + MoE); jamba-1.5-large served at 2 layers (Mamba + MLP, then
# attention + MoE: attention every 2nd layer) and trained at its first
# (Mamba + MLP: a MoE layer's 19.3 GB of experts with float32 AdamW states
# does not fit); batch, prompt, decode steps, cache, training sequence
DIST_TP_FAMILIES = (
    ("mixtral-8x22b", {"n_layers": 1}, {"n_layers": 1}),
    ("jamba-1.5-large-398b", {"n_layers": 2, "attn_period": 2},
     {"n_layers": 1}))
DIST_TP_BATCH, DIST_TP_PROMPT, DIST_TP_DECODE = 2, 256, 4
DIST_TP_MAX_LEN, DIST_TP_TRAIN_SEQ = 512, 256


def dist_tp_families(mesh, card: str) -> int:
    """Phase 14 (a), the families whose MoE experts, Mamba channels and
    RWKV6 heads split over ``model`` (``sharding.TensorParallel``), on
    the one-rank mesh against the unsharded port from the same weights:
    each config of ``DIST_TP_FAMILIES`` served (a prefill through
    ``make_prefill_step``, ``DIST_TP_DECODE`` decode steps through
    ``make_serve_step``: logits and every cache leaf ``torch.equal``) and
    trained one ``make_train_step`` step under deterministic algorithms
    (loss and new params ``torch.equal``).  Returns the sharded
    prefills' flash launches."""
    import warnings

    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.specs import map_tree, place_params
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_prefill_step, make_serve_step
    from repro_torch.launch.train import bind_params, make_train_step
    from repro_torch.models.transformer import Model
    from repro_torch.optim import AdamW, AdamWConfig

    dev = torch.device("cuda")
    rules = shd.use_rules()
    rng = np.random.default_rng(47)
    flash = 0

    def leaves(tree) -> list:
        out = []
        map_tree(out.append, tree)
        return out

    for arch, serve_cut, train_cut in DIST_TP_FAMILIES:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), **serve_cut)
        model = Model(cfg, torch.bfloat16, device=dev, seed=0)
        plain = dict(model.named_parameters())
        tok = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (DIST_TP_BATCH, DIST_TP_PROMPT))).to(dev)
        feed = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (DIST_TP_DECODE, DIST_TP_BATCH, 1))).to(dev)

        def serve(params):
            logits, cache, n = make_prefill_step(model, DIST_TP_MAX_LEN)(
                params, {"tokens": tok})
            out = [full_of(logits)]
            first = map_tree(lambda t: full_of(t).clone(), cache)
            step = make_serve_step(model)
            for i in range(DIST_TP_DECODE):
                logits, cache = step(params, feed[i], cache, n + i)
                out.append(full_of(logits))
            return out, leaves(first) + leaves(map_tree(full_of, cache))

        want, c_want = serve(plain)
        with shd.use_mesh(mesh, rules):
            params = place_params(model, mesh, rules)
            ops.reset_launch_counts()
            got, c_got = serve(params)
            launches = ops.launch_counts()["flash_attention"]
        bind_params(model, plain)
        logits_equal = all(torch.equal(a, b) for a, b in zip(got, want))
        caches_equal = all(torch.equal(a, b) for a, b in zip(c_got, c_want))
        gap = max(float((a - b).abs().max()) for a, b in zip(got, want))
        n_attn = flash_layers(model)
        mix = dict(collections.Counter(f"{k.mixer}/{k.ffn}"
                                       for k in model.kinds))
        del model, plain, params, got, want, c_got, c_want
        torch.cuda.empty_cache()
        print(f"dist (a): {arch} at full width in bf16 (d_model "
              f"{cfg.d_model}, d_ff {cfg.d_ff}, {cfg.n_experts} experts), "
              f"its experts' d_ff and Mamba channels on the model axis "
              f"(sharding.TensorParallel), on the (data 1, model 1) mesh "
              f"against the unsharded port, served at {cfg.n_layers} "
              f"layers ({mix}; B {DIST_TP_BATCH}, a {DIST_TP_PROMPT}-token "
              f"prefill and {DIST_TP_DECODE} decode steps): logits "
              f"torch.equal {logits_equal} (largest gap {gap}), every cache "
              f"leaf torch.equal {caches_equal}, flash launches {launches} "
              f"({n_attn} attention layers), {time.perf_counter() - t0} s; "
              f"{card}", flush=True)

        t0 = time.perf_counter()
        cfg_t = dataclasses.replace(get_config(arch), **train_cut)
        model = Model(cfg_t, torch.bfloat16, loss_chunk=DIST_TP_TRAIN_SEQ,
                      device=dev, seed=0)
        tt = torch.from_numpy(rng.integers(
            0, cfg_t.vocab_size, (DIST_TP_BATCH, DIST_TP_TRAIN_SEQ))).to(dev)
        batch = {"tokens": tt, "labels": torch.roll(tt, -1, 1)}
        # bf16 AdamW states, as the dry run trains these configs: float32
        # ones for mixtral's 4.8 GB of experts, old and new at once, and
        # a second run's do not fit beside the first's params
        opt = AdamW(AdamWConfig(lr=1e-3, state_dtype=torch.bfloat16))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                plain = dict(model.named_parameters())
                out = make_train_step(model, opt)(plain, opt.init(plain),
                                                  batch)
                p_want, m_want = out[0], out[2]
                del out
                bind_params(model, plain)
                with shd.use_mesh(mesh, rules):
                    params = place_params(model, mesh, rules)
                    out = make_train_step(model, opt)(
                        params, opt.init(params), batch)
                    p_got, m_got = out[0], out[2]
                    del out
                torch.cuda.synchronize()
            finally:
                torch.use_deterministic_algorithms(False)
        nondet = sorted({str(w.message).split(".")[0] for w in caught
                         if "deterministic" in str(w.message)})
        with torch.no_grad():
            train_equal = (
                torch.equal(full_of(m_got["loss"]), m_want["loss"])
                and all(torch.equal(full_of(p_got[k]), p_want[k])
                        for k in p_want))
            worst = max(float((full_of(p_got[k]).float()
                               - p_want[k].float()).abs().max())
                        for k in p_want)
        tmix = dict(collections.Counter(f"{k.mixer}/{k.ffn}"
                                        for k in model.kinds))
        print(f"dist (a): {arch} trained one step at {cfg_t.n_layers} "
              f"layer(s) ({tmix}), "
              f"B {DIST_TP_BATCH}, T {DIST_TP_TRAIN_SEQ}, bf16 AdamW states, "
              f"deterministic algorithms, on the mesh against unsharded: "
              f"loss {float(m_got['loss'])}, loss and params torch.equal "
              f"{train_equal} (largest param gap {worst}), ops without a "
              f"deterministic version {nondet}, {time.perf_counter() - t0} "
              f"s; {card}", flush=True)
        del model, plain, params, p_want, p_got
        torch.cuda.empty_cache()
        if not (logits_equal and caches_equal and train_equal) \
                or launches != n_attn:
            fail(f"the sharded {arch} is not bit-equal to the unsharded "
                 f"port on one rank, or launched flash {launches} times")
        flash += launches
    return flash


def dist_pipeline(card: str) -> int:
    """Phase 14 (b): gemma3-1b's 26 layers as 2 stages of 13 on
    ``cuda:0`` twice, 4 microbatches of a B 8, T 512 bf16 prefill forward
    (flash in every layer) through ``pipelined_apply``, against the
    layers applied in sequence.  Returns the pipelined run's flash
    launches."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed.pipeline import pipelined_apply
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import Model

    cfg = get_config("gemma3-1b")
    dev = torch.device("cuda")
    model = Model(cfg, torch.bfloat16, device=dev, seed=0)
    tokens = torch.from_numpy(np.random.default_rng(43).integers(
        0, cfg.vocab_size, (PIPE_BATCH, PIPE_SEQ))).to(dev)
    pos = torch.arange(PIPE_SEQ, device=dev)
    half = cfg.n_layers // PIPE_STAGES
    stages = [model.layers[i * half:(i + 1) * half]
              for i in range(PIPE_STAGES)]

    def stage_fn(layers, h):
        for block in layers:
            h = model._apply_sublayer(block, h, positions=pos)[0]
        return h

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with torch.no_grad():
        x = model._embed(tokens)
        micro = x.reshape(PIPE_MICRO, PIPE_BATCH // PIPE_MICRO, PIPE_SEQ,
                          cfg.d_model)

        def seq():
            return torch.stack([stage_fn(model.layers, m) for m in micro])

        def pipe():
            return pipelined_apply(["cuda:0"] * PIPE_STAGES, stage_fn,
                                   stages, micro)

        seq()                                    # warm-up
        want, t_seq = timed(seq)
        ops.reset_launch_counts()
        got, t_pipe = timed(pipe)
        launches = ops.launch_counts()["flash_attention"]
        _, t_pipe2 = timed(pipe)
        _, t_seq2 = timed(seq)
    equal = torch.equal(got, want)
    print(f"dist (b): pipelined_apply over cuda:0 x {PIPE_STAGES} (stages of "
          f"{half} layers), {PIPE_MICRO} microbatches of "
          f"{PIPE_BATCH // PIPE_MICRO} x {PIPE_SEQ} tokens: torch.equal to "
          f"the layers in sequence: {equal}; flash launches {launches}; "
          f"wall s sequential {t_seq}, {t_seq2}, pipelined {t_pipe}, "
          f"{t_pipe2} (S stages on one card: no overlap); {card}", flush=True)
    if not equal or launches != cfg.n_layers * PIPE_MICRO:
        fail(f"the pipeline differs from sequential application or launched "
             f"flash {launches} times")
    return launches


def dist_snn_shards(card: str) -> dict:
    """Phase 14 (c): one device's shards of the dry run's SNN deployment
    on the (32, 8) mesh, on the card: each equal to its plain version,
    timed against its bound.  Returns their launches."""
    from repro_torch.launch import dryrun_snn

    run = dryrun_snn.run_shard(False, "cuda")
    for kind in ("infer", "train"):
        r = run[kind]
        print(f"dist (c): dryrun_snn {kind} shard ({run['neurons']} neurons, "
              f"{run['samples'] if kind == 'infer' else dryrun_snn.STREAM} "
              f"samples, T {dryrun_snn.T}, {dryrun_snn.N_INPUTS} inputs): "
              f"equal to its plain version {r['equal']}; launches "
              f"{r['launches']}; ms {r['ms']} against bound {r['bound_ms']} "
              f"({r['bound_by']}), plain ms {r['plain_ms']}; {card}",
              flush=True)
    if "infer_window_batch" not in run["infer"]["launches"] \
            or not run["train"]["launches"]:
        fail(f"the SNN shards did not launch their kernels: {run}")
    launches = dict(run["infer"]["launches"])
    for k, v in run["train"]["launches"].items():
        launches[k] = launches.get(k, 0) + v
    return launches


def phase_distributed(card: str) -> dict:
    """Phase 14: (d) the dry runs on the host first (fake groups), then (a)
    the sharded program on a one-rank NCCL group, (b) the pipeline, (c)
    the SNN shards.  Returns every kernel's launches in (a)-(c)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    t_phase = time.perf_counter()
    dry11 = dist_dryruns(card)
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
        world_size=1, device_id=torch.device("cuda:0"))
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        print("dist (a): a process group of one rank over NCCL on cuda:0, "
              "a (data 1, model 1) DeviceMesh. NCCL puts no two ranks of one "
              "communicator on one card, so a multi-rank run waits for the "
              "four-card machine (torchrun --nproc-per-node 4, one rank a "
              "card)", flush=True)
        flash = dist_sharded_serving(mesh, card)
        torch.cuda.empty_cache()
        dist_sharded_training(mesh, dry11, card)
        torch.cuda.empty_cache()
        flash += dist_tp_families(mesh, card)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    flash += dist_pipeline(card)
    torch.cuda.empty_cache()
    launches = dist_snn_shards(card)
    launches["flash_attention"] = flash
    print(f"dist: launches {launches}; phase wall "
          f"{time.perf_counter() - t_phase} s", flush=True)
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
    for source in ("snn_infer", "snn_train", "snn_step", "flash_attn",
                   "decode_attn"):
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
    decode = phase_decode_kernel()
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

    # phase 12: the LM families (MoE, Mamba hybrid, RWKV6, enc-dec,
    # vision prefix) at full width, depth cut
    family_launches, family_by_model = phase_lm_families()

    # phase 13: LM training (gemma3-1b at full width, the recovery, the
    # trained weights served, every family reduced, the flash guard)
    train_flash = phase_lm_train()

    # phase 14: the distribution side (the dry runs, the sharded program
    # on one card, the pipeline, the SNN deployment's shards)
    dist_launches = phase_distributed(card)

    # phase 15: the kernels' JSON line, then the last line

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
        entry["lm_family_launches"] = family_launches.get(kname, 0)
        entry["distributed_launches"] = dist_launches.get(kname, 0)
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
            "lm_family_launches": family_launches.get(kname, 0),
            "distributed_launches": dist_launches.get(kname, 0),
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
        "lm_family_launches": family_launches["flash_attention"],
        "lm_family_launches_by_model": family_by_model,
        "distributed_launches": dist_launches["flash_attention"],
        **train_flash,
        "max_abs_err": max(t["max_abs_err"] for t in flash.values()),
        **{k: main_t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")},
        "shape": "gemma-global-bf16",
        **{shape: t for shape, t in flash.items()
           if shape != "gemma-global-bf16"}})
    kernels.append({
        "name": "decode_attention", "route": "cuda", "source": DECODE_SOURCE,
        "replaces": None,
        "launches": lm_launches["decode_attention"],
        "lm_family_launches": family_launches["decode_attention"],
        "distributed_launches": dist_launches.get("decode_attention", 0),
        "max_abs_err": max(t["max_abs_err"] for t in decode.values()),
        **{k: decode["longgen"][k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")},
        "shape": "longgen",
        **{shape: t for shape, t in decode.items() if shape != "longgen"}})
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
