"""Dry run of the paper's own workload at production scale, and one
device's shard of it run on the card.

The port of the JAX package's ``launch/dryrun_snn.py``: a 4,096-neuron
active-learning ensemble (102 x the paper's 40-neuron network)
classifying a 4,096-sample batch (72 cycles each), and an online-STDP
training stream of 8 samples a step, sharded population x batch over
the H100 production meshes (neurons -> model, batch -> data and pod;
every neuron row is independent, so population parallelism is exact).
One device's shard is neurons / model x batch / (pod x data): 512
neurons x 128 samples on (32, 8), 512 x 64 on (2, 32, 8).

Two variants quantify the paper's central design choice:

  packed   (this work): 1-bit synapses in 32-bit words, AND + popcount
  unpacked (naive port): 0/1 weights as int8, counts as int32 products

For each mesh, kind and variant it records the shard's analytic
per-device bytes (``peak_bytes_per_device``, ``fits_80GB``) and the
roofline of the shard's step traced under ``launch.op_cost`` on ``meta``
tensors (the plain versions' eager ops: the packed step's AND +
popcount are integer ops with no FLOPs in PyTorch's counter; the
unpacked variant is traced, never run).  Where the JAX package
compiles, the port then runs one device's packed shard on ``--device``:
``core.network.infer_batch`` (the pre-packed serving kernel,
``infer_window_batch``) and ``core.network.train_stream`` (one window
launch a sample; the kernel it reaches is printed from the launch
counts), each held equal to its plain version on the same device and,
on a card, timed (CUDA events) against its bound: the bytes each input
and output must cross HBM once against the integer work these inputs
need, the model of ``chip_smoke.py``'s ``bound`` and ``train_bound``.

Usage:  python -m repro_torch.launch.dryrun_snn [--mesh pod|multipod|both]
            [--device cuda|cpu] [--neurons N --batch B] [--out PATH]
"""

from __future__ import annotations

import argparse
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.wenquxing_snn import WENQUXING_22A
from repro_torch.core.bitpack import n_words
from repro_torch.core.lif import lif_params
from repro_torch.core.stdp import stdp_params
from repro_torch.launch.dryrun import load_results, save_results
from repro_torch.launch.mesh import mesh_name, production_shape
from repro_torch.launch.op_cost import OpCost
from repro_torch.launch.roofline import HBM_BW, HBM_BYTES, Roofline

N_NEURONS = 4096
N_INPUTS = 784
BATCH = 4096
T = WENQUXING_22A.n_steps
STREAM = 8  # online-training samples a step

LIF = lif_params(WENQUXING_22A.threshold, WENQUXING_22A.leak)
STDP = stdp_params(N_INPUTS, WENQUXING_22A.w_exp, WENQUXING_22A.gain,
                   WENQUXING_22A.ltp_prob)

# integer rates per SM per clock for compute capability 9.0 (NVIDIA CUDA
# documentation, arithmetic instruction throughput), as chip_smoke.py
INT32_PER_SM_CLK = 64
POPC_PER_SM_CLK = 16
LIF_OPS = 4          # add, compare, subtract-max, count per neuron-cycle
SU_OPS = 30          # u32 operations of the STDP update of one word
TIME_REPS = 20


def shard(multi_pod: bool, neurons: int = N_NEURONS, batch: int = BATCH
          ) -> tuple[int, int, int]:
    """(neurons, samples, chips) of one device's shard."""
    dims, axes = production_shape(multi_pod)
    sizes = dict(zip(axes, dims))
    chips = int(np.prod(dims))
    dp = sizes["data"] * sizes.get("pod", 1)
    return neurons // sizes["model"], batch // dp, chips


# --- the shard's step on meta tensors (traced, never run) -------------------

def infer_unpacked(weights8: torch.Tensor, spikes8: torch.Tensor
                   ) -> torch.Tensor:
    """weights8 i8[N, n_in]; spikes8 i8[B, T, n_in] -> counts i32[B, N]:
    the dynamics of the packed path with the synaptic AND + count as a
    dense int32 product, what a port without the paper's bit-packing
    would do."""
    w = weights8.to(torch.int32)
    v = torch.zeros((spikes8.shape[0], w.shape[0]), dtype=torch.int32,
                    device=w.device)
    acc = torch.zeros_like(v)
    for t in range(spikes8.shape[1]):
        v2 = v + spikes8[:, t].to(torch.int32) @ w.T
        fired = v2 >= LIF.threshold
        v = torch.where(fired, 0, torch.clamp(v2 - LIF.leak, min=0))
        acc += fired.to(torch.int32)
    return acc


def _traced(kind: str, packed: bool, n: int, b: int) -> OpCost:
    from repro_torch.kernels.ref import (infer_window_batch_ref,
                                         train_window_batch_ref)

    w = n_words(N_INPUTS)
    meta = {"device": "meta"}
    cost = OpCost()
    if kind == "infer" and packed:
        args = (torch.empty((n, w), dtype=torch.int32, **meta),
                torch.empty((b, T, w), dtype=torch.int32, **meta))
        cost.track(args)
        with cost:
            infer_window_batch_ref(*args, LIF.threshold, LIF.leak)
    elif kind == "infer":
        args = (torch.empty((n, N_INPUTS), dtype=torch.int8, **meta),
                torch.empty((b, T, N_INPUTS), dtype=torch.int8, **meta))
        cost.track(args)
        with cost:
            infer_unpacked(*args)
    else:
        # one sample's window: every sample of the stream runs the same
        # ops on the same shapes (lower_snn scales the counts)
        args = [torch.empty(shape, dtype=torch.int32, **meta) for shape in
                ((1, n, w), (1, T, w), (1, n), (1, n, w), (1, n))]
        cost.track(args)
        with cost:
            train_window_batch_ref(*args, LIF.threshold, LIF.leak,
                                   STDP.w_exp, STDP.gain, STDP.n_syn,
                                   STDP.ltp_prob)
    return cost


def shard_bytes(kind: str, packed: bool, n: int, b: int) -> int:
    """Analytic per-device bytes of the shard's operands and results."""
    w = n_words(N_INPUTS)
    if kind == "train":
        return 2 * n * w * 4 + STREAM * (T * w + 2 * n) * 4 + n * 4
    if packed:
        return n * w * 4 + b * T * w * 4 + b * n * 4
    return n * N_INPUTS + b * T * N_INPUTS + b * n * 4


def lower_snn(kind: str, multi_pod: bool, packed: bool,
              neurons: int = N_NEURONS, batch: int = BATCH) -> dict:
    n, b, chips = shard(multi_pod, neurons, batch)
    t0 = time.perf_counter()
    cost = _traced(kind, packed, n, b)
    dt = time.perf_counter() - t0
    peak = shard_bytes(kind, packed, n, b)
    reps = STREAM if kind == "train" else 1
    rl = Roofline(flops=reps * cost.flops, bytes_hbm=reps * cost.bytes,
                  bytes_collective=0.0, coll_breakdown={}, chips=chips)
    return {
        "arch": f"wenquxing-22a-x{neurons // WENQUXING_22A.n_neurons}",
        "shape": f"snn_{kind}", "mesh": mesh_name(multi_pod),
        "chips": chips, "status": "ok", "trace_s": round(dt, 2),
        "variant": "packed" if packed else "unpacked",
        "shard": {"neurons": n, "samples": b if kind == "infer" else STREAM},
        "peak_bytes_per_device": peak,
        "traced_peak_bytes": cost.peak,
        "fits_80GB": bool(peak < HBM_BYTES),
        "roofline": rl.summary(),
    }


# --- one device's shard run ---------------------------------------------------

def _rates() -> tuple[float, float]:
    """(int32 results/s, popcounts/s) of the card: the SM count and the
    maximum SM clock (``nvidia-smi``)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=30).stdout.split()[0])
    per_s = sms * mhz * 1e6
    return INT32_PER_SM_CLK * per_s, POPC_PER_SM_CLK * per_s


def _bound(moved: float, ints: float, popc: float) -> tuple[float, str]:
    int_s, popc_s = _rates()
    t_bytes = moved / HBM_BW
    t_ops = max(ints / int_s, popc / popc_s)
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))


def infer_bound(n: int, b: int) -> tuple[float, str]:
    """The serving bound of ``chip_smoke.py`` (pre-packed, every cycle
    of every sample active), in ms."""
    w = n_words(N_INPUTS)
    moved = n * w * 4 + b * T * w * 4 + b * n * 4
    popc = b * T * n * w
    t, by = _bound(moved, 2 * popc + b * T * n * LIF_OPS, popc)
    return 1e3 * t, by


def train_bound(n: int, samples: int, fired: int) -> tuple[float, str]:
    """``chip_smoke.py``'s ``train_bound`` of one training window (one
    stream, pre-packed) summed over the samples, ``fired`` (row, cycle)
    pairs in all, in ms."""
    w = n_words(N_INPUTS)
    moved = samples * (4 * n * w * 4 + T * w * 4 + 3 * n * 4 + T * n + 4)
    popc = samples * T * n * w + fired * w
    ints = (2 * samples * T * n * w + samples * T * n * (LIF_OPS + 1)
            + fired * w * SU_OPS)
    t, by = _bound(moved, ints, popc)
    return 1e3 * t, by


def _event_ms(fn, reps: int = TIME_REPS) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def shard_operands(n: int, b: int, device, seed: int = 0) -> dict:
    """One device's shard: ~50%-dense weights of ``n`` neurons, the
    host-encoded windows of ``b`` procedural digits (and of the stream's
    ``STREAM``), the teacher currents of the stream, on ``device``."""
    from repro_torch.core.encoder import (encode_windows_host,
                                          quantize_intensities, sample_seeds)
    from repro_torch.core.rvsnn import snn_regfile
    from repro_torch.core.stdp import init_weights
    from repro_torch.data.digits import make_digits

    x, labels = make_digits(b + STREAM, seed=seed)
    wins = encode_windows_host(sample_seeds(0x22A, b + STREAM),
                               quantize_intensities(x), T,
                               n_words(N_INPUTS)).to(device)
    weights = init_weights(n, n_words(N_INPUTS), density_seed=seed,
                           dense=False, device=device)
    classes = torch.arange(n, device=device) % 10
    lab = torch.as_tensor(labels[b:], device=device)
    teach = torch.where(classes[None] == lab[:, None],
                        WENQUXING_22A.teach_pos,
                        WENQUXING_22A.teach_neg).to(torch.int32)
    return {"weights": weights, "trains": wins[:b],
            "stream": wins[b:], "teach": teach,
            "rf": snn_regfile(weights.clone(), seed=0x22A)}


def run_shard(multi_pod: bool, device: str, neurons: int = N_NEURONS,
              batch: int = BATCH) -> dict:
    """One device's packed shard run on ``device``: inference and the
    training stream, each equal to its plain version (raises if not),
    with its launches and, on a card, its time and bound."""
    from repro_torch.core.network import infer_batch, train_stream
    from repro_torch.kernels import ops

    n, b, _ = shard(multi_pod, neurons, batch)
    dev = torch.device(device)
    o = shard_operands(n, b, dev)
    out = {"device": device, "neurons": n, "samples": b}

    ops.reset_launch_counts()
    counts = infer_batch(o["weights"], o["trains"], LIF)
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    plain = infer_batch(o["weights"], o["trains"], LIF, kernel_backend="ref")
    if not torch.equal(counts, plain):
        raise AssertionError("the infer shard differs from its plain version")
    inf = {"launches": launches, "equal": True}
    if dev.type == "cuda":
        inf["ms"] = _event_ms(lambda: infer_batch(o["weights"], o["trains"],
                                                  LIF))
        inf["plain_ms"] = _event_ms(lambda: infer_batch(
            o["weights"], o["trains"], LIF, kernel_backend="ref"), 3)
        inf["bound_ms"], inf["bound_by"] = infer_bound(n, b)
    out["infer"] = inf

    ops.reset_launch_counts()
    rf, tcounts = train_stream(o["rf"], o["stream"], o["teach"], LIF, STDP)
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    rf_p, tcounts_p = train_stream(o["rf"], o["stream"], o["teach"], LIF,
                                   STDP, kernel_backend="ref")
    if not (torch.equal(tcounts, tcounts_p)
            and torch.equal(rf.weights, rf_p.weights)
            and torch.equal(rf.lfsr, rf_p.lfsr)):
        raise AssertionError("the train shard differs from its plain version")
    tr = {"launches": launches, "equal": True,
          "kernel": ", ".join(sorted(launches)) or "plain"}
    if dev.type == "cuda":
        tr["ms"] = _event_ms(lambda: train_stream(
            o["rf"], o["stream"], o["teach"], LIF, STDP))
        tr["plain_ms"] = _event_ms(lambda: train_stream(
            o["rf"], o["stream"], o["teach"], LIF, STDP,
            kernel_backend="ref"), 3)
        tr["bound_ms"], tr["bound_by"] = train_bound(
            n, STREAM, int(tcounts.sum()))
    out["train"] = tr
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--device", default="cuda",
                    help="where one device's shard runs (cuda needs a card;"
                         " cpu runs the plain versions)")
    ap.add_argument("--neurons", type=int, default=N_NEURONS)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--out", default="build/dryrun_results.json")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("dryrun_snn: --device cuda needs a CUDA card")
    out = Path(args.out)
    results = load_results(out)
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    for mp in meshes:
        for kind in ("infer", "train"):
            for packed in ((True, False) if kind == "infer" else (True,)):
                res = lower_snn(kind, mp, packed, args.neurons, args.batch)
                key = (f"{res['arch']}|snn_{kind}|{mesh_name(mp)}"
                       f"{'' if packed else '#unpacked'}")
                rl = res["roofline"]
                print(f"[cell] {key}: shard {res['shard']} "
                      f"t_c={rl['t_compute_s']:.3g} t_m={rl['t_memory_s']:.3g}"
                      f" dom={rl['dominant']} peak="
                      f"{res['peak_bytes_per_device'] / 1e6:.3f}MB "
                      f"fits_80GB={res['fits_80GB']}", flush=True)
                results[key] = res
        run = run_shard(mp, args.device, args.neurons, args.batch)
        key = f"{res['arch']}|snn_run|{mesh_name(mp)}"
        print(f"[run] {key} on {args.device}: infer {run['infer']}; train "
              f"{run['train']} (kernel: {run['train']['kernel']})",
              flush=True)
        results[key] = run
        save_results(out, results)


if __name__ == "__main__":
    main()
