"""Quickstart: the paper's SNN on the port in a few lines.

    python -m repro_torch.launch.quickstart [--device cuda|cpu] \\
        [--train 800] [--test 200]

Trains the Wenquxing 22A network (784-10, 1-bit synapses, binary
stochastic STDP) for one epoch on procedural digits and prints its test
accuracy, then runs one fused RV-SNN step (``snn.step``, n = 40 neurons,
w = 25 words) through the CUDA kernel and through its plain PyTorch
version and prints whether they agree bit for bit.  Runs on the card
unless ``--device cpu`` asks for the plain versions (which then stand on
both sides of the check).
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs.wenquxing_snn import WENQUXING_22A
from repro_torch.core import lfsr
from repro_torch.core.bitpack import as_words
from repro_torch.core.encoder import poisson_encode_batch
from repro_torch.core.trainer import accuracy, train
from repro_torch.engine import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch.mnist_stdp import preprocessed_digits

# The fused step's operands and parameters (n neurons of w words).
STEP_N, STEP_W = 40, 25
STEP_PARAMS = dict(threshold=192, leak=16, w_exp=128, gain=4, n_syn=784,
                   ltp_prob=16)


def step_operands(device=None) -> tuple[torch.Tensor, ...]:
    """(weights, pre, v, lfsr, teach) of the fused-step check, from a
    seeded numpy generator: random u32 banks and spikes, v and teach 0,
    LFSR lanes from seed 1."""
    rng = np.random.default_rng(0)
    n, w = STEP_N, STEP_W
    weights = as_words(rng.integers(0, 2**32, (n, w), dtype=np.uint32))
    pre = as_words(rng.integers(0, 2**32, (w,), dtype=np.uint32))
    zeros = torch.zeros((n,), dtype=torch.int32)
    lanes = lfsr.seed(1, n * w).reshape(n, w)
    return tuple(t.to(device) for t in (weights, pre, zeros, lanes,
                                        zeros.clone()))


def fused_step_check(device) -> tuple[tuple, tuple, bool]:
    """One fused SNNU step on ``device`` through the kernel wrapper and
    through the plain version: (kernel outputs, plain outputs, equal)."""
    operands = step_operands(device)
    got = ops.fused_snn_step(*operands, **STEP_PARAMS)
    want = ops.fused_snn_step(*operands, backend="ref", **STEP_PARAMS)
    ok = all(a.dtype == b.dtype and torch.equal(a, b)
             for a, b in zip(got, want))
    return got, want, ok


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda needs a card; cpu runs the "
                         "plain versions)")
    ap.add_argument("--train", type=int, default=800)
    ap.add_argument("--test", type=int, default=200)
    args = ap.parse_args()
    dev = resolve_device(args.device)

    # --- train the paper's SNN on (the offline substitute for) MNIST ---
    x, labels = preprocessed_digits(args.train, seed=1)
    tx, tlabels = preprocessed_digits(args.test, seed=2)
    cfg = dataclasses.replace(WENQUXING_22A, n_neurons=10, epochs=1)
    model = train(cfg, x, labels, device=dev)
    st = poisson_encode_batch(torch.Generator().manual_seed(0),
                              torch.from_numpy(tx), cfg.n_steps).to(dev)
    print(f"784-10 SNN accuracy: {accuracy(model, st, tlabels):.3f}  "
          f"(chance = 0.10)")

    # --- one fused RV-SNN step: the kernel == its plain version --------
    before = ops.fused_snn_step.launches
    _, _, ok = fused_step_check(dev)
    launched = ops.fused_snn_step.launches - before
    where = (f"CUDA kernel, {launched} launch" if dev.type == "cuda"
             else "plain version on the CPU")
    print(f"fused RV-SNN step ({where}) bit-exact vs plain version: {ok}")


if __name__ == "__main__":
    main()
