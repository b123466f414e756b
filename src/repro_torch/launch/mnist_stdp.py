"""The paper's experiment on the port: online STDP training, then test.

    python -m repro_torch.launch.mnist_stdp [--neurons 40] [--wexp 128] \\
        [--train 2000] [--test 1000] [--epochs 2] [--seed 1] \\
        [--train-mode active|parallel] [--cycle-backend window|step] \\
        [--encode host|kernel] [--device cuda|cpu]

Procedural digits (the offline MNIST substitute) -> deskew + soft
threshold -> supervised binary stochastic STDP (active learning, or all
blocks in parallel) -> test-set classification through the engine's
``infer`` verb.  ``--cycle-backend window`` presents each epoch in one
stream-kernel launch (``--encode kernel``) or each sample in one
window-kernel launch (``--encode host``), ``step`` cycle by cycle (one
fused RV-SNN step launch per cycle, replayed from a CUDA graph per
window on a card; the spikes are then encoded on the host).  Prints the
accuracy, the training rate in presented samples per second, and the
kernels' launch counts.  Runs on the card unless ``--device cpu`` asks
for the plain versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.wenquxing_snn import WENQUXING_22A
from repro_torch.core.bitpack import unpack
from repro_torch.core.encoder import (poisson_encode_batch,
                                      quantize_intensities, sample_seeds)
from repro_torch.core.preprocess import preprocess_batch
from repro_torch.core.trainer import accuracy, train
from repro_torch.data.digits import make_digits
from repro_torch.engine import resolve_device
from repro_torch.kernels import ops


def preprocessed_digits(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``n`` procedural digits, deskewed and soft-thresholded on the
    host: (float32[n, 784] in [0, 1], labels int32[n])."""
    imgs, labels = make_digits(n, seed=seed)
    x = preprocess_batch(torch.from_numpy(imgs.reshape(-1, 28, 28)), 0.1)
    return x.reshape(n, -1).numpy(), labels


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--neurons", type=int, default=40,
                    choices=[10, 20, 30, 40])
    ap.add_argument("--wexp", type=int, default=128)
    ap.add_argument("--train", type=int, default=2000)
    ap.add_argument("--test", type=int, default=1000)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--train-mode", default="active",
                    choices=["active", "parallel"],
                    help="active = sequential error-driven blocks, "
                         "parallel = all blocks in one batched launch")
    ap.add_argument("--cycle-backend", default="window",
                    choices=["window", "step"],
                    help="window = one window-kernel launch per "
                         "presentation (one per epoch with --encode "
                         "kernel), step = one fused step launch per cycle")
    ap.add_argument("--encode", default=None, choices=["host", "kernel"],
                    help="kernel = keep uint8 intensities and draw spikes "
                         "in the kernel; host = pre-encode the set "
                         "(default: kernel on the window path, host on "
                         "the step path, which takes no in-kernel draw)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda needs a card; cpu runs the "
                         "plain versions)")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    if args.encode is None:
        args.encode = "kernel" if args.cycle_backend == "window" else "host"

    tr, labels = preprocessed_digits(args.train, args.seed)
    te, tlabels = preprocessed_digits(args.test, args.seed + 1)
    cfg = dataclasses.replace(WENQUXING_22A, n_neurons=args.neurons,
                              w_exp=args.wexp, epochs=args.epochs,
                              train_mode=args.train_mode,
                              cycle_backend=args.cycle_backend,
                              encode=args.encode)
    print(f"training 784-{args.neurons} (w_exp={args.wexp}, "
          f"{args.epochs} epochs, {args.train} samples, "
          f"{args.train_mode}/{args.cycle_backend}/{args.encode}, "
          f"device={dev}) ...", flush=True)
    if dev.type == "cuda":
        # build the kernels and start the device before the clock does
        ops.load_kernels()
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    model = train(cfg, tr, labels, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    print(f"  trained in {seconds:.3f} s, "
          f"{args.train * args.epochs / seconds:.1f} samples/s "
          f"({args.train} samples x {args.epochs} epochs); kernel "
          f"launches {ops.launch_counts()}")

    if args.encode == "kernel":
        # the test set stays intensity-resident too, with counter seeds
        # disjoint from the training chain
        acc = accuracy(model, labels=tlabels,
                       intensities=quantize_intensities(te).to(dev),
                       seeds=sample_seeds(0x7E57, len(te)))
    else:
        g = torch.Generator().manual_seed(99)
        acc = accuracy(model, poisson_encode_batch(g, te, cfg.n_steps)
                       .to(dev), tlabels)
    print(f"test accuracy: {acc:.4f}  (paper, real MNIST @40: 0.9191; "
          f"chance: 0.10)")
    print(f"cycle backend {args.cycle_backend}; kernel launches with the "
          f"test set {ops.launch_counts()}")
    on = unpack(model.weights.cpu(), 784).sum(dim=1).to(torch.float32)
    print(f"effective synapses per neuron: mean={float(on.mean()):.0f} "
          f"(w_exp budget = {args.wexp})")


if __name__ == "__main__":
    main()
