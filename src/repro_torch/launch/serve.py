"""Serving demos on the port's engines.

    python -m repro_torch.launch.serve --arch wenquxing-snn [--device cpu]
    python -m repro_torch.launch.serve --arch gemma3-1b [--device cpu]
    python -m repro_torch.launch.serve --arch gemma3-1b --no-reduced

wenquxing-snn: intensity-resident digit requests with ragged window
lengths go through the dynamic-window-batching :class:`SNNServingEngine`;
every SERVED count vector is then checked against the plain version of
the pre-packed path on the host-encoded window.  Exits nonzero if a
request did not terminate or a count diverged.

An LM config: a few short prompts through the continuous-batching
:class:`ServingEngine`, greedy, with random weights from a seed.
``--reduced`` (the default) serves the config's reduced form in float32
(``attn_chunk=16``, ``max_len=128``), as the JAX launcher does;
``--no-reduced`` serves the full width in bfloat16.  Exits nonzero if a
request did not finish.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from collections import Counter

import numpy as np
import torch

from repro_torch.configs.base import get_config, list_configs, reduced
from repro_torch.configs.wenquxing_snn import WENQUXING_22A
from repro_torch.core.encoder import encode_windows_host, quantize_intensities
from repro_torch.core.stdp import init_weights
from repro_torch.data.digits import make_digits
from repro_torch.engine import plan_from_config
from repro_torch.kernels import ops
from repro_torch.models.transformer import Model
from repro_torch.serving import (Request, ServingEngine, SNNRequest,
                                 SNNServingEngine, SNNServingPolicy)

LM_NEW_TOKENS = 8       # tokens generated per LM request


def _serve_snn(args) -> int:
    """Serve ``--requests`` digits and check them; returns the exit code."""
    cfg = dataclasses.replace(WENQUXING_22A, n_steps=24,
                              encode=args.encode)
    plan = dataclasses.replace(plan_from_config(cfg),
                               max_batch=args.slots)
    weights = init_weights(cfg.n_neurons, cfg.words, dense=True)
    neuron_class = np.tile(np.arange(cfg.n_classes), cfg.n_blocks)
    imgs, _ = make_digits(args.requests, seed=0)
    inten = quantize_intensities(imgs).numpy()
    policy = SNNServingPolicy(max_retries=2, canary_every=2,
                              reprobe_after=4)
    reqs = [SNNRequest(rid=i, intensities=inten[i],
                       n_steps=cfg.n_steps - 4 * (i % 3))
            for i in range(args.requests)]
    eng = SNNServingEngine(weights, plan, neuron_class=neuron_class,
                           policy=policy, device=args.device)
    eng.run(reqs)
    print(f"wenquxing-snn: {sum(r.done for r in reqs)}/{len(reqs)} done, "
          f"{eng.windows_served} windows in {eng.batches} batches "
          f"(max_batch={plan.max_batch}, encode={plan.encode}, "
          f"device={eng.device})")
    by_status = Counter(r.status for r in reqs)
    non_terminal = sum(not r.terminal for r in reqs)
    print("statuses: " + " ".join(f"{k}={v}"
                                  for k, v in sorted(by_status.items()))
          + f" non-terminal={non_terminal}")
    served = [r for r in reqs if r.status == "SERVED"]
    bank = eng.weights.cpu()
    mismatches = 0
    for r in served:
        win = encode_windows_host(r.seed,
                                  torch.from_numpy(r.intensities)[None],
                                  r.n_steps, eng.words)
        want = ops.infer_window_batch(bank, win, threshold=plan.threshold,
                                      leak=plan.leak, backend="ref")[0]
        mismatches += int(not np.array_equal(r.counts, want.numpy()))
    print(f"oracle-check: {'ok' if mismatches == 0 else 'MISMATCH'} "
          f"({len(served)} served, {mismatches} diverged)")
    if args.bench:
        print("serve-bench: " + " ".join(
            f"{k}={'/'.join(map(str, v)) if isinstance(v, list) else v}"
            for k, v in sorted(eng.stats().items())))
    return int(bool(non_terminal or mismatches))


def _serve_lm(args) -> int:
    """Serve ``--requests`` short prompts; returns the exit code."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
        model = Model(cfg, torch.float32, attn_chunk=16, device=args.device)
    else:
        model = Model(cfg, device=args.device)
    ops.reset_launch_counts()
    eng = ServingEngine(model, n_slots=args.slots, max_len=128)
    reqs = [Request(rid=i, prompt=[1 + i, 2, 3],
                    max_new_tokens=LM_NEW_TOKENS)
            for i in range(args.requests)]
    eng.run(reqs, max_steps=2000)
    done = sum(r.done for r in reqs)
    print(f"{cfg.name}: {done}/{len(reqs)} done, {eng.tokens_out} tokens "
          f"(device={eng.device}, dtype={model.dtype}, flash_attention "
          f"launches {ops.launch_counts()['flash_attention']})")
    return int(done != len(reqs))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True,
                    choices=["wenquxing-snn"] + list_configs())
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--encode", default="kernel", choices=["host", "kernel"],
                    help="where the Poisson encode runs (wenquxing-snn)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda needs a card; cpu runs the "
                         "plain versions)")
    ap.add_argument("--bench", action="store_true",
                    help="print the serving stats after the run "
                         "(wenquxing-snn)")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the LM config's reduced form in float32 "
                         "(--no-reduced: full width in bfloat16)")
    args = ap.parse_args()
    if args.arch == "wenquxing-snn":
        sys.exit(_serve_snn(args))
    sys.exit(_serve_lm(args))


if __name__ == "__main__":
    main()
