"""Serve a small LM with continuous batching.

    python -m repro_torch.launch.serve_lm [--arch starcoder2-3b] \\
        [--slots 4] [--requests 10] [--max-new 16] [--temperature 0.0] \\
        [--device cpu]

The port's counterpart of ``examples/serve_lm.py``, with its flags and
defaults: the arch at its reduced size in float32, random weights from
a seed, ragged random prompts (3 to 11 tokens), greedy or temperature
sampling through :class:`ServingEngine` (prefill/decode split, per-slot
cache lengths, slot reuse).  The engine serves decoder-only archs
(dense, MoE, SSM, hybrid); ``launch/serve.py`` drives whisper and
internvl2.  Runs on ``--device`` (``cuda`` unless ``cpu`` asks for the
plain versions); exits nonzero if a request did not finish.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_configs, reduced
from repro_torch.models.transformer import Model
from repro_torch.serving import Request, ServingEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="starcoder2-3b", choices=list_configs())
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda needs a card; cpu runs the "
                         "plain versions)")
    args = ap.parse_args(argv)

    cfg = reduced(get_config(args.arch))
    if cfg.frontend is not None:
        sys.exit(f"{args.arch} takes a {cfg.frontend} front end, which the "
                 f"engine does not serve: use repro_torch.launch.serve")
    print(f"serving {cfg.name} ({cfg.n_params() / 1e6:.1f}M params, "
          f"{args.slots} slots)")
    model = Model(cfg, torch.float32, attn_chunk=16, device=args.device)
    eng = ServingEngine(model, n_slots=args.slots, max_len=128,
                        temperature=args.temperature)

    rng = np.random.default_rng(42)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(3, 12))
        prompt = rng.integers(1, cfg.vocab_size, plen).tolist()
        reqs.append(Request(rid=i, prompt=prompt,
                            max_new_tokens=args.max_new))

    t0 = time.time()
    eng.run(reqs, max_steps=2000)
    dt = time.time() - t0
    done = sum(r.done for r in reqs)
    print(f"completed {done}/{len(reqs)} requests in {dt:.1f}s "
          f"({eng.tokens_out} tokens, {eng.tokens_out / dt:.1f} tok/s, "
          f"{eng.steps} engine steps, device={model.device})")
    for r in reqs[:3]:
        print(f"  req {r.rid}: prompt={r.prompt[:6]}... "
              f"output={r.output}")
    sys.exit(int(done != len(reqs)))


if __name__ == "__main__":
    main()
