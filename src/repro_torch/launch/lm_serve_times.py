"""Time the LM serving workload of ``chip_smoke.py``'s phase 9b.

    python src/repro_torch/launch/lm_serve_times.py [--device cuda] \\
        [--reduced] [--repeat 3]

gemma3-1b at full width in bfloat16 (``--reduced``: its reduced config
in float32, for a check on the CPU), random weights from seed 0, served
by :class:`~repro_torch.serving.ServingEngine` on 4 slots (max_len
4,096): phase 9b's eight prompts (37 to 2,048 tokens), 32 new tokens
each.  Every ``Model.prefill`` and ``Model.decode_step`` call is timed on
the host's clock around work that ends in a synchronize.  Prints one
JSON line: the package's path, the decode step ms (median and min of the
steps after the first, per repeat), the prefill ms by prompt length, and
``Model.decode_step`` alone at B 4 over a 2,048-token cache (median ms
of 64 steps, per repeat).

It imports only what every tree of the port since its LM slice has
(``Model``, ``ServingEngine``, ``Request``, ``get_config``), and runs
from its file path: with another tree's ``src`` first on ``PYTHONPATH``
it times that tree's package, so one call on the card can time two
trees in turn (parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

PROMPTS = (37, 300, 511, 512, 513, 1000, 1536, 2048)
NEW_TOKENS = 32
SLOTS, MAX_LEN = 4, 4096
BARE_STEPS, BARE_CACHE = 64, 2048


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def serve_once(model, dev, cfg) -> tuple[list, dict]:
    """(decode step ms, prefill ms by prompt length) of one engine run."""
    from repro_torch.serving import Request, ServingEngine

    prefill_ms, decode_ms = {}, []

    def timed(fn, record):
        def call(*args, **kwargs):
            _sync(dev)
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync(dev)
            record(args, 1e3 * (time.perf_counter() - t))
            return out
        return call

    model.prefill = timed(model.prefill, lambda a, ms: prefill_ms.__setitem__(
        int(a[0].shape[1]), ms))
    model.decode_step = timed(model.decode_step,
                              lambda a, ms: decode_ms.append(ms))
    try:
        rng = np.random.default_rng(14)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
                   for n in PROMPTS]
        reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
                for i, p in enumerate(prompts)]
        ServingEngine(model, n_slots=SLOTS, max_len=MAX_LEN).run(reqs)
    finally:
        del model.prefill, model.decode_step
    if not all(r.done and len(r.output) == NEW_TOKENS for r in reqs):
        raise SystemExit("a request did not finish")
    return decode_ms, prefill_ms


def bare_decode(model, dev, cfg) -> float:
    """Median ms of ``Model.decode_step`` at B 4 over a cache of
    ``BARE_CACHE`` tokens (written by one prefill)."""
    rng = np.random.default_rng(15)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (SLOTS, BARE_CACHE))).to(dev)
    _, cache, n = model.prefill(toks, BARE_CACHE + BARE_STEPS + 1)
    tok = toks[:, -1:]
    times = []
    for i in range(BARE_STEPS):
        _sync(dev)
        t = time.perf_counter()
        logits, cache = model.decode_step(tok, cache, n + i)
        _sync(dev)
        times.append(1e3 * (time.perf_counter() - t))
        tok = logits.argmax(-1, keepdim=True)
    return statistics.median(times[1:])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args(argv)

    import repro_torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.transformer import Model

    dev = torch.device(args.device)
    cfg = get_config("gemma3-1b")
    dtype = torch.bfloat16
    if args.reduced:
        cfg, dtype = reduced(cfg), torch.float32
    model = Model(cfg, dtype, device=dev, seed=0)
    serve_once(model, dev, cfg)  # warm-up: cuBLAS handles, allocator
    runs = []
    for _ in range(args.repeat):
        decode_ms, prefill_ms = serve_once(model, dev, cfg)
        bare = bare_decode(model, dev, cfg)
        rest = decode_ms[1:]
        runs.append({"decode_median_ms": statistics.median(rest),
                     "decode_min_ms": min(rest), "decode_steps": len(rest),
                     "prefill_ms": prefill_ms, "bare_decode_median_ms": bare})
    print(json.dumps({"package": repro_torch.__file__, "arch": cfg.name,
                      "device": str(dev), "runs": runs}), flush=True)


if __name__ == "__main__":
    main()
