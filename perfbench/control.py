"""The readings that a cell's check limits are set from.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 \
        --seconds 50

In one process, for each seed: the model built with the seed's weights,
the cell's traffic served for ``--seconds`` at its own load (the
harness's loop, with the run's logits kept as a run keeps them), the
model freed, then the check's sample through the harness's own
comparison (:func:`perfbench.harness.verify`) twice:

* ``program``: the program's served tokens and kept logits;
* ``control``: the reference computed in float8 e4m3 put in the
  program's place: at each served position the token it ranks first,
  and its logits at the positions the run kept.

Each gives the numbers compared, beside the cell's limits, and
``correct``.  Besides, ``witness_bf16``: the reference computed in bf16
(a witness that only rounds) through the same comparison, with the
share of served positions whose experts differ from the float32
reference's in some layer, overall and among the witness's gaps above
0.1: what rounding alone does through the routes.  And what the
capacity rule did while serving: the pairs dropped in the prefills, and
in the decode steps the slots that lost a pair (a step is one MoE call
over every slot).  One JSON line a seed.  The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed, log, capture, device) -> dict:
    """The program's, the control's and the witness's numbers through
    ``harness.verify``, each with its ``correct``."""
    import torch

    from perfbench import checks, harness

    memo: dict = {}

    def reference(dims, seed_, flights, device_):
        if "f32" not in memo:
            memo["flights"] = flights
            memo["routes"] = []
            memo["f32"] = checks.reference_logits(
                dims, seed_, flights, device_, routes=memo["routes"])
        return memo["f32"]

    def lower(precision, routes=None):
        def served(flights):
            low = checks.reference_logits(cell.dims, seed, flights, device,
                                          precision, routes)
            memo[precision] = low
            tokens = [lg.argmax(-1) for lg in low]
            rows = [{p: lg[p] for p in capture.of(f.spec.index)}
                    for f, lg in zip(flights, low)]
            return tokens, rows
        return served

    def through(served=None):
        ok, shown = harness.verify(cell, log, seed, device, capture,
                                   say=lambda *_: None, served=served,
                                   reference=reference)
        return {"correct": ok, **{k: v["value"] for k, v in shown.items()}}

    out = {"program": through(), "control": through(lower("float8"))}
    r16: list = []
    out["witness_bf16"] = through(lower("bfloat16", r16))
    r32, flights = memo["routes"], memo["flights"]
    flipped = torch.zeros(r32[0].shape[0], dtype=torch.bool, device=device)
    for a, b in zip(r32, r16):
        flipped |= (a.sort(-1).values != b.sort(-1).values).any(-1)
    flips, big, start = [], [], 0
    for f, ref, w in zip(flights, memo["f32"], memo["bfloat16"]):
        n = len(f.spec.tokens) + len(f.req.output) - 1
        flips.append(flipped[start + len(f.spec.tokens) - 1:start + n])
        big.append(ref.amax(-1) - ref.gather(-1, w.argmax(-1)[:, None])[:, 0]
                   > 0.1)
        start += n
    fl, bg = torch.cat(flips), torch.cat(big)
    out["witness_route_flipped_share"] = float(fl.float().mean())
    out["witness_big_gaps_flipped_share"] = (
        float(fl[bg].float().mean()) if bool(bg.any()) else None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from perfbench import harness, traffic
    from perfbench.capture import Capture
    from repro_torch.models.layers import moe

    device = torch.device("cuda", 0)
    cell = harness.find(ROOT, args.workload)
    params, dims = cell.traffic, cell.dims
    seeds = [int(s) for s in args.seeds.split(",")]
    print(f"card: {harness.card_info()}", flush=True)

    n_slots = params["n_slots"]
    seen: list = []
    orig = moe.slots

    def counted(idx, n_experts):
        onehot, pos = orig(idx, n_experts)
        n = idx.shape[0]
        seen.append((n, (pos >= dims.capacity(n))))
        return onehot, pos

    for seed in seeds:
        t = time.perf_counter()
        tr = traffic.Traffic(params, seed, dims.vocab, args.seconds)
        model = harness.build_model(cell, seed, device)
        if seed == seeds[0]:
            harness.warm_up(model, params, tr)
        seen.clear()
        moe.slots = counted
        engine = harness.engine_for(model, params)
        capture = Capture(seed, cell.check["keep_every"])
        capture.install(engine)
        log = harness.drive(engine, tr, params, args.seconds,
                            capture=capture)
        capture.uninstall()
        moe.slots = orig
        del engine, model
        torch.cuda.synchronize()
        by_slot = torch.zeros(n_slots, dtype=torch.int64, device=device)
        pre_drop = pre_pairs = steps = 0
        for n, dropped in seen:
            if n == n_slots:
                by_slot += dropped.any(dim=1).long()
                steps += 1
            else:
                pre_drop += int(dropped.sum())
                pre_pairs += dropped.numel()
        seen.clear()
        torch.cuda.empty_cache()
        line = {"seed": seed,
                "finished": sum(1 for f in log.flights if f.req.done),
                "decode_steps": steps // dims.n_layers,
                "decode_slot_drops": by_slot.tolist(),
                "prefill_dropped_share": pre_drop / max(pre_pairs, 1)}
        line.update(readings(cell, seed, log, capture, device))
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
