"""Find an open-loop cell's knee: the highest rate it sustains.

    python3 perfbench/sweep.py --workload <cell> --seed 7 --seconds 40 \
        --rates 3,4,5,6

One process, one model: for each rate the cell's traffic at that rate
for ``--seconds``, stopped at the window's close.  A line a rate: the
requests due, the share that had their first token by the close, the
backlog (due, no first token) at the middle and at the close, the time
to the first token (median and 95th percentile) of the requests due in
each half, the output tokens a second, and the slots in use (mean over
the window, from each request's first to its last token, and the most
at once).  A backlog that grows from the middle to the close, or a
second half's tail far above the first's, is a rate past the knee.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import numpy as np
    import torch

    from perfbench import harness, traffic

    device = torch.device("cuda", 0)
    cell = harness.find(ROOT, args.workload)
    print(f"card: {harness.card_info()}", flush=True)
    model = harness.build_model(cell, args.seed, device)
    base = dict(cell.traffic, drain_s=0.0)
    harness.warm_up(model, base,
                    traffic.Traffic(base, args.seed, cell.dims.vocab,
                                    args.seconds))
    for rate in (float(r) for r in args.rates.split(",")):
        params = dict(base, arrivals={"process": "poisson",
                                      "rate_rps": rate})
        engine = harness.engine_for(model, params)
        log = harness.drive(engine, traffic.Traffic(params, args.seed,
                                                    cell.dims.vocab,
                                                    args.seconds),
                            params, args.seconds)
        del engine
        t0, mid, close = log.t0, log.t0 + args.seconds / 2, log.t_close
        due = [f for f in log.flights if f.t_due < close]

        def backlog(at):
            return sum(1 for f in due if f.t_due < at
                       and not (f.times and f.times[0] <= at))

        def ttft(lo, hi):
            v = [f.times[0] - f.t_due for f in due
                 if lo <= f.t_due < hi and f.times]
            return ([float(np.percentile(v, q)) for q in (50, 95)]
                    if v else None)

        toks = sum(1 for f in log.flights for t in f.times if t0 < t <= close)
        spans = [(max(f.times[0], t0), min(f.times[-1], close))
                 for f in log.flights if f.times]
        ends = sorted([(a, 1) for a, b in spans if a < b]
                      + [(b, -1) for a, b in spans if a < b])
        live = np.cumsum([d for _, d in ends]) if ends else [0]
        print(json.dumps({
            "rate": rate, "due": len(due),
            "first_token_share": sum(1 for f in due if f.times) / len(due),
            "backlog_mid": backlog(mid), "backlog_close": backlog(close),
            "ttft_first_half": ttft(t0, mid),
            "ttft_second_half": ttft(mid, close),
            "output_tokens_per_s": toks / (close - t0),
            "slots_mean": sum(b - a for a, b in spans if a < b)
            / (close - t0),
            "slots_most": int(max(live)),
            "n_slots": params["n_slots"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
