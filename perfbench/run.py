"""Run one cell of the port's benchmark on this machine's card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Prints, last on standard output, one JSON
line: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and last ``checks``, each number the check compared beside
its limit (also the last lines on standard error).  Exits with 1, and
prints no result, where there is no card or fewer than the cell asks
for, where the port's sources are missing, or where JAX or the JAX
package was loaded.  Builds and caches stay inside the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    build = ROOT / "build"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(build / sub)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no port under {ROOT / 'src'}: nothing to measure",
              file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from perfbench import harness

    chips = harness.find(ROOT, args.workload).entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    result = harness.run(ROOT, args.workload, args.seed, args.seconds,
                         bool(args.trace), torch.device("cuda", 0),
                         T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the process holds {bad} after the window: no result",
              file=sys.stderr)
        return 1
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
