"""The paper's evaluation on the port: one module per table or figure.

    python -m repro_torch.bench.run [module ...] [--json[=PATH]] \\
        [--device cuda|cpu] [--n-train N] [--n-test N] [--n-steps T] \\
        [--epochs E] [--neurons N]

Prints ``name,us_per_call,derived`` CSV rows (``common.emit``).

  table1_accuracy   Table 1  MNIST-recognition comparison row
  fig5_neurons      Fig. 5   CA vs {10,20,40} output neurons
  wexp_sweep        §3.3     w_exp {128,256,512} dead-neuron sweep
  fig4_energy       Fig. 4   modeled power, fused vs decoupled
  table2_resources  Table 2  state-footprint analogue of LUT/FF/BRAM

The paper-module part of the JAX package's ``benchmarks/run.py``.  Any
number of module names filters the run (none = all five).  With no
flags every module runs its JAX script's full setting on the card
(``--device cuda``); ``--device cpu`` runs the kernels' plain versions.
The size flags override every module that takes them (``--neurons``:
the population of Table 1, Fig. 4 and the w_exp sweep).  A row's timing
field is the wall time of its training (and test pass) on the device;
every energy, power and time of Fig. 4 is the FPGA model's.

``--json`` additionally writes every emitted row as JSON (name -> the
row's fields).  PATH defaults to ``bench_paper.json``; the ``=`` form
keeps the module filter unambiguous.  It never writes
``BENCH_kernels.json``, which holds the JAX package's CPU/XLA rows.
``benchmarks/run.py``'s ``--gate``, ``--history``, ``kernels_bench`` and
``loadgen_bench`` are not here yet: they come with the port's benchmark
harness.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import json
import sys
import time
from pathlib import Path

from repro_torch.bench import common
from repro_torch.engine import resolve_device

MODULES = ("table1_accuracy", "fig5_neurons", "wexp_sweep", "fig4_energy",
           "table2_resources")
DEFAULT_JSON = "bench_paper.json"


def run_modules(names=MODULES, **opts) -> dict:
    """Run the named modules in ``MODULES`` order; each gets the options
    (``dataset``, ``n_train``, ``n_test``, ``n_steps``, ``epochs``,
    ``n_neurons``, ``device``, ``block_seeds``) its ``run()`` takes.
    Returns each module's result by name."""
    out = {}
    for name in MODULES:
        if name not in names:
            continue
        mod = importlib.import_module(f"repro_torch.bench.{name}")
        params = inspect.signature(mod.run).parameters
        t0 = time.time()
        out[name] = mod.run(**{k: v for k, v in opts.items()
                               if k in params and v is not None})
        print(f"# {name} done in {time.time() - t0:.1f}s", flush=True)
    return out


def main(argv: list[str] | None = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    # a bare --json names no file: ``--json fig4_energy`` filters
    args = [f"--json={DEFAULT_JSON}" if a in ("--json", "--json=") else a
            for a in args]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("modules", nargs="*")
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda needs a card; cpu runs the "
                         "plain versions)")
    ap.add_argument("--n-train", type=int, default=None)
    ap.add_argument("--n-test", type=int, default=None)
    ap.add_argument("--n-steps", type=int, default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--neurons", type=int, default=None)
    a = ap.parse_args(args)
    unknown = set(a.modules) - set(MODULES)
    if unknown:
        print(f"# unknown module(s): {', '.join(sorted(unknown))}",
              flush=True)
        return 2
    json_path = a.json
    if json_path is not None and Path(json_path).name == "BENCH_kernels.json":
        print("# BENCH_kernels.json holds the JAX package's rows; name "
              "another file", flush=True)
        return 2
    resolve_device(a.device)  # no card for cuda: stop before any work
    print("name,us_per_call,derived")
    run_modules(a.modules or MODULES, device=a.device, n_train=a.n_train,
                n_test=a.n_test, n_steps=a.n_steps, epochs=a.epochs,
                n_neurons=a.neurons)
    if json_path is not None:
        rows = {rec["name"]: {k: v for k, v in rec.items() if k != "name"}
                for rec in common.RECORDS}
        with open(json_path, "w") as fh:
            json.dump(rows, fh, indent=2, sort_keys=True)
        print(f"# wrote {len(rows)} rows to {json_path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
