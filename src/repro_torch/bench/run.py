"""The benchmark harness of the port: one module per paper table or
figure, the kernel rows and the load rows.

    python -m repro_torch.bench.run [module ...] [--json[=PATH]] \\
        [--gate] [--history[=DIR]] [--device cuda|cpu] [--n-train N] \\
        [--n-test N] [--n-steps T] [--epochs E] [--neurons N]

Prints ``name,us_per_call,derived`` CSV rows (``common.emit``).

  table1_accuracy   Table 1  MNIST-recognition comparison row
  fig5_neurons      Fig. 5   CA vs {10,20,40} output neurons
  wexp_sweep        §3.3     w_exp {128,256,512} dead-neuron sweep
  fig4_energy       Fig. 4   modeled power, fused vs decoupled
  table2_resources  Table 2  state-footprint analogue of LUT/FF/BRAM
  kernels_bench     §2.2     fused SNNU vs unfused chain, window vs steps
  loadgen_bench     serving  open-loop throughput vs latency, rate sweep

The counterpart of the JAX package's ``benchmarks/run.py``.  Any number
of module names filters the run (none = all seven).  With no flags
every module runs its JAX script's full setting on the card
(``--device cuda``); ``--device cpu`` runs the kernels' plain versions.
The size flags override every paper module that takes them
(``--neurons``: the population of Table 1, Fig. 4 and the w_exp sweep).
A paper row's timing field is the wall time of its training (and test
pass) on the device; every energy, power and time of Fig. 4 is the FPGA
model's.  A kernel row's is the wall time of a synchronized call on the
device.

``--json`` additionally writes every emitted row as JSON (name -> the
row's fields), after a ``meta/device`` row that names the device, the
card and its power limit (as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them) and the commit.  PATH defaults to
``bench_paper.json``; the ``=`` form keeps the module filter
unambiguous.  It never writes ``BENCH_kernels.json``, which holds the
JAX package's CPU/XLA rows; the port's committed baseline is
``BENCH_torch.json``.

``--history[=DIR]`` also archives the rows as ``DIR/<git-sha>.json``
(DIR defaults to ``bench_history``): one artifact per commit, which
``plot_history`` renders.

``--gate`` makes the run a perf gate: before PATH is overwritten, its
rows become the baseline, and a shared row that regressed past the
rules of :func:`check_regressions` (the JAX package's rules and
thresholds) fails the run with exit code 1.  ``--gate`` without
``--json``, or without a baseline that loads, exits 2, never a silent
pass.  Without ``--gate`` regressions are printed as warnings.  The
``meta/device`` row never gates.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import json
import sys
import time
import subprocess
from pathlib import Path

import torch

from repro_torch.bench import common
from repro_torch.engine import resolve_device

MODULES = ("table1_accuracy", "fig5_neurons", "wexp_sweep", "fig4_energy",
           "table2_resources", "kernels_bench", "loadgen_bench")
PAPER_MODULES = MODULES[:5]     # the paper's tables and figures
DEFAULT_JSON = "bench_paper.json"
DEFAULT_HISTORY = "bench_history"
META_ROW = "meta/device"

GATE_THRESHOLD = 0.25          # fail on >25% drop of a gated ratio
GATE_TIME_BASE_MIN = 4.0       # only clearly-structural rows time-gate
GATE_TIME_FLOOR = 1.25         # ...and only when the speedup is gone
_GATED_METRICS = ("time_ratio", "bytes_ratio")

# serving latency gates in the increase direction: a percentile fails
# only when it grows past GATE_LATENCY_RATIO x its committed baseline
# and lands above GATE_LATENCY_FLOOR_MS, so a noisy but healthy run
# passes and a structural regression (a blocking refresh in the serving
# step) lands far past both
GATE_LATENCY_RATIO = 8.0
GATE_LATENCY_FLOOR_MS = 10.0
_GATED_LATENCY_SUFFIXES = ("_ms_p50", "_ms_p99", "_ms_p999")

# loadgen rows: SLO attainment is a fraction of offered requests, so it
# gates on an absolute drop; sustainable_rps comes from a deterministic
# virtual-clock bisection, so the structural threshold applies as is
GATE_SLO_DROP = 0.05


def _git(*args: str) -> str:
    """``git`` with ``args`` in the current directory: its output, or ""
    outside a checkout."""
    try:
        return subprocess.run(["git", *args], capture_output=True,
                              text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def archive_history(rows: dict, history_dir: str) -> str:
    """Write rows to ``history_dir/<git-sha>.json`` (``nogit`` outside a
    checkout); returns the path.  One artifact per commit."""
    import os

    os.makedirs(history_dir, exist_ok=True)
    sha = _git("rev-parse", "--short", "HEAD") or "nogit"
    path = os.path.join(history_dir, f"{sha}.json")
    with open(path, "w") as fh:
        json.dump(rows, fh, indent=2, sort_keys=True)
    return path


def load_baseline(path: str) -> dict | None:
    try:
        with open(path) as fh:
            return json.load(fh)
    except (FileNotFoundError, json.JSONDecodeError):
        return None


def check_regressions(baseline: dict, rows: dict,
                      threshold: float = GATE_THRESHOLD) -> list[str]:
    """Rows whose gated metrics regressed past the rules; the JAX
    package's ``benchmarks/run.py`` rules, message for message.

    Only rows and metrics present on both sides are compared, and the
    ``meta/device`` row never is.  ``bytes_ratio`` gates on the relative
    ``threshold``.  ``time_ratio`` fails only when the baseline was a
    clearly structural speedup (>= ``GATE_TIME_BASE_MIN``) and the new
    ratio fell below ``GATE_TIME_FLOOR``.  Latency percentiles
    (``*_ms_p50``/``*_ms_p99``/``*_ms_p999``) fail when the new value
    exceeds both ``GATE_LATENCY_RATIO`` x the baseline and
    ``GATE_LATENCY_FLOOR_MS``.  ``slo_attainment`` and
    ``high_slo_attainment`` fail on an absolute drop past
    ``GATE_SLO_DROP``; ``sustainable_rps`` and ``goodput_rps`` on a
    relative collapse past ``threshold``.
    """
    msgs = []
    for name in sorted(set(baseline) & set(rows) - {META_ROW}):
        old, new = baseline[name], rows[name]
        for key in ("slo_attainment", "high_slo_attainment"):
            ov, nv = old.get(key), new.get(key)
            if (isinstance(ov, (int, float)) and isinstance(nv, (int, float))
                    and nv < ov - GATE_SLO_DROP):
                msgs.append(f"{name}: {key} {ov:.4f} -> {nv:.4f} "
                            f"(gate is an absolute -{GATE_SLO_DROP})")
        for rate_key in ("sustainable_rps", "goodput_rps"):
            ov, nv = old.get(rate_key), new.get(rate_key)
            if (isinstance(ov, (int, float))
                    and isinstance(nv, (int, float))
                    and ov > 0 and nv < ov * (1.0 - threshold)):
                msgs.append(
                    f"{name}: {rate_key} {ov:.0f} -> {nv:.0f} "
                    f"({(nv / ov - 1.0) * 100:+.0f}%, gate is "
                    f"-{threshold * 100:.0f}%)")
        for metric in _GATED_METRICS:
            ov, nv = old.get(metric), new.get(metric)
            if not (isinstance(ov, (int, float))
                    and isinstance(nv, (int, float))):
                continue
            if metric == "time_ratio" and (
                    ov < GATE_TIME_BASE_MIN or nv >= GATE_TIME_FLOOR):
                continue
            if ov > 0 and nv < ov * (1.0 - threshold):
                msgs.append(
                    f"{name}: {metric} {ov:.2f} -> {nv:.2f} "
                    f"({(nv / ov - 1.0) * 100:+.0f}%, gate is "
                    f"-{threshold * 100:.0f}%)")
        for metric in sorted(set(old) & set(new)):
            if not metric.endswith(_GATED_LATENCY_SUFFIXES):
                continue
            ov, nv = old[metric], new[metric]
            if not (isinstance(ov, (int, float))
                    and isinstance(nv, (int, float))):
                continue
            if (nv >= GATE_LATENCY_FLOOR_MS
                    and nv > max(ov, 1e-6) * GATE_LATENCY_RATIO):
                msgs.append(
                    f"{name}: {metric} {ov:.3f}ms -> {nv:.3f}ms "
                    f"(latency gate is {GATE_LATENCY_RATIO:.0f}x above "
                    f"{GATE_LATENCY_FLOOR_MS:.0f}ms)")
    return msgs


def device_row(device, commit: str | None = None) -> dict:
    """The ``meta/device`` row: the device, the card's name and power
    limit (``nvidia-smi``; "cpu" off the card) and the commit (default
    ``git describe --always --dirty``, "nogit" outside a checkout)."""
    dev = torch.device(device)
    card = "cpu"
    if dev.type == "cuda":
        try:
            card = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=30).stdout.strip().splitlines()[0]
        except (OSError, subprocess.SubprocessError, IndexError):
            card = torch.cuda.get_device_name(dev)
    return {"device": str(dev), "card": card,
            "commit": (commit or _git("describe", "--always", "--dirty",
                                      "--abbrev=7") or "nogit")}


def missing_rows(baseline: dict, rows: dict) -> list[str]:
    """The baseline's rows that this run lacks, each as a regression
    message; only rows of a family (the name's part before ``/``) that
    this run emitted count, so a run of fewer modules than the baseline's
    is not held to the others' rows."""
    families = {name.split("/")[0] for name in rows}
    return [f"{name}: row missing from this run" for name in sorted(baseline)
            if name != META_ROW and name not in rows
            and name.split("/")[0] in families]


def run_modules(names=MODULES, **opts) -> dict:
    """Run the named modules (default: all, as the CLI without names) in
    ``MODULES`` order; each gets the options
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


def write_rows(rows: dict, path: str, device, commit: str | None = None
               ) -> dict:
    """Write ``rows`` to ``path`` after the ``meta/device`` row; returns
    what was written."""
    out = {name: dict(sorted(row.items())) for name, row in
           [(META_ROW, device_row(device, commit)), *sorted(rows.items())]}
    with open(path, "w") as fh:
        json.dump(out, fh, indent=2)
    return out


def main(argv: list[str] | None = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    # a bare --json or --history names no file: ``--json fig4_energy``
    # filters
    args = [f"--json={DEFAULT_JSON}" if a in ("--json", "--json=") else
            f"--history={DEFAULT_HISTORY}" if a in ("--history",
                                                    "--history=") else a
            for a in args]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("modules", nargs="*")
    ap.add_argument("--json", default=None)
    ap.add_argument("--gate", action="store_true",
                    help="fail (exit 1) on a regression against the rows "
                         "at the --json path")
    ap.add_argument("--history", default=None, metavar="DIR",
                    help="archive the rows as DIR/<git-sha>.json")
    ap.add_argument("--commit", default=None,
                    help="the commit the meta/device row names (default: "
                         "git describe --always --dirty)")
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
    if a.history is not None and json_path is None:
        print("# --history requires --json (nothing to archive)",
              flush=True)
        return 2
    if a.gate and json_path is None:
        print("# --gate requires --json (nothing to compare)", flush=True)
        return 2
    dev = resolve_device(a.device)  # no card for cuda: stop before work
    print("name,us_per_call,derived")
    run_modules(a.modules or MODULES, device=a.device, n_train=a.n_train,
                n_test=a.n_test, n_steps=a.n_steps, epochs=a.epochs,
                n_neurons=a.neurons)
    if json_path is None:
        return 0
    rows = {rec["name"]: {k: v for k, v in rec.items() if k != "name"}
            for rec in common.RECORDS}
    baseline = load_baseline(json_path)
    written = write_rows(rows, json_path, dev, a.commit)
    print(f"# wrote {len(rows)} rows to {json_path}", flush=True)
    if a.history is not None:
        hist = archive_history(written, a.history)
        print(f"# archived history artifact {hist}", flush=True)
    if baseline is None:
        if a.gate:
            print(f"# perf gate FAILED: no committed baseline at "
                  f"{json_path} (missing or unparseable)", flush=True)
            return 2
        return 0
    msgs = check_regressions(baseline, rows) + missing_rows(baseline, rows)
    for m in msgs:
        print(f"# PERF REGRESSION {m}", flush=True)
    if msgs and a.gate:
        print(f"# perf gate FAILED ({len(msgs)} regressed rows)",
              flush=True)
        return 1
    if not msgs:
        shared = len(set(baseline) & set(rows) - {META_ROW})
        print(f"# perf gate OK ({shared} rows within "
              f"{GATE_THRESHOLD * 100:.0f}%)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
