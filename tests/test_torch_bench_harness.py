"""The port's benchmark harness (``repro_torch.bench``: ``run``'s gate and
history, ``kernels_bench``, ``loadgen_bench``, ``plot_history``) against
the JAX package's ``benchmarks/`` and its committed
``BENCH_kernels.json``.

The analytic fields of the kernel rows and every field of the
virtual-clock load rows are deterministic, so they must equal the JAX
package's committed rows exactly; timed fields are the device's own and
are not compared."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.bench import (common, kernels_bench, loadgen_bench,
                               plot_history, run)

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmarks import plot_history as jplot_history  # noqa: E402
from benchmarks import run as jrun  # noqa: E402

BENCH = json.loads((REPO / "BENCH_kernels.json").read_text())


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread for this module, the old count restored
    after it: the 50,000-request virtual replay runs many small CPU ops,
    which torch's default of a thread a core oversubscribes when several
    test workers share the cores."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
# the kernel rows' fields that follow from the shapes alone
ANALYTIC = ("min_hbm_bytes", "bytes_ratio", "input_bytes", "dataset_bytes",
            "vmem_ratio", "vmem_spike_bytes", "per_device_weight_bytes",
            "mesh", "streams_per_device", "launches")


# --- the gate ----------------------------------------------------------------

def test_gate_constants_equal_the_jax_package():
    for k in ("GATE_THRESHOLD", "GATE_TIME_BASE_MIN", "GATE_TIME_FLOOR",
              "GATE_LATENCY_RATIO", "GATE_LATENCY_FLOOR_MS",
              "GATE_SLO_DROP", "_GATED_METRICS", "_GATED_LATENCY_SUFFIXES"):
        assert getattr(run, k) == getattr(jrun, k), k
    assert run.MODULES == ("table1_accuracy", "fig5_neurons", "wexp_sweep",
                           "fig4_energy", "table2_resources",
                           "kernels_bench", "loadgen_bench")
    # without names, run_modules runs every module, as the CLI does
    import inspect
    assert inspect.signature(run.run_modules).parameters[
        "names"].default == run.MODULES
    assert run.PAPER_MODULES == run.MODULES[:5]


def _every_rule():
    """A baseline and a new run whose rows touch every rule, each on
    both sides of its threshold."""
    base = {
        "loadgen/a": {"slo_attainment": 0.99, "high_slo_attainment": 1.0,
                      "sustainable_rps": 40000.0, "goodput_rps": 20000.0,
                      "e2e_ms_p99": 1.5, "e2e_ms_p50": 1.0,
                      "e2e_ms_p999": 2.0},
        "loadgen/b": {"slo_attainment": 0.99, "high_slo_attainment": 0.97,
                      "sustainable_rps": 40000.0, "goodput_rps": 20000.0,
                      "e2e_ms_p99": 30.0},
        "kernels/structural": {"time_ratio": 6.0, "bytes_ratio": 30.0},
        "kernels/noisy": {"time_ratio": 2.0, "bytes_ratio": 1.27},
        "kernels/still-fast": {"time_ratio": 8.0},
        "serve/latency-x": {"queue_wait_ms_p50": 0.7,
                            "service_ms_p99": 2.7, "analytic": True},
        "serve/latency-y": {"queue_wait_ms_p99": 5.0, "service_ms_p50": 3.0},
        "kernels/removed": {"bytes_ratio": 4.0},
        "kernels/text": {"launches": "1_vs_8", "bytes_ratio": "n/a"},
    }
    new = {
        "loadgen/a": {"slo_attainment": 0.90, "high_slo_attainment": 0.90,
                      "sustainable_rps": 20000.0, "goodput_rps": 10000.0,
                      "e2e_ms_p99": 15.0, "e2e_ms_p50": 9.0,
                      "e2e_ms_p999": 200.0},
        "loadgen/b": {"slo_attainment": 0.95, "high_slo_attainment": 0.93,
                      "sustainable_rps": 31000.0, "goodput_rps": 15000.0,
                      "e2e_ms_p99": 239.0},
        "kernels/structural": {"time_ratio": 1.0, "bytes_ratio": 20.0},
        "kernels/noisy": {"time_ratio": 0.5, "bytes_ratio": 1.0},
        "kernels/still-fast": {"time_ratio": 1.3},
        "serve/latency-x": {"queue_wait_ms_p50": 9.9,
                            "service_ms_p99": 30.0, "analytic": True},
        "serve/latency-y": {"queue_wait_ms_p99": 41.0,
                            "service_ms_p50": "n/a"},
        "kernels/added": {"bytes_ratio": 0.1},
        "kernels/text": {"launches": "1_vs_2", "bytes_ratio": 0.5},
    }
    return base, new


def _perturbed(seed):
    """Random baselines and runs around the thresholds."""
    rng = np.random.default_rng(seed)
    metrics = ("slo_attainment", "high_slo_attainment", "sustainable_rps",
               "goodput_rps", "time_ratio", "bytes_ratio", "e2e_ms_p50",
               "e2e_ms_p99", "queue_wait_ms_p999", "service_ms_p99")
    base, new = {}, {}
    for i in range(12):
        name = f"{rng.choice(['kernels', 'loadgen', 'serve'])}/row{i}"
        keys = rng.choice(metrics, size=rng.integers(1, 5), replace=False)
        base[name] = {str(k): float(rng.uniform(0.5, 60.0)) for k in keys}
        new[name] = {k: v * float(rng.choice([0.2, 0.7, 0.8, 1.0, 1.3, 9.0]))
                     for k, v in base[name].items()}
        for k in ("slo_attainment", "high_slo_attainment"):
            if k in base[name]:
                base[name][k] = float(rng.uniform(0.8, 1.0))
                new[name][k] = base[name][k] - float(rng.choice(
                    [0.0, 0.04, 0.06, 0.2]))
    return base, new


@pytest.mark.parametrize("case", ["every-rule"] + [f"random-{s}"
                                                   for s in range(8)])
def test_check_regressions_equals_the_jax_gate(case):
    base, new = (_every_rule() if case == "every-rule"
                 else _perturbed(int(case.split("-")[1])))
    want = jrun.check_regressions(base, new)
    assert run.check_regressions(base, new) == want
    if case == "every-rule":
        assert len(want) >= 10
        assert any("kernels/structural: time_ratio" in m for m in want)
        assert not any("kernels/noisy: time_ratio" in m for m in want)
        assert not any("still-fast" in m for m in want)
    # the meta/device row never gates, whatever it holds
    meta = {"device": "cuda:0", "card": "x", "commit": "abc",
            "bytes_ratio": 9.0}
    assert run.check_regressions(
        {**base, run.META_ROW: meta},
        {**new, run.META_ROW: dict(meta, bytes_ratio=0.1)}) == want
    assert run.check_regressions(base, new, threshold=0.5) == \
        jrun.check_regressions(base, new, threshold=0.5)


@pytest.mark.parametrize("argv", [
    ["table2_resources", "--gate"], ["table2_resources", "--history"],
    ["table2_resources", "--history=/tmp/x"],
    ["table2_resources", "--json=BENCH_kernels.json"],
    ["table2_resources", "--json=sub/BENCH_kernels.json"],
    ["table2_resources", "--gate", "--json={missing}"], ["nonesuch"]])
def test_gate_and_history_misuse_exits_2(argv, tmp_path, capsys):
    argv = [a.format(missing=tmp_path / "none.json") for a in argv]
    assert run.main([*argv, "--device", "cpu"]) == 2
    out = capsys.readouterr().out
    assert out.count("\n") >= 1


def test_gate_passes_on_an_equal_run_and_fails_on_a_regression(
        tmp_path, capsys, monkeypatch):
    ratio = {"value": 30.0}

    def modules(names, **opts):
        common.emit("kernels/x", 1.0, f"bytes_ratio={ratio['value']:.2f}x")

    monkeypatch.setattr(run, "run_modules", modules)
    path = tmp_path / "rows.json"
    for argv, rc in (([], 0), (["--gate"], 0)):
        monkeypatch.setattr(common, "RECORDS", [])
        assert run.main(["--device", "cpu", f"--json={path}", *argv]) == rc
    assert "# perf gate OK (1 rows" in capsys.readouterr().out
    rows = json.loads(path.read_text())
    assert list(rows) == [run.META_ROW, "kernels/x"]
    assert rows[run.META_ROW] == {"card": "cpu", "commit": run._git(
        "describe", "--always", "--dirty", "--abbrev=7") or "nogit",
        "device": "cpu"}
    assert run.device_row("cpu", "abc1234")["commit"] == "abc1234"
    ratio["value"] = 20.0                # a 33% drop: past the 25% gate
    monkeypatch.setattr(common, "RECORDS", [])
    assert run.main(["--device", "cpu", f"--json={path}", "--gate"]) == 1
    out = capsys.readouterr().out
    assert "# PERF REGRESSION kernels/x: bytes_ratio 30.00 -> 20.00" in out
    assert "# perf gate FAILED (1 regressed rows)" in out


def test_gate_fails_on_a_baseline_row_the_run_lacks(tmp_path, capsys,
                                                    monkeypatch):
    """A row of the baseline that the run did not emit (a crashed row)
    fails the gate; rows of modules the run did not name do not."""
    names = {"value": ("kernels/x", "kernels/y")}

    def modules(names_, **opts):
        for name in names["value"]:
            common.emit(name, 1.0, "bytes_ratio=30.00x")

    monkeypatch.setattr(run, "run_modules", modules)
    path = tmp_path / "rows.json"
    monkeypatch.setattr(common, "RECORDS", [])
    assert run.main(["--device", "cpu", f"--json={path}"]) == 0
    rows = json.loads(path.read_text())
    rows["loadgen/z"] = {"slo_attainment": 1.0}    # another module's row
    path.write_text(json.dumps(rows))
    names["value"] = ("kernels/x",)
    monkeypatch.setattr(common, "RECORDS", [])
    capsys.readouterr()
    assert run.main(["--device", "cpu", f"--json={path}", "--gate"]) == 1
    out = capsys.readouterr().out
    assert "# PERF REGRESSION kernels/y: row missing from this run" in out
    assert "loadgen/z" not in out
    assert "# perf gate FAILED (1 regressed rows)" in out


def test_archive_history_names_its_file_by_the_commit(tmp_path):
    sha = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                         capture_output=True, text=True,
                         cwd=REPO).stdout.strip()
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        path = run.archive_history({"a/b": {"x": 1.0}}, str(tmp_path / "h"))
    finally:
        os.chdir(cwd)
    assert Path(path) == tmp_path / "h" / f"{sha or 'nogit'}.json"
    assert json.loads(Path(path).read_text()) == {"a/b": {"x": 1.0}}
    os.chdir(tmp_path)
    try:                                  # outside a checkout
        path = run.archive_history({}, str(tmp_path / "h2"))
    finally:
        os.chdir(cwd)
    assert Path(path).name in (f"{sha}.json", "nogit.json")


# --- kernels_bench ------------------------------------------------------------

@pytest.fixture(scope="module")
def emitted_rows():
    """The module's rows on the CPU, its timing stubbed out (the wall
    times are the device's and the grid rows' subprocess is tested in
    test_torch_snn_mesh)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kernels_bench, "time_fn", lambda fn, *a, **kw: 1.0)
        mp.setattr(kernels_bench, "_grid_bench",
                   lambda dev, flags, prefix, what: (
                       {"t_single_us": "2.0", "t_shard_us": "1.0"}
                       if prefix == "BENCH" else
                       {"t_1d_us": "3.0", "t_2d_us": "1.5"}))
        n0 = len(common.RECORDS)
        kernels_bench.run("cpu")
        rows = {r["name"]: r for r in common.RECORDS[n0:]}
        del common.RECORDS[n0:]
    return rows


def test_kernels_bench_analytic_fields_equal_the_committed_rows(
        emitted_rows):
    """Every field of every emitted row but the timed ones equals the
    committed row's: the same fields, the same values."""
    for name, row in emitted_rows.items():
        assert kernels_bench.untimed(row) == kernels_bench.untimed(
            BENCH[name]), name
    # the analytic fields are among those compared
    compared = {k for n in emitted_rows
                for k in kernels_bench.untimed(BENCH[n])}
    assert set(ANALYTIC) <= compared


def test_kernels_bench_emits_every_row_with_the_committed_fields(
        emitted_rows):
    """Every row name of the JAX module; the ``*-interp-*`` rows time the
    plain versions (``backend=ref``)."""
    rows = emitted_rows
    want = sorted(n for n in BENCH if n.startswith(("kernels/", "serve/")))
    assert sorted(rows) == want
    for name, row in rows.items():
        assert set(row) - {"name"} == set(BENCH[name]), name
        if "backend" in BENCH[name]:
            assert row["backend"] == "ref"
    assert rows["kernels/train-2d-1024x2048xT32xB32"]["time_ratio"] == 2.0


def test_kernels_bench_grid_rows_run_the_port_snn_mesh_bench():
    kv = kernels_bench._grid_bench(
        __import__("torch").device("cpu"),
        ["--devices", "2", "--neurons", "8", "--words", "2", "--steps", "3",
         "--batch", "2"], "BENCH", "window-shard")
    assert kv is not None and kv["devices"] == "2"
    assert float(kv["t_single_us"]) > 0


# --- loadgen_bench ------------------------------------------------------------

def test_loadgen_virtual_row_equals_the_committed_row():
    """``loadgen/virtual-50k@20000``: the committed smoke trace replayed
    on the virtual clock through the port's engine on the CPU, every
    field equal to the JAX package's row (but its wall time)."""
    n0 = len(common.RECORDS)
    tag, metrics = loadgen_bench.virtual_row("cpu")
    rec = common.RECORDS[n0]
    del common.RECORDS[n0:]
    name = f"loadgen/{tag}"
    assert name == "loadgen/virtual-50k@20000"
    want = {k: v for k, v in BENCH[name].items() if k != "us_per_call"}
    got = {k: v for k, v in rec.items() if k not in ("name", "us_per_call")}
    assert got == want
    assert metrics["served"] == 50000


def test_loadgen_constants_equal_the_jax_module():
    from benchmarks import loadgen_bench as jloadgen

    for k in ("SLO_MS", "SWEEP_FLOOR", "OVERLOAD_SCALE",
              "OVERLOAD_RETENTION", "OVERLOAD_HIGH_FLOOR",
              "OVERLOAD_FAULTS"):
        assert getattr(loadgen_bench, k) == getattr(jloadgen, k), k
    assert Path(loadgen_bench.TRACE) == Path(jloadgen.TRACE).resolve()
    assert Path(loadgen_bench.OVERLOAD_TRACE) == \
        Path(jloadgen.OVERLOAD_TRACE).resolve()


# --- plot_history -------------------------------------------------------------

def _history():
    rng = np.random.default_rng(3)
    hist = []
    for i, sha in enumerate(["a1b2c3d", "b2c3d4e", "c3d4e5f", "d4e5f60"]):
        rows = {"meta/device": {"card": "x", "commit": sha,
                                "device": "cuda:0"}}
        for name in list(BENCH)[:8 + i]:
            rows[name] = {k: (v * float(rng.uniform(0.5, 2.0))
                              if isinstance(v, float) else v)
                          for k, v in BENCH[name].items()}
        if i == 2:                       # a commit that lacks a row: a gap
            rows.pop(list(BENCH)[1])
        for name in ("loadgen/virtual-50k@20000", "loadgen/sweep-5k"):
            rows[name] = dict(BENCH[name], achieved_rps=20000.0 + i * 1e4)
        hist.append((sha, rows))
    return hist


def test_plot_history_renders_the_jax_svg_byte_for_byte(tmp_path):
    hist = _history()
    svg = plot_history.render_svg(hist)
    assert svg == jplot_history.render_svg(hist)
    assert svg.startswith("<svg") and "load harness throughput" in svg
    for i, (sha, rows) in enumerate(hist):
        p = tmp_path / f"{sha}.json"
        p.write_text(json.dumps(rows))
        os.utime(p, (1_000_000 + i, 1_000_000 + i))
    got = plot_history.load_history(str(tmp_path))
    assert [s for s, _ in got] == [s for s, _ in hist]
    assert got == jplot_history.load_history(str(tmp_path))
    out = tmp_path / "h.svg"
    assert plot_history.main(["--history", str(tmp_path),
                              "--out", str(out)]) == 0
    assert out.read_text() == jplot_history.render_svg(got)
    assert plot_history.main(["--history", str(tmp_path / "none")]) == 0
