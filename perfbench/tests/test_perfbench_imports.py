"""Nothing the benchmark runs loads JAX or the JAX package (whole
top-level names: the port's ``repro_torch`` begins with ``repro``), the
reference loads nothing of the port, and ``run.py`` prints no result
where it may not."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
ENV = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def _top_imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax():
    for path in BENCH.rglob("*.py"):
        assert not _top_imports(path) & {"jax", "jaxlib", "flax", "repro"}, \
            path


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").glob("*.py"):
        assert _top_imports(path) <= {"__future__", "itertools", "torch"}, \
            path
    code = ("import sys; sys.path[:0] = [%r]; "
            "import perfbench.reference.moe_lm; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('repro_torch', 'repro', 'jax')))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=ENV, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_run_loads_no_jax(tiny_root):
    code = f"""
import sys, time
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
import torch
torch.set_num_threads(2)
from perfbench import harness, control, sweep
from pathlib import Path
root = Path({str(tiny_root)!r})
for m in ("ttft_p95_ms", "itl_p95_ms", "setup_s", "decode_step_ms"):
    harness.reader(root, m)
r = harness.run(root, "tiny-chat", 3, 2.0, True, "cpu", time.perf_counter())
print(harness.forbidden_modules(), r["correct"] in (True, False))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=ENV, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_run_py_refuses_without_a_card_or_the_port(tmp_path):
    import torch

    if not torch.cuda.is_available():
        out = subprocess.run(
            [sys.executable, "perfbench/run.py", "--workload",
             "mixtral-chat", "--seed", str(2**31 + 7), "--seconds", "1"],
            cwd=ROOT, capture_output=True, text=True, env=ENV, timeout=300)
        assert out.returncode != 0 and not out.stdout.strip()
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "perfbench")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "mixtral-chat",
         "--seed", "1", "--seconds", "1"], cwd=tmp_path,
        capture_output=True, text=True, env=ENV, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
    json.loads((tmp_path / "BENCHMARK.json").read_text())


def test_run_py_refuses_once_jax_is_loaded():
    code = f"""
import sys, types
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}, {str(BENCH)!r}]
import torch
import run
from perfbench import harness
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
harness.run = lambda *a, **k: {{"correct": True}}
sys.modules["jax"] = types.ModuleType("jax")
rc = run.main(["--workload", "mixtral-chat", "--seed", "1",
               "--seconds", "1"])
print("rc", rc)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=ENV, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines() == ["rc 1"]
    assert "['jax']" in out.stderr
