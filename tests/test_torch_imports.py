"""The port stands alone: nothing under ``src/repro_torch/``, nor
``chip_smoke.py``, imports JAX or the JAX package ``repro``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_neither_jax_nor_repro(path):
    assert path.is_file()
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_importing_the_serving_stack_loads_no_jax():
    code = ("import sys, repro_torch.serving.snn, repro_torch.launch.serve,"
            " repro_torch.convert, repro_torch.launch.mnist_stdp,"
            " repro_torch.launch.quickstart, repro_torch.core.network,"
            " repro_torch.launch.loadgen, repro_torch.loadgen.runner,"
            " repro_torch.checkpoint, repro_torch.serving,"
            " repro_torch.bench.run, repro_torch.bench.fig4_energy,"
            " repro_torch.bench.fig5_neurons, repro_torch.bench.wexp_sweep,"
            " repro_torch.bench.table1_accuracy,"
            " repro_torch.bench.table2_resources,"
            " repro_torch.bench.kernels_bench, repro_torch.bench.loadgen_bench,"
            " repro_torch.bench.plot_history, repro_torch.distributed,"
            " repro_torch.distributed.snn_mesh; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# JAX package-level names whose modules the port does not have yet
# (``configs/shapes.py``, ``data/loader.py``, ``data/synthetic.py``)
UNPORTED = {"repro.configs": {"SHAPES", "ShapeSpec", "applicable_shapes"},
            "repro.data": {"ShardedLoader", "SyntheticTokens"}}
UNPORTED_MODULES = ("configs/shapes.py", "data/loader.py",
                    "data/synthetic.py")


@pytest.mark.parametrize("package", ["repro.core", "repro.configs",
                                     "repro.data"])
def test_package_level_names_match_the_jax_package(package):
    """Every package-level name of the JAX package whose module is
    ported resolves at the port's package level, to an object of the
    same name (and a module to the port's counterpart)."""
    import importlib
    import types

    jpkg = importlib.import_module(package)
    pkg = importlib.import_module(package.replace("repro", "repro_torch",
                                                  1))
    skip = UNPORTED.get(package, set())
    for name in jpkg.__all__:
        if name in skip:
            assert not hasattr(pkg, name)
            continue
        assert name in pkg.__all__, f"{pkg.__name__}.__all__ lacks {name}"
        got, want = getattr(pkg, name), getattr(jpkg, name)
        if isinstance(want, types.ModuleType):
            assert got.__name__ == want.__name__.replace("repro",
                                                         "repro_torch", 1)
        elif getattr(want, "__name__", None) == name:
            assert got.__name__ == name
    for path in UNPORTED_MODULES:
        assert not (REPO / "src" / "repro_torch" / path).exists(), (
            f"{path} is ported: export its names and drop it from "
            f"UNPORTED")


def test_registered_configs_and_package_values_match_the_jax_package():
    import dataclasses

    from repro.configs import WENQUXING_22A as J22A
    from repro.configs import get_config as jget_config
    from repro_torch.configs import WENQUXING_22A, get_config, list_configs

    assert list_configs() == ["command-r-35b", "gemma3-1b", "llama3-405b",
                              "starcoder2-3b"]
    for name in list_configs():
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(jget_config(name))
    # every field both packages have, but ``kernel_backend``: the port's
    # values are "kernel" and "ref", the JAX package's "ref", "interp"
    # and "tpu"
    want = dataclasses.asdict(J22A)
    got = dataclasses.asdict(WENQUXING_22A)
    shared = sorted(set(got) & set(want) - {"kernel_backend"})
    assert len(shared) > 15
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}


def test_lif_reset_and_lfsr_period_equal_the_jax_package():
    import numpy as np
    import torch

    from repro.core import lfsr as jlfsr
    from repro.core import lif_reset as jlif_reset
    from repro_torch.core import lfsr, lif_reset

    assert lfsr.LFSR_PERIOD == jlfsr.LFSR_PERIOD == 65535
    for n in (0, 1, 40):
        v = lif_reset(n, device="cpu")
        assert v.dtype == torch.int32 and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), np.asarray(jlif_reset(n)))
    # the period is the generator's: 65,535 steps return to the seed
    s = lfsr.seed(0x22A, 4)
    t = s
    for _ in range(lfsr.LFSR_PERIOD):
        t = lfsr.step(t)
    assert torch.equal(t, s)


def test_every_port_module_imports_on_its_own():
    """Each module of the port imports first in an interpreter that has
    loaded nothing of the port (import cycles show only in some
    orders)."""
    src = REPO / "src"
    mods = sorted(".".join(p.relative_to(src).with_suffix("").parts)
                  .removesuffix(".__init__")
                  for p in (src / "repro_torch").rglob("*.py"))
    code = (
        "import importlib, sys, traceback\n"
        f"bad = []\nfor m in {mods!r}:\n"
        "    for k in [k for k in sys.modules if k == 'repro_torch'"
        " or k.startswith('repro_torch.')]:\n"
        "        del sys.modules[k]\n"
        "    try:\n        importlib.import_module(m)\n"
        "    except Exception:\n"
        "        bad.append(m + ': ' + traceback.format_exc(limit=1))\n"
        "print('\\n'.join(bad)); sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(src))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert len(mods) > 60
    assert proc.returncode == 0, proc.stdout + proc.stderr
