import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips without one)")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tiny runs are timed windows, and under a
    parallel test run many threads a process starve each other's steps."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """A checkout-like directory: the tiny fixture's BENCHMARK.json,
    configs, traffic and cells, and the benchmark's own metric readers."""
    shutil.copytree(ROOT / "perfbench" / "tests" / "fixtures", tmp_path,
                    dirs_exist_ok=True)
    shutil.copytree(ROOT / "perfbench" / "metrics",
                    tmp_path / "perfbench" / "metrics")
    return tmp_path


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
