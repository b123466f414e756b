import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips without one)")
