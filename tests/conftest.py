# NOTE: no XLA_FLAGS here on purpose -- smoke tests and benches must see 1
# device; multi-device tests spawn subprocesses that set the flag themselves.
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-device subprocess tests (still run by default)")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one")
