"""Shared fixtures. NOTE: no XLA_FLAGS here on purpose — smoke tests and
benches must see 1 device; only dryrun.py forces 512 host devices."""
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card; skips without one"
    )


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
