"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests must see 1 device
(the 512-device trick is exclusive to launch/dryrun.py)."""
import jax
import pytest


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips "
                            "without one")
