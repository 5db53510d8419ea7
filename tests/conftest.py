"""Test bootstrap: run everything on a virtual 8-device CPU "slice".

Mirrors the reference's threads-as-ranks / artificial-slots testing ideas
(SURVEY.md §4): shardings and collectives are exercised for real, on CPU.
Must run before jax initialises any backend, hence top of conftest.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("KERAS_BACKEND", "jax")  # Keras 3 on the JAX backend

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from determined_tpu import _jax_compat  # noqa: E402

_jax_compat.install()  # jax.sharding.set_mesh & co on jax < 0.5

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def devices():
    devs = jax.devices()
    assert len(devs) == 8, f"expected 8 virtual cpu devices, got {devs}"
    return devs


@pytest.fixture()
def rng():
    return jax.random.PRNGKey(0)


@pytest.fixture()
def np_rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running e2e (excluded from the tier-1 time budget)",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (the port's kernels); skips without one",
    )
