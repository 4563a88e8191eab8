import numpy as np
import pytest

import repro.platform

# Platform config BEFORE anything touches a jax backend: by default no
# variable is set and tests see the real single device (the 512-device
# override lives ONLY in repro.launch.dryrun). CI's forced-multi-device
# lane exports REPRO_HOST_DEVICES=4 and runs the mesh tests in-process.
repro.platform.configure_from_env()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs an NVIDIA card; skipped where CUDA is absent")
