import os

# Tests run with the real single CPU device; only dryrun-specific tests
# spawn subprocesses with XLA_FLAGS device-count overrides.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", False)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Compiled XLA:CPU executables accumulate across the suite (the full
    run was OOM-killed at 36 GB); dropping them per module keeps the
    single-process footprint bounded."""
    yield
    jax.clear_caches()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "requires_cuda: needs an NVIDIA GPU with the CUDA toolkit "
        "(the port's hand-written kernels); skipped where there is none",
    )
