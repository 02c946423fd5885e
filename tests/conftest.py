"""Test configuration: run everything on a virtual 8-device CPU mesh so the
multi-device sharding paths are exercised without a multi-card machine
(SURVEY.md §4).

Tests marked `gpu` run compiled kernels on a card: the `gpu_device`
fixture skips them where JAX finds none. On a GPU machine run them with
`python -m pytest tests -m gpu -p no:cacheprovider` (the env below pins
the CPU, so that run must override JAX_PLATFORMS: see README).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# Never let tests touch the persistent compile cache: test_cli runs the
# CLI in-process, which would enable .jax_cache/ for the REST of the
# suite — and CPU executables AOT-compiled on an earlier host
# generation (mismatched machine features; the cpu_aot_loader warning)
# can miscompute, which surfaced as a flaky exact-equality failure in
# test_chunked_dense_entry_matches_oneshot (full-suite order only).
os.environ["SHINE_NO_COMPILE_CACHE"] = "1"
# The CPU backend reports no memory limit; the memory-derived rules
# (config.device_bytes) read this stated size instead.
os.environ.setdefault("SHINE_HBM_BYTES", str(16 << 30))
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: runs compiled kernels on a GPU; skips without one"
    )


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu_device():
    """The first GPU device, or a skip where JAX finds none. Decided
    here, at run time, never while a test module is imported."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU: compiled Triton kernels have no CPU run")
    return devs[0]
