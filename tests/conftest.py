"""Test config: force CPU with 8 virtual devices (SURVEY.md §4 "Distributed
(no cluster)") so every mesh/shard_map/collective path runs without a GPU.

Note: some installed pytest plugin imports jax before this conftest runs,
so setting JAX_PLATFORMS via os.environ alone is too late — we must also
override through jax.config. XLA_FLAGS still works as long as no backend
has been initialized yet (backends initialize lazily at first use).

On a machine with a GPU, ``MCEIK_TEST_PLATFORMS=cpu,cuda`` keeps the CPU
as the default backend and makes the card visible to the tests marked
``gpu``: ``MCEIK_TEST_PLATFORMS=cpu,cuda python -m pytest tests/ -m gpu``.
"""

import os
import sys

import pytest

PLATFORMS = os.environ.get("MCEIK_TEST_PLATFORMS", "cpu")
os.environ["JAX_PLATFORMS"] = PLATFORMS
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", PLATFORMS)
assert not jax._src.xla_bridge._backends, (
    "a JAX backend initialized before tests/conftest.py could force CPU; "
    "tests would silently run on an accelerator"
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def gpu():
    """Skip unless an NVIDIA GPU is visible (see the module docstring).
    Decided here, per test, never while modules are imported."""
    try:
        devs = jax.devices("cuda")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU")
    return devs[0]
