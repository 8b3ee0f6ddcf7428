import os

import pytest

# Run tests hermetically on the CPU with 8 virtual devices so sharding/mesh
# tests work without several accelerators (SURVEY.md §4). The config update
# before first backend use holds JAX to the CPU even on a machine with a
# GPU.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert jax.devices()[0].platform == "cpu"


@pytest.fixture
def gpu():
    """The first GPU, for tests marked `gpu`; skips where JAX sees none
    (always under this conftest, which holds JAX to the CPU)."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU; python chip_smoke.py runs this "
                    "check on the card")
