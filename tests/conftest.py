"""Test configuration.

By default the tests run on the CPU, on 8 virtual devices. Set
JAX_PLATFORMS yourself to run elsewhere: `JAX_PLATFORMS=cuda python -m
pytest -m gpu tests/` runs the card-only tests (marked `gpu`) on a GPU.
XLA_FLAGS must be set before the first backend initialization.
"""

import os

import pytest

if "JAX_PLATFORMS" not in os.environ:
  os.environ["JAX_PLATFORMS"] = "cpu"
if os.environ["JAX_PLATFORMS"] == "cpu":
  _flags = os.environ.get("XLA_FLAGS", "")
  if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()


def pytest_configure(config):
  config.addinivalue_line(
      "markers",
      "slow: heavyweight test; default tier runs -m 'not slow', full tier "
      "runs everything.")
  config.addinivalue_line(
      "markers",
      "gpu: needs an NVIDIA GPU (kernels compiled for the card); skips "
      "elsewhere. Run with JAX_PLATFORMS=cuda python -m pytest -m gpu.")


@pytest.fixture
def gpu():
  """Skips the test unless JAX's default device is a GPU."""
  import jax
  platform = jax.devices()[0].platform
  if platform != "gpu":
    pytest.skip(f"needs a GPU; JAX's default device is {platform!r}")
