"""Test configuration: run everything on a virtual 8-device CPU mesh.

The suite runs on XLA's CPU backend with host-platform device emulation, so
an N-way mesh is available everywhere.  Accelerator runs go through
`python chip_smoke.py` (one GPU) and `python chip_smoke.py --four` (four);
tests that need the card carry the `gpu` marker and decide inside a fixture
whether one is present.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert jax.devices()[0].platform == "cpu", jax.devices()
# the CLI entry point places a persistent compile cache; tests stay
# hermetic and never read programs compiled by another worker or run
jax.config.update("jax_enable_compilation_cache", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU; skips inside a fixture without one")
