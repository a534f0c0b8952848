"""Test configuration: run the suite on a simulated 8-device CPU mesh.

This mirrors the reference's dual-backend test strategy (SURVEY.md §4): the
sequential CI job runs full distributed semantics on a fake backend
(DebugArray); we run the same sharded code paths on XLA's host-platform
device simulation.

Tests that need the GPU carry the `gpu` marker. They run only when the
marker is selected (`python -m pytest tests/ -m gpu`, on a machine with a
card); then the default backend is left alone. In every other run the
CPU backend is forced before any test touches a device, and the marked
tests skip through the `gpu_device` fixture.
"""
import jax
import pytest


def _gpu_selected(config) -> bool:
    expr = config.getoption("markexpr") or ""
    return "gpu" in expr and "not gpu" not in expr


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; run with -m gpu on the card"
    )
    jax.config.update("jax_enable_x64", True)
    if _gpu_selected(config):
        return
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

    from jax.extend.backend import clear_backends

    clear_backends()
    assert jax.devices()[0].platform == "cpu"


@pytest.fixture
def gpu_device():
    """The first JAX device, or a skip when it is not a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (default device is {dev.platform})")
    return dev
