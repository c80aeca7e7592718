"""Test harness config: force the CPU backend with 8 virtual devices, so the
multi-device sharding paths run without an accelerator (SURVEY.md §4).
Tests that need a GPU carry the ``gpu`` marker and skip here (see
``gpu_env`` below); ``chip_smoke.py`` drives the whole GPU path."""

import os
import subprocess

import pytest

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

# Backends are not initialized yet at conftest time, so the platform choice
# also holds when something imported jax before this file ran.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Isolate the engine's capacity-memory file per test session: tests must
# not read (or pollute) the checkout's capmem — shared state made
# retry-budget tests order-dependent.
import tempfile  # noqa: E402

os.environ["SAHARA_CAPMEM_PATH"] = os.path.join(
    tempfile.gettempdir(), f"sahara_capmem_test_{os.getpid()}.json"
)


@pytest.fixture
def gpu_env():
    """Environment for a child process that runs on the GPU, for tests
    marked ``gpu``; skips where there is no card.  Decided here, at run
    time, so every worker collects the same tests.  The test process itself
    stays on the CPU, and the child is the only process on the card."""
    try:
        listed = subprocess.run(["nvidia-smi", "-L"], capture_output=True, text=True)
    except OSError:
        listed = None
    if listed is None or listed.returncode != 0 or "GPU" not in listed.stdout:
        pytest.skip("needs an NVIDIA GPU")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    return env
