"""Suite hermeticity guard: unit tests must run on the 8-virtual-device
CPU backend, never an accelerator (conftest.py forces it; a regression
here means the suite would silently contend with chip runs)."""

import jax


def test_suite_runs_on_virtual_cpu_mesh():
    devs = jax.devices()
    assert devs[0].platform == "cpu", f"suite leaked onto {devs[0].platform}"
    assert len(devs) >= 8, f"expected 8 virtual CPU devices, got {len(devs)}"
