"""The measuring scripts' view of the card: they run on a GPU or not at all.

A number taken on the CPU backend says nothing about the card, so
``require_gpu`` refuses to fall back, and every result names the device it
ran on together with the card's power limit (a card set below its maximum
runs slower under load)."""

from __future__ import annotations

import subprocess


def require_gpu():
    """The first JAX device, which must be a GPU; RuntimeError otherwise."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's default device is {devs[0].platform!r}")
    return devs[0]


def device_record() -> dict:
    """Platform, kind and count of the devices JAX reports."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()
