from sahara_jax.engine.device import DeviceIndex  # noqa: F401
