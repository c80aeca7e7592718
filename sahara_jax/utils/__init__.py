from sahara_jax.utils.stopwatch import StopWatch, Timings  # noqa: F401
from sahara_jax.utils.errors import SaharaError  # noqa: F401
