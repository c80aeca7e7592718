from sahara_jax.index.fmindex import FMIndex, BiFMIndex, load_index, save_index  # noqa: F401
from sahara_jax.index.build import build_fmindex, build_bifmindex, build_text  # noqa: F401
