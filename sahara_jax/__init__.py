"""sahara_jax — approximate pattern matching in JAX.

A from-scratch re-design of the capabilities of seqan/sahara (an FM-index
read mapper driven by Optimum Search Schemes) for an accelerator:

- The FM-index occurrence table is stored as dense per-symbol bit-planes with
  absolute int32 rank checkpoints, so a rank query is one row gather plus an
  in-register popcount (see ``sahara_jax.index.occtable``).
- Approximate search is a vectorized frontier (wavefront) engine: thousands of
  (query, search-branch) states are stepped in lockstep through a compiled
  search-scheme "tape" under ``jax.jit`` (see ``sahara_jax.engine``).
- Locate is a batched LF-walk to the sampled suffix array.
- Scaling is data-parallel over queries via ``jax.sharding.Mesh`` with the
  index replicated per device (see ``sahara_jax.parallel``).

Reference behavior being reproduced: /root/reference/src/sahara/*.cpp
(see SURVEY.md for the full component inventory).
"""

__version__ = "0.1.0"

import os as _os

_CHECKOUT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
# host-side caches (engine capacity memory, benchmark workloads)
CACHE_DIR = _os.path.join(_CHECKOUT, ".sahara_cache")

# XLA compiles of the search scans are slow, so compiled programs persist
# across runs.  Where JAX_COMPILATION_CACHE_DIR is set, JAX keeps them there;
# otherwise they go to a fixed directory of the checkout (a cache whose path
# moves from run to run never hits).
if "JAX_COMPILATION_CACHE_DIR" not in _os.environ:
    import jax as _jax

    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_CHECKOUT, ".jax_cache"),
    )
