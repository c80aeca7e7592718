from sahara_jax.parallel.mesh import data_mesh, replicate_index, shard_queries
from sahara_jax.parallel.search import distributed_scheme_search
