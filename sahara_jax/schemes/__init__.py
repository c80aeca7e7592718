from sahara_jax.schemes.types import Search, Scheme, is_valid, is_complete, is_non_redundant
from sahara_jax.schemes.expand import expand, expand_count, limit_to_hamming
from sahara_jax.schemes.generators import GENERATORS, get_generator
from sahara_jax.schemes.costs import node_count, weighted_node_count
