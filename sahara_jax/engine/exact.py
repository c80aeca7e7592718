"""Batched exact backward search (the ``fmc::search_no_errors::search``
analogue, reference call site uni-search.cpp:114-119).

All queries advance one character per ``lax.scan`` step in lockstep; empty
intervals stay empty (rank monotonicity), so no per-lane control flow is
needed.  Queries are left-aligned and right-padded; a lane only starts
stepping once the scan position enters its length.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from sahara_jax.engine.device import DeviceIndex
from sahara_jax.engine.rank import rank_all


@jax.jit
def exact_search(index: DeviceIndex, queries: jax.Array, qlens: jax.Array):
    """Search every query exactly. Returns (lb, len) int32[B] on the forward
    index.  ``queries``: int32[B, L] left-aligned, ``qlens``: int32[B]."""
    B, L = queries.shape
    sigma = index.sigma
    occ = index.occ
    c_arr = index.c_arr

    lb0 = jnp.zeros(B, dtype=jnp.int32)
    rb0 = jnp.full(B, index.n, dtype=jnp.int32)

    def step(carry, j):
        lb, rb = carry
        # backward search consumes the query right-to-left: at scan step t we
        # process character index qlen-1-t of each lane (lanes with shorter
        # queries simply start at their own tail immediately).
        ch_idx = qlens - 1 - j
        active = ch_idx >= 0
        ch = jnp.take_along_axis(queries, jnp.clip(ch_idx, 0, L - 1)[:, None], axis=1)[:, 0]
        r1 = rank_all(occ, sigma, lb, index.fold)
        r2 = rank_all(occ, sigma, rb, index.fold)
        base = jnp.take(c_arr, ch)
        lb2 = base + jnp.take_along_axis(r1, ch[:, None], axis=1)[:, 0]
        rb2 = base + jnp.take_along_axis(r2, ch[:, None], axis=1)[:, 0]
        lb = jnp.where(active, lb2, lb)
        rb = jnp.where(active, rb2, rb)
        return (lb, rb), None

    (lb, rb), _ = lax.scan(step, (lb0, rb0), jnp.arange(L, dtype=jnp.int32))
    return lb, rb - lb
