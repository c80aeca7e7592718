"""Distributed scheme search: shard_map over the data axis.

Each device runs the lockstep stepper on its query shard against the
replicated index; per-shard hit buffers stay device-local (hits are
located and materialized per shard) while the global hit count is reduced
with ``psum`` — the replacement here for the reference's
absent multi-process story (SURVEY.md §5.8).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from sahara_jax.engine.approx import SearchHits, scheme_search
from sahara_jax.engine.device import DeviceIndex
from sahara_jax.engine.tape import SchemeTape
from sahara_jax.engine.workq import FlatHits
from sahara_jax.parallel.mesh import DATA_AXIS, shard_queries


def distributed_scheme_search(
    mesh,
    index: DeviceIndex,
    queries: np.ndarray,  # [nq, m] host batch (uniform length)
    tape: SchemeTape,
    *,
    edit: bool,
    s_cap: int = 64,
    h_cap: int = 32,
) -> tuple[SearchHits, int]:
    """Run the scheme search data-parallel over the mesh.

    Returns (hits over the original nq queries, global hit count)."""
    nq, m = queries.shape
    ns = tape.num_searches
    k = tape.max_errors
    q_sharded, nq_orig = shard_queries(queries, mesh)
    nq_pad = q_sharded.shape[0]
    n_dev = mesh.devices.size

    t_side = jnp.asarray(tape.side)
    t_qpos = jnp.asarray(tape.qpos)
    t_lo = jnp.asarray(tape.lo)
    t_hi = jnp.asarray(tape.hi)

    # padded lanes beyond nq_orig are masked off via `active`
    active = np.arange(nq_pad) < nq_orig

    def shard_fn(index, q_shard, side, qpos, lo, hi, act):
        h_lb, h_sz, h_err, cnt, fovf, hovf = scheme_search(
            index, q_shard, side, qpos, lo, hi, act,
            edit=edit, s_cap=s_cap, h_cap=h_cap, m=m, ns=ns, k=k,
        )
        total = jax.lax.psum(jnp.sum(cnt), DATA_AXIS)
        return h_lb, h_sz, h_err, cnt, fovf, hovf, total

    idx_spec = jax.tree.map(lambda _: P(), index)
    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(idx_spec, P(DATA_AXIS, None), P(), P(), P(), P(), P(DATA_AXIS)),
        out_specs=(
            P(DATA_AXIS, None), P(DATA_AXIS, None), P(DATA_AXIS, None),
            P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P(),
        ),
        check_vma=False,
    )
    act_sharded = jax.device_put(active, NamedSharding(mesh, P(DATA_AXIS)))
    h_lb, h_sz, h_err, cnt, fovf, hovf, total = jax.jit(fn)(
        index, q_sharded, t_side, t_qpos, t_lo, t_hi, act_sharded
    )

    hits = SearchHits(
        lb=np.asarray(h_lb).reshape(nq_pad, ns, h_cap)[:nq_orig],
        sz=np.asarray(h_sz).reshape(nq_pad, ns, h_cap)[:nq_orig],
        err=np.asarray(h_err).reshape(nq_pad, ns, h_cap)[:nq_orig],
        count=np.asarray(cnt).reshape(nq_pad, ns)[:nq_orig],
        frontier_overflow=np.asarray(fovf).reshape(nq_pad, ns)[:nq_orig],
        hit_overflow=np.asarray(hovf).reshape(nq_pad, ns)[:nq_orig],
    )
    return hits, int(total)


def distributed_workq_search(
    mesh,
    index: DeviceIndex,
    queries: np.ndarray,  # [nq, m] host batch (uniform length)
    tape: SchemeTape,
    *,
    edit: bool,
    q_mult: int = 16,
    hit_mult: int = 64,
    dedup: bool = True,
    max_retries: int = 4,
    active: np.ndarray | None = None,
) -> tuple[FlatHits, int]:
    """Data-parallel work-queue search: each device runs the v2 engine on
    its query shard against the replicated index; per-shard packed hit
    arrays come back stacked along the data axis, the global hit count is
    reduced with psum.  Shard overflows retry with doubled capacities
    (mirroring the single-chip ``run_workq_search``); a persistent overflow
    raises instead of silently dropping hits.

    ``active`` optionally masks queries off (besthits strata / fallback
    subsets); inactive lanes produce no hits.

    Returns (FlatHits with lanes over the ORIGINAL query ids, total).

    Implemented on the single-chip quality path (dispatch_workq with
    ``mesh``): capmem capacity memory, live-profile segment plans, the
    probe bootstrap, and overflow retries all apply per device.  Drivers
    that chunk + pipeline use dispatch_workq/collect_workq directly
    (engine/driver.py::_run_workq_grouped)."""
    from sahara_jax.engine.workq import collect_workq, dispatch_workq

    nq, m = queries.shape
    ns = tape.num_searches
    n_dev = mesh.devices.size
    pad = (-nq) % n_dev
    act = np.ones(nq, dtype=bool) if active is None else np.asarray(active, dtype=bool)
    if pad:
        queries = np.concatenate([queries, np.zeros((pad, m), dtype=queries.dtype)])
        act = np.concatenate([act, np.zeros(pad, dtype=bool)])

    st = dispatch_workq(
        index, queries, tape, edit=edit, active=act, q_mult=q_mult,
        hit_mult=hit_mult, max_retries=max_retries,
        dedup=dedup, mesh=mesh,
    )
    hits = collect_workq(st)
    if hits.queue_overflow or hits.hit_overflow:
        raise RuntimeError(
            "distributed workq search overflowed after retries "
            f"(queue={hits.queue_overflow}, hits={hits.hit_overflow}); "
            "hits would be dropped"
        )
    keep = (hits.lane // ns) < nq
    hits = FlatHits(
        lane=hits.lane[keep],
        lb=hits.lb[keep],
        sz=hits.sz[keep],
        err=hits.err[keep],
        n_hits=int(keep.sum()),
        queue_overflow=False,
        hit_overflow=False,
    )
    return hits, hits.n_hits
