"""Lockstep search-scheme engine: thousands of (query, search) lanes step
through compiled scheme tapes in a single ``lax.scan``.

Replacement for ``fmc::search_ng24::search[_n]`` and
``fmc::search_ng21::search_best[_n]`` (reference call sites
search.cpp:227-240).  The reference prunes its error tree branch-by-branch
with a recursive DFS per query; here every lane keeps a bounded *frontier*
of live states (bidirectional cursor + error count + tape position) that is
expanded and re-compacted every step — dead branches cost a masked slot
instead of a branch, and all rank queries of a step become one batched
gather against the stacked occ table.

Edit-distance transitions per state (match/substitute over every symbol,
delete = extend the cursor without consuming a query character, insert =
consume without extending) follow the classic bidirectional scheme-search
semantics with these canonicalization rules:

- adjacent insert-after-delete / delete-after-insert pairs are suppressed
  (they alias a cheaper substitution covering the same span);
- deletions before the first consumed character are suppressed (such a
  deletion lands at the direction-switch seam and is enumerated there
  instead, or at a span boundary where it is invalid anyway);
- a hit's text span must not begin or end with a deleted character
  (minimal-span rule): each state tracks "my span currently ends in a
  deletion" flags per edge, set by deletions and cleared by match/sub
  extensions on that edge; flagged states are dropped at emission.

The op field packs (last op, left-edge-deleted, right-edge-deleted) into
bits 0-1, 2, 3.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from sahara_jax.engine.device import DeviceIndex
from sahara_jax.engine.rank import rank_all_offset
from sahara_jax.engine.tape import SchemeTape

OP_MATCH = 0
OP_INS = 1
OP_DEL = 2
_OP_BITS = 3  # bits 0-1: last op
_EDGE_L = 4  # bit 2: span's left edge is a deleted character
_EDGE_R = 8  # bit 3: span's right edge is a deleted character
_EDGE_BITS = _EDGE_L | _EDGE_R


@dataclasses.dataclass
class SearchHits:
    """Host-side results of a scheme search over one bucket.

    Arrays indexed [nq, ns, H]; ``count[q, s]`` = valid hits in lane (q, s).
    ``frontier_overflow`` / ``hit_overflow`` flag lanes that exceeded the
    static caps (the driver retries those with larger caps)."""

    lb: np.ndarray
    sz: np.ndarray
    err: np.ndarray
    count: np.ndarray
    frontier_overflow: np.ndarray
    hit_overflow: np.ndarray

    @property
    def any_overflow(self) -> bool:
        return bool(self.frontier_overflow.any() or self.hit_overflow.any())


def _compact(dest: jax.Array, cap: int, fields: list[jax.Array], base=None) -> list[jax.Array]:
    """Scatter-compact candidate fields [B, C] into [B, cap] buffers using
    per-lane destinations (dest >= cap means dead).  Dead elements get an
    out-of-bounds flat destination so mode="drop" discards them before any
    memory write — a shared in-bounds dump slot would serialize its
    colliding writes.  ``base`` optionally supplies existing buffers
    to scatter into (used for hit accumulation)."""
    b = dest.shape[0]
    ok = dest < cap
    flat_dest = jnp.where(
        ok, jnp.arange(b, dtype=jnp.int32)[:, None] * cap + dest, b * cap
    ).reshape(-1)
    out = []
    for i, f in enumerate(fields):
        if base is None:
            buf = jnp.zeros((b * cap,), dtype=f.dtype)
        else:
            buf = base[i].reshape(-1)
        buf = buf.at[flat_dest].set(f.reshape(-1), mode="drop")
        out.append(buf.reshape(b, cap))
    return out


@partial(jax.jit, static_argnames=("edit", "s_cap", "h_cap", "m", "ns", "k"))
def scheme_search(
    index: DeviceIndex,
    queries: jax.Array,  # int32[nq, m]
    t_side: jax.Array,  # int32[ns, m]
    t_qpos: jax.Array,
    t_lo: jax.Array,
    t_hi: jax.Array,
    active: jax.Array,  # bool[nq] — lanes of inactive queries never start
    *,
    edit: bool,
    s_cap: int,
    h_cap: int,
    m: int,
    ns: int,
    k: int,
):
    """Run all searches of one scheme over all queries in lockstep.

    Returns (h_lb, h_sz, h_err int32[B, h_cap], hit_cnt int32[B],
    frontier_overflow bool[B], hit_overflow bool[B]) with B = nq * ns lanes
    ordered query-major (lane = q * ns + s)."""
    nq = queries.shape[0]
    sigma = index.sigma
    b = nq * ns
    if not (index.rev_rows > 0 or index.mirrored):
        raise ValueError("scheme search requires a bidirectional index")

    occ = index.occ
    c_arr = index.c_arr
    rev_rows = index.rev_word_off

    q_id = jnp.arange(b, dtype=jnp.int32) // ns
    s_id = jnp.arange(b, dtype=jnp.int32) % ns

    queries_flat = queries.reshape(-1)
    side_flat = t_side.reshape(-1)
    qpos_flat = t_qpos.reshape(-1)
    lo_flat = t_lo.reshape(-1)
    hi_flat = t_hi.reshape(-1)

    # initial frontier: slot 0 = the empty cursor
    def init_field(v, dtype=jnp.int32):
        z = jnp.zeros((b, s_cap), dtype=dtype)
        return z.at[:, 0].set(v)

    lane_active = jnp.take(active, q_id)
    lb0 = init_field(0)
    lbr0 = init_field(0)
    sz0 = init_field(jnp.where(lane_active, index.n, 0))
    err0 = init_field(0)
    d0 = init_field(0)
    op0 = init_field(OP_MATCH)

    h_lb0 = jnp.zeros((b, h_cap), dtype=jnp.int32)
    h_sz0 = jnp.zeros((b, h_cap), dtype=jnp.int32)
    h_err0 = jnp.zeros((b, h_cap), dtype=jnp.int32)
    hit_cnt0 = jnp.zeros((b,), dtype=jnp.int32)
    fovf0 = jnp.zeros((b,), dtype=jnp.bool_)
    hovf0 = jnp.zeros((b,), dtype=jnp.bool_)

    n_steps = m + 1 + (k if edit else 0)

    def step(carry, _):
        lb, lbr, sz, err, d, op, h_lb, h_sz, h_err, hit_cnt, fovf, hovf = carry
        alive = sz > 0

        # --- extract finished states (d == m) into the hit buffers -------
        # minimal-span rule: states whose span still ends in a deletion on
        # either edge are not valid hits (and can no longer recover)
        done = alive & (d >= m)
        finished = done & ((op & _EDGE_BITS) == 0)
        fidx = jnp.cumsum(finished.astype(jnp.int32), axis=1) - 1 + hit_cnt[:, None]
        hdest = jnp.where(finished & (fidx < h_cap), fidx, h_cap)
        h_lb, h_sz, h_err = _compact(hdest, h_cap, [lb, sz, err], base=[h_lb, h_sz, h_err])
        new_hits = jnp.sum(finished, axis=1, dtype=jnp.int32)
        hovf = hovf | (hit_cnt + new_hits > h_cap)
        hit_cnt = jnp.minimum(hit_cnt + new_hits, h_cap)
        alive = alive & ~done

        # --- tape lookups for live states --------------------------------
        dc = jnp.minimum(d, m - 1)
        tape_idx = s_id[:, None] * m + dc
        side = jnp.take(side_flat, tape_idx)
        qp = jnp.take(qpos_flat, tape_idx)
        lo_b = jnp.take(lo_flat, tape_idx)
        hi_b = jnp.take(hi_flat, tape_idx)
        qc = jnp.take(queries_flat, q_id[:, None] * m + qp)

        # --- one batched rank-all per interval edge -----------------------
        primary = jnp.where(side == 1, lbr, lb)
        secondary = jnp.where(side == 1, lb, lbr)
        word_off = side * rev_rows
        r_lo = rank_all_offset(occ, sigma, primary, word_off, index.fold)  # [B, S, sigma]
        r_hi = rank_all_offset(occ, sigma, primary + sz, word_off, index.fold)
        cnt = r_hi - r_lo
        prefix = jnp.cumsum(cnt, axis=-1) - cnt  # exclusive prefix over symbols
        new_primary = c_arr[None, None, :sigma] + r_lo
        new_secondary = secondary[..., None] + prefix
        ext_lb = jnp.where(side[..., None] == 1, new_secondary, new_primary)
        ext_lbr = jnp.where(side[..., None] == 1, new_primary, new_secondary)

        # --- children ----------------------------------------------------
        cand_lb, cand_lbr, cand_sz, cand_err, cand_d, cand_op, cand_alive = [], [], [], [], [], [], []

        # a match/sub on edge `side` makes the new character the outermost
        # one there, clearing that edge's deletion flag
        ms_op = op & jnp.where(side == 0, _EDGE_R, _EDGE_L)
        del_op = OP_DEL | (op & _EDGE_BITS) | jnp.where(side == 0, _EDGE_L, _EDGE_R)
        ins_op = OP_INS | (op & _EDGE_BITS)
        last = op & _OP_BITS

        # match / substitution per real symbol c in 1..sigma-1
        for c in range(1, sigma):
            e2 = err + jnp.where(qc == c, 0, 1)
            ok = alive & (cnt[..., c] > 0) & (e2 <= hi_b) & (e2 >= lo_b)
            cand_lb.append(ext_lb[..., c])
            cand_lbr.append(ext_lbr[..., c])
            cand_sz.append(cnt[..., c])
            cand_err.append(e2)
            cand_d.append(d + 1)
            cand_op.append(ms_op)
            cand_alive.append(ok)

        if edit:
            # deletion: extend the cursor, keep the tape position
            for c in range(1, sigma):
                e2 = err + 1
                ok = alive & (cnt[..., c] > 0) & (e2 <= hi_b) & (d > 0) & (last != OP_INS)
                cand_lb.append(ext_lb[..., c])
                cand_lbr.append(ext_lbr[..., c])
                cand_sz.append(cnt[..., c])
                cand_err.append(e2)
                cand_d.append(d)
                cand_op.append(del_op)
                cand_alive.append(ok)
            # insertion: consume the query character, keep the cursor
            e2 = err + 1
            ok = alive & (e2 <= hi_b) & (e2 >= lo_b) & (last != OP_DEL)
            cand_lb.append(lb)
            cand_lbr.append(lbr)
            cand_sz.append(sz)
            cand_err.append(e2)
            cand_d.append(d + 1)
            cand_op.append(ins_op)
            cand_alive.append(ok)

        c_lb = jnp.concatenate(cand_lb, axis=1)
        c_lbr = jnp.concatenate(cand_lbr, axis=1)
        c_sz = jnp.concatenate(cand_sz, axis=1)
        c_err = jnp.concatenate(cand_err, axis=1)
        c_d = jnp.concatenate(cand_d, axis=1)
        c_op = jnp.concatenate(cand_op, axis=1)
        c_ok = jnp.concatenate(cand_alive, axis=1)
        c_sz = jnp.where(c_ok, c_sz, 0)

        # --- compact candidates back into s_cap slots ---------------------
        cidx = jnp.cumsum(c_ok.astype(jnp.int32), axis=1) - 1
        total = jnp.sum(c_ok, axis=1, dtype=jnp.int32)
        fovf = fovf | (total > s_cap)
        dest = jnp.where(c_ok & (cidx < s_cap), cidx, s_cap)
        lb, lbr, sz, err, d, op = _compact(dest, s_cap, [c_lb, c_lbr, c_sz, c_err, c_d, c_op])

        return (lb, lbr, sz, err, d, op, h_lb, h_sz, h_err, hit_cnt, fovf, hovf), None

    carry = (lb0, lbr0, sz0, err0, d0, op0, h_lb0, h_sz0, h_err0, hit_cnt0, fovf0, hovf0)
    carry, _ = lax.scan(step, carry, None, length=n_steps)
    (_, _, _, _, _, _, h_lb, h_sz, h_err, hit_cnt, fovf, hovf) = carry
    return h_lb, h_sz, h_err, hit_cnt, fovf, hovf


def run_scheme_search(
    index: DeviceIndex,
    queries: np.ndarray,  # int32[nq, m] uniform-length bucket
    tape: SchemeTape,
    *,
    edit: bool,
    active: np.ndarray | None = None,
    s_cap: int = 64,
    h_cap: int = 32,
    max_retries: int = 8,
) -> SearchHits:
    """Host wrapper: run the jitted stepper, retrying with doubled caps for
    as long as any lane overflowed (the static-shape analogue of the
    reference's unbounded DFS).  Eight doublings take s_cap to 8192 —
    enough for k=4 schemes on repetitive corpora; the workq engine (the
    default) has no per-lane cap at all."""
    nq, m = queries.shape
    ns = tape.num_searches
    k = tape.max_errors
    queries_j = jnp.asarray(queries, dtype=jnp.int32)
    act = np.ones(nq, dtype=bool) if active is None else np.asarray(active, dtype=bool)
    t_side = jnp.asarray(tape.side)
    t_qpos = jnp.asarray(tape.qpos)
    t_lo = jnp.asarray(tape.lo)
    t_hi = jnp.asarray(tape.hi)

    for attempt in range(max_retries):
        h_lb, h_sz, h_err, cnt, fovf, hovf = scheme_search(
            index,
            queries_j,
            t_side,
            t_qpos,
            t_lo,
            t_hi,
            jnp.asarray(act),
            edit=edit,
            s_cap=s_cap,
            h_cap=h_cap,
            m=m,
            ns=ns,
            k=k,
        )
        fovf_np = np.asarray(fovf)
        hovf_np = np.asarray(hovf)
        if not (fovf_np.any() or hovf_np.any()) or attempt == max_retries - 1:
            return SearchHits(
                lb=np.asarray(h_lb).reshape(nq, ns, h_cap),
                sz=np.asarray(h_sz).reshape(nq, ns, h_cap),
                err=np.asarray(h_err).reshape(nq, ns, h_cap),
                count=np.asarray(cnt).reshape(nq, ns),
                frontier_overflow=fovf_np.reshape(nq, ns),
                hit_overflow=hovf_np.reshape(nq, ns),
            )
        if fovf_np.any():
            s_cap *= 2
        if hovf_np.any():
            h_cap *= 2
    raise AssertionError("unreachable")


def _concat_hits(parts: list[SearchHits], nq: int) -> SearchHits:
    """Concatenate chunked results along the query axis, padding hit buffers
    to the widest h_cap among chunks (overflow retries may widen some)."""
    h_cap = max(p.lb.shape[2] for p in parts)
    s_fields = {}
    for name in ("lb", "sz", "err"):
        arrs = []
        for p in parts:
            a = getattr(p, name)
            if a.shape[2] < h_cap:
                pad = np.zeros((a.shape[0], a.shape[1], h_cap - a.shape[2]), dtype=a.dtype)
                a = np.concatenate([a, pad], axis=2)
            arrs.append(a)
        s_fields[name] = np.concatenate(arrs, axis=0)[:nq]
    return SearchHits(
        **s_fields,
        count=np.concatenate([p.count for p in parts], axis=0)[:nq],
        frontier_overflow=np.concatenate([p.frontier_overflow for p in parts], axis=0)[:nq],
        hit_overflow=np.concatenate([p.hit_overflow for p in parts], axis=0)[:nq],
    )


def run_scheme_search_chunked(
    index: DeviceIndex,
    queries: np.ndarray,
    tape: SchemeTape,
    *,
    edit: bool,
    active: np.ndarray | None = None,
    s_cap: int = 64,
    h_cap: int = 32,
    chunk: int = 1024,
    max_retries: int = 8,
) -> SearchHits:
    """Process queries in fixed-size chunks (the last chunk is padded with
    inactive lanes) so one compiled program shape serves the whole batch and
    per-step working memory stays bounded."""
    nq, m = queries.shape
    if nq <= chunk:
        return run_scheme_search(
            index, queries, tape, edit=edit, active=active,
            s_cap=s_cap, h_cap=h_cap, max_retries=max_retries,
        )
    act = np.ones(nq, dtype=bool) if active is None else np.asarray(active, dtype=bool)
    parts: list[SearchHits] = []
    for start in range(0, nq, chunk):
        q = queries[start : start + chunk]
        a = act[start : start + chunk]
        if q.shape[0] < chunk:  # pad to the compiled shape
            pad_n = chunk - q.shape[0]
            q = np.concatenate([q, np.zeros((pad_n, m), dtype=q.dtype)], axis=0)
            a = np.concatenate([a, np.zeros(pad_n, dtype=bool)])
        parts.append(
            run_scheme_search(
                index, q, tape, edit=edit, active=a,
                s_cap=s_cap, h_cap=h_cap, max_retries=max_retries,
            )
        )
    return _concat_hits(parts, nq)
