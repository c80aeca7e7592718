"""Batched locate: expand hit intervals into SA rows, LF-walk every row to a
sampled position in lockstep.

Replacement for ``fmc::LocateLinear`` (reference call sites
search.cpp:244-250, uni-search.cpp:124-129): the per-cursor iteration becomes
a ragged-to-dense interval expansion (cumsum + searchsorted) followed by a
fixed-trip-count masked LF-walk (< rate steps by the text-layout invariant —
see sahara_jax.index.fmindex).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from sahara_jax.engine.device import DeviceIndex
from sahara_jax.engine.rank import (
    occ_row,
    rank_all_from_row,
    sampled_bit,
    sampled_rank,
    symbol_from_row,
)


@partial(jax.jit, static_argnames=("cap_rows",))
def expand_intervals(lb: jax.Array, ln: jax.Array, cap_rows: int):
    """Flatten intervals [lb_i, lb_i+ln_i) into a dense row vector.

    Returns (rows int32[cap_rows], src int32[cap_rows] — the interval index
    each row came from, valid bool[cap_rows], total int32 scalar).  Rows
    beyond ``cap_rows`` are dropped (caller checks ``total`` for overflow).
    """
    ends = jnp.cumsum(ln.astype(jnp.int32))
    total = ends[-1] if ln.size else jnp.int32(0)
    out_idx = jnp.arange(cap_rows, dtype=jnp.int32)
    src = jnp.searchsorted(ends, out_idx, side="right").astype(jnp.int32)
    src_c = jnp.clip(src, 0, max(lb.shape[0] - 1, 0))
    start_of_src = jnp.take(ends, src_c) - jnp.take(ln, src_c)
    rows = jnp.take(lb, src_c) + (out_idx - start_of_src)
    valid = out_idx < total
    return rows, src_c, valid, total


@jax.jit
def lf_walk(index: DeviceIndex, rows: jax.Array, valid: jax.Array):
    """Walk each row backward via LF until its SA position is sampled.

    Returns (seq_id int32[...], pos int32[...]) — final located positions.

    Fast path: with the full-SA sidecar resident (``index.sa_full``) the
    walk collapses to ONE position gather plus a seq-start subtraction (the
    sampled walk is a rate-trip pointer chase whose every trip pays a full
    occ-row gather).

    Contract: rows whose suffix starts at a sentinel (inter-sequence
    padding) are unspecified and may differ between the two paths — no
    search hit can produce one (query ranks 1..4 never match sentinel 0,
    so every hit row starts at a real text character).
    """
    if index.sa_full is not None and index.seq_starts is not None:
        abs_pos = jnp.take(index.sa_full, jnp.where(valid, rows, 0))
        seq_id = (
            jnp.searchsorted(index.seq_starts, abs_pos, side="right").astype(jnp.int32) - 1
        )
        pos = abs_pos - jnp.take(index.seq_starts, jnp.clip(seq_id, 0, None))
        return jnp.where(valid, seq_id, -1), jnp.where(valid, pos, -1)
    occ, c_arr, sigma = index.occ, index.c_arr, index.sigma

    def body(_, state):
        row, steps = state
        done = sampled_bit(index.sampled, row, index.fold_s) == 1
        r = occ_row(occ, row, index.fold, sigma)
        c = symbol_from_row(r, sigma, row)
        ranks = rank_all_from_row(r, sigma, row)
        rank_c = jnp.take_along_axis(ranks, c[..., None], axis=-1)[..., 0]
        nxt = jnp.take(c_arr, c) + rank_c
        row = jnp.where(done, row, nxt)
        steps = jnp.where(done, steps, steps + 1)
        return row, steps

    steps0 = jnp.zeros_like(rows)
    # <= rate-1 steps by construction; fixed trip count keeps shapes static
    row, steps = lax.fori_loop(0, index.rate, body, (rows, steps0))
    slot = sampled_rank(index.sampled, row, index.fold_s)
    slot = jnp.clip(slot, 0, index.sample_seq.shape[0] - 1)
    seq_id = jnp.take(index.sample_seq, slot)
    pos = jnp.take(index.sample_pos, slot) + steps
    seq_id = jnp.where(valid, seq_id, -1)
    pos = jnp.where(valid, pos, -1)
    return seq_id, pos


@partial(jax.jit, static_argnames=("cap_rows",))
def locate(index: DeviceIndex, lb: jax.Array, ln: jax.Array, cap_rows: int):
    """Locate all rows of all intervals.

    Returns (src int32[cap_rows] — interval id per row, seq_id, pos, valid,
    total).
    """
    rows, src, valid, total = expand_intervals(lb, ln, cap_rows)
    seq_id, pos = lf_walk(index, jnp.where(valid, rows, 0), valid)
    return src, seq_id, pos, valid, total


@partial(jax.jit, static_argnames=("cap_rows",))
def locate_packed(index: DeviceIndex, lb: jax.Array, ln: jax.Array, cap_rows: int):
    """Like ``locate`` but returns ONE int32 array [3*cap_rows + 8]:
    src | seq_id | pos | (total, pad...) with invalid rows marked seq_id=-1
    — a single device->host transfer."""
    src, seq_id, pos, valid, total = locate(index, lb, ln, cap_rows)
    tail = jnp.zeros(8, dtype=jnp.int32).at[0].set(jnp.minimum(total, cap_rows))
    return jnp.concatenate([src, jnp.where(valid, seq_id, -1), pos, tail])


@partial(jax.jit, static_argnames=())
def lf_walk_packed(index: DeviceIndex, rows: jax.Array, valid: jax.Array):
    """LF-walk only, ONE packed output [2*n]: seq_id | pos (invalid rows
    seq_id = -1)."""
    seq_id, pos = lf_walk(index, jnp.where(valid, rows, 0), valid)
    return jnp.concatenate([seq_id, pos])


def locate_rows_begin(index: DeviceIndex, lb, ln, cap_rows: int) -> dict:
    """Expand the ragged intervals with numpy on the host and launch the
    device LF-walk WITHOUT blocking — jax dispatch is async, so callers can
    overlap further host/device work and call :func:`locate_rows_end`
    later."""
    import numpy as np

    lb = np.asarray(lb, dtype=np.int64)
    ln = np.asarray(ln, dtype=np.int64)
    total = int(ln.sum())
    n = min(total, cap_rows)
    src = np.repeat(np.arange(len(ln), dtype=np.int32), ln)[:n]
    excl = np.concatenate([[0], np.cumsum(ln)[:-1]])
    offsets = np.arange(total, dtype=np.int64)[:n] - np.repeat(excl, ln)[:n]
    rows = (lb[src] + offsets).astype(np.int32)
    rows_pad = np.zeros(cap_rows, dtype=np.int32)
    rows_pad[:n] = rows
    valid = np.zeros(cap_rows, dtype=bool)
    valid[:n] = True
    fut = lf_walk_packed(index, jnp.asarray(rows_pad), jnp.asarray(valid))
    return {"fut": fut, "src": src, "n": n, "cap_rows": cap_rows}


def locate_rows_end(ctx: dict):
    """Block on a dispatched LF-walk: numpy (src, seq_id, pos) of valid rows."""
    import numpy as np

    packed = np.asarray(ctx["fut"])
    n, cap_rows = ctx["n"], ctx["cap_rows"]
    return ctx["src"], packed[:cap_rows][:n], packed[cap_rows:][:n]


def locate_rows_host(index: DeviceIndex, lb, ln, cap_rows: int):
    """Synchronous locate_rows_begin + locate_rows_end."""
    return locate_rows_end(locate_rows_begin(index, lb, ln, cap_rows))
