"""Seed-and-verify search engine: pigeonhole exact seeding + banded verify.

The third engine (after ``approx`` and ``workq``), and an inversion of the
whole search problem.  The reference — and the two scheme engines here —
carry *approximate* search through FM space (search.cpp:227-240): every
error branch multiplies live states, so the per-query cost explodes with k.
On an accelerator the cheap resource is dense vectorized arithmetic, so
this engine does the opposite:

1. **Seed**: split each query into k+1 contiguous parts.  Any occurrence
   with <= k errors aligns at least one part *exactly* (pigeonhole over the
   alignment's error positions), so exact backward search of every part
   finds a witness for every hit.  Exact search needs no queue at all: all
   nq*(k+1) part lanes step in lockstep through one scan — ~m occ rows per
   query TOTAL, where the scheme engines pay per live *state*.
2. **Expand**: part SA intervals -> candidate rows (exact host-side ragged
   expansion, no overflow possible).
3. **Verify**: LF-walk each candidate row to its text position (the
   existing locate kernel), then check the *full query* against the packed
   text store around the anchor with a banded minimal-span edit DP
   ((2k+1) candidate starts x (2k+1) band, unit-cost elementwise ops) — emitting
   located hits directly.  There is no separate locate phase: the verified
   position IS the hit position.

Hit contract: identical to the scheme engines — every (queryId, seqId,
pos) whose minimal-span edit (or Hamming) distance is <= k, with the
minimal error count per position (tests/util.py::brute_edit_hits_minimal
is the spec; property-tested against it and against the workq engine).
Sentinel barriers: window characters with rank 0 (sequence padding) can
neither match, substitute, nor delete, so alignments never cross sequence
boundaries — mirroring FM-space extension, which only ever extends by
symbols >= 1.
"""

from __future__ import annotations

import dataclasses
import os as _os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from sahara_jax.engine.device import DeviceIndex
from sahara_jax.engine.locate import lf_walk
from sahara_jax.engine.rank import rank_sym_word

_BLK = 512
# plain int (NOT jnp.int32: a module-level jnp call would initialize the
# XLA backend at import time, breaking jax.distributed.initialize callers)
_INF = 1 << 20

MIN_PART = 10  # shortest exact part worth seeding with (else candidate blowup)

# Per-part occurrence budget: a part whose SA interval exceeds this many rows
# (low-complexity or repeat-saturated seeds — e.g. poly-A reads against a
# tandem-repeat reference) is NOT host-expanded; its query is flagged for
# fallback to the scheme engine instead.  Pigeonhole exactness needs all
# k+1 parts as potential witnesses, so dropping ANY part drops the whole
# query from this engine — the driver re-runs flagged queries through the
# workq engine (which has real capacity planning, workq.py), keeping the
# combined hit set exact while bounding host candidate memory to
# nq * (k+1) * PART_CAP rows worst-case.
PART_CAP = 1 << 16


def _balanced_split(m: int, p: int) -> tuple[tuple[int, int], ...]:
    base, rem = divmod(m, p)
    parts = []
    off = 0
    for i in range(p):
        ln = base + (1 if i < rem else 0)
        parts.append((off, ln))
        off += ln
    return tuple(parts)


def plan_parts(m: int, k: int, min_part: int = MIN_PART) -> tuple[tuple[int, int], ...] | None:
    """Balanced split of an m-char query into k+1 parts: ((off, len), ...).
    None when the parts would be too short to filter effectively.

    SAHARA_SV_PARTS_EXTRA=N adds N extra parts (still pigeonhole-complete:
    k errors over k+1+N parts leave >= 1+N parts exact) — shorter parts
    cut the seed scan's post-table step count at the cost of candidate
    volume; an A/B knob for the seed-phase floor (tools/ab_sv_parts.py)."""
    import os

    p = k + 1 + int(os.environ.get("SAHARA_SV_PARTS_EXTRA", "0"))
    if m // p < min_part:
        p = k + 1
        if m // p < min_part:
            return None
    return _balanced_split(m, p)


def plan_parts_e1(m: int, k: int, min_part: int = MIN_PART) -> tuple[tuple[int, int], ...] | None:
    """Parts for ONE-error-per-seed pigeonhole (scheme-seeded SV): with
    P = ceil((k+1)/2) disjoint parts covering [0, m), any alignment with
    <= k errors leaves some part whose restricted alignment has <= 1 error
    (if every part had >= 2, the total would be >= 2P >= k+1).  Extends SV
    eligibility to short reads whose exact k+1-way split would drop below
    MIN_PART (e.g. 36bp at k=3: 2 parts of 18 instead of 4 parts of 9);
    seeds come from a k=1 scheme-engine pass over the part slices."""
    if k < 2:
        return None  # k<2 either has an exact plan or parts are too short anyway
    p = (k + 2) // 2
    if m // p < min_part:
        return None
    return _balanced_split(m, p)


def seed_bad_mask(
    index: DeviceIndex, queries: np.ndarray, parts: tuple[tuple[int, int], ...]
) -> np.ndarray | None:
    """Queries whose table-covered part suffixes carry ranks the j-mer
    table cannot encode (N, sentinels — anything outside 1..4): their seed
    intervals are garbage under the table path and they must fall back to
    a scheme engine.  None when the table path is inactive."""
    j = index.lut_j
    if index.lut is None or j <= 0 or min(ln for _, ln in parts) < j:
        return None
    cols = [off + ln - 1 - i for off, ln in parts for i in range(j)]
    sub = queries[:, cols]
    bad = ((sub < 1) | (sub > 4)).any(axis=1)
    return bad if bad.any() else None


def sv_eligible(index: DeviceIndex, m: int, k: int, seed_errors: int = 0) -> bool:
    """``seed_errors=1`` additionally admits the scheme-seeded plan
    (plan_parts_e1) when the exact k+1-way split is too short."""
    if not (index.text4 is not None and index.seq_starts is not None and k <= 7):
        return False
    if plan_parts(m, k) is not None:
        return True
    return seed_errors >= 1 and plan_parts_e1(m, k) is not None


# --------------------------------------------------------------------------
# phase 1: exact part seeding (one lockstep scan, no queue)
# --------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("parts",))
def seed_parts(
    index: DeviceIndex,
    queries: jax.Array,  # int32[nq, m]
    parts: tuple[tuple[int, int], ...],
) -> jax.Array:
    """Exact backward search of every (query, part) lane against the
    forward occ table.  Returns ONE packed int32[2 * nq * P]: lo | sz."""
    lo, hi = _seed_scan(index, queries, parts)
    sz = jnp.maximum(hi - lo, 0)
    return jnp.concatenate([lo.reshape(-1), sz.reshape(-1)])


def _seed_scan(
    index: DeviceIndex,
    queries: jax.Array,  # int32[nq, m]
    parts: tuple[tuple[int, int], ...],
) -> tuple[jax.Array, jax.Array]:
    """Traceable seed-scan body: (lo, hi) int32[nq, P] part intervals."""
    occ, c_arr, sigma = index.occ, index.c_arr, index.sigma
    queries = queries.astype(jnp.int32)  # uint8 ranks would wrap in the code shifts
    nq = queries.shape[0]
    p_cnt = len(parts)
    maxlen = max(ln for _, ln in parts)
    # j-mer table skip: the first lut_j steps of every lane collapse into
    # one (lo, hi) lookup per (query, part) — digits are the consumed
    # ranks - 1, little-endian in consumption order (index/jmer.py).
    # Queries carrying ranks outside 1..4 take the table path with a
    # clamped code and produce garbage intervals; the driver flags them
    # for scheme-engine fallback BEFORE expansion (expand_seeds zeroes
    # their sizes), so those lanes never reach verification.
    t0 = 0
    if index.lut is not None and index.lut_j > 0 and min(ln for _, ln in parts) >= index.lut_j:
        j = index.lut_j
        code = jnp.zeros((nq, p_cnt), dtype=jnp.int32)
        for i in range(j):
            cols = [off + ln - 1 - i for off, ln in parts]
            c = jnp.stack([queries[:, col] for col in cols], axis=1)  # [nq, P]
            code = code + ((c - 1) << (2 * i))
        code = jnp.clip(code, 0, (1 << (2 * j)) - 1)
        lo = jnp.take(index.lut, code.reshape(-1)).reshape(nq, p_cnt)
        hi = jnp.take(index.lut, code.reshape(-1) + (1 << (2 * j))).reshape(nq, p_cnt)
        t0 = j
    else:
        lo = jnp.zeros((nq, p_cnt), dtype=jnp.int32)
        hi = jnp.full((nq, p_cnt), jnp.int32(index.n))

    # unrolled lockstep: step t consumes char off+len-1-t of every part still
    # active (static per step); ONE fused two-edge single-symbol rank gather
    # for all parts (rank_sym_word: the step knows each lane's symbol, so
    # the all-sigma rank + select of the original design is ~2x wasted
    # elementwise work)
    for t in range(t0, maxlen):
        cols = [off + max(ln - 1 - t, 0) for off, ln in parts]
        act = [ln > t for _, ln in parts]
        c = jnp.stack([queries[:, col] for col in cols], axis=1)  # [nq, P]
        c_flat = jnp.clip(c.reshape(-1), 0, sigma - 1)
        c2 = jnp.concatenate([c_flat, c_flat])
        pos = jnp.concatenate([lo.reshape(-1), hi.reshape(-1)])
        rank_c = rank_sym_word(occ, pos >> 5, c2, pos, index.fold, sigma)
        base = jnp.take(c_arr, c_flat).reshape(nq, p_cnt)
        new_lo = base + rank_c[: nq * p_cnt].reshape(nq, p_cnt)
        new_hi = base + rank_c[nq * p_cnt :].reshape(nq, p_cnt)
        act_m = jnp.asarray(act, dtype=bool)[None, :]
        lo = jnp.where(act_m, new_lo, lo)
        hi = jnp.where(act_m, new_hi, hi)

    return lo, hi


def expand_seeds(
    packed: np.ndarray,
    nq: int,
    parts: tuple[tuple[int, int], ...],
    active: np.ndarray | None,
    part_cap: int = PART_CAP,
    bad: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host ragged expansion of part intervals into candidate rows.

    Returns (rows int32[R] — SA rows, q_of int32[R], off_of int32[R] — the
    part's query offset, fallback bool[nq]).  Exact (host-side), so
    candidates can never overflow a device buffer.  Queries with any part
    interval larger than ``part_cap``, plus any flagged in ``bad`` (ranks
    the j-mer table cannot encode — their seed intervals are garbage), are
    excluded entirely and flagged in ``fallback`` — the caller must search
    them with a scheme engine (see PART_CAP above for why partial
    expansion would lose hits)."""
    p_cnt = len(parts)
    lo = packed[: nq * p_cnt].astype(np.int64)
    sz = packed[nq * p_cnt :].astype(np.int64)
    if active is not None:
        sz = np.where(np.repeat(np.asarray(active, dtype=bool), p_cnt), sz, 0)
    fallback = (sz.reshape(nq, p_cnt) > part_cap).any(axis=1)
    if bad is not None:
        b = np.asarray(bad, dtype=bool)
        if active is not None:
            b = b & np.asarray(active, dtype=bool)
        fallback = fallback | b
    if fallback.any():
        sz = np.where(np.repeat(fallback, p_cnt), 0, sz)
    total = int(sz.sum())
    lane = np.repeat(np.arange(nq * p_cnt, dtype=np.int64), sz)
    excl = np.concatenate([[0], np.cumsum(sz)[:-1]])
    rows = (lo[lane] + (np.arange(total, dtype=np.int64) - np.repeat(excl, sz))).astype(np.int32)
    offs = np.asarray([off for off, _ in parts], dtype=np.int32)
    q_of = (lane // p_cnt).astype(np.int32)
    off_of = offs[(lane % p_cnt).astype(np.int32)]
    return rows, q_of, off_of, fallback


# --------------------------------------------------------------------------
# phase 2: locate + window gather + banded minimal-span DP verify
# --------------------------------------------------------------------------


def _gather_windows(index: DeviceIndex, base: jax.Array, wlen: int) -> jax.Array:
    """Ranks of text[base .. base+wlen) per candidate: [R, wlen] int32.
    Out-of-range positions read as rank 0 (sentinel)."""
    n = index.n
    nw = index.text4.shape[0]
    wbase = base >> 3
    nwords = wlen // 8 + 2
    widx = wbase[:, None] + jnp.arange(nwords, dtype=jnp.int32)[None, :]
    words = jnp.take(index.text4, jnp.clip(widx, 0, nw - 1))  # [R, nwords]
    # materialized once: the 8 alignment slices below each read every word
    words = lax.optimization_barrier(words)
    off8 = base & 7
    # unpack every gathered nibble once (pure elementwise), then select the
    # rank-offset alignment from 8 STATIC slices — no dynamic lane gathers
    uwords = lax.bitcast_convert_type(words, jnp.uint32)
    shifts = jnp.asarray(4 * np.arange(8, dtype=np.uint32))[None, None, :]
    allr = lax.bitcast_convert_type(
        (uwords[:, :, None] >> shifts) & jnp.uint32(0xF), jnp.int32
    ).reshape(base.shape[0], nwords * 8)
    out = allr[:, :wlen]
    for o in range(1, 8):
        out = jnp.where((off8 == o)[:, None], allr[:, o : o + wlen], out)
    pos = base[:, None] + jnp.arange(wlen, dtype=jnp.int32)[None, :]
    return jnp.where((pos >= 0) & (pos < n), out, 0)


@partial(jax.jit, static_argnames=("m", "k", "edit", "hq_cap"))
def sv_verify(
    index: DeviceIndex,
    queries: jax.Array,  # int32[nq, m]
    rows: jax.Array,  # int32[capR] SA rows (padded)
    q_of: jax.Array,  # int32[capR]
    off_of: jax.Array,  # int32[capR]
    valid: jax.Array,  # bool[capR]
    *,
    m: int,
    k: int,
    edit: bool,
    hq_cap: int,
) -> jax.Array:
    """Locate candidate rows and verify the full query around each anchor.

    Returns ONE packed int32[3*hq_cap + 8]: hit candidate-ids | abs text
    positions | error counts | (count, hit_overflow, pad...).  The id
    encodes (delta * capR + candidate), host-decodable with q_of."""
    sel, h_pos, h_err, total = _verify_core(
        index, queries, rows, q_of, off_of, valid, m=m, k=k, edit=edit, hq_cap=hq_cap
    )
    tail = jnp.zeros(8, dtype=jnp.int32)
    tail = tail.at[0].set(jnp.minimum(total, hq_cap))
    tail = tail.at[1].set((total > hq_cap).astype(jnp.int32))
    return jnp.concatenate([sel, h_pos, h_err, tail])


def _verify_core(
    index: DeviceIndex,
    queries: jax.Array,
    rows: jax.Array,
    q_of: jax.Array,
    off_of: jax.Array,
    valid: jax.Array,
    *,
    m: int,
    k: int,
    edit: bool,
    hq_cap: int,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Traceable verify body: (sel int32[hq_cap] — delta-major flat slot
    (delta * capR + candidate) or -1, abs positions, error counts, total
    hit count before capping)."""
    capR = rows.shape[0]
    assert capR % _BLK == 0
    S = 2 * k + 1 if edit else 1  # candidate starts per anchor
    B = 2 * k + 1  # DP band width

    # --- locate: SA row -> absolute text position of the part match -------
    seq_id, pos = lf_walk(index, jnp.where(valid, rows, 0), valid)
    seq_id_c = jnp.clip(seq_id, 0, index.seq_starts.shape[0] - 1)
    abs_pos = jnp.take(index.seq_starts, seq_id_c) + pos
    a0 = abs_pos - off_of  # anchor: query start if no indels before the part
    base = a0 - (k if edit else 0)  # window origin (earliest candidate start)

    wlen = m + (3 * k if edit else 0) + 1
    wlen = -(-wlen // 8) * 8  # round up so the unpack variants stay static
    W = _gather_windows(index, base, wlen)  # [capR, wlen] ranks, 0 = sentinel/OOB
    Q = jnp.take(queries, jnp.minimum(q_of, queries.shape[0] - 1), axis=0)  # [capR, m]

    if not edit:
        # Hamming: single start (p = a0), exact span of m chars; sentinels
        # (rank 0) poison the span (oracle requires p + m <= seq length)
        wm = W[:, :m]
        mism = jnp.sum((wm != Q).astype(jnp.int32), axis=1)
        dist = jnp.where(jnp.any(wm == 0, axis=1), _INF, mism)  # [capR]
        dist = dist[:, None]  # [capR, 1]
    else:
        # Banded minimal-span edit DP, all S starts at once.
        # For start delta (p = base + delta), DP cell (i, j): j = i - k + c,
        # c in [0, B).  Window char for (delta, c) at DP row i lives at
        # W[:, delta + i - k + c - 1] -> rolling-buffer column delta + c.
        # a = oracle's A matrix (first span char consumed by match/sub:
        # no deletion may enter column j == 1); b = A plus "last char
        # consumed by match/sub"; dist = min_j b[m][j].
        c_iota = jnp.arange(B, dtype=jnp.int32)[None, None, :]  # [1, 1, B]
        d_iota = jnp.arange(S, dtype=jnp.int32)[None, :, None]  # [1, S, 1]

        # a[0][j]: j == 0 -> 0, j > 0 unreachable (w chars only consumed
        # via M/S through sub0, which needs i >= 1)
        j0 = 0 - k + c_iota  # j at i=0
        a_st = jnp.where(jnp.broadcast_to(j0 == 0, (capR, S, B)), 0, _INF)
        b_st = jnp.full((capR, S, B), _INF)
        dist_st = jnp.full((capR, S), _INF)

        # rolling window buffer: before step i it holds W columns
        # [i-k-2 .. i+3k-2]; each step rolls in column i + 3k - 1.
        # initialize for i=1: columns [-k-1 .. 3k-1) with negatives = 0
        width = 4 * k + 1
        neg = k + 1  # columns -k-1..-1
        buf0 = jnp.concatenate(
            [jnp.zeros((capR, neg), dtype=jnp.int32), W[:, : width - neg]], axis=1
        )
        xs_cols = W[:, 3 * k - 1 + 1 : 3 * k + m].T  # column i+3k-1 for i=1..m -> [m, capR]
        q_xs = Q.T  # [m, capR]
        i_xs = jnp.arange(1, m + 1, dtype=jnp.int32)

        def dp_step(carry, xs):
            a_prev, b_prev, dist_acc, buf = carry
            w_new, q_i, i = xs
            buf = jnp.concatenate([buf[:, 1:], w_new[:, None]], axis=1)
            # w char per (delta, c): buffer column delta + c (static slices)
            wch = jnp.stack([buf[:, d : d + B] for d in range(S)], axis=1)  # [capR, S, B]
            j = i - k + c_iota  # [1, 1, B] broadcast j per band cell
            sub = jnp.where(wch == q_i[:, None, None], 0, 1)
            sub = jnp.where(wch == 0, _INF, sub)  # sentinel: no match/sub
            dele = jnp.where(wch == 0, _INF, 1)  # sentinel: no deletion
            # shifted a_prev: diag c' = c (same col), up c' = c + 1
            up = jnp.concatenate([a_prev[:, :, 1:], jnp.full((capR, S, 1), _INF)], axis=2)
            cand = jnp.minimum(a_prev + sub, up + 1)
            # base column j == 0: a[i][0] = i (leading query insertions)
            cand = jnp.where(j == 0, i, cand)
            cand = jnp.where(j < 0, _INF, cand)
            # left (deletion) chain within the row; j == 1 admits none.
            # Min-plus prefix form instead of the sequential per-column
            # update (B-1 dependent full-tensor writes the compiler cannot
            # fuse): entering column c from c-1 costs w[c] (1, or _INF when
            # the deletion is forbidden), so with P = prefix-sum(w),
            # a_cur[c] = P[c] + min_{c'<=c}(cand[c'] - P[c']) — one
            # Kogge-Stone prefix-sum + prefix-min, log2(B) shifted ops.
            # Paths crossing a forbidden edge pick up +_INF via P and lose;
            # magnitudes stay < B*_INF + _INF + m << 2^31.
            if _os.environ.get("SAHARA_VERIFY_DP", "") == "chain":
                a_cur = cand
                for c in range(1, B):
                    left = a_cur[:, :, c - 1] + dele[:, :, c]
                    left = jnp.where(j[0, 0, c] == 1, _INF, left)
                    a_cur = a_cur.at[:, :, c].set(jnp.minimum(a_cur[:, :, c], left))
            else:
                w = jnp.where(j == 1, _INF, dele)  # cost of entering col c
                w = jnp.concatenate(
                    [jnp.zeros_like(w[:, :, :1]), w[:, :, 1:]], axis=2
                )
                p = w
                for sh in (1, 2, 4, 8):
                    if sh >= B:
                        break
                    p = p + jnp.pad(p, ((0, 0), (0, 0), (sh, 0)))[:, :, :B]
                mm = cand - p
                for sh in (1, 2, 4, 8):
                    if sh >= B:
                        break
                    shifted = jnp.pad(
                        mm, ((0, 0), (0, 0), (sh, 0)), constant_values=_INF
                    )[:, :, :B]
                    mm = jnp.minimum(mm, shifted)
                a_cur = jnp.minimum(cand, mm + p)
            # b: last char consumed by match/sub
            b_up = jnp.concatenate([b_prev[:, :, 1:], jnp.full((capR, S, 1), _INF)], axis=2)
            b_cur = jnp.minimum(a_prev + sub, b_up + 1)
            b_cur = jnp.where(j <= 0, _INF, b_cur)
            dist_acc = jnp.where(i == m, jnp.min(b_cur, axis=2), dist_acc)
            return (a_cur, b_cur, dist_acc, buf), None

        (a_st, b_st, dist, buf0), _ = lax.scan(
            dp_step, (a_st, b_st, dist_st, buf0), (xs_cols, q_xs, i_xs)
        )

    # --- emit: compact (candidate, delta) pairs with dist <= k ------------
    flags = (dist <= k) & valid[:, None]  # [capR, S]
    fl = flags.T.reshape(-1)  # delta-major
    pos_all = (base[None, :] + jnp.arange(S, dtype=jnp.int32)[:, None]).reshape(-1)
    err_all = dist.T.reshape(-1)
    incl = jnp.cumsum(fl.astype(jnp.int32))
    total = incl[-1]
    dest = jnp.where(fl, incl - 1, hq_cap)
    # scatter the delta-major FLAT slot index (delta * capR + cand), then
    # gather pos/err by slot: ids value == slot for this layout
    slot = jnp.arange(S * capR, dtype=jnp.int32)
    sel = jnp.full(hq_cap, -1, dtype=jnp.int32).at[dest].set(slot, mode="drop")
    got = sel >= 0
    sel_c = jnp.maximum(sel, 0)
    h_pos = jnp.where(got, jnp.take(pos_all, sel_c), -1)
    h_err = jnp.where(got, jnp.take(err_all, sel_c), 0)
    return jnp.where(got, sel, -1), h_pos, h_err, total


# --------------------------------------------------------------------------
# fused single-dispatch path: seed -> expand -> verify in ONE device call
# --------------------------------------------------------------------------
#
# The two-phase driver costs, per chunk, one int32 query H2D, a seed-result
# D2H round trip and a verify D2H, with the host expansion between the two
# device calls.  The fused path
# (a) uploads the whole query matrix ONCE as uint8 and slices chunks
# on-device, and (b) moves the ragged candidate expansion onto the device
# (the same cumsum/searchsorted locate.expand_intervals uses), so a chunk
# costs ONE dispatch and ONE D2H of the final hit list.  Candidate or hit
# overflow falls back to the exact two-phase path for that chunk — the
# fused path is a fast path, never a semantics change.


@partial(
    jax.jit,
    static_argnames=("parts", "m", "k", "edit", "capR", "hq_cap", "part_cap", "chunk"),
)
def sv_fused(
    index: DeviceIndex,
    qfull: jax.Array,  # uint8[nq_pad, m] — the WHOLE padded query matrix
    act_full: jax.Array,  # bool[nq_pad]
    bad_full: jax.Array,  # bool[nq_pad] — queries the j-mer table can't seed
    start: jax.Array,  # int32 scalar — chunk offset into qfull
    *,
    parts: tuple[tuple[int, int], ...],
    m: int,
    k: int,
    edit: bool,
    capR: int,
    hq_cap: int,
    part_cap: int,
    chunk: int,
) -> jax.Array:
    """One fused chunk: returns packed int32[3*hq_cap + ceil(chunk/32) + 8]:
    local hit query idx | abs positions | errors | fallback bitmask |
    (n_hits, hit_ovf, cand_ovf, n_cands, pad*4)."""
    from sahara_jax.engine.locate import expand_intervals

    P = len(parts)
    queries = lax.dynamic_slice(qfull, (start, 0), (chunk, m)).astype(jnp.int32)
    act = lax.dynamic_slice(act_full, (start,), (chunk,))
    bad = lax.dynamic_slice(bad_full, (start,), (chunk,))

    lo, hi = _seed_scan(index, queries, parts)
    sz = jnp.maximum(hi - lo, 0)  # [chunk, P]
    sz = jnp.where((act & ~bad)[:, None], sz, 0)
    over = (sz > part_cap).any(axis=1)
    fallback = (over | bad) & act
    sz = jnp.where(fallback[:, None], 0, sz)
    n_cands = jnp.sum(sz)  # int32 reduction: exact
    cand_ovf = n_cands > capR
    ln = jnp.where(cand_ovf, 0, sz.reshape(-1))  # zero sizes keep the int32
    # interval cumsum bounded by capR
    rows, src, valid, _ = expand_intervals(lo.reshape(-1), ln, capR)
    q_of = src // P
    offs = jnp.asarray(np.asarray([off for off, _ in parts], dtype=np.int32))
    off_of = jnp.take(offs, src % P)

    sel, h_pos, h_err, total = _verify_core(
        index, queries, jnp.where(valid, rows, 0), q_of, off_of, valid,
        m=m, k=k, edit=edit, hq_cap=hq_cap,
    )
    got = sel >= 0
    cand = jnp.maximum(sel, 0) % capR
    h_q = jnp.where(got, jnp.take(q_of, cand), -1)

    # fallback flags packed 32/word (the D2H is latency-bound; keep it small)
    nw = -(-chunk // 32)
    fb = jnp.zeros(nw * 32, dtype=jnp.int32).at[:chunk].set(fallback.astype(jnp.int32))
    bits = jnp.asarray(np.arange(32, dtype=np.int32))[None, :]
    fb_words = jnp.sum(fb.reshape(nw, 32) << bits, axis=1)

    tail = jnp.zeros(8, dtype=jnp.int32)
    tail = tail.at[0].set(jnp.minimum(total, hq_cap))
    tail = tail.at[1].set((total > hq_cap).astype(jnp.int32))
    tail = tail.at[2].set(cand_ovf.astype(jnp.int32))
    tail = tail.at[3].set(n_cands)
    return jnp.concatenate([h_q, h_pos, h_err, fb_words, tail])


# --------------------------------------------------------------------------
# host driver
# --------------------------------------------------------------------------


@dataclasses.dataclass
class SvHits:
    """Verified, located hits (absolute text positions)."""

    q_idx: np.ndarray  # int32[H] — local query index
    abs_pos: np.ndarray  # int64[H] — position in the padded text layout
    err: np.ndarray  # int32[H]
    # queries excluded by the per-part occurrence budget (PART_CAP); the
    # caller must re-search these with a scheme engine for an exact hit set
    fallback: np.ndarray | None = None  # bool[nq] or None


def _quant(x: int) -> int:
    """512-multiple with ~3 significant bits (compile-variant bound)."""
    x = max(int(x), _BLK)
    step = max(_BLK, 1 << (max(x - 1, 1).bit_length() - 3))
    return -(-x // step) * step


_SEED_TAPES: dict[tuple[int, bool], object] = {}


def _seed_tape(ln: int, edit: bool):
    """Compiled k=1 scheme tape for ln-char seed parts (cached)."""
    key = (ln, edit)
    t = _SEED_TAPES.get(key)
    if t is None:
        from sahara_jax.engine.tape import compile_tape
        from sahara_jax.schemes import GENERATORS, expand, limit_to_hamming

        ess = expand(GENERATORS["optimum"].generator(0, 1, 0, 0), ln)
        if not edit:
            ess = limit_to_hamming(ess)
        t = compile_tape(ess)
        _SEED_TAPES[key] = t
    return t


def dispatch_sv(
    index: DeviceIndex,
    queries: np.ndarray,  # int32[nq, m]
    k: int,
    *,
    edit: bool,
    active: np.ndarray | None = None,
    queries_dev: jax.Array | None = None,
    part_cap: int = PART_CAP,
) -> dict:
    """Launch the seed phase asynchronously; collect with collect_sv.

    Two seed plans: exact parts (plan_parts — the lockstep scan) when the
    k+1-way split is long enough, else ONE-error seeds over the
    plan_parts_e1 split, found by a k=1 scheme-engine (workq) pass on the
    part slices.  Verification is identical either way: the ±k candidate
    band absorbs the anchor displacement (prefix indels <= k - e_part plus
    minimal-span start trim <= e_part, so total <= k)."""
    nq, m = queries.shape
    parts = plan_parts(m, k)
    qdev = jnp.asarray(queries, dtype=jnp.int32) if queries_dev is None else queries_dev
    if parts is not None:
        fut = seed_parts(index, qdev, parts)
        return {
            "fut": fut, "qdev": qdev, "nq": nq, "m": m, "k": k, "edit": edit,
            "parts": parts, "active": active, "index": index, "part_cap": part_cap,
            "bad": seed_bad_mask(index, np.asarray(queries), parts),
        }
    parts = plan_parts_e1(m, k)
    if parts is None:
        raise ValueError(f"seed-verify not applicable: m={m}, k={k}")
    from sahara_jax.engine.workq import dispatch_workq

    qhost = np.asarray(queries)
    act = None if active is None else np.asarray(active, dtype=bool)
    groups: dict[int, list[int]] = {}  # part length -> part indices
    for pi, (off, ln) in enumerate(parts):
        groups.setdefault(ln, []).append(pi)
    wq = []
    for ln, pidx in sorted(groups.items()):
        sub = np.stack([qhost[:, parts[pi][0] : parts[pi][0] + ln] for pi in pidx], axis=1)
        pq = np.ascontiguousarray(sub.reshape(nq * len(pidx), ln)).astype(np.int32)
        a = None if act is None else np.repeat(act, len(pidx))
        wq.append(
            (dispatch_workq(index, pq, _seed_tape(ln, edit), edit=edit, active=a,
                            dedup=True, max_retries=6),
             pidx)
        )
    return {
        "seed_e1": wq, "qdev": qdev, "nq": nq, "m": m, "k": k, "edit": edit,
        "parts": parts, "active": active, "index": index, "part_cap": part_cap,
    }


_MAX_CAPR = 1 << 20  # candidate rows per verify call (bounds its DP workspace)


def collect_sv_expand(st: dict) -> None:
    """Block on the seed result and host-expand candidates (phase between
    the two device calls — split out so drivers can pipeline)."""
    if "seed_e1" in st:
        _collect_e1_expand(st)
        return
    packed = np.asarray(st["fut"])
    rows, q_of, off_of, fallback = expand_seeds(
        packed, st["nq"], st["parts"], st["active"], st.get("part_cap", PART_CAP),
        bad=st.get("bad"),
    )
    st["cands"] = (rows, q_of, off_of)
    st["fallback"] = fallback


def _collect_e1_expand(st: dict) -> None:
    """Expand one-error seed hits (workq FlatHits intervals) to candidate
    rows; apply the per-(query, part) occurrence budget like the exact
    path, and drop duplicate (query, part, row) candidates (the same text
    span can witness two alignments of a part)."""
    from sahara_jax.engine.workq import collect_workq

    nq, parts = st["nq"], st["parts"]
    part_cap = st.get("part_cap", PART_CAP)
    p_cnt = len(parts)
    offs = np.asarray([off for off, _ in parts], dtype=np.int32)
    tot = np.zeros(nq * p_cnt, dtype=np.int64)
    acc = []  # (lb int64[], sz int64[], qp int64[] = q * p_cnt + part)
    for st_wq, pidx in st["seed_e1"]:
        h = collect_workq(st_wq)
        if h.queue_overflow or h.hit_overflow:
            raise RuntimeError(
                "seed search overflowed its work buffers after retries "
                "(pathologically repetitive reference for one-error seeds)"
            )
        if h.n_hits == 0:
            continue
        ns = st_wq["ns"]
        npi = len(pidx)
        pq = (h.lane // ns).astype(np.int64)
        q = pq // npi
        part = np.asarray(pidx, dtype=np.int64)[pq % npi]
        qp = q * p_cnt + part
        sz = h.sz.astype(np.int64)
        np.add.at(tot, qp, sz)
        acc.append((h.lb.astype(np.int64), sz, qp))
    fallback = (tot.reshape(nq, p_cnt) > part_cap).any(axis=1)
    if acc:
        lb = np.concatenate([a[0] for a in acc])
        sz = np.concatenate([a[1] for a in acc])
        qp = np.concatenate([a[2] for a in acc])
        sz = np.where(fallback[(qp // p_cnt).astype(np.int64)], 0, sz)
        total = int(sz.sum())
        lane = np.repeat(np.arange(len(sz), dtype=np.int64), sz)
        excl = np.concatenate([[0], np.cumsum(sz)[:-1]])
        rows = (lb[lane] + (np.arange(total, dtype=np.int64) - excl[lane])).astype(np.int64)
        key = (qp[lane] << 32) | rows  # rows < 2^31 (int32 SA)
        key = np.unique(key)
        rows = (key & 0xFFFFFFFF).astype(np.int32)
        qp_u = key >> 32
        q_of = (qp_u // p_cnt).astype(np.int32)
        off_of = offs[(qp_u % p_cnt).astype(np.int32)]
    else:
        rows = np.zeros(0, dtype=np.int32)
        q_of = np.zeros(0, dtype=np.int32)
        off_of = np.zeros(0, dtype=np.int32)
    st["cands"] = (rows, q_of, off_of)
    st["fallback"] = fallback


def dispatch_sv_verify(st: dict, hit_mult: int = 8) -> None:
    """Launch verify call(s) for the expanded candidates (async)."""
    index, m, k, edit = st["index"], st["m"], st["k"], st["edit"]
    rows, q_of, off_of = st["cands"]
    futs = []
    for s in range(0, max(len(rows), 1), _MAX_CAPR):
        r = rows[s : s + _MAX_CAPR]
        capR = _quant(len(r))
        pad = capR - len(r)
        rr = np.pad(r, (0, pad)).astype(np.int32)
        qq = np.pad(q_of[s : s + _MAX_CAPR], (0, pad)).astype(np.int32)
        oo = np.pad(off_of[s : s + _MAX_CAPR], (0, pad)).astype(np.int32)
        vv = np.zeros(capR, dtype=bool)
        vv[: len(r)] = True
        hq_cap = _quant(max(2 * len(r), hit_mult * 64))
        futs.append(
            (
                sv_verify(
                    index, st["qdev"], jnp.asarray(rr), jnp.asarray(qq), jnp.asarray(oo),
                    jnp.asarray(vv), m=m, k=k, edit=edit, hq_cap=hq_cap,
                ),
                qq, capR, hq_cap, s,
            )
        )
    st["vfuts"] = futs


def collect_sv(st: dict) -> SvHits:
    """Block on verify calls; retry any slice whose hit buffer overflowed."""
    index, m, k, edit = st["index"], st["m"], st["k"], st["edit"]
    out_q, out_p, out_e = [], [], []
    for fut, qq, capR, hq_cap, s in st["vfuts"]:
        while True:
            packed = np.asarray(fut)
            cnt = int(packed[3 * hq_cap])
            ovf = bool(packed[3 * hq_cap + 1])
            if not ovf:
                break
            hq_cap = _quant(hq_cap * 4)
            rows, q_of, off_of = st["cands"]
            r = rows[s : s + _MAX_CAPR]
            pad = capR - len(r)
            rr = np.pad(r, (0, pad)).astype(np.int32)
            oo = np.pad(off_of[s : s + _MAX_CAPR], (0, pad)).astype(np.int32)
            vv = np.zeros(capR, dtype=bool)
            vv[: len(r)] = True
            fut = sv_verify(
                index, st["qdev"], jnp.asarray(rr), jnp.asarray(qq), jnp.asarray(oo),
                jnp.asarray(vv), m=m, k=k, edit=edit, hq_cap=hq_cap,
            )
        ids = packed[:cnt]
        pos = packed[hq_cap : hq_cap + cnt]
        err = packed[2 * hq_cap : 2 * hq_cap + cnt]
        cand = ids % capR
        out_q.append(qq[cand])
        out_p.append(pos.astype(np.int64))
        out_e.append(err)
    fb = st.get("fallback")
    if not out_q:
        z = np.zeros(0, dtype=np.int64)
        return SvHits(z.astype(np.int32), z, z.astype(np.int32), fallback=fb)
    return SvHits(
        q_idx=np.concatenate(out_q).astype(np.int32),
        abs_pos=np.concatenate(out_p),
        err=np.concatenate(out_e).astype(np.int32),
        fallback=fb,
    )


def run_sv_search(
    index: DeviceIndex,
    queries: np.ndarray,
    k: int,
    *,
    edit: bool,
    active: np.ndarray | None = None,
    part_cap: int = PART_CAP,
) -> SvHits:
    """Synchronous seed -> expand -> verify for one query chunk."""
    st = dispatch_sv(index, queries, k, edit=edit, active=active, part_cap=part_cap)
    collect_sv_expand(st)
    dispatch_sv_verify(st)
    return collect_sv(st)
