"""Work-queue scheme-search engine (v2): one dense global state queue.

The v1 stepper (sahara_jax.engine.approx) gives every (query, search) lane a
fixed per-lane frontier — robust, but most slots are dead most of the time
while bursty lanes overflow.  This engine keeps ONE dense queue of live
states shared by all lanes (the classic work-queue inversion), so per-step
cost tracks the *actual* number of search-tree nodes.  Design:

- everything a step needs is packed so a main step issues three gather ops
  (per-lane tape word, fused two-edge occ-row gather, one combined
  state+rank-product row gather) plus one compaction scatter (and one
  scatter+gather pair when dedup is on);
- no integer div/mod in the hot loop: the compaction scatters
  (parent<<4)|branch payloads so decoding is shift/mask at any
  512-multiple cap, and search/query ids live in meta bit fields;
- stream compaction is an integer prefix sum (``jnp.cumsum``) of the
  candidate flags plus one scatter of the payloads to their positions;
- states can only finish in the last k+1 steps (d advances by at most one
  per step), so the hit-drain compaction runs only in a short tail scan;
- per-step cost is O(queue capacity), and the live-state count varies by
  orders of magnitude over the tape, so the main scan is split into
  *segments with individual capacities* (a static ``plan``), auto-tuned
  from the measured per-step live profile of earlier runs;
- after the exact prefix (phase 0) most (query, search) lanes are already
  dead (their exact piece mismatched), so seeds are compacted into the
  first segment's capacity before the queue phase starts.

State = four parallel int32[Q] vectors (lb, lbr, sz, meta) with meta =
opf | err | d | s_id | q_id packed to a workload-sized bit layout
(``MetaLayout``; Hamming tapes drop the 4 opf bits entirely, so e.g.
m=100/ns=3/k=2 leaves 17 bits of query id).  Transition semantics are
identical to v1 (match/sub/del/ins, minimal-span edge flags, I-D adjacency
suppression) — property-tested for bit-identical hit multisets with
``dedup=False``.  With ``dedup=True`` the engine additionally merges
*dominated* states each step (same cursor/depth/search/query where the
survivor can reproduce every future transition of the victim — equal-err
duplicate orderings, subsumed edge flags, and lower-err states once the
remaining lower bounds permit), which shrinks the queue and the duplicate
hit multiplicity without changing the hit position sets.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from sahara_jax.engine.device import DeviceIndex
from sahara_jax.engine.rank import occ_row_word, rank_all_from_row
from sahara_jax.engine.tape import SchemeTape

OP_MATCH, OP_INS, OP_DEL = 0, 1, 2
_EDGE_L, _EDGE_R = 4, 8
_EDGES = _EDGE_L | _EDGE_R

MAX_NS = 8  # searches per tape (driver splits bigger schemes into groups)
MAX_M = 511
MAX_ERR = 7

_BLK = 512

# Hard per-dispatch queue/hit capacity ceiling (rows).  Beyond this the
# retry ladder stops growing (an 8M-row queue already costs ~GBs of HBM
# workspace) and the caller must degrade instead: the grouped driver
# splits the chunk's ACTIVE query set in halves (same compiled shapes)
# until the frontier fits (driver._run_workq_grouped).  Module attribute
# so tests can shrink it to exercise the split path cheaply.
HARD_CAP = 1 << 23
_I32_MAX = np.iinfo(np.int32).max

import os as _os

_PROFILE_BRANCHES = _os.environ.get("SAHARA_PROFILE_BRANCHES", "") == "1"


@dataclasses.dataclass(frozen=True)
class MetaLayout:
    """Bit layout of the packed per-state meta word, sized to the actual
    workload statics so the query-id field gets every spare bit (Hamming
    tapes carry no op/edge info at all): opf | err | d | s_id | q_id."""

    opf_bits: int
    err_bits: int
    d_bits: int
    s_bits: int

    @property
    def err_shift(self) -> int:
        return self.opf_bits

    @property
    def d_shift(self) -> int:
        return self.opf_bits + self.err_bits

    @property
    def s_shift(self) -> int:
        return self.d_shift + self.d_bits

    @property
    def q_shift(self) -> int:
        return self.s_shift + self.s_bits

    @property
    def q_bits(self) -> int:
        return 32 - self.q_shift

    @property
    def max_nq(self) -> int:
        return 1 << self.q_bits

    @property
    def opf_mask(self) -> int:
        return (1 << self.opf_bits) - 1

    @property
    def err_mask(self) -> int:
        return (1 << self.err_bits) - 1

    @property
    def d_mask(self) -> int:
        return (1 << self.d_bits) - 1

    @property
    def s_mask(self) -> int:
        return (1 << self.s_bits) - 1

    @property
    def q_mask(self) -> int:
        return (1 << self.q_bits) - 1

    @property
    def key_mask(self) -> int:
        # d | s | q: cursor identity minus op/err — int32 wraparound form
        m = ~((1 << self.d_shift) - 1)
        return m & 0xFFFFFFFF


def meta_layout(m: int, ns: int, k: int, edit: bool) -> MetaLayout:
    return MetaLayout(
        opf_bits=4 if edit else 0,
        err_bits=max(int(k).bit_length(), 1),
        d_bits=int(m).bit_length(),  # d reaches m
        s_bits=max(int(ns - 1).bit_length(), 1) if ns > 1 else 0,
    )


def max_chunk_queries(m: int, ns: int, k: int, edit: bool) -> int:
    """Largest per-call query count the meta packing supports."""
    return min(meta_layout(m, ns, k, edit).max_nq, 1 << 17)


@dataclasses.dataclass
class FlatHits:
    """Global hit list: parallel arrays over hits (not per-lane)."""

    lane: np.ndarray  # int32[H] — lane = query * ns + search
    lb: np.ndarray
    sz: np.ndarray
    err: np.ndarray
    n_hits: int
    queue_overflow: bool
    hit_overflow: bool
    max_live: int = 0
    live_profile: np.ndarray | None = None  # int32[1 + steps]: seeds + per-step live


def _fold_rows(cols: list[jax.Array], g: int, f: int) -> jax.Array:
    """Pack per-element int32 fields into ``f`` groups of ``g`` lanes per
    wide row: element i lives in row i >> log2(f), lanes (i & (f-1))*g ..
    +len(cols).  The same wide-row re-layout as engine.rank's folded occ
    table, so :func:`_fold_take` fetches state rows as wide rows."""
    n = cols[0].shape[0]
    cols = cols + [jnp.zeros_like(cols[0])] * (g - len(cols))
    return jnp.stack(cols, axis=1).reshape(n // f, g * f)


def _fold_take(mat: jax.Array, idx: jax.Array, g: int, f: int) -> jax.Array:
    """Gather logical g-lane rows from a :func:`_fold_rows` matrix: one wide
    row gather + a strided mask-add group select (one mask pass over the
    wide row plus f-1 g-lane adds — ~free next to the gather)."""
    wide = jnp.take(mat, idx >> (f.bit_length() - 1), axis=0)  # [n, g*f]
    grp = (idx & (f - 1))[:, None]
    lane_grp = jnp.asarray(np.arange(g * f, dtype=np.int32) // g)[None, :]
    masked = jnp.where(lane_grp == grp, wide, 0)
    row = masked[:, :g]
    for j in range(1, f):
        row = row + masked[:, j * g : (j + 1) * g]
    return row  # [n, g]


_SF_G, _SF_F = 8, 16  # state fold: 8-lane field groups, 16 states per row
_PF_G, _PF_F = 4, 32  # rank-product fold: 4-lane groups, 32 per row


def _positions(flags: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Exclusive positions of set flags (flat bool[N]) by an integer prefix
    sum.  Returns (pos int32[N], total int32)."""
    incl = jnp.cumsum(flags.astype(jnp.int32))
    return incl - flags.astype(jnp.int32), incl[-1]


def _compact(fl: jax.Array, payload: jax.Array, cap: int) -> tuple[jax.Array, jax.Array]:
    """Stream compaction: the payloads of set flags, in flag order, into
    ``cap`` slots.  Returns (sel int32[cap] — payload per slot, 0 beyond the
    live range; total int32 — flags set, which may exceed ``cap``)."""
    pos, total = _positions(fl)
    dest = jnp.where(fl, pos, cap)  # dead -> out of bounds -> dropped
    sel = jnp.zeros(cap, dtype=jnp.int32).at[dest].set(payload, mode="drop")
    return sel, total


def _pack_lane_tape(
    queries: jax.Array,
    t_side: jax.Array,
    t_qpos: jax.Array,
    t_lo: jax.Array,
    t_hi: jax.Array,
    ns: int,
) -> jax.Array:
    """Per-lane tape words [b * m]: side | lo<<1 | hi<<5 | qc<<9 | maxlo<<17.

    Folding the query character into the tape removes two gathers from the
    hot loop (tape and query lookups become one); ``maxlo`` = max of the
    remaining lower bounds from this step on, which gates the err-dominance
    merge (a lower-err state can only absorb a higher-err one when no
    future lower bound exceeds its error count)."""
    nq, m = queries.shape
    t_maxlo = jnp.flip(lax.cummax(jnp.flip(t_lo, axis=1), axis=1), axis=1)
    qc_at = jnp.take(queries, t_qpos.reshape(-1), axis=1).reshape(nq, ns, m)
    word = (
        t_side[None, :, :]
        | (t_lo[None, :, :] << 1)
        | (t_hi[None, :, :] << 5)
        | (qc_at << 9)
        | (t_maxlo[None, :, :] << 17)
    )
    return word.reshape(nq * ns * m)


def main_tail_steps(m: int, ph0: int, k: int, edit: bool) -> tuple[int, int]:
    """(main_steps, tail_steps): no state can reach d == m during the first
    ``main_steps`` queue steps (d grows by at most one per step), so the
    hit drain runs only in the tail."""
    main_steps = max(m - ph0 - 1, 0)
    tail_steps = (m - ph0) + 1 + (k if edit else 0) - main_steps
    return main_steps, tail_steps


@partial(
    jax.jit,
    static_argnames=(
        "edit", "plan", "tail_cap", "hq_cap", "m", "ns", "k", "ph0", "dedup_every",
        "cap_per_query", "packed", "e_plan", "e_tail_cap",
    ),
)
def workq_search(
    index: DeviceIndex,
    queries: jax.Array,  # int32[nq, m]
    t_side: jax.Array,  # int32[ns, m]
    t_qpos: jax.Array,
    t_lo: jax.Array,
    t_hi: jax.Array,
    active: jax.Array,  # bool[nq]
    n_init: jax.Array | None = None,  # dynamic text length (interval shards)
    *,
    edit: bool,
    plan: tuple[tuple[int, int], ...],  # ((steps, q_cap), ...) covering main_steps
    tail_cap: int,
    hq_cap: int,
    m: int,
    ns: int,
    k: int,
    ph0: int,
    dedup_every: int = 0,
    cap_per_query: int = 0,
    packed: bool = True,
    e_plan: tuple[int, ...] = (),  # per-segment exact-lane caps ((), = lane off)
    e_tail_cap: int = 0,
):
    """Returns one packed int32 array [4*hq_cap + 8 + 1 + total_steps
    (+ total_steps exact-lane profile when the lane is on)]:
    h_lane | h_lb | h_sz | h_err | (n_hits, q_overflow, h_overflow,
    max_live, pad*4) | live profile (seed count + per-step live totals)
    | exact-lane occupancy per step.

    **Exact lane** (``e_tail_cap`` > 0): a state whose error count has
    reached its search's FINAL upper bound can never branch again — scheme
    bounds are monotone (isValid), so every future step admits only the
    exact-match extension.  The branch histogram probe measured ~49% of
    live state-steps in this regime at bench shapes (82% late in the
    tape).  Such states migrate at segment boundaries into a second queue
    that steps ph0-style (one tape-word gather + one fused occ gather,
    no candidate enumeration / compaction / dedup / product gathers).
    Hit multiplicity is unchanged (the exact extension is precisely the
    single branch the full step would have produced); with dedup on,
    migrated states leave the dedup table's reach, which can only increase
    duplicate hits the driver's merge already drops.

    ``cap_per_query`` > 0 stops expanding a query's lanes once it has
    emitted that many hit intervals (the in-search ``search_n`` work bound,
    search.cpp:228): the emitted per-query count may overshoot by one tail
    step's worth, so drivers wanting an exact cap still filter the result
    (CONFORMANCE.md §3)."""
    nq = queries.shape[0]
    sigma = index.sigma
    b = nq * ns
    L = meta_layout(m, ns, k, edit)
    if nq > L.max_nq or ns > MAX_NS or m > MAX_M or k > MAX_ERR or sigma > 8:
        raise ValueError(
            f"workq meta packing limits exceeded (nq<={L.max_nq} for this workload, "
            "ns<=8, m<=511, k<=7, sigma<=8)"
        )
    if not (index.rev_rows > 0 or index.mirrored):
        raise ValueError("scheme search requires a bidirectional index")
    main_steps, tail_steps = main_tail_steps(m, ph0, k, edit)
    if sum(s for s, _ in plan) != main_steps:
        raise ValueError(f"plan steps {plan} do not sum to main_steps={main_steps}")
    exact = e_tail_cap > 0
    if exact:
        assert len(e_plan) == len(plan)
    caps = [c for _, c in plan] + [tail_cap, hq_cap] + ([*e_plan, e_tail_cap] if exact else [])
    for c in caps:
        # (parent << 4) | branch payloads must stay inside int32
        assert c % _BLK == 0 and c <= 1 << 27, "caps: multiples of 512, at most 2^27"

    occ, c_arr, rev_rows = index.occ, index.c_arr, index.rev_word_off

    lane_tape = _pack_lane_tape(queries, t_side, t_qpos, t_lo, t_hi, ns)

    lanes = jnp.arange(b, dtype=jnp.int32)
    s_id0 = lanes % ns  # outside the scan: fine
    q_id0 = lanes // ns
    lane_active = jnp.take(active, q_id0)

    # branch enumeration runs over the symbols actually present in the text
    # (sigma_live <= sigma): a symbol with zero occurrences always yields
    # cnt == 0, so dropping its match/sub and del branch columns is
    # hit-set-identical while shrinking the candidate scatter + flag math.
    sl = max(min(index.sigma_live or sigma, sigma), 2)
    n_ms = sl - 1

    def fused_rank(primary, sz, word_off):
        """One gather for both interval edges: rank-all rows at primary and
        primary+sz.  Returns (r_lo, r_hi) each [n, sigma].  The barrier keeps
        the ranks materialized once: they feed every per-symbol candidate
        column, and a fusion that took the gather into each consumer would
        re-execute it per column."""
        n = primary.shape[0]
        pos = jnp.concatenate([primary, primary + sz])
        woff = jnp.concatenate([word_off, word_off])
        rows = occ_row_word(occ, (pos >> 5) + woff, index.fold, 2 * sigma)
        ranks = rank_all_from_row(rows, sigma, pos)
        ranks = lax.optimization_barrier(ranks)
        return ranks[:n], ranks[n:]

    # ---------------- phase 0: exact seed, one state per lane ------------
    # every lane is at d == t in lockstep here, so the per-step tape words
    # are a ROW of the transposed tape (scan xs — no gather at all), and
    # the per-symbol selections are masked sums (no take_along_axis)
    sym_iota = jnp.arange(sigma, dtype=jnp.int32)[None, :]

    def ph0_step(carry, word):
        lb, lbr, sz = carry
        side = word & 1
        qc = (word >> 9) & 0xFF
        primary = jnp.where(side == 1, lbr, lb)
        secondary = jnp.where(side == 1, lb, lbr)
        r_lo, r_hi = fused_rank(primary, sz, side * rev_rows)
        cnt = r_hi - r_lo
        c = qc[:, None]
        eq = sym_iota == c
        newp = jnp.where(eq, c_arr[None, :sigma] + r_lo, 0).sum(axis=1)
        news = secondary + jnp.where(sym_iota < c, cnt, 0).sum(axis=1)
        nsz = jnp.where(eq, cnt, 0).sum(axis=1)
        lb = jnp.where(side == 1, news, newp)
        lbr = jnp.where(side == 1, newp, news)
        return (lb, lbr, jnp.maximum(nsz, 0)), None

    lb0 = jnp.zeros(b, dtype=jnp.int32)
    lbr0 = jnp.zeros(b, dtype=jnp.int32)
    n0 = jnp.int32(index.n) if n_init is None else n_init.astype(jnp.int32)
    sz0 = jnp.where(lane_active, n0, 0)
    tape_T = lane_tape.reshape(b, m).T  # [m, b]
    (lb0, lbr0, sz0), _ = lax.scan(ph0_step, (lb0, lbr0, sz0), tape_T[:ph0])

    # -------- compact surviving seeds into the first segment capacity ----
    cap0 = plan[0][1] if plan else tail_cap
    sel0, seed_total = _compact(sz0 > 0, jnp.arange(b, dtype=jnp.int32), cap0)
    live0 = jnp.arange(cap0, dtype=jnp.int32) < jnp.minimum(seed_total, cap0)
    meta0 = (jnp.int32(ph0) << L.d_shift) | (s_id0 << L.s_shift) | (q_id0 << L.q_shift)
    sel0c = jnp.minimum(sel0, b - 1)
    # the state is carried as four parallel vectors (lb, lbr, sz, meta)
    state = (
        jnp.where(live0, jnp.take(lb0, sel0c), 0),
        jnp.where(live0, jnp.take(lbr0, sel0c), 0),
        jnp.where(live0, jnp.take(sz0, sel0c), 0),
        jnp.where(live0, jnp.take(meta0, sel0c), 0),
    )
    q_ovf = seed_total > cap0

    # ---------------- exact lane (see docstring) -------------------------
    def _i32(x: int) -> jnp.ndarray:
        return jnp.int32(x - (1 << 32) if x >= 2**31 else x)

    if exact:
        final_hi = t_hi[:, -1]  # [ns] — per-search final (max) upper bound
        _keep_mask = _i32(
            ((L.err_mask << L.err_shift) | (L.s_mask << L.s_shift) | (L.q_mask << L.q_shift))
            & 0xFFFFFFFF
        )

    def _decode_e(e_meta):
        d = (e_meta >> L.d_shift) & L.d_mask
        s_id = (e_meta >> L.s_shift) & L.s_mask if ns > 1 else jnp.zeros_like(e_meta)
        q_id = (e_meta >> L.q_shift) & L.q_mask
        return d, s_id, q_id

    def exact_step(e_state):
        """Advance every live exact-lane row by its single match branch
        (ph0-style math at per-row depth).  Dead rows ride until the next
        boundary compaction."""
        e_lb, e_lbr, e_sz, e_meta = e_state
        alive = e_sz > 0
        d, s_id, q_id = _decode_e(e_meta)
        lane = q_id * ns + s_id
        dc = jnp.minimum(d, m - 1)
        # materialized once: every decoded field below reads the gathered word
        word = lax.optimization_barrier(jnp.take(lane_tape, lane * m + dc))
        side = word & 1
        qc = jnp.clip((word >> 9) & 0xFF, 0, sigma - 1)
        primary = jnp.where(side == 1, e_lbr, e_lb)
        secondary = jnp.where(side == 1, e_lb, e_lbr)
        r_lo, r_hi = fused_rank(primary, e_sz, side * rev_rows)
        cnt = r_hi - r_lo
        c = qc[:, None]
        eq = sym_iota == c
        newp = jnp.where(eq, c_arr[None, :sigma] + r_lo, 0).sum(axis=1)
        news = secondary + jnp.where(sym_iota < c, cnt, 0).sum(axis=1)
        nsz = jnp.maximum(jnp.where(eq, cnt, 0).sum(axis=1), 0)
        nsz = jnp.where(alive, nsz, 0)
        new_lb = jnp.where(side == 1, news, newp)
        new_lbr = jnp.where(side == 1, newp, news)
        if edit:
            other_bit = jnp.where(side == 0, _EDGE_R, _EDGE_L)
            new_opf = e_meta & L.opf_mask & other_bit
        else:
            new_opf = jnp.zeros_like(e_meta)
        new_meta = (e_meta & _keep_mask) | new_opf | (jnp.minimum(d + 1, L.d_mask) << L.d_shift)
        new_meta = jnp.where(alive, new_meta, 0)
        return (
            jnp.where(alive, new_lb, 0),
            jnp.where(alive, new_lbr, 0),
            nsz,
            new_meta,
        )

    def migrate(state, e_state, e_count, q_ovf, cap_new, e_cap_new):
        """Segment boundary: move saturated B rows (err at their search's
        final bound) into the exact lane; recompact both queues into the
        next segment's capacities."""
        q_lb, q_lbr, q_sz, meta = state
        cap_old = q_lb.shape[0]
        err = (meta >> L.err_shift) & L.err_mask
        s_id = (meta >> L.s_shift) & L.s_mask if ns > 1 else jnp.zeros_like(meta)
        alive = q_sz > 0
        fhi = jnp.take(final_hi, s_id)
        sat = alive & (err >= fhi)

        # E recompaction (drop dead) + saturated append into e_cap_new.
        # Saturated rows that DON'T fit simply STAY in B (they are still
        # correct there, just on the expensive path) — E capacity is a
        # pure performance knob and can never force an overflow retry.
        e_lb, e_lbr, e_sz, e_meta = e_state
        e_cap_old = e_lb.shape[0]
        alive_e = e_sz > 0
        epos, etot = _positions(alive_e)
        iota_e = jnp.arange(e_cap_old, dtype=jnp.int32)
        sel_e = (
            jnp.full(e_cap_new, -1, dtype=jnp.int32)
            .at[jnp.where(alive_e, epos, e_cap_new)]
            .set(iota_e, mode="drop")
        )
        spos, stot = _positions(sat)
        mig = sat & (etot + spos < e_cap_new)
        iota_b = jnp.arange(cap_old, dtype=jnp.int32)
        sel_s = (
            jnp.full(e_cap_new, -1, dtype=jnp.int32)
            .at[jnp.where(mig, etot + spos, e_cap_new)]
            .set(iota_b, mode="drop")
        )
        from_e = sel_e >= 0
        from_b = sel_s >= 0
        sel_ec = jnp.minimum(jnp.maximum(sel_e, 0), e_cap_old - 1)
        sel_sc = jnp.minimum(jnp.maximum(sel_s, 0), cap_old - 1)
        new_e = tuple(
            jnp.where(
                from_e,
                jnp.take(ev, sel_ec),
                jnp.where(from_b, jnp.take(bv, sel_sc), 0),
            )
            for ev, bv in ((e_lb, q_lb), (e_lbr, q_lbr), (e_sz, q_sz), (e_meta, meta))
        )
        if dedup_every:
            # E-internal dominance merge at the boundary: rows in the
            # exact lane escape the per-step B dedup, and saturated
            # duplicate orderings are the MOST redundant states in the
            # whole search (equal cursor, equal err — err == the search's
            # final bound for every sat row of a search).  Without this
            # the lane inflates total row-steps instead of shrinking them
            # (measured: E row-steps ~= the states dedup used to kill).
            # Winner rule: identical (lb, lbr, sz, d, s, q) and the
            # winner's edge flags are a subset of the victim's (a
            # match-only future never sets new flags, so fewer flags
            # reproduce every finish of more flags).
            ne_lb, ne_lbr, ne_sz, ne_meta = new_e
            alive2 = ne_sz > 0
            cb = (e_cap_new - 1).bit_length()
            ht = 1 << cb
            keym = jnp.int32(L.key_mask - (1 << 32) if L.key_mask >= 2**31 else L.key_mask)
            hsh = (
                ne_lb * jnp.int32(0x9E3779B1 - (1 << 32))
                ^ ne_lbr * jnp.int32(0x85EBCA77 - (1 << 32))
                ^ ne_sz * jnp.int32(0xC2B2AE3D - (1 << 32))
                ^ (ne_meta & keym) * jnp.int32(0x27D4EB2F)
            ) & (ht - 1)
            row_e = jnp.arange(e_cap_new, dtype=jnp.int32)
            opf2 = ne_meta & L.opf_mask
            nbad = ((opf2 >> 2) & 1) + ((opf2 >> 3) & 1)
            pri = jnp.where(alive2, (nbad << cb) | row_e, _I32_MAX)
            table = jnp.full(ht, _I32_MAX, dtype=jnp.int32).at[hsh].min(pri)
            win = jnp.minimum(jnp.take(table, hsh) & (ht - 1), e_cap_new - 1)
            _nm = (~L.opf_mask) & 0xFFFFFFFF
            nopfm = jnp.int32(_nm - (1 << 32) if _nm >= 2**31 else _nm)
            w_lb = jnp.take(ne_lb, win)
            w_lbr = jnp.take(ne_lbr, win)
            w_sz = jnp.take(ne_sz, win)
            w_meta = jnp.take(ne_meta, win)
            same = (
                (w_lb == ne_lb)
                & (w_lbr == ne_lbr)
                & (w_sz == ne_sz)
                & (((w_meta ^ ne_meta) & nopfm) == 0)
            )
            edge_dom = ((w_meta & _EDGES) & ~opf2) == 0
            kill = alive2 & same & (win != row_e) & edge_dom
            new_e = (ne_lb, ne_lbr, jnp.where(kill, 0, ne_sz), ne_meta)
        e_count = jnp.minimum(etot + stot, e_cap_new)

        # B recompaction (keep everything alive that didn't migrate)
        keep = alive & ~mig
        kpos, ktot = _positions(keep)
        sel_b = (
            jnp.zeros(cap_new, dtype=jnp.int32)
            .at[jnp.where(keep, kpos, cap_new)]
            .set(iota_b, mode="drop")
        )
        live_b = jnp.arange(cap_new, dtype=jnp.int32) < jnp.minimum(ktot, cap_new)
        q_ovf = q_ovf | (ktot > cap_new)
        new_state = tuple(
            jnp.where(live_b, jnp.take(v, jnp.minimum(sel_b, cap_old - 1)), 0)
            for v in (q_lb, q_lbr, q_sz, meta)
        )
        return new_state, new_e, e_count, q_ovf

    def make_e_drain(e_cap):
        def e_drain(e_state, hits, n_hits, n_true, h_ovf, hq_counts):
            """Tail-step hit drain for the exact lane (mirrors the B
            drain: finished rows emit, done rows die)."""
            e_lb, e_lbr, e_sz, e_meta = e_state
            alive = e_sz > 0
            d, s_id, q_id = _decode_e(e_meta)
            if cap_per_query:
                alive = alive & (jnp.take(hq_counts, q_id) < cap_per_query)
            opf = e_meta & L.opf_mask
            done = alive & (d >= m)
            finished = done & ((opf & _EDGES) == 0)
            fpos, ftot = _positions(finished)
            fdest = jnp.where(finished, n_hits + fpos, hq_cap)
            row_ids = jnp.arange(e_cap, dtype=jnp.int32)
            sel_h = (
                jnp.full(hq_cap, e_cap, dtype=jnp.int32)
                .at[fdest]
                .set(row_ids, mode="drop")
            )
            got = sel_h < e_cap
            sel_hc = jnp.minimum(sel_h, e_cap - 1)
            slot_new = jnp.arange(hq_cap, dtype=jnp.int32) >= n_hits
            upd = slot_new & got
            lane = q_id * ns + s_id
            err = (e_meta >> L.err_shift) & L.err_mask
            h_lane, h_lb, h_sz, h_err = hits
            h_lane = jnp.where(upd, jnp.take(lane, sel_hc), h_lane)
            h_lb = jnp.where(upd, jnp.take(e_lb, sel_hc), h_lb)
            h_sz = jnp.where(upd, jnp.take(e_sz, sel_hc), h_sz)
            h_err = jnp.where(upd, jnp.take(err, sel_hc), h_err)
            hits = (h_lane, h_lb, h_sz, h_err)
            h_ovf = h_ovf | (n_hits + ftot > hq_cap)
            n_true = n_true + ftot
            n_hits = jnp.minimum(n_hits + ftot, hq_cap)
            if cap_per_query:
                hq_counts = hq_counts.at[q_id].add(finished.astype(jnp.int32), mode="drop")
            e_sz = jnp.where(done | ~alive, 0, e_sz)
            return (e_lb, e_lbr, e_sz, e_meta), hits, n_hits, n_true, h_ovf, hq_counts

        return e_drain

    def make_step(cap, drain):
        def expand_step(state, hits, n_hits, n_true, q_ovf, h_ovf, max_live, hq_counts, t=None):
            """One generic step: dedup -> drain -> candidates -> compaction.

            With ``packed`` (default), the per-field scalar gathers are
            replaced by row gathers of stacked matrices, so one gather
            fetches five fields; the packed paths are property-tested
            bit-identical against the unpacked ones (tests/test_workq.py)
            and against the v1 engine.  Each stacked matrix sits behind a
            barrier so it is materialized in its stacked layout: fused into
            its gathers, the stack would turn each row gather back into one
            gather per field."""
            q_lb, q_lbr, q_sz, meta = state
            opf = meta & L.opf_mask
            err = (meta >> L.err_shift) & L.err_mask
            d = (meta >> L.d_shift) & L.d_mask
            s_id = (meta >> L.s_shift) & L.s_mask if ns > 1 else jnp.zeros_like(meta)
            q_id = (meta >> L.q_shift) & L.q_mask
            alive = q_sz > 0
            lane = q_id * ns + s_id
            row_ids = jnp.arange(cap, dtype=jnp.int32)

            # ---- one tape-word gather ----------------------------------
            # (materialized once: five decoded fields read it)
            dc = jnp.minimum(d, m - 1)
            word = lax.optimization_barrier(jnp.take(lane_tape, lane * m + dc))
            side = word & 1
            lo_b = (word >> 1) & 0xF
            hi_b = (word >> 5) & 0xF
            qc = (word >> 9) & 0xFF
            maxlo = (word >> 17) & 0xF

            if packed == "fold":
                # folded state matrix (see _fold_rows): serves the dedup
                # compare AND the survivor parent-field gathers below at the
                # wide-row gather rate (killed/drained rows never become
                # parents, so pre-dedup values are safe)
                SF = lax.optimization_barrier(
                    _fold_rows([q_lb, q_lbr, q_sz, meta, word], _SF_G, _SF_F)
                )
            elif packed == "wide":
                # dedup-only narrow stack; the parent gather reads the
                # combined state+product matrix built after the occ gather
                S4 = lax.optimization_barrier(
                    jnp.stack([q_lb, q_lbr, q_sz, meta], axis=1)
                )
            elif packed:
                # one stacked matrix serves the dedup compare AND the
                # survivor parent-field gathers below (killed/drained rows
                # never become parents, so pre-dedup values are safe)
                S5 = lax.optimization_barrier(
                    jnp.stack([q_lb, q_lbr, q_sz, meta, word], axis=1)
                )

            if dedup_every:
                # Merge states the winner *dominates*: identical cursor
                # (lb, lbr, sz) at the same (d, s_id, q_id), where the
                # winner's err/edge-flags/last-op let it reproduce every
                # future transition of the victim.  One scatter-min elects
                # the best candidate per hash slot (lowest err, cleanest
                # op flags); domination is then verified field-by-field so
                # hash collisions and non-dominating winners are left
                # untouched (safe).  Hit position sets are unchanged;
                # queue occupancy shrinks (output multiplicity is handled
                # centrally by the driver's unique-rows merge, so dedup —
                # and its cadence — never changes what the user sees).
                # hash-table size is the pow2 >= cap (cap itself need only
                # be a multiple of 512); empty slots decode to a clamped
                # row whose kill is still gated by the full `same` check
                def _dedup_sz(q_sz_in):
                    alive_in = q_sz_in > 0
                    cb = (cap - 1).bit_length()
                    ht = 1 << cb
                    hsh = (
                        q_lb * jnp.int32(0x9E3779B1 - (1 << 32))
                        ^ q_lbr * jnp.int32(0x85EBCA77 - (1 << 32))
                        ^ q_sz_in * jnp.int32(0xC2B2AE3D - (1 << 32))
                        ^ (meta & jnp.int32(L.key_mask - (1 << 32) if L.key_mask >= 2**31 else L.key_mask)) * jnp.int32(0x27D4EB2F)
                    ) & (ht - 1)
                    bad = ((opf & 3) != 0).astype(jnp.int32) + ((opf >> 2) & 1) + ((opf >> 3) & 1)
                    packed_pri = (err << (cb + 2)) | (jnp.minimum(bad, 3) << cb) | row_ids
                    packed_pri = jnp.where(alive_in, packed_pri, _I32_MAX)
                    table = jnp.full(ht, _I32_MAX, dtype=jnp.int32).at[hsh].min(packed_pri)
                    win = jnp.minimum(jnp.take(table, hsh) & (ht - 1), cap - 1)
                    keym = jnp.int32(L.key_mask - (1 << 32) if L.key_mask >= 2**31 else L.key_mask)
                    if packed == "fold":
                        W = _fold_take(SF, win, _SF_G, _SF_F)
                        w_lb, w_lbr, w_sz, w_meta = W[:, 0], W[:, 1], W[:, 2], W[:, 3]
                    elif packed == "wide":
                        W = jnp.take(S4, win, axis=0)
                        w_lb, w_lbr, w_sz, w_meta = W[:, 0], W[:, 1], W[:, 2], W[:, 3]
                    elif packed:
                        W = jnp.take(S5, win, axis=0)
                        w_lb, w_lbr, w_sz, w_meta = W[:, 0], W[:, 1], W[:, 2], W[:, 3]
                    else:
                        w_lb = jnp.take(q_lb, win)
                        w_lbr = jnp.take(q_lbr, win)
                        w_sz = jnp.take(q_sz_in, win)
                        w_meta = jnp.take(meta, win)
                    w_opf = w_meta & L.opf_mask
                    w_err = (w_meta >> L.err_shift) & L.err_mask
                    same = (
                        (w_lb == q_lb)
                        & (w_lbr == q_lbr)
                        & (w_sz == q_sz_in)
                        & (((w_meta ^ meta) & keym) == 0)
                    )
                    err_dom = (w_err == err) | ((w_err < err) & (maxlo <= w_err))
                    edge_dom = (w_opf & _EDGES & ~opf) == 0  # winner edges subset
                    op_dom = ((w_opf & 3) == 0) | ((w_opf & 3) == (opf & 3))
                    # (for Hamming tapes opf is always 0, so edge/op dominance
                    # holds trivially and this reduces to the err-aware merge)
                    kill = alive_in & same & (win != row_ids) & err_dom & edge_dom & op_dom
                    return jnp.where(kill, 0, q_sz_in)

                if dedup_every == 1 or t is None:
                    q_sz = _dedup_sz(q_sz)
                else:
                    q_sz = lax.cond(t % dedup_every == 0, _dedup_sz, lambda x: x, q_sz)
                alive = q_sz > 0

            if drain:
                if cap_per_query:
                    # kill all lanes of queries that already emitted enough
                    alive = alive & (jnp.take(hq_counts, q_id) < cap_per_query)
                done = alive & (d >= m)
                finished = done & ((opf & _EDGES) == 0)
                fpos, ftot = _positions(finished)
                # dead/overflow slots get an out-of-bounds destination: with
                # mode="drop" they never reach memory (a shared in-bounds dump
                # slot would serialize millions of colliding writes)
                fdest = jnp.where(finished, n_hits + fpos, hq_cap)
                sel_h = (
                    jnp.full(hq_cap, cap, dtype=jnp.int32)
                    .at[fdest]
                    .set(row_ids, mode="drop")
                )
                got = sel_h < cap
                sel_hc = jnp.minimum(sel_h, cap - 1)
                slot_new = jnp.arange(hq_cap, dtype=jnp.int32) >= n_hits
                upd = slot_new & got
                h_lane, h_lb, h_sz, h_err = hits
                h_lane = jnp.where(upd, jnp.take(lane, sel_hc), h_lane)
                h_lb = jnp.where(upd, jnp.take(q_lb, sel_hc), h_lb)
                h_sz = jnp.where(upd, jnp.take(q_sz, sel_hc), h_sz)
                h_err = jnp.where(upd, jnp.take(err, sel_hc), h_err)
                hits = (h_lane, h_lb, h_sz, h_err)
                h_ovf = h_ovf | (n_hits + ftot > hq_cap)
                n_true = n_true + ftot  # uncapped: sizes the one-shot retry
                n_hits = jnp.minimum(n_hits + ftot, hq_cap)
                alive = alive & ~done
                if cap_per_query:
                    hq_counts = hq_counts.at[q_id].add(finished.astype(jnp.int32), mode="drop")

            # ---- one fused occ gather ----------------------------------
            primary = jnp.where(side == 1, q_lbr, q_lb)
            secondary = jnp.where(side == 1, q_lb, q_lbr)
            r_lo, r_hi = fused_rank(primary, q_sz, side * rev_rows)
            cnt = (r_hi - r_lo)[:, :sl]
            prefix = jnp.cumsum(cnt, axis=-1) - cnt
            newp = c_arr[None, :sl] + r_lo[:, :sl]
            news = secondary[:, None] + prefix
            if packed == "fold":
                # rank products folded 32-per-wide-row (entry = parent*sl+sym)
                PF = lax.optimization_barrier(
                    _fold_rows(
                        [cnt.reshape(-1), newp.reshape(-1), news.reshape(-1)],
                        _PF_G, _PF_F,
                    )
                )
            elif packed == "wide":
                # ONE combined [cap, 5+3*sl] matrix: state fields + ALL
                # per-symbol rank products.  The survivor loop then gathers
                # once at `parent` and selects the symbol column with a
                # one-hot mask-add instead of two narrow gathers
                WIDE = lax.optimization_barrier(
                    jnp.concatenate(
                        [jnp.stack([q_lb, q_lbr, q_sz, meta, word], axis=1), cnt, newp, news],
                        axis=1,
                    )
                )
            elif packed:
                # rank products as one [cap*sl, 3] matrix: one row
                # gather at pidx instead of three flat takes
                P3 = lax.optimization_barrier(
                    jnp.stack([cnt.reshape(-1), newp.reshape(-1), news.reshape(-1)], axis=1)
                )
            else:
                # materialized rank products, not recomputed in each gather
                f_cnt = lax.optimization_barrier(cnt.reshape(-1))
                f_newp = lax.optimization_barrier(newp.reshape(-1))
                f_news = lax.optimization_barrier(news.reshape(-1))

            # ---- candidate flags [cap, e_used] --------------------------
            syms = jnp.arange(1, sl, dtype=jnp.int32)[None, :]
            e_ms = err[:, None] + (qc[:, None] != syms)
            ok_ms = (
                alive[:, None]
                & (cnt[:, 1:] > 0)
                & (e_ms <= hi_b[:, None])
                & (e_ms >= lo_b[:, None])
            )
            cols = [ok_ms]
            if edit:
                last = opf & 0x3
                ok_del = (
                    alive[:, None]
                    & (cnt[:, 1:] > 0)
                    & ((err + 1)[:, None] <= hi_b[:, None])
                    & (d[:, None] > 0)
                    & (last[:, None] != OP_INS)
                )
                ok_ins = (
                    alive & (err + 1 <= hi_b) & (err + 1 >= lo_b) & (last != OP_DEL)
                )[:, None]
                cols += [ok_del, ok_ins]
            flags = jnp.concatenate(cols, axis=1)  # [cap, e_used], no padding

            # branch-major (column-major) flat layout: the compaction
            # scatter and prefix sum cost per SOURCE element, so
            # covering only the e_used real branch columns (11 for edit,
            # 5 for Hamming) instead of a pow2-padded 16/8 saves ~1/3 of
            # both.  The scattered value is the (parent<<4)|branch PAYLOAD,
            # not a flat candidate id, so decoding never divides by cap —
            # caps only need to be multiples of 512, not powers of two
            # (pow2 quantization wasted ~40% of row-steps on the bench
            # profile).
            e_used = flags.shape[1]
            fl = flags.T.reshape(-1)
            cand_payload = (
                (jnp.arange(cap, dtype=jnp.int32)[None, :] << 4)
                | jnp.arange(e_used, dtype=jnp.int32)[:, None]
            ).reshape(-1)
            sel, total = _compact(fl, cand_payload, cap)
            if _PROFILE_BRANCHES:
                # temporary diagnostics (env SAHARA_PROFILE_BRANCHES=1):
                # per-step parent branching histogram rides in the y slot
                cnt_p = flags.sum(axis=1).astype(jnp.int32)
                hist_y = jnp.stack(
                    [
                        total,
                        (cnt_p > 0).sum().astype(jnp.int32),
                        (cnt_p == 1).sum().astype(jnp.int32),
                        (cnt_p == 2).sum().astype(jnp.int32),
                        jnp.maximum(cnt_p - 2, 0).sum().astype(jnp.int32),
                        # saturated = alive at the global error budget: such
                        # states can only extend by exact match for the rest
                        # of the tape (hi <= k always), i.e. they never
                        # branch — candidates for a cheap exact-only lane
                        (alive & (err >= k)).sum().astype(jnp.int32),
                    ]
                )
            else:
                hist_y = None
            q_ovf = q_ovf | (total > cap)
            max_live = jnp.maximum(max_live, total)
            live = jnp.arange(cap, dtype=jnp.int32) < jnp.minimum(total, cap)

            parent = sel >> 4
            branch = sel & 15

            is_del = (branch >= n_ms) & (branch < 2 * n_ms) if edit else jnp.zeros_like(branch, dtype=bool)
            is_ins = (branch >= 2 * n_ms) if edit else jnp.zeros_like(branch, dtype=bool)
            sym = jnp.where(branch < n_ms, branch + 1, branch - n_ms + 1)
            sym = jnp.clip(sym, 1, sl - 1)

            # ---- survivor fields ----------------------------------------
            pidx = parent * sl + sym
            if packed == "wide":
                P = jnp.take(WIDE, parent, axis=0)
                p_lb, p_lbr, p_sz, p_meta, p_word = (
                    P[:, 0], P[:, 1], P[:, 2], P[:, 3], P[:, 4],
                )
                oh = jnp.asarray(np.arange(sl, dtype=np.int32))[None, :] == sym[:, None]
                g_cnt = jnp.where(oh, P[:, 5 : 5 + sl], 0).sum(axis=1)
                g_newp = jnp.where(oh, P[:, 5 + sl : 5 + 2 * sl], 0).sum(axis=1)
                g_news = jnp.where(oh, P[:, 5 + 2 * sl : 5 + 3 * sl], 0).sum(axis=1)
            elif packed == "fold":
                P = _fold_take(SF, parent, _SF_G, _SF_F)
                p_lb, p_lbr, p_sz, p_meta, p_word = (
                    P[:, 0], P[:, 1], P[:, 2], P[:, 3], P[:, 4],
                )
                G = _fold_take(PF, pidx, _PF_G, _PF_F)
                g_cnt, g_newp, g_news = G[:, 0], G[:, 1], G[:, 2]
            elif packed:
                P = jnp.take(S5, parent, axis=0)
                p_lb, p_lbr, p_sz, p_meta, p_word = (
                    P[:, 0], P[:, 1], P[:, 2], P[:, 3], P[:, 4],
                )
                G = jnp.take(P3, pidx, axis=0)
                g_cnt, g_newp, g_news = G[:, 0], G[:, 1], G[:, 2]
            else:
                p_lb = jnp.take(q_lb, parent)
                p_lbr = jnp.take(q_lbr, parent)
                p_sz = jnp.take(q_sz, parent)
                p_meta = jnp.take(meta, parent)
                g_cnt = jnp.take(f_cnt, pidx)
                g_newp = jnp.take(f_newp, pidx)
                g_news = jnp.take(f_news, pidx)
            p_opf = p_meta & L.opf_mask
            p_err = (p_meta >> L.err_shift) & L.err_mask
            p_d = (p_meta >> L.d_shift) & L.d_mask
            rest_mask = (L.s_mask << L.s_shift) | (L.q_mask << L.q_shift)
            p_rest = p_meta & jnp.int32(rest_mask - (1 << 32) if rest_mask >= 2**31 else rest_mask)
            if packed:
                p_side = p_word & 1
                p_qc = (p_word >> 9) & 0xFF
            else:
                p_side = jnp.take(side, parent)
                p_qc = jnp.take(qc, parent)

            ext_lb = jnp.where(p_side == 1, g_news, g_newp)
            ext_lbr = jnp.where(p_side == 1, g_newp, g_news)

            if edit:
                new_lb = jnp.where(is_ins, p_lb, ext_lb)
                new_lbr = jnp.where(is_ins, p_lbr, ext_lbr)
                new_sz = jnp.where(is_ins, p_sz, g_cnt)
                new_err = jnp.where(branch < n_ms, p_err + (p_qc != sym), p_err + 1)
                new_d = jnp.where(is_del, p_d, p_d + 1)
                edge_bit = jnp.where(p_side == 0, _EDGE_L, _EDGE_R)
                other_bit = jnp.where(p_side == 0, _EDGE_R, _EDGE_L)
                ms_op = p_opf & other_bit
                del_op = OP_DEL | (p_opf & _EDGES) | edge_bit
                ins_op = OP_INS | (p_opf & _EDGES)
                new_op = jnp.where(branch < n_ms, ms_op, jnp.where(is_del, del_op, ins_op))
            else:
                new_lb, new_lbr, new_sz = ext_lb, ext_lbr, g_cnt
                new_err = p_err + (p_qc != sym)
                new_d = p_d + 1
                new_op = jnp.zeros_like(p_opf)

            new_sz = jnp.where(live, new_sz, 0)
            new_meta = new_op | (new_err << L.err_shift) | (new_d << L.d_shift) | p_rest
            new_meta = jnp.where(live, new_meta, 0)

            if exact:
                # saturated-survivor count: with the E-queue alive count
                # added by the caller this forms the per-step SATURATED
                # TOTAL — the segmentation-INDEPENDENT sizing profile for
                # e_plan (a boundary at step t migrates exactly this many
                # rows into E, wherever the boundary lands)
                new_s = (new_meta >> L.s_shift) & L.s_mask if ns > 1 else jnp.zeros_like(new_meta)
                sat_cnt = jnp.sum(
                    ((new_sz > 0) & (new_err >= jnp.take(final_hi, new_s))).astype(jnp.int32)
                )
            else:
                sat_cnt = jnp.int32(0)
            new_state = (new_lb, new_lbr, new_sz, new_meta)
            return (
                new_state, hits, n_hits, n_true, q_ovf, h_ovf, max_live, hq_counts,
                total if hist_y is None else hist_y, sat_cnt,
            )

        return expand_step

    hits0 = (
        jnp.zeros(hq_cap, dtype=jnp.int32),
        jnp.zeros(hq_cap, dtype=jnp.int32),
        jnp.zeros(hq_cap, dtype=jnp.int32),
        jnp.zeros(hq_cap, dtype=jnp.int32),
    )
    n_hits0 = jnp.int32(0)
    ovf0 = jnp.bool_(False)
    max_live0 = jnp.int32(0)

    def _resize(state, new_cap, q_ovf):
        cur = state[0].shape[0]
        if new_cap == cur:
            return state, q_ovf
        if new_cap > cur:
            pad = jnp.zeros(new_cap - cur, dtype=jnp.int32)
            return tuple(jnp.concatenate([v, pad]) for v in state), q_ovf
        # shrinking: live rows are compacted at the front; flag if any live
        # row would be cut off (triggers the host retry path)
        q_ovf = q_ovf | jnp.any(state[2][new_cap:] > 0)
        return tuple(v[:new_cap] for v in state), q_ovf

    hq_counts0 = jnp.zeros(nq, dtype=jnp.int32)
    live_profiles = [seed_total.reshape(1)]
    e_profiles = []
    max_live = max_live0
    e_state = tuple(jnp.zeros(_BLK, dtype=jnp.int32) for _ in range(4))
    e_count = jnp.int32(0)
    step_base = 0  # global step index feeds the dedup cadence
    for seg_i, (steps, cap) in enumerate(plan):
        if exact:
            state, e_state, e_count, q_ovf = migrate(
                state, e_state, e_count, q_ovf, cap, e_plan[seg_i]
            )
        else:
            state, q_ovf = _resize(state, cap, q_ovf)
        step_fn = make_step(cap, drain=False)

        def main_body(carry, t):
            state, e_state, q_ovf, max_live = carry
            state, _, _, _, q_ovf, _, max_live, _, total, sat = step_fn(
                state, hits0, n_hits0, n_hits0, q_ovf, ovf0, max_live, hq_counts0, t
            )
            if exact:
                e_state = exact_step(e_state)
                sat = sat + jnp.sum((e_state[2] > 0).astype(jnp.int32))
            return (state, e_state, q_ovf, max_live), (total, sat)

        (state, e_state, q_ovf, max_live), (lives, sats) = lax.scan(
            main_body,
            (state, e_state, q_ovf, max_live),
            jnp.arange(step_base, step_base + steps, dtype=jnp.int32),
        )
        live_profiles.append(lives)
        e_profiles.append(sats)
        step_base += steps

    if exact:
        state, e_state, e_count, q_ovf = migrate(
            state, e_state, e_count, q_ovf, tail_cap, e_tail_cap
        )
        e_drain_fn = make_e_drain(e_tail_cap)
    else:
        state, q_ovf = _resize(state, tail_cap, q_ovf)
    tail_fn = make_step(tail_cap, drain=True)

    def tail_body(carry, t):
        state, e_state, hits, n_hits, n_true, q_ovf, h_ovf, max_live, hq_counts = carry
        state, hits, n_hits, n_true, q_ovf, h_ovf, max_live, hq_counts, total, sat = tail_fn(
            state, hits, n_hits, n_true, q_ovf, h_ovf, max_live, hq_counts, t
        )
        if exact:
            e_state, hits, n_hits, n_true, h_ovf, hq_counts = e_drain_fn(
                e_state, hits, n_hits, n_true, h_ovf, hq_counts
            )
            e_state = exact_step(e_state)
            sat = sat + jnp.sum((e_state[2] > 0).astype(jnp.int32))
        return (state, e_state, hits, n_hits, n_true, q_ovf, h_ovf, max_live, hq_counts), (total, sat)

    (state, e_state, hits, n_hits, n_true, q_ovf, h_ovf, max_live, _), (tail_lives, tail_sats) = lax.scan(
        tail_body,
        (state, e_state, hits0, n_hits0, n_hits0, q_ovf, ovf0, max_live, hq_counts0),
        jnp.arange(step_base, step_base + tail_steps, dtype=jnp.int32),
    )
    live_profiles.append(tail_lives)
    e_profiles.append(tail_sats)

    # pack everything into ONE output array: one device->host transfer per
    # call instead of seven, each with its own fixed latency
    tailvals = jnp.zeros(8, dtype=jnp.int32)
    tailvals = tailvals.at[0].set(n_hits)
    tailvals = tailvals.at[1].set(q_ovf.astype(jnp.int32))
    tailvals = tailvals.at[2].set(h_ovf.astype(jnp.int32))
    tailvals = tailvals.at[3].set(max_live)
    tailvals = tailvals.at[4].set(n_true)  # finished-hit count, uncapped
    if _PROFILE_BRANCHES:
        live_profiles = [live_profiles[0]] + [p.reshape(-1) for p in live_profiles[1:]]
    profile = jnp.concatenate(live_profiles)
    if exact:
        # exact-lane occupancy per step (constant within a segment —
        # appends happen only at boundaries); sizes e_plan on later runs
        profile = jnp.concatenate([profile] + e_profiles)
    h_lane, h_lb, h_sz, h_err = hits
    return jnp.concatenate([h_lane, h_lb, h_sz, h_err, tailvals, profile])


def phase0_length(tape: SchemeTape, edit: bool) -> int:
    """Steps during which every search still has u == 0: single-state
    frontier, steppable in place."""
    hi = tape.hi
    ph0 = 0
    for t in range(tape.length):
        if (hi[:, t] == 0).all():
            ph0 = t + 1
        else:
            break
    return ph0


# per-workload tuning memory: last successful capacities plus the
# elementwise-max per-step live profile observed so far.  Retries are
# expensive (a full extra search run + possibly a compile), so later calls
# start from capacities/plans that worked; the profile only grows, so the
# derived segment plan converges and stays compile-stable.  Persisted to
# disk (best effort) so fresh processes skip the expensive flat-capacity
# warm pass and jump straight to the profiled segment plan whose
# executable sits in the persistent compile cache.
_CAP_MEMORY: dict[tuple, dict] = {}
_CAP_MEMORY_LOADED = False

_MAX_SEGS = 8
# segment caps are quantized to 1/8-octave steps (see _quant_cap), so this
# margin is most of the headroom; the profile is an elementwise max over
# all observed chunks (only grows) and the overflow retry is the backstop
_PLAN_MARGIN = 1.1


def _capmem_path() -> str:
    import os

    from sahara_jax import CACHE_DIR

    return os.environ.get("SAHARA_CAPMEM_PATH", os.path.join(CACHE_DIR, "capmem.json"))


def _capmem_load() -> None:
    global _CAP_MEMORY_LOADED
    if _CAP_MEMORY_LOADED:
        return
    _CAP_MEMORY_LOADED = True
    import json
    import os

    try:
        with open(_capmem_path()) as fh:
            raw = json.load(fh)
        for k, v in raw.items():
            key = tuple(json.loads(k))
            if key in _CAP_MEMORY:
                continue
            plan = None
            if v.get("plan"):
                p = v["plan"]
                plan = (
                    tuple(tuple(x) for x in p[0]),
                    p[1],
                    tuple(p[2]) if len(p) > 2 and p[2] is not None else (),
                    p[3] if len(p) > 3 else 0,
                )
            _CAP_MEMORY[key] = {
                "q_cap": v["q_cap"],
                "hq_cap": v["hq_cap"],
                "profile": np.asarray(v["profile"], dtype=np.int64) if v.get("profile") else None,
                "eprofile": np.asarray(v["eprofile"], dtype=np.int64) if v.get("eprofile") else None,
                "prof_flat": bool(v.get("prof_flat", False)),
                "plan": plan,
            }
    except (OSError, ValueError, KeyError):
        pass


def _capmem_save() -> None:
    import json
    import os

    try:
        path = _capmem_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        raw = {}
        for k, v in _CAP_MEMORY.items():
            plan = None
            if v.get("plan"):
                p = v["plan"]
                plan = [[list(x) for x in p[0]], int(p[1]),
                        [int(c) for c in (p[2] if len(p) > 2 else ())],
                        int(p[3]) if len(p) > 3 else 0]
            raw[json.dumps(list(k))] = {
                "q_cap": int(v["q_cap"]),
                "hq_cap": int(v["hq_cap"]),
                "profile": [int(x) for x in v["profile"]] if v.get("profile") is not None else None,
                "eprofile": [int(x) for x in v["eprofile"]] if v.get("eprofile") is not None else None,
                "prof_flat": bool(v.get("prof_flat", False)),
                "plan": plan,
            }
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(raw, fh)
        os.replace(tmp, path)
    except OSError:
        pass


def _pow2_cap(x: int) -> int:
    n = _BLK
    while n < x:
        n *= 2
    return n


def _quant_cap(x: int) -> int:
    """Round up to a 512-multiple keeping ~3 significant bits (1/8-octave
    steps): segment caps track the live profile within ~12% instead of the
    pow2 quantizer's ~50% average headroom, while the coarse steps plus the
    plan hysteresis in ``run_workq_search`` keep recompiles bounded."""
    x = max(int(x), _BLK)
    step = max(_BLK, 1 << (max(x - 1, 1).bit_length() - 3))
    return min(-(-x // step) * step, HARD_CAP)


def plan_from_profile(profile: np.ndarray, main_steps: int, tail_steps: int) -> tuple[tuple, int]:
    """Derive a segmented capacity plan from a measured live profile.

    ``profile`` = [seed_total, live after each of main+tail steps].  The
    capacity for step t must hold both the states entering it and its
    survivors; segments are merged greedily (fewest extra row-steps) down
    to at most ``_MAX_SEGS`` to bound compiled program size."""
    prof = np.asarray(profile, dtype=np.int64)
    need = np.maximum(prof[:-1], prof[1:])  # need[t] for step t (0-based over all steps)
    caps = [_quant_cap(int(v * _PLAN_MARGIN) + 1) for v in need]
    main_caps = caps[:main_steps]
    tail_cap = max(caps[main_steps:], default=_BLK)
    if not main_caps:
        return (), tail_cap
    # contiguous runs of equal cap
    runs: list[list[int]] = []  # [steps, cap]
    for c in main_caps:
        if runs and runs[-1][1] == c:
            runs[-1][0] += 1
        else:
            runs.append([1, c])
    # greedy merge until few enough segments: pick the adjacent pair whose
    # merge adds the fewest row-steps
    while len(runs) > _MAX_SEGS:
        best_i, best_cost = 0, None
        for i in range(len(runs) - 1):
            (s1, c1), (s2, c2) = runs[i], runs[i + 1]
            cost = (s1 + s2) * max(c1, c2) - (s1 * c1 + s2 * c2)
            if best_cost is None or cost < best_cost:
                best_i, best_cost = i, cost
        s1, c1 = runs[best_i]
        s2, c2 = runs.pop(best_i + 1)
        runs[best_i] = [s1 + s2, max(c1, c2)]
    return tuple((s, c) for s, c in runs), tail_cap


_PROBE_NQ = 1024


def predict_fit_chunk(index, tape, chunk: int, *, edit: bool, dedup: bool = True,
                      max_hits: int = 0) -> int:
    """Largest chunk width (by halving ``chunk``) whose predicted
    live-queue peak fits under HARD_CAP, using capacity memory from
    sibling keys that differ only in query count.

    Live states scale ~linearly with nq, so a sibling's measured peak
    (profile max; or its stored q_cap when it only ever overflowed —
    an UNDERestimate, hence the 0.75 headroom) predicts this width's
    need.  The HIT queue scales the same way, so the sibling's hq_cap
    is folded in too — hit-bound workloads (wide-interval repeat hits)
    otherwise blow HARD_CAP on the hit side and pay the retry ladder
    at full width every chunk.  Right-sizing the dispatch up front
    keeps it on an efficient segmented plan; the doubling retries and
    the driver's active-set split remain the backstop for cold keys
    and wrong predictions."""
    import os

    _capmem_load()
    dedup_every = int(os.environ.get("SAHARA_DEDUP_EVERY", "4")) if dedup else 0
    cap_per_query = 4 * max_hits if max_hits > 0 else 0
    exact = not _PROFILE_BRANCHES and os.environ.get("SAHARA_EXACT_LANE", "") == "1"
    m = tape.length
    rest = (tape.num_searches, m, tape.max_errors, phase0_length(tape, edit),
            edit, dedup_every, cap_per_query, int(index.n), int(exact))
    per_q = 0.0
    for sk, sv in _CAP_MEMORY.items():
        if len(sk) == 10 and tuple(sk[1:]) == rest:
            prof = sv.get("profile")
            peak = int(np.max(prof)) if prof is not None else int(sv["q_cap"])
            peak = max(peak, int(sv["hq_cap"]))
            per_q = max(per_q, peak / sk[0])
    if per_q <= 0:
        return chunk
    while chunk > _BLK and per_q * chunk > 0.75 * HARD_CAP:
        chunk //= 2
    return chunk


def _sibling_bootstrap(cap_key: tuple) -> dict | None:
    """Scaled capacity memory from a sibling workload that differs only in
    query count: live states scale ~linearly with nq, so a scaled profile
    skips the flat-capacity first pass; the overflow retry path backstops
    underestimates."""
    nq = cap_key[0]
    sib_best = None
    for sk, sv in _CAP_MEMORY.items():
        if len(sk) == len(cap_key) and sk[1:] == cap_key[1:] and sv.get("profile") is not None:
            if sib_best is None or sk[0] > sib_best[0]:
                sib_best = (sk[0], sv)
    if sib_best is None:
        return None
    scale = nq / sib_best[0] * 1.25
    eprof = sib_best[1].get("eprofile")
    mem = {
        "q_cap": _pow2_cap(int(sib_best[1]["q_cap"] * scale)),
        "hq_cap": _pow2_cap(int(sib_best[1]["hq_cap"] * scale)),
        "profile": np.ceil(sib_best[1]["profile"] * scale).astype(np.int64),
        "eprofile": np.ceil(eprof * scale).astype(np.int64) if eprof is not None else None,
        # scaled profiles inherit the sibling's flatness (and the probe
        # sibling is usually flat): mark flat so the first real segmented
        # run REPLACES this estimate instead of max-merging under it
        "prof_flat": bool(sib_best[1].get("prof_flat", True)),
        "plan": None,
    }
    _CAP_MEMORY[cap_key] = mem
    return mem


# SPMD callables for mesh dispatch, keyed on (mesh, static engine config):
# rebuilding jit(shard_map(...)) per call would miss jax's compile cache
# (jit keys on callable identity), so the wrappers are cached here
_MESH_FNS: dict[tuple, object] = {}


def _mesh_workq_fn(mesh, index, *, edit, plan, tail_cap, hq_cap, m, ns, k, ph0,
                   dedup_every, cap_per_query, packed, e_plan=(), e_tail_cap=0):
    """One SPMD program: per-device workq_search on the local query shard
    against the replicated index; packed outputs stacked on the data axis."""
    from jax.sharding import PartitionSpec as P

    from sahara_jax.parallel.mesh import DATA_AXIS

    # the index treedef is part of the key: DeviceIndexes with different
    # optional fields (text4/lut present or not) need different in_specs
    key = (mesh, jax.tree.structure(index), edit, plan, tail_cap, hq_cap, m,
           ns, k, ph0, dedup_every, cap_per_query, packed, e_plan, e_tail_cap)
    fn = _MESH_FNS.get(key)
    if fn is not None:
        return fn
    idx_spec = jax.tree.map(lambda _: P(), index)

    def body(idx, q, side, qpos, lo, hi, act):
        out = workq_search(
            idx, q, side, qpos, lo, hi, act,
            edit=edit, plan=plan, tail_cap=tail_cap, hq_cap=hq_cap,
            m=m, ns=ns, k=k, ph0=ph0, dedup_every=dedup_every,
            cap_per_query=cap_per_query, packed=packed,
            e_plan=e_plan, e_tail_cap=e_tail_cap,
        )
        return out.reshape(1, -1)

    fn = jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(idx_spec, P(DATA_AXIS, None), P(), P(), P(), P(), P(DATA_AXIS)),
            out_specs=P(DATA_AXIS, None),
            check_vma=False,
        )
    )
    _MESH_FNS[key] = fn
    return fn


def _e_caps_for_plan(
    eprof: np.ndarray | None, plan: tuple, tail_steps: int, flat_cap: int
) -> tuple[tuple[int, ...], int]:
    """Per-segment exact-lane caps from a measured per-step occupancy
    profile; flat fallback when none is stored.  The occupancy is bounded
    by the total live-state count, so the flat B capacity is always a
    safe ceiling."""
    if eprof is None:
        return tuple(flat_cap for _ in plan), flat_cap
    eprof = np.asarray(eprof, dtype=np.int64)
    caps = []
    t = 0
    for steps, _ in plan:
        # a boundary INTO this segment migrates sat(last step of the
        # previous segment) rows, which can exceed every in-segment value
        # when migrants die fast — include the boundary step in the max
        seg = eprof[max(t - 1, 0) : t + steps]
        caps.append(_quant_cap(int(seg.max(initial=0) * _PLAN_MARGIN) + 1))
        t += steps
    tail_seg = eprof[max(t - 1, 0) : t + tail_steps]
    return tuple(caps), _quant_cap(int(tail_seg.max(initial=0) * _PLAN_MARGIN) + 1)


def _workq_attempt(st: dict) -> None:
    """Select a capacity plan from the attempt state and launch ONE device
    call (async — the result future lands in st['dev_out'])."""
    mem = st["mem"]
    main_steps, tail_steps = st["main_steps"], st["tail_steps"]
    exact = st["exact"]
    if st["use_profile"]:
        plan, tail_cap = plan_from_profile(mem["profile"], main_steps, tail_steps)
        e_caps, e_tail = (
            _e_caps_for_plan(mem.get("eprofile"), plan, tail_steps, st["q_cap"])
            if exact
            else ((), 0)
        )
        # compile hysteresis: chunk-to-chunk profile jitter must not
        # trigger a recompile per chunk — keep the already-compiled
        # plan unless the new one is meaningfully cheaper AND the old
        # one still has capacity for the grown profile
        old_plan = mem.get("plan")
        if old_plan is not None:
            op, otc, oec, oet = old_plan
            old_cost = sum(s * c for s, c in op) + tail_steps * otc

            def _percap(pl, tc, ec, et):
                out = []
                for (s, c), e in zip(pl, ec if ec else [0] * len(pl)):
                    out += [(c, e)] * s
                return out + [(tc, et)] * tail_steps

            oc_steps = _percap(op, otc, oec, oet)
            nc_steps = _percap(plan, tail_cap, e_caps, e_tail)
            new_cost = sum(s * c for s, c in plan) + tail_steps * tail_cap
            # the old compiled plan still fits if it has at least the
            # new plan's capacity at every step (segment boundaries may
            # jitter run to run — that must not force a recompile)
            fits = len(oc_steps) == len(nc_steps) and all(
                o[0] >= n[0] and o[1] >= n[1] for o, n in zip(oc_steps, nc_steps)
            )
            if fits and new_cost >= 0.9 * old_cost:
                plan, tail_cap, e_caps, e_tail = op, otc, oec, oet
        mem["plan"] = (plan, tail_cap, e_caps, e_tail)
    else:
        plan = ((main_steps, st["q_cap"]),) if main_steps else ()
        tail_cap = st["q_cap"]
        e_caps = tuple(st["q_cap"] for _ in plan) if exact else ()
        e_tail = st["q_cap"] if exact else 0
    st["cur_hq"] = st["hq_cap"]
    st["ran_profiled"] = bool(st["use_profile"])
    mesh = st.get("mesh")
    if mesh is not None:
        fn = _mesh_workq_fn(
            mesh, st["index"], edit=st["edit"], plan=plan, tail_cap=tail_cap,
            hq_cap=st["hq_cap"], m=st["m"], ns=st["ns"], k=st["k"], ph0=st["ph0"],
            dedup_every=st["dedup_every"], cap_per_query=st["cap_per_query"],
            packed=st["packed"], e_plan=e_caps, e_tail_cap=e_tail,
        )
        st["dev_out"] = fn(st["index"], st["queries_j"], *st["device_tape"], st["act_j"])
        return
    st["dev_out"] = workq_search(
        st["index"], st["queries_j"], *st["device_tape"], st["act_j"],
        edit=st["edit"], plan=plan, tail_cap=tail_cap, hq_cap=st["hq_cap"],
        m=st["m"], ns=st["ns"], k=st["k"], ph0=st["ph0"],
        dedup_every=st["dedup_every"], cap_per_query=st["cap_per_query"],
        packed=st["packed"], e_plan=e_caps, e_tail_cap=e_tail,
    )


def dispatch_workq(
    index: DeviceIndex,
    queries: np.ndarray,
    tape: SchemeTape,
    *,
    edit: bool,
    active: np.ndarray | None = None,
    q_mult: int = 16,
    hit_mult: int = 32,
    max_retries: int = 6,
    device_tape: tuple | None = None,
    dedup: bool = False,
    dedup_every: int | None = None,
    max_hits: int = 0,
    packed: bool | None = None,
    mesh=None,
) -> dict:
    """Plan capacities and launch the search WITHOUT blocking on the
    result: jax dispatch is async, so the caller can overlap host work
    (or launch further chunks) and call :func:`collect_workq` later.
    Returns an opaque attempt-state dict.

    With ``mesh`` the call runs SPMD over the data axis: ``queries`` rows
    (a multiple of the mesh size) are sharded contiguously per device, the
    index must be replicated on the mesh, and ALL single-chip quality
    machinery — capmem capacity memory, live-profile segment plans, the
    probe bootstrap, overflow retries — applies per device (the capacity
    key uses the per-device query count, so profiles transfer between
    single-chip and mesh runs of the same per-device workload)."""
    import os

    if packed is None:
        # gather mode for the hot step: "fold" (wide folded state/product
        # rows — the fast path, see _fold_rows), "packed" (narrow stacked
        # matrices), "flat" (per-field takes; also SAHARA_NO_PACKED_GATHERS=1)
        mode = _os.environ.get("SAHARA_WORKQ_GATHER", "")
        if mode:
            packed = {"fold": "fold", "wide": "wide", "packed": True, "flat": False}[mode]
        elif _os.environ.get("SAHARA_NO_PACKED_GATHERS", "") == "1":
            packed = False
        else:
            packed = "wide"
    if dedup_every is None:
        # cadence: dominance-merge every Nth step — thinning the
        # scatter-min + winner-verify trades merge latency (slightly larger
        # queue) for step cost; every-4th was the fastest of 1..6 on
        # another chip (not re-tuned on the GPU), hit-identical
        dedup_every = int(os.environ.get("SAHARA_DEDUP_EVERY", "4")) if dedup else 0
    nq, m = queries.shape
    n_dev = mesh.devices.size if mesh is not None else 1
    if nq % n_dev:
        raise ValueError(f"query count {nq} not a multiple of the mesh size {n_dev}")
    nq_local = nq // n_dev
    ns = tape.num_searches
    k = tape.max_errors
    b = nq_local * ns
    ph0 = phase0_length(tape, edit)
    main_steps, tail_steps = main_tail_steps(m, ph0, k, edit)
    if device_tape is None:
        device_tape = upload_tape(tape, mesh=mesh)

    cap_per_query = 4 * max_hits if max_hits > 0 else 0
    # Exact lane: OPT-IN (SAHARA_EXACT_LANE=1), a negative result on
    # another chip (not re-measured on the GPU): the saturated states the
    # lane extracts were also the most dedup-mergeable ones, so the B queue
    # with dedup was already eliminating most of their cost; the lane
    # re-exposes it as E rows (boundary dedup recovers only part) plus
    # migration overhead.  Kept gated, like the "fold" gather mode.
    exact = not _PROFILE_BRANCHES and os.environ.get("SAHARA_EXACT_LANE", "") == "1"
    # ph0 is part of the key: it sets main/tail step counts, so profiles
    # from tapes with a different exact-prefix length are not interchangeable
    _capmem_load()
    cap_key = (nq_local, ns, m, k, ph0, edit, dedup_every, cap_per_query, int(index.n),
               int(exact))
    mem = _CAP_MEMORY.get(cap_key)
    if mem is None:
        mem = _sibling_bootstrap(cap_key)
    if mem is None and nq_local > 2 * _PROBE_NQ and not _PROFILE_BRANCHES:
        # cold start at large nq: profile a small query slice first, then
        # scale its live profile up.  This keeps the first full-size call on
        # a segmented plan: a flat first pass at full width would run every
        # step at its worst-case capacity guess, and each overflow of that
        # guess would retry (and recompile) at full width, while the probe
        # pays those costs at _PROBE_NQ queries.  On a mesh the probe runs as a replicated computation (the index is
        # committed to every device); its profile scales to nq_local.
        run_workq_search(
            index, np.asarray(queries)[:_PROBE_NQ], tape, edit=edit,
            device_tape=device_tape if mesh is None else None,
            dedup=dedup_every > 0,
            dedup_every=dedup_every, max_hits=max_hits, packed=packed,
        )
        mem = _sibling_bootstrap(cap_key)
    use_profile = mem is not None and mem.get("profile") is not None
    if mem is None:
        q_cap = min(_pow2_cap(b * q_mult), HARD_CAP)
        hq_cap = min(_pow2_cap(nq_local * hit_mult), HARD_CAP)
        mem = {"q_cap": q_cap, "hq_cap": hq_cap, "profile": None, "plan": None}
    else:
        q_cap, hq_cap = min(mem["q_cap"], HARD_CAP), min(mem["hq_cap"], HARD_CAP)
    act_host = np.ones(nq, dtype=bool) if active is None else np.asarray(active, dtype=bool)
    # half-active dispatches (the driver's HARD_CAP split, late besthits
    # strata) measure their peaks at reduced load; storing those profiles
    # under the mask-blind cap_key would seed UNDERSIZED plans for future
    # full-active dispatches, which then churn through overflow retries.
    # Only near-full-active runs update capacity memory.
    store_ok = int(act_host.sum()) >= nq // 2
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from sahara_jax.parallel.mesh import DATA_AXIS

        queries_j = jax.device_put(
            np.asarray(queries, dtype=np.int32), NamedSharding(mesh, P(DATA_AXIS, None))
        )
        act_j = jax.device_put(act_host, NamedSharding(mesh, P(DATA_AXIS)))
    else:
        queries_j = jnp.asarray(queries, dtype=jnp.int32)
        act_j = jnp.asarray(act_host)
    st = {
        "index": index,
        "queries_j": queries_j,
        "act_j": act_j,
        "device_tape": device_tape,
        "edit": edit, "m": m, "ns": ns, "k": k, "ph0": ph0,
        "dedup_every": dedup_every, "cap_per_query": cap_per_query, "packed": packed,
        "main_steps": main_steps, "tail_steps": tail_steps,
        "cap_key": cap_key, "mem": mem, "use_profile": use_profile,
        "q_cap": q_cap, "hq_cap": hq_cap, "max_retries": max_retries, "attempt": 0,
        "mesh": mesh, "n_dev": n_dev, "nq_local": nq_local, "store_ok": store_ok,
        "exact": exact,
    }
    _workq_attempt(st)
    return st


def collect_workq(st: dict) -> FlatHits:
    """Block on a dispatched search, parse it, and run the overflow retry
    loop (synchronously) if its static buffers were too small.

    Mesh dispatches come back as [n_dev, L] stacked shard outputs: hits
    merge with lanes shifted to global query ids; overflow flags OR,
    peak/profile aggregates take the per-device max (capacity memory then
    records the per-device envelope, matching the single-chip key)."""
    while True:
        out = np.asarray(st["dev_out"])  # ONE device->host transfer
        hq_cap = st["cur_hq"]
        # with the exact lane, the per-step occupancy profile of the E
        # queue rides after the B live profile (1 + main + tail entries)
        prof_len = 1 + st["main_steps"] + st["tail_steps"] if st["exact"] else None
        if st.get("mesh") is not None:
            shards = out  # [n_dev, 4*hq_cap + 8 + profile]
            n_hits = int(shards[:, 4 * hq_cap].sum())
            q_ovf_b = bool(shards[:, 4 * hq_cap + 1].any())
            h_ovf_b = bool(shards[:, 4 * hq_cap + 2].any())
            max_live = int(shards[:, 4 * hq_cap + 3].max())
            n_true = int(shards[:, 4 * hq_cap + 4].max())
            full_prof = shards[:, 4 * hq_cap + 8 :].max(axis=0)
        else:
            n_hits = int(out[4 * hq_cap])
            q_ovf_b = bool(out[4 * hq_cap + 1])
            h_ovf_b = bool(out[4 * hq_cap + 2])
            max_live = int(out[4 * hq_cap + 3])
            n_true = int(out[4 * hq_cap + 4])
            full_prof = out[4 * hq_cap + 8 :]
        if prof_len is not None:
            profile, eprofile = full_prof[:prof_len], full_prof[prof_len:]
        else:
            profile, eprofile = full_prof, None
        at_cap_limit = (q_ovf_b and st["q_cap"] >= HARD_CAP) or (
            h_ovf_b and st["hq_cap"] >= HARD_CAP
        )
        if not (q_ovf_b or h_ovf_b) or st["attempt"] == st["max_retries"] - 1 or at_cap_limit:
            # remember the observed peaks for future calls, quantized to
            # powers of two to bound the number of compiled variants; the
            # stored values only grow across chunks, so they converge to
            # the workload's true peak and stay there
            if not _PROFILE_BRANCHES and st.get("store_ok", True):  # diagnostic/low-active runs skip capmem
                cap_key = st["cap_key"]
                want_q = _pow2_cap(max_live + _BLK)
                want_h = _pow2_cap(n_true + _BLK)
                old = _CAP_MEMORY.get(cap_key)
                # With the exact lane, a FLAT run's B profile is
                # systematically larger than a segmented run's (flat plans
                # migrate saturated states only at step 0 and the tail, so
                # B carries them through main).  A segmented profile
                # therefore REPLACES a flat-run one (max-merging would pin
                # B at the no-migration sizes forever); a flat run never
                # merges over a stored segmented profile.
                ran_profiled = st.get("ran_profiled", False)
                old_flat = bool(old.get("prof_flat")) if old else False
                new_prof = profile.astype(np.int64)
                new_eprof = eprofile.astype(np.int64) if eprofile is not None else None
                grown = old is None or old.get("profile") is None
                if not grown and old_flat and ran_profiled and st["exact"]:
                    grown = True  # replace: drop the flat profile
                elif not grown and not old_flat and not ran_profiled and st["exact"]:
                    # flat run over a segmented store: keep the stored one
                    new_prof = old["profile"]
                    new_eprof = old.get("eprofile")
                elif not grown and len(old["profile"]) == len(new_prof):
                    merged = np.maximum(old["profile"], new_prof)
                    grown = not np.array_equal(merged, old["profile"])
                    new_prof = merged
                    if (
                        new_eprof is not None
                        and old.get("eprofile") is not None
                        and len(old["eprofile"]) == len(new_eprof)
                    ):
                        merged_e = np.maximum(old["eprofile"], new_eprof)
                        grown = grown or not np.array_equal(merged_e, old["eprofile"])
                        new_eprof = merged_e
                _CAP_MEMORY[cap_key] = {
                    "q_cap": max(want_q, old["q_cap"] if old else 0),
                    "hq_cap": max(want_h, old["hq_cap"] if old else 0),
                    "profile": None if (q_ovf_b or h_ovf_b) else new_prof,
                    "eprofile": None if (q_ovf_b or h_ovf_b) else new_eprof,
                    "prof_flat": (not ran_profiled) if not (old and not old_flat and not ran_profiled and st["exact"]) else False,
                    "plan": old.get("plan") if old else None,
                }
                # skip the (whole-file json) disk write when nothing moved:
                # in steady state every chunk landed here, ~10-20ms each
                if grown or old is None or _CAP_MEMORY[cap_key]["q_cap"] != old["q_cap"] or _CAP_MEMORY[cap_key]["hq_cap"] != old["hq_cap"]:
                    _capmem_save()
            if st.get("mesh") is not None:
                ns, nq_local = st["ns"], st["nq_local"]
                lanes, lbs, szs, errs = [], [], [], []
                for d in range(st["n_dev"]):
                    p = out[d]
                    n_d = int(p[4 * hq_cap])
                    lanes.append(p[:n_d] + d * nq_local * ns)  # local -> global
                    lbs.append(p[hq_cap : hq_cap + n_d])
                    szs.append(p[2 * hq_cap : 2 * hq_cap + n_d])
                    errs.append(p[3 * hq_cap : 3 * hq_cap + n_d])
                z = np.zeros(0, np.int32)
                return FlatHits(
                    lane=np.concatenate(lanes) if lanes else z,
                    lb=np.concatenate(lbs) if lbs else z,
                    sz=np.concatenate(szs) if szs else z,
                    err=np.concatenate(errs) if errs else z,
                    n_hits=n_hits,
                    queue_overflow=q_ovf_b,
                    hit_overflow=h_ovf_b,
                    max_live=max_live,
                    live_profile=profile,
                )
            n = n_hits
            return FlatHits(
                lane=out[:n],
                lb=out[hq_cap : hq_cap + n],
                sz=out[2 * hq_cap : 2 * hq_cap + n],
                err=out[3 * hq_cap : 3 * hq_cap + n],
                n_hits=n,
                queue_overflow=q_ovf_b,
                hit_overflow=h_ovf_b,
                max_live=max_live,
                live_profile=profile,
            )
        # an overflow DISTORTS the observed peaks downward (states lost at
        # the cap spawn no children), so max_live/n_true lag the true need
        # and a pure jump ladder can creep: grow 4x once a retry has
        # already happened, 2x + peak-jump on the first
        growth = 2 if st["attempt"] == 0 else 4
        if q_ovf_b:
            st["use_profile"] = False  # fall back to a flat plan on retry
            st["q_cap"] = min(max(st["q_cap"] * growth, _pow2_cap(max_live + _BLK)), HARD_CAP)
        if h_ovf_b:
            st["hq_cap"] = min(max(st["hq_cap"] * growth, _pow2_cap(n_true + _BLK)), HARD_CAP)
        st["attempt"] += 1
        _workq_attempt(st)


def run_workq_search(
    index: DeviceIndex,
    queries: np.ndarray,
    tape: SchemeTape,
    **kw,
) -> FlatHits:
    """Host wrapper with overflow retry (doubling queue/hit capacity) and
    live-profile-driven segmented capacity planning.

    ``max_hits`` > 0 engages the in-search work bound at 4x the cap (see
    ``workq_search``'s ``cap_per_query``): pathological queries stop
    expanding once saturated; exact per-query capping in canonical order
    remains the driver's job.

    ``device_tape`` optionally supplies pre-uploaded (side, qpos, lo, hi)
    device arrays so repeated chunk calls skip the host->device latency.

    Synchronous form of :func:`dispatch_workq` + :func:`collect_workq` —
    drivers that pipeline chunks use those directly."""
    return collect_workq(dispatch_workq(index, queries, tape, **kw))


def upload_tape(tape: SchemeTape, mesh=None) -> tuple:
    """Upload tape arrays to device once (reused across query chunks).
    With ``mesh``, replicate them across all mesh devices."""
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        sh = NamedSharding(mesh, P())
        return tuple(
            jax.device_put(np.asarray(a), sh)
            for a in (tape.side, tape.qpos, tape.lo, tape.hi)
        )
    return (
        jnp.asarray(tape.side),
        jnp.asarray(tape.qpos),
        jnp.asarray(tape.lo),
        jnp.asarray(tape.hi),
    )
