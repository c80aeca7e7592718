"""Search driver: host orchestration of the scheme engine.

The ``runSearch`` analogue (/root/reference/src/sahara/search.cpp:104-274)
minus IO: bucket queries by length (the reference assumes uniform length —
search.cpp:191 expands for queries[0] only; we expand per distinct length),
compile the scheme tape per bucket, run the lockstep stepper, locate hits,
and return (queryId, seqId, pos, errors) rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sahara_jax.engine.approx import SearchHits, run_scheme_search_chunked
from sahara_jax.engine.device import DeviceIndex
from sahara_jax.engine.locate import locate, locate_rows_begin, locate_rows_end, locate_rows_host
from sahara_jax.engine.tape import SchemeTape, compile_tape
from sahara_jax.engine.workq import (
    MAX_NS,
    FlatHits,
    collect_workq,
    dispatch_workq,
    max_chunk_queries,
    predict_fit_chunk,
    run_workq_search,
    upload_tape,
)
from sahara_jax.engine.seedverify import (
    SvHits,
    collect_sv,
    collect_sv_expand,
    dispatch_sv,
    dispatch_sv_verify,
    seed_bad_mask,
    sv_eligible,
    sv_fused,
)
from sahara_jax.schemes import expand, get_generator, limit_to_hamming
from sahara_jax.schemes.costs import node_count, optimize_by_wnc_topdown, weighted_node_count
from sahara_jax.schemes.types import Scheme


# count of chunk active-set splits forced by HARD_CAP overflow (test
# telemetry only — cumulative across runs; tests reset it before use)
_SPLITS = 0


@dataclasses.dataclass
class SearchResult:
    """Located hits: parallel arrays (row-per-hit)."""

    query_id: np.ndarray
    seq_id: np.ndarray
    pos: np.ndarray
    errors: np.ndarray

    def rows(self) -> list[tuple[int, int, int, int]]:
        return list(zip(self.query_id.tolist(), self.seq_id.tolist(), self.pos.tolist(), self.errors.tolist()))


def _next_pow2(x: int) -> int:
    n = 1
    while n < x:
        n *= 2
    return n


def _cap_hits_per_query(result: SearchResult, max_hits: int) -> SearchResult:
    """Keep at most ``max_hits`` rows per queryId, preserving row order
    (``search_n`` truncation semantics, search.cpp:228).  Vectorized: rows
    need not be grouped by query."""
    if max_hits <= 0 or len(result.query_id) == 0:
        return result
    q = result.query_id
    order = np.argsort(q, kind="stable")
    qs = q[order]
    # rank of each row within its query group (0-based, stable order)
    starts = np.flatnonzero(np.r_[True, qs[1:] != qs[:-1]])
    run_len = np.diff(np.r_[starts, len(qs)])
    rank = np.arange(len(qs)) - np.repeat(starts, run_len)
    keep = np.zeros(len(q), dtype=bool)
    keep[order] = rank < max_hits
    return SearchResult(
        result.query_id[keep], result.seq_id[keep], result.pos[keep], result.errors[keep]
    )


def load_scheme(
    generator_name: str,
    min_k: int,
    max_k: int,
    length: int,
    *,
    edit: bool,
    sigma: int,
    n_text: int,
    dynamic: bool = False,
    verbose_cb=None,
) -> Scheme:
    """Generate + expand a scheme for one query length
    (``loadSearchScheme``, search.cpp:186-212)."""
    gen = get_generator(generator_name)
    oss = gen.generator(min_k, max_k, 0, 0)
    if dynamic:
        # --dynamic_generator uses the top-down optimizer (search.cpp:193-195
        # calls optimizeByWNCTopDown + expandByWNCTopDown)
        partition = optimize_by_wnc_topdown(oss, length, sigma, n_text, edit)
        if verbose_cb:
            verbose_cb(f"partition: {partition}")
        ess = expand(oss, partition)
    else:
        ess = expand(oss, length)
    if verbose_cb:
        verbose_cb(f"node count: {node_count(ess, sigma, edit)}")
        verbose_cb(f"weighted node count: {weighted_node_count(ess, sigma, n_text, edit)}")
    return ess


def _locate_hits(
    index: DeviceIndex,
    hits: SearchHits,
    query_ids: np.ndarray,
    max_hits: int = 0,
) -> SearchResult:
    """Expand hit intervals to located (queryId, seqId, pos, err) rows.

    Row order: query-major, then search index, then hit discovery order,
    then SA-interval row — the canonical output order of this framework
    (the reference's emission order follows its DFS; only the hit *set* is
    part of the conformance contract, SURVEY.md §7 "Hard parts")."""
    nq, ns, h_cap = hits.lb.shape
    # valid hit mask per (q, s, h)
    slot = np.arange(h_cap)[None, None, :]
    valid = slot < hits.count[:, :, None]
    q_idx, s_idx, h_idx = np.nonzero(valid)
    lb = hits.lb[q_idx, s_idx, h_idx]
    sz = hits.sz[q_idx, s_idx, h_idx]
    err = hits.err[q_idx, s_idx, h_idx]
    if len(lb) == 0:
        z = np.zeros(0, dtype=np.int64)
        return SearchResult(z, z, z, z)

    cap_rows = max(_next_pow2(int(sz.sum())), 8)
    src, seq_id, pos, row_valid, total = locate(
        index, np.asarray(lb, dtype=np.int32), np.asarray(sz, dtype=np.int32), cap_rows
    )
    src = np.asarray(src)[np.asarray(row_valid)]
    seq_id = np.asarray(seq_id)[np.asarray(row_valid)]
    pos = np.asarray(pos)[np.asarray(row_valid)]

    out_q = query_ids[q_idx[src]]
    out_err = err[src]
    result = SearchResult(
        query_id=out_q.astype(np.int64),
        seq_id=seq_id.astype(np.int64),
        pos=pos.astype(np.int64),
        errors=out_err.astype(np.int64),
    )
    return _cap_hits_per_query(result, max_hits)


def _locate_flat_hits_begin(
    index: DeviceIndex,
    hits: FlatHits,
    ns: int,
    query_ids: np.ndarray,
) -> dict | None:
    """Host-expand a work-queue result's hit intervals and launch the
    device LF-walk asynchronously (collect with _locate_flat_hits_end)."""
    if hits.n_hits == 0:
        return None
    lane_q = hits.lane // ns
    order = np.argsort(hits.lane, kind="stable")
    lb = hits.lb[order]
    sz = hits.sz[order]
    err = hits.err[order]
    q_of_hit = lane_q[order]

    cap_rows = max(_next_pow2(int(sz.sum())), 8)
    ctx = locate_rows_begin(
        index, np.asarray(lb, dtype=np.int32), np.asarray(sz, dtype=np.int32), cap_rows
    )
    ctx["err"] = err
    ctx["q_of_hit"] = q_of_hit
    ctx["query_ids"] = query_ids
    return ctx


def _locate_flat_hits_end(ctx: dict | None, max_hits: int = 0) -> SearchResult:
    if ctx is None:
        z = np.zeros(0, dtype=np.int64)
        return SearchResult(z, z, z, z)
    src, seq_id, pos = locate_rows_end(ctx)
    result = SearchResult(
        query_id=ctx["query_ids"][ctx["q_of_hit"][src]].astype(np.int64),
        seq_id=seq_id.astype(np.int64),
        pos=pos.astype(np.int64),
        errors=ctx["err"][src].astype(np.int64),
    )
    return _cap_hits_per_query(result, max_hits)


def _locate_flat_hits(
    index: DeviceIndex,
    hits: FlatHits,
    ns: int,
    query_ids: np.ndarray,
    max_hits: int = 0,
) -> SearchResult:
    """Locate a work-queue engine result (flat hit list)."""
    return _locate_flat_hits_end(_locate_flat_hits_begin(index, hits, ns, query_ids), max_hits)


def _run_workq_grouped(
    index: DeviceIndex,
    qarr: np.ndarray,
    tape: SchemeTape,
    qids: np.ndarray,
    *,
    edit: bool,
    active: np.ndarray | None,
    max_hits: int,
    chunk: int,
    mesh=None,
) -> SearchResult:
    """Work-queue engine driver: chunk queries to the meta-packing limit,
    split schemes with more than MAX_NS searches into tape groups, and
    PIPELINE the chunks — up to ``_INFLIGHT`` device searches are queued
    ahead so host-side parsing/locate-prep of chunk i overlaps the device
    executing chunks i+1.. (the device runs one stream FIFO; jax dispatch
    is async).  LF-walk collections all happen at the end.

    With ``mesh`` each dispatched chunk runs SPMD over the data axis
    (``chunk`` counts queries PER DEVICE, so a global chunk holds
    chunk * n_dev queries); the capmem plans, pre-uploaded tapes, and the
    pipeline apply identically — per-chip step cost matches the
    single-chip engine at equal per-device chunk size."""
    ns_total = tape.num_searches
    groups = [
        SchemeTape(
            side=tape.side[g : g + MAX_NS],
            qpos=tape.qpos[g : g + MAX_NS],
            lo=tape.lo[g : g + MAX_NS],
            hi=tape.hi[g : g + MAX_NS],
        )
        for g in range(0, ns_total, MAX_NS)
    ]
    group_tapes = [upload_tape(g, mesh=mesh) for g in groups]
    n_dev = mesh.devices.size if mesh is not None else 1
    chunk = min(chunk, *(max_chunk_queries(g.length, g.num_searches, g.max_errors, edit) for g in groups))
    # shrink pre-emptively when capacity memory predicts this width's live
    # frontier would blow HARD_CAP: right-sized dispatches get segmented
    # plans; the active-set split in _collect_or_split backstops cold keys
    chunk = min(chunk, *(predict_fit_chunk(index, g, chunk, edit=edit, max_hits=max_hits) for g in groups))
    chunk_g = chunk * n_dev
    nq = qarr.shape[0]
    act_all = np.ones(nq, dtype=bool) if active is None else np.asarray(active, dtype=bool)

    import os as _os

    _INFLIGHT = int(_os.environ.get("SAHARA_WORKQ_INFLIGHT", "4"))
    inflight: list[tuple] = []
    loc_pending: list[dict | None] = []

    def _collect_or_split(st, q, a, ids_d, gt, dt, ns_g):
        """Collect one dispatch; if its buffers overflowed even at the
        engine's HARD_CAP ceiling (after the doubling retries), degrade
        instead of failing: halve the ACTIVE query set via the mask —
        same compiled shapes, no recompile — and search the halves
        synchronously, recursing until the frontier fits.  Only a SINGLE
        query whose frontier exceeds HARD_CAP is a hard error."""
        global _SPLITS
        hits = collect_workq(st)
        if not (hits.queue_overflow or hits.hit_overflow):
            loc_pending.append(_locate_flat_hits_begin(index, hits, ns_g, ids_d))
            return
        act_idx = np.flatnonzero(a)
        if len(act_idx) <= 1:
            # the engine is exact only when its static buffers held; one
            # query overflowing the ceiling alone means hits were dropped
            # — never return silently-partial results
            raise RuntimeError(
                "scheme search overflowed its work buffers after retries "
                f"(queue_overflow={hits.queue_overflow}, hit_overflow={hits.hit_overflow}); "
                "a single query's frontier exceeds the engine capacity ceiling"
            )
        _SPLITS += 1
        for half in np.array_split(act_idx, 2):
            a2 = np.zeros_like(a)
            a2[half] = True
            st2 = dispatch_workq(
                index, q, gt, edit=edit, active=a2, device_tape=dt, dedup=True,
                max_hits=max_hits, mesh=mesh,
            )
            _collect_or_split(st2, q, a2, ids_d, gt, dt, ns_g)

    def _drain_one():
        _collect_or_split(*inflight.pop(0))

    for start in range(0, nq, chunk_g):
        q = qarr[start : start + chunk_g]
        a = act_all[start : start + chunk_g]
        ids = qids[start : start + chunk_g]
        # pad to the compiled shape (multi-chunk runs) or to a mesh-size
        # multiple (single chunk on a mesh)
        want = chunk_g if nq > chunk_g else -(-q.shape[0] // n_dev) * n_dev
        if q.shape[0] < want:
            pad_n = want - q.shape[0]
            q = np.concatenate([q, np.zeros((pad_n, q.shape[1]), dtype=q.dtype)])
            a = np.concatenate([a, np.zeros(pad_n, dtype=bool)])
            ids = np.concatenate([ids, np.zeros(pad_n, dtype=ids.dtype)])
        for gt, dt in zip(groups, group_tapes):
            if len(inflight) >= _INFLIGHT:
                _drain_one()
            # dedup merges dominated states (duplicate enumeration
            # orderings); hit positions are unchanged
            st = dispatch_workq(
                index, q, gt, edit=edit, active=a, device_tape=dt, dedup=True,
                max_hits=max_hits, mesh=mesh,
            )
            inflight.append((st, q, a, ids, gt, dt, gt.num_searches))
    while inflight:
        _drain_one()
    results = [_locate_flat_hits_end(ctx) for ctx in loc_pending]
    merged = _merge_results(results)
    return _cap_hits_per_query(merged, max_hits)


def _sv_hits_to_result(index: DeviceIndex, hits, qids: np.ndarray) -> SearchResult:
    """Map SV hits (absolute padded-text positions) to (seqId, pos) rows."""
    if len(hits.q_idx) == 0:
        z = np.zeros(0, dtype=np.int64)
        return SearchResult(z, z, z, z)
    starts_host = np.asarray(index.seq_starts).astype(np.int64)
    seq = np.searchsorted(starts_host, hits.abs_pos, side="right") - 1
    pos = hits.abs_pos - starts_host[seq]
    return SearchResult(
        query_id=qids[hits.q_idx].astype(np.int64),
        seq_id=seq.astype(np.int64),
        pos=pos.astype(np.int64),
        errors=hits.err.astype(np.int64),
    )


def _run_sv_mesh(
    index: DeviceIndex,
    qarr: np.ndarray,
    qids: np.ndarray,
    *,
    mesh,
    k: int,
    edit: bool,
    max_hits: int,
    chunk: int,
    part_cap: int | None,
) -> tuple[SearchResult, np.ndarray]:
    """Data-parallel seed-and-verify driver (parallel/sv.py)."""
    from sahara_jax.engine.seedverify import PART_CAP
    from sahara_jax.parallel.sv import distributed_sv_search

    hits, _ = distributed_sv_search(
        mesh, index, qarr, k, edit=edit, chunk=chunk,
        part_cap=PART_CAP if part_cap is None else part_cap,
    )
    res = _sv_hits_to_result(index, hits, qids)
    res = _merge_results([res])  # canonical order + dedup
    fb = hits.fallback if hits.fallback is not None else np.zeros(qarr.shape[0], dtype=bool)
    return _cap_hits_per_query(res, max_hits), fb


# fused-path capacity memory: (m, k, edit, P, chunk) -> {"capR", "hq_cap"}
# (in-process; the first pass discovers real candidate/hit volumes and
# right-sizes subsequent compiles)
_FUSED_CAPS: dict[tuple, dict] = {}


def _quant_fused(x: int) -> int:
    """512-multiple with ~3 significant bits (bounds compile variants)."""
    x = max(int(x), 512)
    step = max(512, 1 << (max(x - 1, 1).bit_length() - 3))
    return -(-x // step) * step


def _run_sv_fused(
    index: DeviceIndex,
    qarr: np.ndarray,
    qids: np.ndarray,
    *,
    k: int,
    edit: bool,
    active: np.ndarray | None,
    max_hits: int,
    chunk: int,
    part_cap: int,
    parts: tuple[tuple[int, int], ...],
) -> tuple[SearchResult, np.ndarray]:
    """Fused seed-and-verify driver: ONE device dispatch and ONE D2H per
    chunk (seedverify.sv_fused).  The query matrix uploads once as uint8;
    chunks are sliced on-device.  Candidate/hit overflow retries the
    chunk with grown capacities (sized from in-process capacity memory
    after the first pass).  Hit set identical to the two-phase path —
    property- and oracle-tested (tests/test_seedverify.py)."""
    import jax.numpy as jnp

    nq, m = qarr.shape
    nq_pad = -(-max(nq, 1) // chunk) * chunk
    qpad = np.zeros((nq_pad, m), dtype=np.uint8)
    qpad[:nq] = qarr
    act = np.zeros(nq_pad, dtype=bool)
    act[:nq] = True if active is None else np.asarray(active, dtype=bool)
    bad = seed_bad_mask(index, qpad, parts)
    bad_pad = np.zeros(nq_pad, dtype=bool) if bad is None else bad
    qfull = jnp.asarray(qpad)
    act_d = jnp.asarray(act)
    bad_d = jnp.asarray(bad_pad)

    key = (m, k, edit, len(parts), chunk)
    caps = _FUSED_CAPS.setdefault(
        key, {"capR": _quant_fused(2 * chunk), "hq_cap": _quant_fused(chunk)}
    )
    nw = -(-chunk // 32)

    def _dispatch(start, capR, hq_cap):
        return sv_fused(
            index, qfull, act_d, bad_d, jnp.int32(start), parts=parts, m=m, k=k,
            edit=edit, capR=capR, hq_cap=hq_cap, part_cap=part_cap, chunk=chunk,
        )

    starts = list(range(0, nq_pad, chunk))
    futs = [(_dispatch(s, caps["capR"], caps["hq_cap"]), caps["capR"], caps["hq_cap"]) for s in starts]

    fallback_all = np.zeros(nq, dtype=bool)
    out_q, out_p, out_e = [], [], []
    seen_cands = seen_hits = 0
    for start, (fut, capR, hq_cap) in zip(starts, futs):
        for _ in range(8):
            packed = np.asarray(fut)
            tail = packed[3 * hq_cap + nw :]
            n_hits, hit_ovf, cand_ovf, n_cands = (int(tail[0]), bool(tail[1]),
                                                  bool(tail[2]), int(tail[3]))
            if not (hit_ovf or cand_ovf):
                break
            if cand_ovf:
                caps["capR"] = _quant_fused(max(int(n_cands * 1.3), 2 * caps["capR"]))
            if hit_ovf:
                caps["hq_cap"] = _quant_fused(4 * caps["hq_cap"])
            capR, hq_cap = caps["capR"], caps["hq_cap"]
            fut = _dispatch(start, capR, hq_cap)
        else:
            raise RuntimeError("fused seed-verify retries exhausted")
        seen_cands = max(seen_cands, n_cands)
        seen_hits = max(seen_hits, n_hits)
        fb_words = packed[3 * hq_cap : 3 * hq_cap + nw]
        fb = (fb_words[:, None] >> np.arange(32, dtype=np.int32)[None, :]) & 1
        fb = fb.astype(bool).reshape(-1)[:chunk]
        n_real = min(chunk, nq - start)
        if n_real > 0:
            fallback_all[start : start + n_real] = fb[:n_real]
        if n_hits:
            out_q.append(start + packed[:n_hits])
            out_p.append(packed[hq_cap : hq_cap + n_hits].astype(np.int64))
            out_e.append(packed[2 * hq_cap : 2 * hq_cap + n_hits])
    # right-size the next compile generation from observed volumes (only
    # shrink when it saves a large factor — recompiles cost more than
    # moderately-padded verifies)
    if seen_cands and _quant_fused(int(seen_cands * 1.4)) * 3 < caps["capR"]:
        caps["capR"] = _quant_fused(int(seen_cands * 1.4))
    if seen_hits and _quant_fused(int(seen_hits * 2)) * 3 < caps["hq_cap"]:
        caps["hq_cap"] = _quant_fused(int(seen_hits * 2))

    if out_q:
        hits = SvHits(
            q_idx=np.concatenate(out_q).astype(np.int32),
            abs_pos=np.concatenate(out_p),
            err=np.concatenate(out_e).astype(np.int32),
        )
    else:
        z = np.zeros(0, dtype=np.int64)
        hits = SvHits(z.astype(np.int32), z, z.astype(np.int32))
    res = _sv_hits_to_result(index, hits, qids)
    res = _merge_results([res])
    return _cap_hits_per_query(res, max_hits), fallback_all


def _run_sv_grouped(
    index: DeviceIndex,
    qarr: np.ndarray,
    qids: np.ndarray,
    *,
    k: int,
    edit: bool,
    active: np.ndarray | None,
    max_hits: int,
    chunk: int,
    part_cap: int | None = None,
) -> tuple[SearchResult, np.ndarray]:
    """Seed-and-verify engine driver: chunk queries, pipeline the two device
    calls (chunk i's host expansion overlaps chunk i+1's seed search).

    Routes to the fused single-dispatch path (_run_sv_fused) whenever the
    exact-parts plan applies; the two-phase path remains for one-error
    (plan_parts_e1) seeds and as the SAHARA_NO_FUSED_SV=1 fallback.

    Returns (hits, fallback bool[nq]): queries excluded by the per-part
    occurrence budget (seedverify.PART_CAP) produce NO hits here and are
    flagged for an exact re-search through the scheme engine."""
    import os as _os

    from sahara_jax.engine.seedverify import PART_CAP, plan_parts

    nq = qarr.shape[0]
    if nq:
        parts = plan_parts(qarr.shape[1], k)
        if parts is not None and _os.environ.get("SAHARA_NO_FUSED_SV", "") != "1":
            return _run_sv_fused(
                index, qarr, qids, k=k, edit=edit, active=active,
                max_hits=max_hits, chunk=min(chunk, nq),
                part_cap=PART_CAP if part_cap is None else part_cap, parts=parts,
            )
    act_all = np.ones(nq, dtype=bool) if active is None else np.asarray(active, dtype=bool)
    fallback_all = np.zeros(nq, dtype=bool)

    sts: list[dict] = []
    prev: dict | None = None
    for start in range(0, nq, chunk):
        q = qarr[start : start + chunk]
        a = act_all[start : start + chunk]
        ids = qids[start : start + chunk]
        if q.shape[0] < chunk and nq > chunk:  # pad to the compiled shape
            pad_n = chunk - q.shape[0]
            q = np.concatenate([q, np.zeros((pad_n, q.shape[1]), dtype=q.dtype)])
            a = np.concatenate([a, np.zeros(pad_n, dtype=bool)])
            ids = np.concatenate([ids, np.zeros(pad_n, dtype=ids.dtype)])
        st = dispatch_sv(
            index, q, k, edit=edit, active=a,
            **({} if part_cap is None else {"part_cap": part_cap}),
        )
        st["ids"] = ids
        st["start"] = start
        sts.append(st)
        if prev is not None:
            collect_sv_expand(prev)  # blocks on the PREVIOUS chunk's seed
            dispatch_sv_verify(prev)
        prev = st
    if prev is not None:
        collect_sv_expand(prev)
        dispatch_sv_verify(prev)

    results: list[SearchResult] = []
    for st in sts:
        hits = collect_sv(st)
        if hits.fallback is not None and hits.fallback.any():
            start = st["start"]
            n_real = min(chunk, nq - start)
            fallback_all[start : start + n_real] = hits.fallback[:n_real]
        if len(hits.q_idx) == 0:
            continue
        results.append(_sv_hits_to_result(index, hits, st["ids"]))
    merged = _merge_results(results)
    return _cap_hits_per_query(merged, max_hits), fallback_all


def _besthits_filter(result: SearchResult) -> SearchResult:
    """Keep each query's minimal-error hits only (search_best semantics:
    the first error stratum with any hit wins, search.cpp:234-240 — for
    min-err-per-position hit sets that is exactly err == per-query min)."""
    if len(result.query_id) == 0:
        return result
    order = np.argsort(result.query_id, kind="stable")
    q = result.query_id[order]
    e = result.errors[order]
    starts = np.flatnonzero(np.r_[True, q[1:] != q[:-1]])
    run_len = np.diff(np.r_[starts, len(q)])
    best = np.minimum.reduceat(e, starts)
    keep_sorted = e == np.repeat(best, run_len)
    keep = np.zeros(len(q), dtype=bool)
    keep[order] = keep_sorted
    return SearchResult(
        result.query_id[keep], result.seq_id[keep], result.pos[keep], result.errors[keep]
    )


def _shard_to_global(res: SearchResult, sharded, i: int) -> SearchResult:
    gid = sharded.seq_gid[i][res.seq_id]
    pos = res.pos + sharded.seq_off[i][res.seq_id]
    return SearchResult(res.query_id, gid.astype(np.int64), pos.astype(np.int64), res.errors)


def _dedup_windowed(merged: SearchResult, sharded) -> SearchResult:
    """Hits inside a window overlap appear once per window: keep one."""
    if not (len(sharded.windowed_gids) and len(merged.query_id)):
        return merged
    windowed = np.isin(merged.seq_id, sharded.windowed_gids)
    rows = np.stack([merged.query_id, merged.seq_id, merged.pos, merged.errors], axis=1)
    _, first = np.unique(rows, axis=0, return_index=True)
    keep_dup = np.zeros(len(rows), dtype=bool)
    keep_dup[first] = True
    keep = keep_dup | ~windowed
    return SearchResult(
        merged.query_id[keep], merged.seq_id[keep], merged.pos[keep], merged.errors[keep]
    )


def _resident_budget() -> float:
    """Bytes the resident SV views may take: three quarters of the device
    memory pool JAX manages, leaving the rest for the engine's workspace.
    A backend that reports no pool (the CPU) keeps the views in host
    memory and sets no bound."""
    import jax

    stats = jax.devices()[0].memory_stats()
    if not stats or "bytes_limit" not in stats:
        return float("inf")
    return 0.75 * stats["bytes_limit"]


def _sv_resident_devices(sharded, verbose_cb=None) -> list | None:
    """HBM-resident SV-only views of every shard (forward occ + sampled SA
    + packed text, NO reverse table), built once and cached on the
    ShardedIndex.  Returns None when they would not fit the device pool."""
    from sahara_jax.engine.device import DeviceIndex

    devs = getattr(sharded, "_resident_devs", None)
    if devs is not None:
        return devs

    def _sv_bytes(host) -> int:
        b = host.occ.nbytes + host.sampled.nbytes
        b += host.sample_seq.nbytes + host.sample_pos.nbytes
        if host.text4 is not None:
            b += host.text4.nbytes
        return b + (8 << 20)  # j-mer lut

    total = sum(_sv_bytes(h) for h in sharded.shards)
    if total > _resident_budget():
        return None
    if verbose_cb:
        verbose_cb(
            f"resident SV views: {sharded.num_shards} shards, "
            f"{total / 1e9:.1f}GB (no shard swapping)"
        )
    devs = [DeviceIndex.from_host(h, include_rev=False) for h in sharded.shards]
    sharded._resident_devs = devs
    return devs


def search_queries_sharded(
    sharded,
    queries: list[np.ndarray],
    *,
    query_ids: np.ndarray | None = None,
    verbose_cb=None,
    **kw,
) -> SearchResult:
    """Search against an interval-sharded index (index/shard.py): per-shard
    hits map back through the (global seqId, window offset) tables,
    window-duplicate hits are merged, output is the canonical global order.

    Two regimes:

    - **Resident SV** (the fast path): when every shard carries a text
      store, the workload is seed-and-verify-eligible, and the SV-only
      device views (forward occ + sampled SA + packed text — no reverse
      table, ~35% smaller) of ALL shards fit device memory together
      (``_resident_budget``), each shard is uploaded ONCE and stays
      resident.  Shard swapping — H2D of multi-GB occ tables through the
      host link for every pass — is eliminated entirely.  Repeat-saturated
      fallback queries (PART_CAP) are deferred: the full bidirectional
      index for an affected shard is built AFTER the resident pass
      (residents freed first) and searched with the scheme engine.
    - **Swap** (the general path): shards are searched sequentially
      through HBM; the next shard's host-side preparation overlaps the
      current search on a worker thread."""
    from concurrent.futures import ThreadPoolExecutor

    from sahara_jax.engine.device import DeviceIndex
    from sahara_jax.engine.seedverify import plan_parts

    k = kw.get("k", 0)
    mode = kw.get("mode", "all")
    engine = kw.get("engine", "auto")
    lengths = {len(q) for q in queries}
    sv_ok = (
        len(lengths) == 1
        and engine in ("auto", "sv")
        and mode in ("all", "besthits")
        and k <= 7
        and all(h.text4 is not None for h in sharded.shards)
        and plan_parts(next(iter(lengths)), k) is not None
    )
    if sv_ok:
        devs = _sv_resident_devices(sharded, verbose_cb)
        if devs is not None:
            return _search_sharded_resident(
                sharded, devs, queries, query_ids=query_ids, verbose_cb=verbose_cb, **kw
            )

    parts: list[SearchResult] = []
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(DeviceIndex.from_host, sharded.shards[0])
        for i, host in enumerate(sharded.shards):
            if verbose_cb:
                verbose_cb(f"shard {i + 1}/{sharded.num_shards}: n={host.n}")
            dev = fut.result()
            # device_put is ASYNC: block until the multi-GB H2D completes
            # before dispatching searches, or every chunk dispatch queues
            # behind transfer fragments
            import jax

            jax.block_until_ready(dev.occ)
            res = search_queries(dev, queries, query_ids=query_ids, verbose_cb=verbose_cb, **kw)
            del dev  # free this shard's HBM
            if i + 1 < sharded.num_shards:
                fut = ex.submit(DeviceIndex.from_host, sharded.shards[i + 1])
            parts.append(_shard_to_global(res, sharded, i))
    merged = _dedup_windowed(_merge_results(parts), sharded)
    if mode == "besthits":
        # per-shard besthits keeps per-shard minima; the global minimum per
        # query is the minimum of those — re-filter after the merge
        merged = _besthits_filter(merged)
    return merged


def _search_sharded_resident(
    sharded,
    devs: list,
    queries: list[np.ndarray],
    *,
    query_ids: np.ndarray | None = None,
    verbose_cb=None,
    k: int = 0,
    generator_name: str = "h2-k2",
    edit: bool = True,
    mode: str = "all",
    max_hits: int = 0,
    dynamic: bool = False,
    chunk: int = 16384,
    sv_part_cap: int | None = None,
    **_ignored,
) -> SearchResult:
    """Resident-SV sharded search (see search_queries_sharded)."""
    from sahara_jax.engine.device import DeviceIndex

    qarr = np.stack(queries).astype(np.int32, copy=False)
    m = qarr.shape[1]
    qids = (
        np.arange(len(queries), dtype=np.int64)
        if query_ids is None
        else np.asarray(query_ids, dtype=np.int64)
    )
    parts: list[SearchResult] = []
    fb_by_shard: list[np.ndarray] = []
    for i in range(len(devs)):
        if verbose_cb:
            verbose_cb(f"shard {i + 1}/{sharded.num_shards} (resident): n={devs[i].n}")
        res, fb = _run_sv_grouped(
            devs[i], qarr, qids, k=k, edit=edit, active=None, max_hits=0,
            chunk=chunk, part_cap=sv_part_cap,
        )
        fb_by_shard.append(fb)
        parts.append(_shard_to_global(res, sharded, i))
    if any(fb.any() for fb in fb_by_shard):
        # repeat-saturated queries: exact re-search through the scheme
        # engine against the FULL bidirectional index of each affected
        # shard — residents are dropped first so the 2x-size index fits
        sharded._resident_devs = None
        devs = None
        for i, fb in enumerate(fb_by_shard):
            if not fb.any():
                continue
            if verbose_cb:
                verbose_cb(
                    f"shard {i + 1}: {int(fb.sum())} repeat-saturated queries "
                    "re-searched via the scheme engine (full index swap-in)"
                )
            full = DeviceIndex.from_host(sharded.shards[i])
            ess = load_scheme(
                generator_name, 0, k, m, edit=edit, sigma=full.sigma,
                n_text=full.n, dynamic=dynamic,
            )
            if not edit:
                ess = limit_to_hamming(ess)
            res_fb = _run_workq_grouped(
                full, qarr, compile_tape(ess), qids, edit=edit, active=fb,
                max_hits=0, chunk=chunk,
            )
            del full
            parts.append(_shard_to_global(res_fb, sharded, i))
    merged = _dedup_windowed(_merge_results(parts), sharded)
    if mode == "besthits":
        merged = _besthits_filter(merged)
    return _cap_hits_per_query(merged, max_hits)


def _merge_results(results: list[SearchResult]) -> SearchResult:
    """Merge partial results into the canonical output: unique
    (queryId, seqId, pos) rows sorted lexicographically, keeping the
    minimal error count per position.

    Output is a hit *set* (CONFORMANCE.md §3 item 1): duplicate rows from
    overlapping scheme searches, tape groups, or enumeration paths are an
    engine artifact (the reference's own multiplicity is an artifact of
    its DFS), so they are dropped here once, centrally — engine-level
    state merging (workq dedup) then only affects speed, never output."""
    if not results:
        z = np.zeros(0, dtype=np.int64)
        return SearchResult(z, z, z, z)
    q = np.concatenate([r.query_id for r in results])
    s = np.concatenate([r.seq_id for r in results])
    p = np.concatenate([r.pos for r in results])
    e = np.concatenate([r.errors for r in results])
    if len(q) == 0:
        return SearchResult(q, s, p, e)
    order = np.lexsort((e, p, s, q))
    q, s, p, e = q[order], s[order], p[order], e[order]
    keep = np.r_[True, (q[1:] != q[:-1]) | (s[1:] != s[:-1]) | (p[1:] != p[:-1])]
    return SearchResult(q[keep], s[keep], p[keep], e[keep])


def search_queries(
    index: DeviceIndex,
    queries: list[np.ndarray],
    *,
    k: int,
    generator_name: str = "h2-k2",
    edit: bool = True,
    mode: str = "all",
    max_hits: int = 0,
    dynamic: bool = False,
    s_cap: int = 64,
    h_cap: int = 32,
    # 16384-query chunks were the fastest for both engines on another chip
    # (8192 and 24-32k were slower); not re-tuned on the GPU
    chunk: int = 16384,
    engine: str = "auto",
    query_ids: np.ndarray | None = None,
    sv_part_cap: int | None = None,
    mesh=None,
    verbose_cb=None,
) -> SearchResult:
    """Approximate search of rank-array queries against a bidirectional
    device index.  Returns located hits over all queries.

    ``query_ids`` optionally maps local query indices to global ids (used
    by the multi-host runner, where each host owns a contiguous slice of
    the global query list and must emit global ids).

    ``mesh`` optionally distributes the search data-parallel over a
    ``jax.sharding.Mesh`` (queries sharded, index replicated — the index
    must have been uploaded with ``parallel.replicate_index``); both the
    seed-and-verify and workq engines have SPMD drivers (parallel/sv.py,
    parallel/search.py)."""
    use_mesh = mesh is not None and mesh.devices.size > 1
    sigma = index.sigma
    results: list[SearchResult] = []

    # bucket queries by length (reference assumes uniform length).  A 2-D
    # ndarray is accepted directly as one uniform bucket — the streaming
    # CLI path feeds parsed blocks this way, skipping the per-row list
    # round-trip and re-stack entirely.
    by_len: dict[int, list[int] | None] = {}
    if isinstance(queries, np.ndarray):
        if queries.ndim != 2:
            raise ValueError("matrix queries must be 2-D [nq, m]")
        if queries.shape[1]:
            by_len[queries.shape[1]] = None
    else:
        for i, q in enumerate(queries):
            by_len.setdefault(len(q), []).append(i)

    for length, idxs in sorted(by_len.items()):
        if length == 0:
            continue
        if idxs is None:
            qarr = np.ascontiguousarray(queries, dtype=np.int32)
            qids = np.arange(len(queries), dtype=np.int64)
        else:
            # one vectorized cast — a per-query asarray(dtype=int32) costs ~24us
            # of Python overhead each, ~3s per pass at 131k queries
            qarr = np.stack([queries[i] for i in idxs]).astype(np.int32, copy=False)
            qids = np.asarray(idxs, dtype=np.int64)
        if query_ids is not None:
            qids = np.asarray(query_ids, dtype=np.int64)[qids]

        # engine resolution: "auto" prefers seed-and-verify (the cheapest
        # path by a wide margin) whenever the index carries a text store and
        # the parts are long enough to filter; scheme engines otherwise
        # single-chip SV also admits scheme-seeded (one-error) plans for
        # short reads (plan_parts_e1); the mesh SV driver seeds exactly
        use_sv = engine in ("auto", "sv") and mode in ("all", "besthits") and sv_eligible(
            index, length, k, seed_errors=0 if use_mesh else 1
        )
        if engine == "sv" and not use_sv:
            raise ValueError(
                "seed-verify engine not applicable (index lacks a text store, "
                f"or parts too short for m={length}, k={k})"
            )
        if verbose_cb:
            eng_name = "seed-verify" if use_sv else ("workq" if engine == "auto" else engine)
            where = f"mesh[{mesh.devices.size}]" if use_mesh else "single-device"
            verbose_cb(f"engine: {eng_name} ({where}, m={length}, {len(qarr)} queries)")
        if use_sv:
            if use_mesh:
                res, fallback = _run_sv_mesh(
                    index, qarr, qids, mesh=mesh, k=k, edit=edit,
                    max_hits=0, chunk=chunk, part_cap=sv_part_cap,
                )
            else:
                res, fallback = _run_sv_grouped(
                    index, qarr, qids, k=k, edit=edit, active=None,
                    max_hits=0, chunk=chunk, part_cap=sv_part_cap,
                )
            if fallback.any():
                # repeat-saturated queries (any part over the occurrence
                # budget): exact automatic re-search via the workq engine
                if verbose_cb:
                    verbose_cb(
                        f"seed-verify: {int(fallback.sum())} repeat-saturated "
                        "queries re-searched via the scheme engine"
                    )
                ess = load_scheme(
                    generator_name, 0, k, length, edit=edit, sigma=sigma,
                    n_text=index.n, dynamic=dynamic, verbose_cb=None,
                )
                if not edit:
                    ess = limit_to_hamming(ess)
                res_fb = _run_workq_grouped(
                    index, qarr, compile_tape(ess), qids, edit=edit,
                    active=fallback, max_hits=0, chunk=chunk,
                    mesh=mesh if use_mesh else None,
                )
                res = _merge_results([res, res_fb])
            if mode == "besthits":
                res = _besthits_filter(res)
            results.append(_cap_hits_per_query(res, max_hits))
            continue
        bucket_engine = "workq" if engine == "auto" else engine
        if use_mesh and bucket_engine != "workq":
            raise ValueError(
                f"engine {bucket_engine!r} has no distributed driver; use "
                "engine='auto' or 'workq' with a mesh"
            )

        if mode == "all":
            ess = load_scheme(
                generator_name, 0, k, length, edit=edit, sigma=sigma, n_text=index.n,
                dynamic=dynamic, verbose_cb=verbose_cb,
            )
            if not edit:
                ess = limit_to_hamming(ess)
            tape = compile_tape(ess)
            if bucket_engine == "workq":
                results.append(
                    _run_workq_grouped(
                        index, qarr, tape, qids, edit=edit, active=None,
                        max_hits=max_hits, chunk=chunk,
                        mesh=mesh if use_mesh else None,
                    )
                )
            else:
                hits = run_scheme_search_chunked(
                    index, qarr, tape, edit=edit, s_cap=s_cap, h_cap=h_cap, chunk=chunk
                )
                if hits.any_overflow:
                    raise RuntimeError(
                        "scheme search overflowed its frontier/hit buffers after retries; "
                        "hits would be silently dropped"
                    )
                results.append(_locate_hits(index, hits, qids, max_hits=max_hits))
        elif mode == "besthits":
            # strata j = 0..k: stop per query at the first stratum with hits
            # (search_ng21::search_best semantics, search.cpp:234-240)
            active = np.ones(len(qarr), dtype=bool)
            for j in range(k + 1):
                if not active.any():
                    break
                ess = load_scheme(
                    generator_name, j, j, length, edit=edit, sigma=sigma, n_text=index.n,
                    dynamic=dynamic, verbose_cb=verbose_cb,
                )
                if not edit:
                    ess = limit_to_hamming(ess)
                tape = compile_tape(ess)
                if bucket_engine == "workq":
                    res = _run_workq_grouped(
                        index, qarr, tape, qids, edit=edit, active=active,
                        max_hits=max_hits, chunk=chunk,
                        mesh=mesh if use_mesh else None,
                    )
                else:
                    hits = run_scheme_search_chunked(
                        index, qarr, tape, edit=edit, active=active, s_cap=s_cap, h_cap=h_cap, chunk=chunk
                    )
                    if hits.any_overflow:
                        raise RuntimeError(
                            "scheme search overflowed its frontier/hit buffers after retries; "
                            "hits would be silently dropped"
                        )
                    res = _locate_hits(index, hits, qids, max_hits=max_hits)
                results.append(res)
                active &= ~np.isin(qids, res.query_id)
        else:
            raise ValueError(f"unknown search mode {mode!r}")

    return _merge_results(results)
