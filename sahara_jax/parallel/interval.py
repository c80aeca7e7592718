"""Interval-parallel search: the index sharded by text interval across the
mesh, queries replicated (SURVEY.md §5.7 — the context-parallel analogue
for this workload; genome-scale references).

Each device owns one (padded) shard's occ tables; every query visits every
shard.  Shard occ tables are padded to a common word count so one SPMD
program serves all devices; per-shard text lengths ride as a dynamic
array.  The driver has the same quality features as the single-chip workq
path: query chunks PIPELINE across shard_map calls (up to ``_INFLIGHT``
in flight), capacities come from the shared capmem store (live profiles
aggregated as the per-step max over shards, so the segmented plan covers
the busiest shard), and overflowed chunks retry with flat doubled caps.
Hits are located ON-DEVICE in a second SPMD pass against the same stacked
tables (no shard re-uploads), then mapped to global sequence ids via the
shard's (seqId, window-offset) tables host-side.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from sahara_jax.engine.device import DeviceIndex
from sahara_jax.engine.driver import SearchResult, _merge_results
from sahara_jax.engine.locate import lf_walk
from sahara_jax.engine.tape import SchemeTape
from sahara_jax.engine.workq import (
    _CAP_MEMORY,
    _capmem_load,
    _capmem_save,
    _pow2_cap,
    main_tail_steps,
    phase0_length,
    plan_from_profile,
    upload_tape,
    workq_search,
)
from sahara_jax.index.shard import ShardedIndex
from sahara_jax.parallel.mesh import DATA_AXIS


def _pad2(a: np.ndarray, rows: int) -> np.ndarray:
    out = np.zeros((rows,) + a.shape[1:], dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


def stack_shards(sh: ShardedIndex, mesh) -> tuple[DeviceIndex, jax.Array, int]:
    """Pad all shards to common shapes and shard the stacked arrays along
    the mesh data axis (one shard per device; shard count must not exceed
    the mesh size — extra devices get empty shards).

    Returns (stacked DeviceIndex with leading shard axis, n per shard,
    padded shard count)."""
    from sahara_jax.engine.rank import fold_occ_rows, pick_fold

    n_dev = mesh.devices.size
    if sh.num_shards > n_dev:
        raise ValueError(f"{sh.num_shards} shards > {n_dev} devices; use the sequential driver")
    w_max = max(s.occ.shape[0] for s in sh.shards)
    s_max = max(len(s.sample_seq) for s in sh.shards)
    sigma = sh.sigma
    fold = pick_fold(sigma)
    fold_s = 64
    wp = -(-w_max // fold) * fold  # shared padded word count -> static rev offset
    wp_s = -(-w_max // fold_s) * fold_s
    occ, sampled, sseq, spos, c_arr, ns_arr = [], [], [], [], [], []
    for s in sh.shards:
        # forward table padded to wp words, reversed table stacked below at
        # the STATIC folded offset so rev_rows is shard-independent
        occ.append(
            np.concatenate([fold_occ_rows(s.occ, fold, wp), fold_occ_rows(s.occ_rev, fold, wp)])
        )
        sampled.append(fold_occ_rows(s.sampled, fold_s, wp_s))
        sseq.append(_pad2(np.asarray(s.sample_seq), s_max))
        spos.append(_pad2(np.asarray(s.sample_pos), s_max))
        c_arr.append(np.asarray(s.c_arr))
        ns_arr.append(s.n)
    for _ in range(n_dev - sh.num_shards):  # empty filler shards
        occ.append(np.zeros_like(occ[0]))
        sampled.append(np.zeros_like(sampled[0]))
        sseq.append(np.zeros_like(sseq[0]))
        spos.append(np.zeros_like(spos[0]))
        c_arr.append(np.zeros_like(c_arr[0]))
        ns_arr.append(0)

    shard_sp = NamedSharding(mesh, P(DATA_AXIS))
    dev = DeviceIndex(
        occ=jax.device_put(np.stack(occ), shard_sp),
        c_arr=jax.device_put(np.stack(c_arr), shard_sp),
        sampled=jax.device_put(np.stack(sampled), shard_sp),
        sample_seq=jax.device_put(np.stack(sseq), shard_sp),
        sample_pos=jax.device_put(np.stack(spos), shard_sp),
        sigma=sigma,
        rate=sh.shards[0].rate,
        n=max(ns_arr),
        rev_rows=wp,
        fold=fold,
        fold_s=fold_s,
    )
    n_per = jax.device_put(np.asarray(ns_arr, dtype=np.int32).reshape(n_dev, 1), shard_sp)
    return dev, n_per, n_dev


# SPMD callable caches (jit keys on callable identity — rebuilding the
# shard_map wrapper per chunk would recompile per chunk)
_IV_FNS: dict = {}


def _local(index):
    return jax.tree.map(lambda x: x[0] if x.ndim and x.shape[0] == 1 else x, index)


def _interval_search_fn(mesh, stacked, *, edit, plan, tail_cap, hq_cap, m, ns, k, ph0,
                        dedup_every):
    key = (mesh, "search", jax.tree.structure(stacked), edit, plan, tail_cap, hq_cap, m, ns, k, ph0, dedup_every)
    fn = _IV_FNS.get(key)
    if fn is not None:
        return fn
    idx_spec = jax.tree.map(lambda _: P(DATA_AXIS), stacked)

    def body(index, n_loc, q, side, qpos, lo, hi, act):
        packed = workq_search(
            _local(index), q, side, qpos, lo, hi, act, n_loc.reshape(()),
            edit=edit, plan=plan, tail_cap=tail_cap, hq_cap=hq_cap,
            m=m, ns=ns, k=k, ph0=ph0, dedup_every=dedup_every,
        )
        return packed.reshape(1, -1)

    fn = jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(idx_spec, P(DATA_AXIS), P(), P(), P(), P(), P(), P()),
            out_specs=P(DATA_AXIS, None),
            check_vma=False,
        )
    )
    _IV_FNS[key] = fn
    return fn


def _interval_locate_fn(mesh, stacked, cap: int):
    key = (mesh, "locate", jax.tree.structure(stacked), cap)
    fn = _IV_FNS.get(key)
    if fn is not None:
        return fn
    idx_spec = jax.tree.map(lambda _: P(DATA_AXIS), stacked)

    def body(index, rows, valid):
        local = _local(index)
        seq_id, pos = lf_walk(local, jnp.where(valid, rows, 0), valid)
        return seq_id.reshape(1, -1), pos.reshape(1, -1)

    fn = jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(idx_spec, P(DATA_AXIS), P(DATA_AXIS)),
            out_specs=(P(DATA_AXIS, None), P(DATA_AXIS, None)),
            check_vma=False,
        )
    )
    _IV_FNS[key] = fn
    return fn


def distributed_interval_search(
    mesh,
    sh: ShardedIndex,
    queries: np.ndarray,  # [nq, m] uniform length
    tape: SchemeTape,
    *,
    edit: bool,
    q_mult: int = 16,
    hit_mult: int = 64,
    dedup: bool = True,
    max_retries: int = 4,
    chunk: int = 8192,
) -> SearchResult:
    """Every device searches replicated query chunks against ITS text
    shard; chunks pipeline, hits locate on-device per shard and merge
    globally."""
    nq, m = queries.shape
    ns = tape.num_searches
    k = tape.max_errors
    ph0 = phase0_length(tape, edit)
    main_steps, tail_steps = main_tail_steps(m, ph0, k, edit)
    dedup_every = 1 if dedup else 0

    stacked, n_per, n_dev = stack_shards(sh, mesh)
    device_tape = upload_tape(tape, mesh=mesh)
    chunk = min(chunk, nq)

    _capmem_load()
    cap_key = (chunk, ns, m, k, ph0, edit, dedup_every, 0, int(stacked.n), "iv")

    def _attempt(q_j, act_j, q_cap, hq_cap, use_profile):
        mem = _CAP_MEMORY.get(cap_key)
        if use_profile and mem is not None and mem.get("profile") is not None:
            plan, tail_cap = plan_from_profile(mem["profile"], main_steps, tail_steps)
        else:
            plan = ((main_steps, q_cap),) if main_steps else ()
            tail_cap = q_cap
        fn = _interval_search_fn(
            mesh, stacked, edit=edit, plan=plan, tail_cap=tail_cap, hq_cap=hq_cap,
            m=m, ns=ns, k=k, ph0=ph0, dedup_every=dedup_every,
        )
        return fn(stacked, n_per, q_j, *device_tape, act_j), hq_cap

    mem0 = _CAP_MEMORY.get(cap_key)
    if mem0 is not None:
        q_cap0, hq_cap0 = mem0["q_cap"], mem0["hq_cap"]
    else:
        q_cap0, hq_cap0 = _pow2_cap(chunk * ns * q_mult), _pow2_cap(chunk * hit_mult)

    # pipeline: dispatch up to _INFLIGHT chunks ahead of the collector
    _INFLIGHT = 4
    inflight: list[dict] = []
    per_shard: list[list] = [[] for _ in range(sh.num_shards)]  # (lane, lb, sz, err)

    def _collect_one():
        st = inflight.pop(0)
        q_cap, hq_cap = st["q_cap"], st["hq_cap"]
        for attempt in range(max_retries):
            out = np.asarray(st["fut"])  # [n_dev, 4*hq_cap + 8 + profile]
            ovf_q = bool(out[:, 4 * hq_cap + 1].any())
            ovf_h = bool(out[:, 4 * hq_cap + 2].any())
            if not (ovf_q or ovf_h):
                break
            if attempt == max_retries - 1:
                raise RuntimeError("interval search overflowed after retries")
            max_live = int(out[:, 4 * hq_cap + 3].max())
            n_true = int(out[:, 4 * hq_cap + 4].max())
            if ovf_q:
                q_cap = min(max(q_cap * 2, _pow2_cap(max_live + 512)), 1 << 23)
            if ovf_h:
                hq_cap = min(max(hq_cap * 2, _pow2_cap(n_true + 512)), 1 << 23)
            st["fut"], hq_cap = _attempt(st["q_j"], st["act_j"], q_cap, hq_cap, False)
            st["q_cap"], st["hq_cap"] = q_cap, hq_cap
        # capacity memory: per-step max over shards (the busiest shard
        # bounds the plan); only grows, so the derived plan converges
        profile = out[:, 4 * hq_cap + 8 :].max(axis=0).astype(np.int64)
        max_live = int(out[:, 4 * hq_cap + 3].max())
        n_true = int(out[:, 4 * hq_cap + 4].max())
        old = _CAP_MEMORY.get(cap_key)
        new_prof = profile
        if old is not None and old.get("profile") is not None and len(old["profile"]) == len(new_prof):
            new_prof = np.maximum(old["profile"], new_prof)
        grown = old is None or old.get("profile") is None or not np.array_equal(new_prof, old["profile"])
        _CAP_MEMORY[cap_key] = {
            "q_cap": max(_pow2_cap(max_live + 512), old["q_cap"] if old else 0),
            "hq_cap": max(_pow2_cap(n_true + 512), old["hq_cap"] if old else 0),
            "profile": new_prof,
            "plan": None,
        }
        if grown:
            _capmem_save()
        base = st["start"]
        for i in range(sh.num_shards):
            p = out[i]
            n = int(p[4 * hq_cap])
            if n == 0:
                continue
            per_shard[i].append(
                (p[:n] // ns + base, p[hq_cap : hq_cap + n], p[2 * hq_cap : 2 * hq_cap + n],
                 p[3 * hq_cap : 3 * hq_cap + n])
            )

    # cold start: collect chunk 0 before fanning out so later chunks launch
    # on matured caps/profile instead of cold flat capacities
    cold = mem0 is None or mem0.get("profile") is None
    for start in range(0, nq, chunk):
        q = queries[start : start + chunk]
        act = np.ones(chunk, dtype=bool)
        if q.shape[0] < chunk:
            act[q.shape[0] :] = False
            q = np.concatenate([q, np.zeros((chunk - q.shape[0], m), dtype=q.dtype)])
        q_j = jnp.asarray(q, dtype=jnp.int32)
        act_j = jnp.asarray(act)
        if len(inflight) >= _INFLIGHT or (cold and inflight):
            _collect_one()
            cold = False
        mem = _CAP_MEMORY.get(cap_key)
        q_cap = mem["q_cap"] if mem else q_cap0
        hq_cap = mem["hq_cap"] if mem else hq_cap0
        fut, hq_cap = _attempt(q_j, act_j, q_cap, hq_cap, True)
        inflight.append({"fut": fut, "q_j": q_j, "act_j": act_j, "q_cap": q_cap,
                         "hq_cap": hq_cap, "start": start})
    while inflight:
        _collect_one()

    # on-device locate: expand each shard's hit intervals host-side, pad to
    # a common capacity, ONE SPMD LF-walk against the stacked tables
    exp = []
    max_rows = 1
    for i in range(sh.num_shards):
        if per_shard[i]:
            lane = np.concatenate([h[0] for h in per_shard[i]])
            lb = np.concatenate([h[1] for h in per_shard[i]]).astype(np.int64)
            sz = np.concatenate([h[2] for h in per_shard[i]]).astype(np.int64)
            err = np.concatenate([h[3] for h in per_shard[i]])
            src = np.repeat(np.arange(len(sz)), sz)
            excl = np.concatenate([[0], np.cumsum(sz)[:-1]])
            rows = (lb[src] + np.arange(int(sz.sum())) - np.repeat(excl, sz)).astype(np.int32)
            exp.append((lane, err, src, rows))
            max_rows = max(max_rows, len(rows))
        else:
            exp.append(None)
    cap = _pow2_cap(max_rows)
    rows_all = np.zeros((n_dev, cap), dtype=np.int32)
    valid_all = np.zeros((n_dev, cap), dtype=bool)
    for i, e in enumerate(exp):
        if e is not None:
            rows_all[i, : len(e[3])] = e[3]
            valid_all[i, : len(e[3])] = True
    sp = NamedSharding(mesh, P(DATA_AXIS))
    loc = _interval_locate_fn(mesh, stacked, cap)
    seq_all, pos_all = loc(
        stacked,
        jax.device_put(rows_all.reshape(-1), sp),
        jax.device_put(valid_all.reshape(-1), sp),
    )
    seq_all = np.asarray(seq_all)
    pos_all = np.asarray(pos_all)

    parts: list[SearchResult] = []
    for i, e in enumerate(exp):
        if e is None:
            continue
        lane, err, src, rows = e
        n_rows = len(rows)
        seq_id = seq_all[i, :n_rows]
        pos = pos_all[i, :n_rows]
        gid = sh.seq_gid[i][seq_id]
        gpos = pos + sh.seq_off[i][seq_id]
        parts.append(
            SearchResult(
                query_id=lane[src].astype(np.int64),
                seq_id=gid.astype(np.int64),
                pos=gpos.astype(np.int64),
                errors=err[src].astype(np.int64),
            )
        )
    merged = _merge_results(parts)
    if len(sh.windowed_gids) and len(merged.query_id):
        windowed = np.isin(merged.seq_id, sh.windowed_gids)
        rows = np.stack([merged.query_id, merged.seq_id, merged.pos, merged.errors], axis=1)
        _, first_i = np.unique(rows, axis=0, return_index=True)
        keep = np.zeros(len(rows), dtype=bool)
        keep[first_i] = True
        keep |= ~windowed
        merged = SearchResult(
            merged.query_id[keep], merged.seq_id[keep], merged.pos[keep], merged.errors[keep]
        )
    return merged
