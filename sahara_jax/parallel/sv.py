"""Distributed seed-and-verify search: the flagship engine over a data mesh.

Queries are sharded along the mesh data axis, the index (occ tables, text
store, sampled SA) is replicated per device, and both device phases of the
engine (engine/seedverify.py) run as ONE SPMD program each via
``jax.shard_map``:

    seed   — every device runs the lockstep exact part scan on its query
             shard (index replicated, ``P()``; queries ``P('data')``);
    expand — host-side ragged expansion per shard (the host sees all
             addressable shards of the seed output; expansion is exact and
             enforces the per-part occurrence budget, flagging
             repeat-saturated queries for scheme-engine fallback);
    verify — per-shard candidate rows padded to a common capacity and
             sharded back over the data axis; the banded DP verifier emits
             located hits per shard while the global hit count is reduced
             with ``psum``.

Chunks pipeline exactly like the single-chip driver (_run_sv_grouped):
chunk i's host expansion overlaps chunk i+1's seed scan on the devices.
This is the multi-chip form of the engine behind the headline bench number
(data-parallel query shards, replicated index, collective hit reduction —
the reference itself is single-process, SURVEY.md §2.3).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from sahara_jax.engine.device import DeviceIndex
from sahara_jax.engine.seedverify import (
    _MAX_CAPR,
    PART_CAP,
    SvHits,
    _quant,
    expand_seeds,
    plan_parts,
    seed_parts,
    sv_verify,
)
from sahara_jax.parallel.mesh import DATA_AXIS


def _make_seed_fn(mesh, index, parts):
    """One SPMD seed program: queries sharded, index replicated."""
    idx_spec = jax.tree.map(lambda _: P(), index)

    def body(idx, q):
        return seed_parts(idx, q, parts).reshape(1, -1)

    return jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(idx_spec, P(DATA_AXIS, None)),
            out_specs=P(DATA_AXIS, None),
            check_vma=False,
        )
    )


def _make_verify_fn(mesh, index, *, m, k, edit, hq_cap):
    """One SPMD verify program: candidates + queries sharded, index
    replicated, global hit count psum-reduced over the data axis."""
    idx_spec = jax.tree.map(lambda _: P(), index)

    def body(idx, q, rows, q_of, off_of, valid):
        packed = sv_verify(
            idx, q, rows, q_of, off_of, valid, m=m, k=k, edit=edit, hq_cap=hq_cap
        )
        total = jax.lax.psum(packed[3 * hq_cap], DATA_AXIS)
        return packed.reshape(1, -1), total

    return jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(
                idx_spec, P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS),
                P(DATA_AXIS), P(DATA_AXIS),
            ),
            out_specs=(P(DATA_AXIS, None), P()),
            check_vma=False,
        )
    )


def _dispatch_seed_chunk(mesh, index, seed_fn, qchunk, act, n_dev):
    """Shard one padded query chunk and launch the SPMD seed scan."""
    q_sh = jax.device_put(qchunk, NamedSharding(mesh, P(DATA_AXIS, None)))
    fut = seed_fn(index, q_sh)
    return {"fut": fut, "qdev": q_sh, "qhost": qchunk, "act": act, "nq": qchunk.shape[0]}


def _expand_chunk(st, index, parts, n_dev, part_cap):
    """Host expansion per device shard (blocks on this chunk's seed)."""
    from sahara_jax.engine.seedverify import seed_bad_mask

    packed = np.asarray(st["fut"])  # [n_dev, 2 * nq_local * P]
    nq_local = st["nq"] // n_dev
    cands, fallback = [], []
    for d in range(n_dev):
        sl = slice(d * nq_local, (d + 1) * nq_local)
        bad = seed_bad_mask(index, st["qhost"][sl], parts)
        rows, q_of, off_of, fb = expand_seeds(
            packed[d], nq_local, parts, st["act"][sl], part_cap, bad=bad
        )
        cands.append((rows, q_of, off_of))
        fallback.append(fb)
    st["cands"] = cands
    st["fallback"] = np.concatenate(fallback)


def _dispatch_verify_chunk(st, mesh, index, verify_cache, *, m, k, edit, n_dev, hit_mult=8):
    """Pad per-shard candidates to a common capacity and launch the SPMD
    verify program(s); slices over _MAX_CAPR like the single-chip driver."""
    cands = st["cands"]
    max_len = max((len(r) for r, _, _ in cands), default=0)
    n_slices = max(-(-max_len // _MAX_CAPR), 1)
    futs = []
    for si in range(n_slices):
        s = si * _MAX_CAPR
        lens = [min(max(len(r) - s, 0), _MAX_CAPR) for r, _, _ in cands]
        capR = _quant(max(max(lens), 1))
        hq_cap = _quant(max(2 * max(lens), hit_mult * 64))
        rr = np.zeros((n_dev, capR), dtype=np.int32)
        qq = np.zeros((n_dev, capR), dtype=np.int32)
        oo = np.zeros((n_dev, capR), dtype=np.int32)
        vv = np.zeros((n_dev, capR), dtype=bool)
        for d, (rows, q_of, off_of) in enumerate(cands):
            ln = lens[d]
            rr[d, :ln] = rows[s : s + ln]
            qq[d, :ln] = q_of[s : s + ln]
            oo[d, :ln] = off_of[s : s + ln]
            vv[d, :ln] = True
        futs.append(
            _launch_verify(
                st, mesh, index, verify_cache, rr, qq, oo, vv,
                m=m, k=k, edit=edit, capR=capR, hq_cap=hq_cap, n_dev=n_dev,
            )
        )
    st["vfuts"] = futs


def _launch_verify(st, mesh, index, verify_cache, rr, qq, oo, vv, *, m, k, edit, capR, hq_cap, n_dev):
    key = (capR, hq_cap)
    if key not in verify_cache:
        verify_cache[key] = _make_verify_fn(mesh, index, m=m, k=k, edit=edit, hq_cap=hq_cap)
    fn = verify_cache[key]
    sh = NamedSharding(mesh, P(DATA_AXIS))
    fut, total = fn(
        index,
        st["qdev"],
        jax.device_put(rr.reshape(-1), sh),
        jax.device_put(qq.reshape(-1), sh),
        jax.device_put(oo.reshape(-1), sh),
        jax.device_put(vv.reshape(-1), sh),
    )
    return {"fut": fut, "total": total, "qq": qq, "rr": rr, "oo": oo, "vv": vv,
            "capR": capR, "hq_cap": hq_cap}


def _collect_chunk(st, mesh, index, verify_cache, *, m, k, edit, n_dev, nq_local):
    """Block on this chunk's verify programs; retry overflowed slices with
    a larger hit buffer; decode per-shard hits to chunk-local query ids."""
    out_q, out_p, out_e = [], [], []
    for v in st["vfuts"]:
        while True:
            packed = np.asarray(v["fut"])  # [n_dev, 3*hq_cap+8]
            hq_cap, capR = v["hq_cap"], v["capR"]
            if not packed[:, 3 * hq_cap + 1].any():
                break
            v = _launch_verify(
                st, mesh, index, verify_cache, v["rr"], v["qq"], v["oo"], v["vv"],
                m=m, k=k, edit=edit, capR=capR, hq_cap=_quant(hq_cap * 4), n_dev=n_dev,
            )
        for d in range(n_dev):
            p = packed[d]
            cnt = int(p[3 * hq_cap])
            if cnt == 0:
                continue
            ids = p[:cnt]
            cand = ids % capR
            out_q.append(v["qq"][d][cand] + d * nq_local)
            out_p.append(p[hq_cap : hq_cap + cnt].astype(np.int64))
            out_e.append(p[2 * hq_cap : 2 * hq_cap + cnt])
    if not out_q:
        z = np.zeros(0, dtype=np.int64)
        return SvHits(z.astype(np.int32), z, z.astype(np.int32), fallback=st["fallback"])
    return SvHits(
        q_idx=np.concatenate(out_q).astype(np.int32),
        abs_pos=np.concatenate(out_p),
        err=np.concatenate(out_e).astype(np.int32),
        fallback=st["fallback"],
    )


def distributed_sv_search(
    mesh,
    index: DeviceIndex,
    queries: np.ndarray,  # int32[nq, m] uniform length
    k: int,
    *,
    edit: bool,
    chunk: int = 8192,  # queries per device per chunk
    part_cap: int = PART_CAP,
    active: np.ndarray | None = None,
) -> tuple[SvHits, int]:
    """Data-parallel seed-and-verify over the mesh.

    Returns (SvHits with ``q_idx`` global over the input batch and
    ``fallback`` bool[nq] flagging repeat-saturated queries the caller must
    re-search with a scheme engine, global verified-hit count)."""
    n_dev = mesh.devices.size
    # int32 is load-bearing: the j-mer seed code computation shifts
    # (rank - 1) << (2*i), which silently wraps in uint8 (the repo's
    # native rank dtype) and produces wrong-but-in-range table codes
    queries = np.asarray(queries, dtype=np.int32)
    nq, m = queries.shape
    parts = plan_parts(m, k)
    if parts is None:
        raise ValueError(f"seed-verify not applicable: m={m}, k={k}")
    act_all = np.ones(nq, dtype=bool) if active is None else np.asarray(active, dtype=bool)

    chunk_g = chunk * n_dev
    nq_pad = -(-nq // chunk_g) * chunk_g if nq > chunk_g else -(-nq // n_dev) * n_dev
    if nq_pad > nq:
        queries = np.concatenate(
            [queries, np.zeros((nq_pad - nq, m), dtype=queries.dtype)], axis=0
        )
        act_all = np.concatenate([act_all, np.zeros(nq_pad - nq, dtype=bool)])
    chunk_g = min(chunk_g, nq_pad)
    nq_local = chunk_g // n_dev

    seed_fn = _make_seed_fn(mesh, index, parts)
    verify_cache: dict = {}

    sts = []
    prev = None
    for start in range(0, nq_pad, chunk_g):
        st = _dispatch_seed_chunk(
            mesh, index, seed_fn,
            queries[start : start + chunk_g],
            act_all[start : start + chunk_g],
            n_dev,
        )
        st["start"] = start
        sts.append(st)
        if prev is not None:
            _expand_chunk(prev, index, parts, n_dev, part_cap)
            _dispatch_verify_chunk(prev, mesh, index, verify_cache, m=m, k=k, edit=edit, n_dev=n_dev)
        prev = st
    if prev is not None:
        _expand_chunk(prev, index, parts, n_dev, part_cap)
        _dispatch_verify_chunk(prev, mesh, index, verify_cache, m=m, k=k, edit=edit, n_dev=n_dev)

    all_q, all_p, all_e = [], [], []
    fallback = np.zeros(nq_pad, dtype=bool)
    for st in sts:
        hits = _collect_chunk(
            st, mesh, index, verify_cache, m=m, k=k, edit=edit, n_dev=n_dev, nq_local=nq_local
        )
        fallback[st["start"] : st["start"] + chunk_g] = hits.fallback
        if len(hits.q_idx):
            all_q.append(hits.q_idx + st["start"])
            all_p.append(hits.abs_pos)
            all_e.append(hits.err)
    if all_q:
        q_idx = np.concatenate(all_q).astype(np.int32)
        keep = q_idx < nq  # drop padded lanes (masked inactive anyway)
        out = SvHits(
            q_idx=q_idx[keep],
            abs_pos=np.concatenate(all_p)[keep],
            err=np.concatenate(all_e)[keep].astype(np.int32),
            fallback=fallback[:nq],
        )
    else:
        z = np.zeros(0, dtype=np.int64)
        out = SvHits(z.astype(np.int32), z, z.astype(np.int32), fallback=fallback[:nq])
    return out, len(out.q_idx)
