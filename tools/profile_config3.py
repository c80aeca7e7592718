"""Phase profile of the seed-and-verify pipeline at config[3] scale.

Attributes the per-strand-visit cost by timing each phase SYNCHRONOUSLY on a few chunks
of one shard: seed scan, host expansion (+candidate volume), verify
(total), and isolated sub-kernels (occ wide-row gather latency on the big
table, lf_walk locate, window gather, banded DP) so the verify total can
be decomposed by subtraction.

    python tools/profile_config3.py [--chunks 3] [--chunk 16384]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from sahara_jax import CACHE_DIR  # noqa: E402


def _block(x):
    jax.block_until_ready(x)
    return x


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, default=3)
    ap.add_argument("--chunk", type=int, default=16384)
    ap.add_argument("--gb", type=float, default=2.5)
    ap.add_argument("--reads", type=int, default=1_000_000)
    args = ap.parse_args()

    from sahara_jax.alphabet import D_DNA5
    from sahara_jax.engine.device import DeviceIndex
    from sahara_jax.engine.locate import lf_walk
    from sahara_jax.engine.rank import occ_row_word, rank_all_from_row
    from sahara_jax.engine.seedverify import (
        collect_sv_expand, dispatch_sv, dispatch_sv_verify, collect_sv, plan_parts,
    )
    from sahara_jax.index.shard import load_any_index

    idx_path = os.path.join(CACHE_DIR, f"c3_{args.gb}gb.idx")
    reads_path = os.path.join(CACHE_DIR, f"c3_{args.gb}gb_reads_{args.reads}.npy")
    sharded = load_any_index(idx_path)
    reads = np.load(reads_path)
    m, k = reads.shape[1], 3

    host0 = sharded.shards[0]
    t0 = time.monotonic()
    dev = DeviceIndex.from_host(host0)
    t_upload = time.monotonic() - t0
    print(f"shard0 upload+lut: {t_upload:.1f}s  n={host0.n}", file=sys.stderr)

    # --- isolated occ gather latency on the big table --------------------
    # NOTE: occ must be a jit ARGUMENT — closing over dev captured the
    # multi-GB table as a lowered CONSTANT (3.75GB inlined per executable,
    # minutes of compile + duplicate HBM)
    rng = np.random.default_rng(0)
    from functools import partial

    @partial(jax.jit, static_argnames=("fold", "sigma", "n"))
    def g50(occ, pos, *, fold, sigma, n):
        def step(p, _):
            rows = occ_row_word(occ, p >> 5, fold, 2 * sigma)
            r = rank_all_from_row(rows, sigma, p)
            return (p + r[:, 0] % 13) % (n - 64), None
        out, _ = jax.lax.scan(step, pos, None, length=50)
        return out

    for tag, nrows in (("occ_gather_262k", 262144),):
        pos = jnp.asarray(rng.integers(0, dev.n - 64, size=nrows).astype(np.int32))
        kw = dict(fold=dev.fold, sigma=dev.sigma, n=int(dev.n))
        fn = lambda occ, p: g50(occ, p, **kw)
        _block(fn(dev.occ, pos))
        best = min(_t(fn, dev.occ, pos) for _ in range(3))
        print(f"{tag}: {best / 50 / nrows * 1e9:.2f} ns/row", file=sys.stderr)

    # --- synchronous phase split over a few chunks ------------------------
    both = []
    for q in reads[: args.chunks * args.chunk // 2]:
        both.append(q)
        both.append(D_DNA5.reverse_complement_rank(q).astype(np.uint8))
    qarr = np.stack(both).astype(np.int32)

    phases = {"seed": 0.0, "expand": 0.0, "verify": 0.0}
    cands_total = 0
    hit_total = 0
    warm = True
    for c in range(args.chunks + 1):  # first chunk warms, not counted
        q = qarr[c * args.chunk : (c + 1) * args.chunk]
        if len(q) < args.chunk:
            break
        t0 = time.monotonic()
        st = dispatch_sv(dev, q, k, edit=True)
        _block(st["fut"])
        t_seed = time.monotonic() - t0
        t0 = time.monotonic()
        collect_sv_expand(st)
        t_exp = time.monotonic() - t0
        ncand = len(st["cands"][0])
        t0 = time.monotonic()
        dispatch_sv_verify(st)
        hits = collect_sv(st)
        t_ver = time.monotonic() - t0
        if not warm:
            phases["seed"] += t_seed
            phases["expand"] += t_exp
            phases["verify"] += t_ver
            cands_total += ncand
            hit_total += len(hits.q_idx)
        print(f"chunk{c}{' (warm)' if warm else ''}: seed={t_seed:.2f}s expand={t_exp:.2f}s "
              f"verify={t_ver:.2f}s cands={ncand} hits={len(hits.q_idx)}", file=sys.stderr)
        warm = False

    n_meas = args.chunks * args.chunk
    per_visit = sum(phases.values()) / n_meas * 1e6
    # --- verify sub-attribution on the last chunk's candidates -----------
    rows_np, q_of, off_of = st["cands"]
    R = len(rows_np)
    sub = {}
    if R:
        rr = jnp.asarray(np.pad(rows_np, (0, -len(rows_np) % 512)).astype(np.int32))
        vv = jnp.asarray(np.arange(len(rr)) < R)

        @jax.jit
        def just_locate(d, rr, vv):
            return lf_walk(d, jnp.where(vv, rr, 0), vv)

        _block(just_locate(dev, rr, vv))
        sub["locate_s"] = min(_t(just_locate, dev, rr, vv) for _ in range(3))
        from sahara_jax.engine.seedverify import _gather_windows

        base = jnp.asarray(rng.integers(0, dev.n - 200, size=len(rr)).astype(np.int32))
        wlen = -(-(m + 3 * k + 1) // 8) * 8

        @partial(jax.jit, static_argnames=("w",))
        def just_windows(d, base, w):
            return _gather_windows(d, base, w)

        wfn = lambda d, b: just_windows(d, b, wlen)
        _block(wfn(dev, base))
        sub["window_s"] = min(_t(wfn, dev, base) for _ in range(3))

    out = {
        "scale_gb": args.gb,
        "chunks_measured": args.chunks,
        "chunk": args.chunk,
        "per_strand_visit_us": round(per_visit, 1),
        "phase_s_per_chunk": {p: round(v / args.chunks, 3) for p, v in phases.items()},
        "cands_per_chunk": cands_total // max(args.chunks, 1),
        "hits_per_chunk": hit_total // max(args.chunks, 1),
        "verify_sub_s_last_chunk": {p: round(v, 3) for p, v in sub.items()},
        "shard_upload_s": round(t_upload, 1),
    }
    print(json.dumps(out, indent=1))


def _t(fn, *a):
    t0 = time.monotonic()
    _block(fn(*a))
    return time.monotonic() - t0


if __name__ == "__main__":
    main()
