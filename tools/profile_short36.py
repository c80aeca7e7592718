"""Attribute the short36/e3 cliff: phase timing of the
scheme-seeded (e1) seed-and-verify path at bench shapes.

Runs ONE 16384-query chunk of 36bp/k=3 queries through the two-phase
driver with per-phase walls: seed workq dispatch+collect, host e1
expansion, verify dispatch+collect.  Also reports candidate volumes and
the seed workq's internal retry count.

    python tools/profile_short36.py [--chunk 16384] [--reps 3]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sahara_jax import CACHE_DIR  # noqa: E402

import numpy as np

import bench


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunk", type=int, default=16384)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    from sahara_jax.alphabet import D_DNA5
    from sahara_jax.engine.device import DeviceIndex
    from sahara_jax.engine.seedverify import (
        collect_sv, collect_sv_expand, dispatch_sv, dispatch_sv_verify,
    )
    from sahara_jax.index.build import build_bifmindex
    from sahara_jax.index.fmindex import load_index, save_index
    from sahara_jax.sim.read_simulator import simulate_reads

    path = os.path.join(CACHE_DIR,
                        f"bench_index{bench.REF_MB}_v2.idx")
    ref, _ = bench.load_workload()
    if os.path.exists(path):
        host = load_index(path)
    else:
        host = build_bifmindex([ref], 6, "d_dna5", rate=16)
        save_index(path, host)
    index = DeviceIndex.from_host(host)

    _RANK_TO_CHAR = np.frombuffer(b"\x00ACGTN", dtype=np.uint8)
    recs = simulate_reads([_RANK_TO_CHAR[ref].tobytes()], num_reads=args.chunk // 2,
                          read_length=36, random_errors=2, seed=7)
    reads = [D_DNA5.char_to_rank(r.seq).astype(np.uint8) for r in recs]
    both = [s for q in reads for s in (q, D_DNA5.reverse_complement_rank(q).astype(np.uint8))]
    qarr = np.stack(both).astype(np.int32)
    print(f"chunk={qarr.shape[0]} m={qarr.shape[1]} k=3", file=sys.stderr)

    for rep in range(args.reps):
        t0 = time.monotonic()
        st = dispatch_sv(index, qarr, 3, edit=True)
        t1 = time.monotonic()
        collect_sv_expand(st)
        t2 = time.monotonic()
        rows, q_of, off_of = st["cands"]
        dispatch_sv_verify(st)
        t3 = time.monotonic()
        hits = collect_sv(st)
        t4 = time.monotonic()
        print(
            f"rep{rep}: total={t4 - t0:.3f}s  seed_dispatch={t1 - t0:.3f}s  "
            f"seed_collect+expand={t2 - t1:.3f}s  verify_dispatch={t3 - t2:.3f}s  "
            f"verify_collect={t4 - t3:.3f}s  cands={len(rows)}  "
            f"hits={len(hits.q_idx)}  fallback={int(st['fallback'].sum())}",
            file=sys.stderr,
        )
        if rep == 0 and "seed_e1" in st:
            print(f"  e1 seed groups: {[(len(pidx), s.get('nq')) for s, pidx in []]}",
                  file=sys.stderr)


if __name__ == "__main__":
    main()
