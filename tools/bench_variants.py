"""Variant bench rows, measured variance-robustly: every row interleaved
against the headline all-mode pass in ONE process window.

Times differ between process windows, so variant rows measured in
separate bench.py invocations are not comparable.  Here every variant runs once per
round, rounds alternate, and each row reports its best-of-N next to the
headline's best-of-N from the SAME window, plus the raw per-round times.

    python tools/bench_variants.py [--rounds N] [--out variants.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sahara_jax import CACHE_DIR  # noqa: E402

import numpy as np

import bench  # repo-root harness: workload gen + caches



def _load_dna5():
    from sahara_jax.engine.device import DeviceIndex
    from sahara_jax.index.build import build_bifmindex
    from sahara_jax.index.fmindex import load_index, save_index

    path = os.path.join(CACHE_DIR, f"bench_index{bench.REF_MB}_v2.idx")
    ref, queries = bench.load_workload()
    if os.path.exists(path):
        host = load_index(path)
    else:
        host = build_bifmindex([ref], 6, "d_dna5", rate=16)
        save_index(path, host)
    return ref, queries, DeviceIndex.from_host(host)


def _load_rbi(ref):
    from sahara_jax.engine.device import DeviceIndex
    from sahara_jax.index.build import build_bifmindex
    from sahara_jax.index.fmindex import load_index, save_index

    path = os.path.join(CACHE_DIR, f"bench_indexrbi_{bench.REF_MB}_v2.idx")
    _DR = np.array([0, 1, 2, 2, 1, 3], dtype=np.uint8)
    dref = _DR[ref]
    if os.path.exists(path):
        host = load_index(path)
    else:
        host = build_bifmindex([dref, dref[::-1].copy()], 4, "dr_dna5",
                               rate=16, threads=4, mirrored=True)
        save_index(path, host)
    return _DR, DeviceIndex.from_host(host)


def _short_reads(ref, n, length, errors, seed):
    from sahara_jax.alphabet import D_DNA5
    from sahara_jax.sim.read_simulator import simulate_reads

    _RANK_TO_CHAR = np.frombuffer(b"\x00ACGTN", dtype=np.uint8)
    recs = simulate_reads([_RANK_TO_CHAR[ref].tobytes()], num_reads=n,
                          read_length=length, random_errors=errors, seed=seed)
    return [D_DNA5.char_to_rank(r.seq).astype(np.uint8) for r in recs]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from sahara_jax.alphabet import D_DNA5
    from sahara_jax.engine.driver import search_queries

    ref, reads, index = _load_dna5()
    n_reads = len(reads)
    both = [s for q in reads for s in (q, D_DNA5.reverse_complement_rank(q).astype(np.uint8))]
    dr_map, rbi_index = _load_rbi(ref)
    rbi_reads = [dr_map[q] for q in reads]
    short36 = _short_reads(ref, 32768, 36, 2, seed=7)
    short36_both = [s for q in short36 for s in (q, D_DNA5.reverse_complement_rank(q).astype(np.uint8))]

    CHUNK = bench.CHUNK
    variants = {
        # name: (n_reads_for_rate, thunk)
        "all_lev": (n_reads, lambda: search_queries(
            index, both, k=2, generator_name="optimum", edit=True, mode="all",
            engine="auto", chunk=CHUNK)),
        "ham": (n_reads, lambda: search_queries(
            index, both, k=2, generator_name="optimum", edit=False, mode="all",
            engine="auto", chunk=CHUNK)),
        "besthits": (n_reads, lambda: search_queries(
            index, both, k=2, generator_name="optimum", edit=True, mode="besthits",
            engine="auto", chunk=CHUNK)),
        "workq": (n_reads, lambda: search_queries(
            index, both, k=2, generator_name="optimum", edit=True, mode="all",
            engine="workq", chunk=CHUNK)),
        "rbi": (n_reads, lambda: search_queries(
            rbi_index, rbi_reads, k=2, generator_name="optimum", edit=True,
            mode="all", engine="auto", chunk=CHUNK)),
        "short36_e2": (len(short36), lambda: search_queries(
            index, short36_both, k=2, generator_name="optimum", edit=True,
            mode="all", engine="auto", chunk=CHUNK)),
        # short reads past exact-pigeonhole range: scheme-seeded SV (e1)
        "short36_e3_sv1": (len(short36), lambda: search_queries(
            index, short36_both, k=3, generator_name="optimum", edit=True,
            mode="all", engine="auto", chunk=CHUNK)),
        "short36_e3_workq": (len(short36), lambda: search_queries(
            index, short36_both, k=3, generator_name="optimum", edit=True,
            mode="all", engine="workq", chunk=CHUNK)),
    }

    # warm: two passes each (compile + capmem tuning, then profiled plan)
    for name, (_, fn) in variants.items():
        t0 = time.monotonic()
        fn()
        t1 = time.monotonic()
        fn()
        print(f"warm {name}: {t1 - t0:.1f}s + {time.monotonic() - t1:.1f}s", file=sys.stderr)

    times: dict[str, list[float]] = {k: [] for k in variants}
    for r in range(args.rounds):
        for name, (_, fn) in variants.items():
            t0 = time.monotonic()
            fn()
            dt = time.monotonic() - t0
            times[name].append(dt)
            print(f"round {r} {name}: {dt:.2f}s", file=sys.stderr)

    rows = {}
    for name, (n, _) in variants.items():
        best = min(times[name])
        med = float(np.median(times[name]))
        qps = n / best
        rows[name] = {
            "reads_per_second": round(qps, 1),
            # medians alongside best-of-N: best is the optimistic
            # envelope, median the center
            "reads_per_second_median": round(n / med, 1),
            "best_s": round(best, 3),
            "median_s": round(med, 3),
            "raw_s": [round(t, 3) for t in times[name]],
        }
    out = {
        "protocol": f"interleaved best-of-{args.rounds} with medians, one process window",
        "chunk": CHUNK,
        "ref_mb": bench.REF_MB,
        "rows": rows,
    }
    print(json.dumps(out, indent=1))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
