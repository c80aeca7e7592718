"""Interleaved A/B of workq gather modes at bench scale (forced workq).

Times differ between process windows more than between the modes, so the
only fair comparison is interleaved inside ONE process: warm both modes,
then alternate steady passes and report the best per mode.

    python tools/ab_workq.py [fold packed ...]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sahara_jax import CACHE_DIR  # noqa: E402

os.environ.setdefault("SAHARA_BENCH_ENGINE", "workq")

import bench  # noqa: E402  (repo-root bench harness: workload gen + cache)


def main() -> None:
    modes = sys.argv[1:] or ["fold", "packed"]
    reps = int(os.environ.get("AB_REPS", "4"))

    from sahara_jax.engine.device import DeviceIndex
    from sahara_jax.engine.driver import search_queries
    from sahara_jax.index.build import build_bifmindex  # noqa: F401

    ref, queries = bench.load_workload()
    n_reads = len(queries)
    from sahara_jax.alphabet import D_DNA5

    queries = [
        s for q in queries for s in (q, D_DNA5.reverse_complement_rank(q).astype("uint8"))
    ]
    idx_cache = os.path.join(
        CACHE_DIR, f"bench_index{bench.REF_MB}_v2.idx"
    )
    from sahara_jax.index.fmindex import load_index

    host = load_index(idx_cache)
    index = DeviceIndex.from_host(host)
    kw = dict(k=bench.ERRORS, generator_name=bench.GENERATOR, edit=True, mode="all",
              engine="workq", chunk=bench.CHUNK)

    def set_mode(mode):
        # mode syntax: "<gather>[:ddN]" — ddN sets the dedup cadence
        gather, _, dd = mode.partition(":")
        os.environ["SAHARA_WORKQ_GATHER"] = gather
        if dd.startswith("dd"):
            os.environ["SAHARA_DEDUP_EVERY"] = dd[2:]
        else:
            os.environ.pop("SAHARA_DEDUP_EVERY", None)

    hits = {}
    for mode in modes:  # warm both (compile + capmem tuning)
        set_mode(mode)
        r = search_queries(index, queries, **kw)
        r = search_queries(index, queries, **kw)
        hits[mode] = len(r.query_id)
    assert len(set(hits.values())) == 1, f"hit counts diverge across modes: {hits}"

    best = {m: float("inf") for m in modes}
    times = {m: [] for m in modes}
    for rep in range(reps):
        for mode in modes:
            set_mode(mode)
            t0 = time.monotonic()
            search_queries(index, queries, **kw)
            dt = time.monotonic() - t0
            times[mode].append(dt)
            best[mode] = min(best[mode], dt)
            print(f"rep{rep} {mode}: {dt:.2f}s", file=sys.stderr)
    for mode in modes:
        print(f"{mode}: best={best[mode]:.2f}s reads/s={n_reads / best[mode]:.0f} "
              f"all={['%.2f' % t for t in times[mode]]} hits={hits[mode]}")


if __name__ == "__main__":
    main()
