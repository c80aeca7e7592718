"""Interleaved A/B of the SV part count on the headline workload.

k+1 parts (default) vs k+2/k+3 (SAHARA_SV_PARTS_EXTRA): fewer post-table
seed steps vs more expansion/verify candidates.  Same protocol as
tools/ab_workq.py: warm each config, alternate steady passes, report
best-of-N with identical-hit assertion.

    python tools/ab_sv_parts.py 0 1 [2]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sahara_jax import CACHE_DIR  # noqa: E402

import numpy as np

import bench


def main() -> None:
    extras = [int(x) for x in (sys.argv[1:] or ["0", "1"])]
    reps = int(os.environ.get("AB_REPS", "4"))

    from sahara_jax.alphabet import D_DNA5
    from sahara_jax.engine.device import DeviceIndex
    from sahara_jax.engine.driver import search_queries
    from sahara_jax.index.fmindex import load_index

    ref, reads = bench.load_workload()
    n_reads = len(reads)
    queries = [
        s for q in reads for s in (q, D_DNA5.reverse_complement_rank(q).astype(np.uint8))
    ]
    host = load_index(os.path.join(
        CACHE_DIR, f"bench_index{bench.REF_MB}_v2.idx"))
    index = DeviceIndex.from_host(host)
    kw = dict(k=bench.ERRORS, generator_name=bench.GENERATOR, edit=True, mode="all",
              engine="sv", chunk=bench.CHUNK)

    hits = {}
    for e in extras:
        os.environ["SAHARA_SV_PARTS_EXTRA"] = str(e)
        search_queries(index, queries, **kw)
        r = search_queries(index, queries, **kw)
        hits[e] = len(r.query_id)
    assert len(set(hits.values())) == 1, f"hit counts diverge: {hits}"

    times = {e: [] for e in extras}
    for rep in range(reps):
        for e in extras:
            os.environ["SAHARA_SV_PARTS_EXTRA"] = str(e)
            t0 = time.monotonic()
            search_queries(index, queries, **kw)
            dt = time.monotonic() - t0
            times[e].append(dt)
            print(f"rep{rep} extra={e}: {dt:.2f}s", file=sys.stderr)
    for e in extras:
        best = min(times[e])
        print(f"extra={e}: best={best:.2f}s reads/s={n_reads / best:.0f} "
              f"all={['%.2f' % t for t in times[e]]} hits={hits[e]}")


if __name__ == "__main__":
    main()
