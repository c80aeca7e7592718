"""Phase attribution for the seed-and-verify headline path at bench shapes.

Measures, in one process window with the bench cache index/queries:
  - end-to-end steady pass (search_queries, auto engine)
  - seed_parts device call alone (per chunk, steady)
  - host expand_seeds alone
  - sv_verify device call alone (steady)
  - lf_walk alone at the verify candidate count
  - the banded DP via sv_verify minus lf_walk (derived)

    python tools/profile_sv.py
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sahara_jax import CACHE_DIR  # noqa: E402

import jax
import jax.numpy as jnp
import numpy as np

import bench


def best_of(fn, n=4):
    fn()  # warm
    best = float("inf")
    for _ in range(n):
        t0 = time.monotonic()
        fn()
        best = min(best, time.monotonic() - t0)
    return best


def main() -> None:
    from sahara_jax.alphabet import D_DNA5
    from sahara_jax.engine.device import DeviceIndex
    from sahara_jax.engine.driver import search_queries
    from sahara_jax.engine.locate import lf_walk_packed
    from sahara_jax.engine.seedverify import (
        collect_sv,
        collect_sv_expand,
        dispatch_sv,
        dispatch_sv_verify,
        expand_seeds,
        plan_parts,
        seed_parts,
    )
    from sahara_jax.index.fmindex import load_index

    ref, reads = bench.load_workload()
    host = load_index(os.path.join(CACHE_DIR, f"bench_index{bench.REF_MB}_v2.idx"))
    index = DeviceIndex.from_host(host)
    both = [s for q in reads for s in (q, D_DNA5.reverse_complement_rank(q).astype(np.uint8))]
    n_reads = len(reads)
    CHUNK = bench.CHUNK
    k, m = bench.ERRORS, bench.READ_LEN

    kw = dict(k=k, generator_name="optimum", edit=True, mode="all", engine="auto", chunk=CHUNK)
    t_e2e = best_of(lambda: search_queries(index, both, **kw))
    print(f"e2e steady: {t_e2e:.3f}s = {n_reads / t_e2e:,.0f} reads/s")

    qarr = np.stack(both[:CHUNK]).astype(np.int32)
    qdev = jnp.asarray(qarr)
    parts = plan_parts(m, k)
    print(f"parts: {parts}  lut_j={index.lut_j}")

    # seed phase alone
    def seed_once():
        jax.block_until_ready(seed_parts(index, qdev, parts))

    t_seed = best_of(seed_once)
    n_chunks = -(-len(both) // CHUNK)
    print(f"seed_parts/chunk: {t_seed * 1e3:.1f}ms  x{n_chunks} chunks = {t_seed * n_chunks:.3f}s")

    # expand on host
    packed = np.asarray(seed_parts(index, qdev, parts))
    t_exp = best_of(lambda: expand_seeds(packed, CHUNK, parts, None))
    rows, q_of, off_of, fb = expand_seeds(packed, CHUNK, parts, None)
    print(f"expand/chunk: {t_exp * 1e3:.1f}ms  candidates={len(rows)} fallback={int(fb.sum())}")

    # verify alone (dispatch_sv_verify + collect)
    st = dispatch_sv(index, qarr, k, edit=True)
    collect_sv_expand(st)

    def verify_once():
        dispatch_sv_verify(st)
        collect_sv(st)

    t_ver = best_of(verify_once)
    print(f"verify/chunk: {t_ver * 1e3:.1f}ms  x{n_chunks} = {t_ver * n_chunks:.3f}s")

    # lf_walk alone at candidate count
    capR = -(-len(rows) // 512) * 512
    rr = np.zeros(capR, dtype=np.int32)
    rr[: len(rows)] = rows
    vv = np.zeros(capR, dtype=bool)
    vv[: len(rows)] = True
    rj, vj = jnp.asarray(rr), jnp.asarray(vv)

    def lf_once():
        jax.block_until_ready(lf_walk_packed(index, rj, vj))

    t_lf = best_of(lf_once)
    print(f"lf_walk/chunk ({capR} rows): {t_lf * 1e3:.1f}ms")
    print(
        f"accounted: seed {t_seed * n_chunks:.3f}s + verify {t_ver * n_chunks:.3f}s "
        f"(lf {t_lf * n_chunks:.3f}s inside) vs e2e {t_e2e:.3f}s"
    )


if __name__ == "__main__":
    main()
