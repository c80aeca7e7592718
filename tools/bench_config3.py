"""config[3] benchmark: e=3, 150bp reads vs a multi-GB interval-sharded index.

The "full human genome" class: builds a 2.5GB
synthetic repeat-structured reference into the v2 sharded container
(threaded build), searches 150bp reads carrying exactly 3 planted errors
(both strands, like the production CLI default), and prints one JSON line
with build + search throughput.  On one chip the shards are searched
sequentially, swapping occ tables through HBM
(engine/driver.py::search_queries_sharded); on a real multi-chip host the
interval mesh path (parallel/interval.py) serves the same container.

Run from /root/repo:  python tools/bench_config3.py
Small-scale smoke:    SAHARA_C3_GB=0.05 SAHARA_C3_READS=2000 python tools/bench_config3.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REF_GB = float(os.environ.get("SAHARA_C3_GB", 2.5))
N_READS = int(os.environ.get("SAHARA_C3_READS", 1_000_000))
READ_LEN = 150
ERRORS = 3
N_SEQS = 4  # equal-size sequences -> equal-shape shards -> one compile set
SHARD_MB = float(os.environ.get("SAHARA_C3_SHARD_MB", REF_GB * 1000 / 2 + 1))
CHUNK = int(os.environ.get("SAHARA_C3_CHUNK", 16384))
from sahara_jax import CACHE_DIR  # noqa: E402


def make_ref_seqs(rng: np.random.Generator) -> list[np.ndarray]:
    """N_SEQS equal chromosomes with segmental duplications (bench.py's
    repeat model at chromosome scale)."""
    per = int(REF_GB * 1e9 / N_SEQS)
    seqs = []
    for _ in range(N_SEQS):
        s = rng.integers(1, 5, size=per).astype(np.uint8)
        covered, target = 0, int(per * 0.35)
        while covered < target:
            seg = int(rng.integers(300, 5001))
            src = int(rng.integers(0, per - seg))
            dst = int(rng.integers(0, per - seg))
            chunk = s[src : src + seg].copy()
            nmut = int(rng.binomial(seg, 0.015))
            if nmut:
                at = rng.choice(seg, size=nmut, replace=False)
                chunk[at] = 1 + (chunk[at] - 1 + rng.integers(1, 4, size=nmut)) % 4
            s[dst : dst + seg] = chunk
            covered += seg
        seqs.append(s)
    return seqs


def make_reads(seqs: list[np.ndarray], rng: np.random.Generator) -> np.ndarray:
    """150bp reads with exactly ERRORS planted S/I/D edits, uint8[N, 150]."""
    out = np.empty((N_READS, READ_LEN), dtype=np.uint8)
    sid = rng.integers(0, len(seqs), size=N_READS)
    for i in range(N_READS):
        s = seqs[sid[i]]
        p = int(rng.integers(0, len(s) - READ_LEN - ERRORS - 1))
        q = s[p : p + READ_LEN + ERRORS].copy()  # slack for deletions
        for _ in range(ERRORS):
            kind = int(rng.integers(0, 3))
            at = int(rng.integers(0, READ_LEN))
            if kind == 0:  # substitution
                q[at] = 1 + (q[at] - 1 + int(rng.integers(1, 4))) % 4
            elif kind == 1:  # deletion from the read
                q = np.delete(q, at)
            else:  # insertion into the read
                q = np.insert(q, at, int(rng.integers(1, 5)))
        out[i] = q[:READ_LEN]
    return out


def main() -> None:
    from sahara_jax.alphabet import D_DNA5
    from sahara_jax.engine.driver import search_queries_sharded
    from sahara_jax.index.shard import build_sharded_bifmindex, load_any_index, save_sharded

    os.makedirs(CACHE_DIR, exist_ok=True)
    tag = f"c3_{REF_GB}gb"
    ref_path = os.path.join(CACHE_DIR, f"{tag}_ref.npz")
    idx_path = os.path.join(CACHE_DIR, f"{tag}.idx")
    reads_path = os.path.join(CACHE_DIR, f"{tag}_reads_{N_READS}.npy")

    rng = np.random.default_rng(777)
    t0 = time.monotonic()
    if os.path.exists(ref_path):
        with np.load(ref_path) as z:
            seqs = [z[f"s{i}"] for i in range(N_SEQS)]
    else:
        seqs = make_ref_seqs(rng)
        np.savez(ref_path, **{f"s{i}": s for i, s in enumerate(seqs)})
    t_gen_ref = time.monotonic() - t0

    t0 = time.monotonic()
    t_build = 0.0
    if os.path.exists(idx_path):
        sharded = load_any_index(idx_path)
        t_load = time.monotonic() - t0
    else:
        sharded = build_sharded_bifmindex(
            seqs, 6, "d_dna5", rate=16,
            max_chars=int(SHARD_MB * 1_000_000), threads=os.cpu_count() or 1,
        )
        t_build = time.monotonic() - t0
        t0 = time.monotonic()
        save_sharded(idx_path, sharded)
        t_load = time.monotonic() - t0  # = save time on the build run

    t0 = time.monotonic()
    if os.path.exists(reads_path):
        reads = np.load(reads_path)
    else:
        reads = make_reads(seqs, rng)
        np.save(reads_path, reads)
    # both strands, interleaved like the CLI (search.cpp:121-122)
    queries: list[np.ndarray] = []
    for q in reads:
        queries.append(q)
        queries.append(D_DNA5.reverse_complement_rank(q).astype(np.uint8))
    t_gen_reads = time.monotonic() - t0

    kw = dict(k=ERRORS, generator_name="optimum", edit=True, chunk=CHUNK)
    # warm with MORE than one chunk so the compiled shapes match the full
    # pass ([CHUNK, m] padded chunks only exist when nq > CHUNK — an
    # undersized warm batch compiles the wrong shapes and the timed pass
    # then pays the real compiles)
    n_warm = min(len(queries), 2 * CHUNK + 1)
    t0 = time.monotonic()
    search_queries_sharded(sharded, queries[:n_warm], **kw)  # compile + tune
    t_warm = time.monotonic() - t0
    t0 = time.monotonic()
    res = search_queries_sharded(sharded, queries, **kw)
    dt = time.monotonic() - t0
    rps = N_READS / dt

    n_chars = sum(len(s) for s in seqs)
    result = {
        "metric": "config3_reads_per_second_e3_150bp_bothstrands",
        "value": round(rps, 1),
        "unit": "reads/s/chip",
        "ref_gb": round(n_chars / 1e9, 3),
        "shards": sharded.num_shards if hasattr(sharded, "num_shards") else 1,
        "reads": N_READS,
        "build_s": round(t_build, 1),
        "search_s": round(dt, 1),
    }
    print(json.dumps(result))
    print(
        f"# gen_ref={t_gen_ref:.0f}s build={t_build:.0f}s save/load={t_load:.0f}s "
        f"gen_reads={t_gen_reads:.0f}s warm={t_warm:.0f}s steady={dt:.1f}s "
        f"hits={len(res.query_id)}",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
