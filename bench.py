"""Benchmark: reads/sec at e=2, 100bp reads, on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "device"}, after a line
with the card's name and power limit.  Refuses to run without a GPU.

Workload (chr21-class): a 40MB reference with
human-like repeat structure (segmental duplications at 1.5% divergence
covering ~35% of the text) and reads carrying exactly ``e`` planted errors
drawn uniformly from {substitution, insertion, deletion} via the
read-simulator transcript machinery (the reference's own fixture semantics,
read_simulator.cpp:119-241) — not substitution-only reads.

Measures the full production path (scheme search + locate) in steady state:
pass 1 warms compile caches and the engine's capacity auto-tuning, pass 2
compiles the live-profile-derived segmented capacity plan, then the best of
four passes is reported.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REF_MB = float(os.environ.get("SAHARA_BENCH_REF_MB", 40))
# 64k reads = 8 pipelined chunks of strand queries: enough for the
# dispatch/collect overlap to reach steady state (with 2 chunks the pipeline
# cannot hide the last chunk's host work)
N_QUERIES = int(os.environ.get("SAHARA_BENCH_QUERIES", 65536))
READ_LEN = int(os.environ.get("SAHARA_BENCH_READ_LEN", 100))
ERRORS = int(os.environ.get("SAHARA_BENCH_ERRORS", 2))
# variant knobs (defaults = the headline metric; the driver runs defaults):
# SAHARA_BENCH_DIST=ham measures Hamming, SAHARA_BENCH_MODE=besthits the
# best-hits strata, SAHARA_BENCH_ENGINE=workq forces the scheme engine
DIST = os.environ.get("SAHARA_BENCH_DIST", "lev")
MODE = os.environ.get("SAHARA_BENCH_MODE", "all")
ENGINE = os.environ.get("SAHARA_BENCH_ENGINE", "auto")
# SAHARA_BENCH_RBI=1 measures the strand-reduced pipeline (rbi family):
# dr_dna5 reduction + mirror-closed single-table index, each read searched
# ONCE (no revcomp expansion — reverse == revcomp under dr).  Hit contract
# is the reference's own rbi semantics (dr-space matches), so this row is
# not comparable to the dna5 rows hit-for-hit — it shows the pipeline the
# reference provides for exactly this purpose.
RBI = os.environ.get("SAHARA_BENCH_RBI", "") == "1"
# `optimum` (solver-derived) does ~33% fewer live row-steps than the
# reference's default h2-k2 at e=2/100bp and has a longer exact phase;
# the hit SET is generator-independent (schemes are complete), so the
# bench uses the cheapest generator, like any production deployment would
GENERATOR = os.environ.get("SAHARA_BENCH_GENERATOR", "optimum")
# 16384-query chunks: the driver's default, tuned on another chip
CHUNK = int(os.environ.get("SAHARA_BENCH_CHUNK", 16384))
CACHE = os.environ.get("SAHARA_BENCH_CACHE", "1") == "1"
PROFILE = os.environ.get("SAHARA_BENCH_PROFILE", "") == "1"
# the reference expands every read to fwd + reverse-complement before search
# (search.cpp:121-122, on by default); its own q/s stat counts the EXPANDED
# queries (search.cpp:272).  Users count reads, so the bench searches both
# strands per read and divides by reads, not strand queries.  SAHARA_BENCH_REVCOMP=0 recovers the single-strand number.
REVCOMP = os.environ.get("SAHARA_BENCH_REVCOMP", "1") == "1"

_RANK_TO_CHAR = np.frombuffer(b"\x00ACGTN", dtype=np.uint8)


def make_reference(rng: np.random.Generator, n: int, repeat_frac: float = 0.35, divergence: float = 0.015) -> np.ndarray:
    """Random DNA overlaid with mutated segmental duplications: a cheap
    stand-in for chr21's repeat structure (random text understates the
    live-state load of a real genome)."""
    ref = rng.integers(1, 5, size=n).astype(np.uint8)
    covered, target = 0, int(n * repeat_frac)
    while covered < target:
        seg = int(rng.integers(300, 5001))
        src = int(rng.integers(0, n - seg))
        dst = int(rng.integers(0, n - seg))
        chunk = ref[src : src + seg].copy()
        nmut = int(rng.binomial(seg, divergence))
        if nmut:
            at = rng.choice(seg, size=nmut, replace=False)
            chunk[at] = 1 + (chunk[at] - 1 + rng.integers(1, 4, size=nmut)) % 4
        ref[dst : dst + seg] = chunk
        covered += seg
    return ref


def make_queries(ref: np.ndarray, n_queries: int, seed: int) -> list[np.ndarray]:
    """Reads with exactly ERRORS planted errors, uniformly S/I/D, via the
    read-simulator transcripts (read length stays READ_LEN)."""
    from sahara_jax.alphabet import D_DNA5
    from sahara_jax.sim.read_simulator import simulate_reads

    ref_bytes = _RANK_TO_CHAR[ref].tobytes()
    records = simulate_reads(
        [ref_bytes],
        num_reads=n_queries,
        read_length=READ_LEN,
        random_errors=ERRORS,
        seed=seed,
    )
    return [D_DNA5.char_to_rank(r.seq).astype(np.uint8) for r in records]


def load_workload():
    suffix = "" if READ_LEN == 100 and ERRORS == 2 else f"_l{READ_LEN}e{ERRORS}"
    from sahara_jax import CACHE_DIR

    cache_path = os.path.join(CACHE_DIR, f"bench_ref{REF_MB}_q{N_QUERIES}{suffix}_v2.npz")
    if CACHE and os.path.exists(cache_path):
        z = np.load(cache_path)
        return z["ref"], list(z["queries"])
    rng = np.random.default_rng(1234)
    n_ref = int(REF_MB * 1_000_000)
    ref = make_reference(rng, n_ref)
    queries = make_queries(ref, N_QUERIES, seed=99)
    if CACHE:
        os.makedirs(os.path.dirname(cache_path), exist_ok=True)
        np.savez_compressed(cache_path, ref=ref, queries=np.stack(queries))
    return ref, queries


def main() -> None:
    from sahara_jax import CACHE_DIR
    from sahara_jax.engine.device import DeviceIndex
    from sahara_jax.engine.driver import search_queries
    from sahara_jax.index.build import build_bifmindex
    from sahara_jax.utils.gpu import card_line, device_record, require_gpu

    require_gpu()
    t0 = time.monotonic()
    ref, queries = load_workload()
    n_reads = len(queries)
    if RBI:
        # strand-reduced pipeline: dr ranks, each read searched ONCE
        _DR = np.array([0, 1, 2, 2, 1, 3], dtype=np.uint8)  # $,A,C,G,T,N
        ref = _DR[ref]
        queries = [_DR[q] for q in queries]
    elif REVCOMP:
        from sahara_jax.alphabet import D_DNA5

        # interleave fwd/rc like the CLI (load_queries_ranked, search.cpp:121)
        queries = [
            s
            for q in queries
            for s in (q, D_DNA5.reverse_complement_rank(q).astype(np.uint8))
        ]
    t_gen = time.monotonic() - t0

    t0 = time.monotonic()
    tag = "rbi_" if RBI else ""
    idx_cache = os.path.join(CACHE_DIR, f"bench_index{tag}{REF_MB}_v2.idx")
    host = None
    if CACHE and os.path.exists(idx_cache):
        from sahara_jax.index.fmindex import load_index

        try:
            host = load_index(idx_cache)
        except ValueError:
            host = None  # stale format: rebuild
    if host is None:
        if RBI:
            # mirror closure + single shared table (rbi-index.cpp:76 analogue)
            host = build_bifmindex(
                [ref, ref[::-1].copy()], 4, "dr_dna5", rate=16, threads=4, mirrored=True
            )
        else:
            host = build_bifmindex([ref], 6, "d_dna5", rate=16)
        if CACHE:
            from sahara_jax.index.fmindex import save_index

            save_index(idx_cache, host)
    index = DeviceIndex.from_host(host)
    t_build = time.monotonic() - t0

    kw = dict(
        k=ERRORS, generator_name=GENERATOR, edit=DIST == "lev", mode=MODE,
        engine=ENGINE, chunk=CHUNK,
    )

    t0 = time.monotonic()
    r = search_queries(index, queries, **kw)  # compile + cap tuning
    t_warm = time.monotonic() - t0
    t0 = time.monotonic()
    r = search_queries(index, queries, **kw)  # compiles the profiled plan
    t_tune = time.monotonic() - t0

    if PROFILE:
        import jax

        jax.profiler.start_trace(os.path.join(CACHE_DIR, "trace"))
    dt = float("inf")
    for _ in range(1 if PROFILE else 4):
        t0 = time.monotonic()
        r = search_queries(index, queries, **kw)
        dt = min(dt, time.monotonic() - t0)
    if PROFILE:
        import jax

        jax.profiler.stop_trace()
    qps = n_reads / dt

    variant = ""
    if RBI:
        variant += "_rbi"
    if DIST != "lev":
        variant += f"_{DIST}"
    if MODE != "all":
        variant += f"_{MODE}"
    if ENGINE != "auto":
        variant += f"_{ENGINE}"
    if RBI:
        # single search covers both orientations (mirror closure)
        base = f"reads_per_second_e{ERRORS}_{READ_LEN}bp"
    elif REVCOMP:
        base = f"reads_per_second_e{ERRORS}_{READ_LEN}bp_bothstrands"
    else:
        base = f"queries_per_second_e{ERRORS}_{READ_LEN}bp"
    result = {
        "metric": base + variant,
        "value": round(qps, 1),
        "unit": "reads/s/chip" if REVCOMP else "q/s/chip",
        "device": device_record(),
    }
    print(card_line())
    print(json.dumps(result))
    print(
        f"# ref={REF_MB}MB strandq={len(queries)} gen={t_gen:.1f}s build={t_build:.1f}s "
        f"warm={t_warm:.1f}s tune={t_tune:.1f}s steady={dt:.2f}s "
        f"strand_qps={len(queries) / dt:.0f} hits={len(r.query_id)}",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
