"""configs[4] scale on available hardware: 10M reads end-to-end through the
real CLI on one chip (the multi-host deployment's read volume on one host).

Exercises the host path nothing else tests at scale: FASTA parse of 10M+
records, vectorized rank/revcomp expansion to 20M strand queries, ~1,200
pipelined device chunks, the canonical merge lexsort at 10^7 rows, and the
vectorized hit write.  Phases are timed separately; a sampled recovery
check asserts planted reads are found.

    python tools/bench_config4.py [--reads 10000000] [--out config4.json]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import bench

from sahara_jax import CACHE_DIR as CACHE  # noqa: E402
_RANK_TO_CHAR = np.frombuffer(b"\x00ACGTN", dtype=np.uint8)


def prepare(n_reads: int) -> tuple[str, str]:
    """Reference FASTA + index + read FASTA, all cached on disk."""
    from sahara_jax.cli.main import main
    from sahara_jax.io.fasta import FastaRecord, write_fasta
    from sahara_jax.sim.read_simulator import simulate_reads

    os.makedirs(CACHE, exist_ok=True)
    ref_fa = os.path.join(CACHE, "config4_ref40.fasta")
    reads_fa = os.path.join(CACHE, f"config4_reads_{n_reads}.fasta")
    if not os.path.exists(ref_fa):
        rng = np.random.default_rng(1234)  # same ref as bench.py
        ref = bench.make_reference(rng, int(bench.REF_MB * 1_000_000))
        write_fasta(ref_fa, [FastaRecord("chr21like", _RANK_TO_CHAR[ref].tobytes())],
                    line_length=0)
    if not os.path.exists(ref_fa + ".idx"):
        t0 = time.monotonic()
        assert main(["index", ref_fa, "--threads", "4"]) == 0
        print(f"# index build: {time.monotonic() - t0:.0f}s", file=sys.stderr)
    if not os.path.exists(reads_fa):
        t0 = time.monotonic()
        ref_bytes = open(ref_fa, "rb").read().split(b"\n", 1)[1].replace(b"\n", b"")
        recs = simulate_reads([ref_bytes], num_reads=n_reads, read_length=100,
                              random_errors=2, seed=99)
        write_fasta(reads_fa, recs, line_length=0)
        print(f"# read gen: {time.monotonic() - t0:.0f}s", file=sys.stderr)
    return ref_fa, reads_fa


def sample_recovery(reads_fa: str, out_path: str, n_sample: int = 200) -> float:
    """Fraction of sampled planted reads whose (seqid,pos) is in the output
    (strand queryId = 2 * read index; positions may be off by <= 2 for
    edit-distance spans, so accept |delta| <= 2)."""
    from sahara_jax.io.fasta import read_fasta

    truth = {}
    pat = re.compile(r"seqid:(\d+), pos:(\d+)")
    for i, rec in enumerate(read_fasta(reads_fa)):
        if i % 50021 == 7:  # spread samples
            m = pat.search(rec.id)
            truth[2 * i] = (int(m.group(1)), int(m.group(2)))
            if len(truth) >= n_sample:
                break
    hits: dict[int, list[tuple[int, int]]] = {qid: [] for qid in truth}
    with open(out_path) as fh:
        for line in fh:
            q, s, p = line.split()
            qi = int(q)
            if qi in hits:
                hits[qi].append((int(s), int(p)))
    ok = 0
    for qid, (sid, pos) in truth.items():
        ok += any(s == sid and abs(p - pos) <= 2 for s, p in hits[qid])
    return ok / max(len(truth), 1)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=10_000_000)
    ap.add_argument("--warm-reads", type=int, default=65536)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from sahara_jax.cli.main import main as cli

    ref_fa, reads_fa = prepare(args.reads)
    warm_fa = os.path.join(CACHE, f"config4_reads_{args.warm_reads}.fasta")
    if not os.path.exists(warm_fa):
        # a prefix slice of the big file (same record shapes)
        with open(reads_fa, "rb") as src, open(warm_fa, "wb") as dst:
            for i, line in enumerate(src):
                if i >= 2 * args.warm_reads:
                    break
                dst.write(line)

    out_warm = os.path.join(CACHE, "config4_warm_out.txt")
    t0 = time.monotonic()
    assert cli(["search", "-q", warm_fa, "-i", ref_fa + ".idx", "-o", out_warm,
                "-e", "2", "-g", "optimum"]) == 0
    t_warm = time.monotonic() - t0
    print(f"# warm pass ({args.warm_reads} reads): {t_warm:.0f}s", file=sys.stderr)

    out_path = os.path.join(CACHE, "config4_out.txt")
    t0 = time.monotonic()
    assert cli(["search", "-q", reads_fa, "-i", ref_fa + ".idx", "-o", out_path,
                "-e", "2", "-g", "optimum"]) == 0
    t_total = time.monotonic() - t0

    n_hits = sum(1 for _ in open(out_path))
    rec = sample_recovery(reads_fa, out_path)
    result = {
        "config": "10M reads, e=2, 100bp, 40MB ref, one chip",
        "n_reads": args.reads,
        "wall_s": round(t_total, 1),
        "reads_per_second_sustained": round(args.reads / t_total, 1),
        "vs_per_chip_northstar": round(args.reads / t_total / (10_000_000 / 60 / 8), 4),
        "n_hits": n_hits,
        "sampled_recovery": rec,
        "warm_pass_s": round(t_warm, 1),
    }
    print(json.dumps(result, indent=1))
    if args.out:
        json.dump(result, open(args.out, "w"), indent=1)


if __name__ == "__main__":
    main()
