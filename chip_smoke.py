"""Bring-up check of the main path on an NVIDIA GPU.

    python chip_smoke.py            # phases 1-3, one card
    python chip_smoke.py --multi    # phases 1 and 4, four cards

1. Device: JAX's device kind and count, the card's name and power limit.
2. Backend equality: deterministic mini-workloads (workq in every gather
   mode, Hamming and edit, dedup on and off, one case whose compaction
   payloads exceed 2^11, seed-and-verify at k=1 and 2, the mirrored rbi
   index) compared bit for bit with a child process on the CPU backend.
3. Main path at full width: a 40 MB chr21-class reference and 65,536
   100 bp reads with 2 planted errors each, indexed and searched twice
   through the CLI (``index``, then ``search -e 2 -d lev``, both strands).
   Every read's true position must be among its hits, and the hits of the
   first 1,024 reads must equal a CPU child's search of the same index.
   Also reports the XLA rank-gather rate on the index's occ table.
4. ``--multi``: on the phase-3 workload, ``search --devices 4`` must give
   the hit set of ``--devices 1``, and an interval-sharded index searched
   over the four-card mesh (parallel/interval.py) must give the hits of the
   single-card search.

Exits non-zero, with no result line, when JAX finds no GPU or a phase
fails.  On success the last line is one JSON object naming the device.
This process is the only one on the card(s): it only ever starts child
processes on the CPU backend.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_CHILD_TIMEOUT = 900  # seconds for any CPU child process

# phase-3 workload (the headline deployment, chr21-class)
REF_MB = 40.0
N_READS = 65536
READ_LEN = 100
ERRORS = 2
SUBSET = 1024
# phase 4: shard size that splits the 40 MB text into four windows, and the
# reads searched through the interval mesh
SHARD_MB = 11.0
N_IV_READS = 4096


# ---------------------------------------------------------------- helpers


def _cpu_env() -> dict:
    """Environment of a child that never opens a card."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    env["SAHARA_CAPMEM_PATH"] = os.path.join(
        tempfile.gettempdir(), f"sahara_capmem_cpu_child_{os.getpid()}.json"
    )
    return env


def _cli(args: list[str], log_path: str) -> float:
    """Run one CLI command in this process; its output goes to ``log_path``.
    Returns the wall time in seconds."""
    from sahara_jax.cli.main import main as cli_main

    t0 = time.monotonic()
    with open(log_path, "a") as log, contextlib.redirect_stdout(log):
        rc = cli_main(args)
    if rc != 0:
        raise RuntimeError(f"sahara {' '.join(args)} exited {rc} (log: {log_path})")
    return time.monotonic() - t0


def _cpu_cli(args: list[str], log_path: str) -> subprocess.Popen:
    """Start one CLI command in a CPU-only child process."""
    with open(log_path, "a") as log:  # the child keeps its own descriptor
        return subprocess.Popen(
            [sys.executable, "-m", "sahara_jax", *args],
            env=_cpu_env(), cwd=_HERE, stdout=log, stderr=subprocess.STDOUT,
        )


def _wait(proc: subprocess.Popen, what: str) -> None:
    try:
        rc = proc.wait(timeout=_CHILD_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0:
        raise RuntimeError(f"CPU child for {what} exited {rc}")


def _hit_lines(path: str, max_qid: int | None = None) -> list[str]:
    with open(path) as fh:
        lines = fh.read().splitlines()
    if max_qid is not None:
        lines = [ln for ln in lines if int(ln.split(" ", 1)[0]) < max_qid]
    return lines


def make_workload(work: str, ref_mb: float, n_reads: int) -> tuple[str, str, list]:
    """The reference (``bench.make_reference``, seed 1234) and reads
    (``sim.read_simulator``, exactly ERRORS planted edits each) as FASTA.
    Returns (reference path, reads path, read records)."""
    from bench import make_reference
    from sahara_jax.io.fasta import FastaRecord, write_fasta
    from sahara_jax.sim.read_simulator import simulate_reads

    rng = np.random.default_rng(1234)
    ref = make_reference(rng, int(ref_mb * 1_000_000))
    ref_bytes = np.frombuffer(b"\x00ACGTN", dtype=np.uint8)[ref].tobytes()
    ref_path = os.path.join(work, "ref.fa")
    write_fasta(ref_path, [FastaRecord(id="chr21_like", seq=ref_bytes)])
    reads = simulate_reads(
        [ref_bytes], num_reads=n_reads, read_length=READ_LEN, random_errors=ERRORS, seed=99
    )
    reads_path = os.path.join(work, "reads.fa")
    write_fasta(reads_path, reads, line_length=0)
    return ref_path, reads_path, reads


def expected_hit(record) -> tuple[int, int]:
    """(seqId, pos) a read must be found at: its simulated start, moved past
    leading deletions (a hit's span starts with a text character consumed
    by a match or substitution; a leading query insertion is allowed)."""
    meta = record.id[record.id.index("(") + 1 : record.id.rindex(")")]
    fields = dict(f.split(":", 1) for f in meta.replace(" ", "").split(","))
    pos = int(fields["pos"])
    for op in fields["trans"]:
        if op in "MS":
            break
        pos += op == "D"
    return int(fields["seqid"]), pos


def rank_gather_rate(index, n_rows: int = 1 << 24, reps: int = 5) -> tuple[float, float]:
    """XLA rank-all over random text positions of the index's forward occ
    table: (rows/s, GB/s of occ rows gathered), median of ``reps``."""
    import jax

    from sahara_jax.engine.rank import rank_all

    occ, sigma, fold = index.occ, index.sigma, index.fold
    pos = jax.random.randint(jax.random.PRNGKey(0), (n_rows,), 0, index.n, dtype=np.int32)
    fn = jax.jit(lambda p: rank_all(occ, sigma, p, fold).sum())
    fn(pos).block_until_ready()
    times = []
    for _ in range(reps):
        t0 = time.monotonic()
        fn(pos).block_until_ready()
        times.append(time.monotonic() - t0)
    dt = float(np.median(times))
    row_bytes = occ.shape[1] * occ.dtype.itemsize
    return n_rows / dt, n_rows * row_bytes / dt / 1e9


# ------------------------------------------------------- phase 2: backend


def run_cases() -> list[dict]:
    """Deterministic mini-workloads; each case's hit rows, sorted."""
    from sahara_jax.engine.device import DeviceIndex
    from sahara_jax.engine.driver import search_queries
    from sahara_jax.engine.seedverify import run_sv_search
    from sahara_jax.engine.tape import compile_tape
    from sahara_jax.engine.workq import run_workq_search
    from sahara_jax.index.build import build_bifmindex
    from sahara_jax.schemes import GENERATORS, expand, limit_to_hamming

    def tape_of(gen, k, m, edit):
        ess = expand(GENERATORS[gen].generator(0, k, 0, 0), m)
        return compile_tape(ess if edit else limit_to_hamming(ess))

    def wq_rows(h):
        return sorted(zip(h.lane.tolist(), h.lb.tolist(), h.sz.tolist(), h.err.tolist()))

    def reads_of(seqs, rng, n, m):
        out = []
        for _ in range(n):
            s = seqs[rng.integers(0, len(seqs))]
            p = rng.integers(0, len(s) - m + 1)
            q = s[p : p + m].copy()
            j = rng.integers(0, m)
            q[j] = 1 + (q[j] - 1 + rng.integers(1, 4)) % 4  # one substitution
            out.append(q)
        return np.stack(out).astype(np.int32)

    rng = np.random.default_rng(7)
    seqs = [rng.integers(1, 5, size=ln).astype(np.uint8) for ln in (300, 150, 80)]
    dev = DeviceIndex.from_host(build_bifmindex(seqs, 6, "d_dna5", rate=16))
    m = 20
    qarr = reads_of(seqs, np.random.default_rng(99), 8, m)

    out = []
    for gen, k, edit, dedup in (
        ("backtracking", 1, False, True),
        ("backtracking", 1, False, False),
        ("optimum", 2, False, True),
        ("optimum", 2, True, True),
        ("h2-k2", 2, True, True),
        ("pigeon_opt", 1, True, False),
    ):
        h = run_workq_search(dev, qarr, tape_of(gen, k, m, edit), edit=edit, dedup=dedup)
        out.append({"case": [gen, k, edit, dedup], "n": h.n_hits, "rows": wq_rows(h)})

    # every gather mode of the hot step on one edit+dedup workload
    tape = tape_of("optimum", 2, m, True)
    for mode in ("wide", "fold", True, False):
        h = run_workq_search(dev, qarr, tape, edit=True, dedup=True, packed=mode)
        out.append({"case": ["gather", str(mode)], "n": h.n_hits, "rows": wq_rows(h)})

    # a queue of thousands of live states, so compaction payloads
    # (parent << 4 | branch) exceed 2^11: the range where a float32 product
    # computed in TF32 would round
    big = reads_of(seqs, np.random.default_rng(5), 512, m)
    h = run_workq_search(dev, big, tape_of("h2-k2", 2, m, True), edit=True, dedup=False)
    out.append({"case": ["payload>2^11", h.max_live], "n": h.n_hits, "rows": wq_rows(h)})

    # seed-and-verify (longer queries so k=2 parts stay seedable)
    m2 = 36
    q2 = reads_of([s for s in seqs if len(s) >= m2], np.random.default_rng(123), 8, m2)
    for k, edit in ((1, True), (2, True), (2, False)):
        h = run_sv_search(dev, q2, k, edit=edit)
        rows = sorted(zip(h.q_idx.tolist(), h.abs_pos.tolist(), h.err.tolist()))
        out.append({"case": ["sv", k, edit, True], "n": len(rows), "rows": rows})

    # mirrored single-table index (rbi family): right extensions rank the
    # forward table
    rng = np.random.default_rng(55)
    dseqs = [rng.integers(1, 4, size=260).astype(np.uint8) for _ in range(2)]
    closed = dseqs + [s[::-1].copy() for s in dseqs]
    mdev = DeviceIndex.from_host(build_bifmindex(closed, 4, "dr_dna5", rate=16, mirrored=True))
    mq = [np.asarray(closed[i % 4][6 * i : 6 * i + 30], dtype=np.uint8) for i in range(6)]
    for engine in ("auto", "workq"):
        rows = sorted(search_queries(mdev, mq, k=1, edit=True, engine=engine).rows())
        out.append({"case": ["mirrored", engine, 1, True], "n": len(rows), "rows": rows})
    return out


def phase_backend_equality() -> None:
    """Phase 2: this process's cases equal the CPU child's, bit for bit."""
    child = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--cpu-cases"],
        env=_cpu_env(), cwd=_HERE, capture_output=True, text=True, timeout=_CHILD_TIMEOUT,
    )
    if child.returncode != 0:
        raise RuntimeError(f"CPU reference run failed:\n{child.stderr[-3000:]}")
    want = json.loads(child.stdout)
    got = run_cases()
    big = [g for g in got if g["case"][0] == "payload>2^11"][0]
    if big["case"][1] < 1024:
        raise RuntimeError(f"payload case peaked at {big['case'][1]} live states, want >= 1024")
    bad = 0
    for w, g in zip(want, got, strict=True):
        same = [list(r) for r in w["rows"]] == [list(r) for r in g["rows"]]
        print(f"  {'ok' if same else 'MISMATCH'}  {g['case']}  cpu={w['n']} device={g['n']}")
        bad += not same
    if bad:
        raise RuntimeError(f"{bad}/{len(want)} cases differ between the CPU and the device")
    print(f"  {len(want)} cases bit-identical between the CPU and the device")


# ----------------------------------------------------- phase 3: main path


def phase_main_path(work: str, ref_mb: float = REF_MB, n_reads: int = N_READS,
                    subset: int = SUBSET) -> None:
    """Phase 3: index + search through the CLI at full width."""
    import jax

    from sahara_jax.engine.device import DeviceIndex
    from sahara_jax.index.fmindex import load_index
    from sahara_jax.io.fasta import write_fasta

    log = os.path.join(work, "cli.log")
    t0 = time.monotonic()
    ref_path, reads_path, reads = make_workload(work, ref_mb, n_reads)
    print(f"  workload: {ref_mb} MB reference, {n_reads} x {READ_LEN} bp reads, "
          f"{ERRORS} planted errors each ({time.monotonic() - t0:.1f} s to generate)")
    idx = ref_path + ".idx"
    print(f"  index build: {_cli(['index', ref_path], log):.1f} s")
    outs = [os.path.join(work, f"hits{i}.txt") for i in (1, 2)]
    search = ["search", "-q", reads_path, "-i", idx, "-e", str(ERRORS), "-d", "lev", "-o"]
    print(f"  search 1 (compiles): {_cli(search + [outs[0]], log):.2f} s")
    print(f"  search 2: {_cli(search + [outs[1]], log):.2f} s")
    hits = _hit_lines(outs[1])
    if hits != _hit_lines(outs[0]):
        raise RuntimeError("the two searches returned different hits")
    print(f"  hits: {len(hits)} for {2 * n_reads} strand queries")
    stats = jax.devices()[0].memory_stats()  # None on the CPU backend
    peak = f"{stats['peak_bytes_in_use'] / 1e9:.2f} GB" if stats else "not reported"
    print(f"  peak device memory: {peak}")

    found = {tuple(map(int, ln.split())) for ln in hits}
    missed = [i for i, r in enumerate(reads) if (2 * i, *expected_hit(r)) not in found]
    print(f"  recall: {n_reads - len(missed)}/{n_reads} reads found at their true position")
    if missed:
        raise RuntimeError(f"{len(missed)} reads missed, first {missed[:5]}")

    sub_path = os.path.join(work, "reads_subset.fa")
    write_fasta(sub_path, reads[:subset], line_length=0)
    cpu_out = os.path.join(work, "hits_cpu_subset.txt")
    child = _cpu_cli(search[:2] + [sub_path] + search[3:] + [cpu_out], os.path.join(work, "cpu.log"))
    try:
        rows_s, gb_s = rank_gather_rate(DeviceIndex.from_host(load_index(idx)))
        print(f"  XLA rank gather: {rows_s:.4g} rows/s, {gb_s:.1f} GB/s of occ rows")
    finally:
        _wait(child, "the subset search")
    if _hit_lines(cpu_out) != _hit_lines(outs[1], max_qid=2 * subset):
        raise RuntimeError(f"hits of the first {subset} reads differ from the CPU run")
    print(f"  first {subset} reads: device hits == CPU hits ({len(_hit_lines(cpu_out))} rows)")


# -------------------------------------------------- phase 4: four cards


def phase_multi(work: str, ref_mb: float = REF_MB, n_reads: int = N_READS,
                n_iv_reads: int = N_IV_READS, shard_mb: float = SHARD_MB,
                n_dev: int = 4) -> None:
    """Phase 4: data-parallel and interval-sharded search over ``n_dev``
    devices against single-device runs of the same workload."""
    import shutil

    from sahara_jax.alphabet import D_DNA5
    from sahara_jax.cli.common import load_queries_ranked
    from sahara_jax.engine.driver import load_scheme
    from sahara_jax.engine.tape import compile_tape
    from sahara_jax.index.shard import ShardedIndex, load_any_index
    from sahara_jax.io.fasta import write_fasta
    from sahara_jax.parallel.interval import distributed_interval_search
    from sahara_jax.parallel.mesh import data_mesh

    log = os.path.join(work, "cli.log")
    ref_path, reads_path, reads = make_workload(work, ref_mb, n_reads)
    idx = ref_path + ".idx"
    print(f"  index build: {_cli(['index', ref_path], log):.1f} s")
    search = ["search", "-q", reads_path, "-i", idx, "-e", str(ERRORS), "-d", "lev"]
    one, many = os.path.join(work, "hits_1dev.txt"), os.path.join(work, "hits_ndev.txt")
    print(f"  search --devices 1: {_cli(search + ['--devices', '1', '-o', one], log):.2f} s")
    print(f"  search --devices {n_dev}: "
          f"{_cli(search + ['--devices', str(n_dev), '-o', many], log):.2f} s")
    hits = _hit_lines(one)
    if _hit_lines(many) != hits:
        raise RuntimeError(f"--devices {n_dev} hits differ from --devices 1")
    print(f"  --devices {n_dev} hits == --devices 1 hits ({len(hits)} rows)")

    sharded_ref = os.path.join(work, "ref_sharded.fa")
    shutil.copyfile(ref_path, sharded_ref)
    _cli(["index", sharded_ref, "--max_shard_mb", str(shard_mb)], log)
    sh = load_any_index(sharded_ref + ".idx")
    if not isinstance(sh, ShardedIndex) or sh.num_shards > n_dev:
        raise RuntimeError(f"expected at most {n_dev} shards, got {getattr(sh, 'num_shards', 1)}")
    sub_path = os.path.join(work, "reads_iv.fa")
    write_fasta(sub_path, reads[:n_iv_reads], line_length=0)
    qarr = np.stack(load_queries_ranked(sub_path, D_DNA5, add_revcomp=True)).astype(np.int32)
    m = qarr.shape[1]
    tape = compile_tape(load_scheme("h2-k2", 0, ERRORS, m, edit=True, sigma=sh.sigma, n_text=sh.shards[0].n))
    mesh = data_mesh(n_dev)
    t0 = time.monotonic()
    res = distributed_interval_search(mesh, sh, qarr, tape, edit=True)
    print(f"  interval search, {sh.num_shards} shards over {n_dev} devices: "
          f"{time.monotonic() - t0:.2f} s for {len(qarr)} strand queries")
    got = [f"{q} {s} {p}" for q, s, p in zip(res.query_id, res.seq_id, res.pos)]
    want = _hit_lines(one, max_qid=len(qarr))
    if got != want:
        raise RuntimeError(f"interval-mesh hits ({len(got)}) differ from one device ({len(want)})")
    print(f"  interval-mesh hits == single-device hits ({len(got)} rows)")


# ------------------------------------------------------------------ main


def _phase(name: str, fn, *args) -> bool:
    print(f"phase: {name}", flush=True)
    t0 = time.monotonic()
    try:
        fn(*args)
    except Exception:
        traceback.print_exc()
        print(f"  FAILED after {time.monotonic() - t0:.1f} s", flush=True)
        return False
    print(f"  passed in {time.monotonic() - t0:.1f} s", flush=True)
    return True


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card phase (needs four GPUs)")
    ap.add_argument("--cpu-cases", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.cpu_cases:  # the CPU child of phase 2
        json.dump(run_cases(), sys.stdout)
        return 0

    try:
        from sahara_jax import CACHE_DIR
        from sahara_jax.utils.gpu import card_line, device_record, require_gpu

        dev = require_gpu()
    except (ImportError, RuntimeError) as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    record = device_record()
    need = 4 if args.multi else 1
    print("phase: device")
    print(f"  jax: {record['kind']} x {record['count']} ({dev.platform})")
    print(f"  card: {card_line()}")
    if record["count"] < need:
        print(f"chip_smoke: needs {need} GPUs, found {record['count']}", file=sys.stderr)
        return 1

    work = os.path.join(CACHE_DIR, "smoke_multi" if args.multi else "smoke")
    os.makedirs(work, exist_ok=True)
    if args.multi:
        ok = _phase("four cards", phase_multi, work)
    else:
        ok = _phase("backend equality", phase_backend_equality)
        ok = _phase("main path", phase_main_path, work) and ok
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": record}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
