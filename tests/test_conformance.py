"""Frozen-golden conformance corpus (CONFORMANCE.md).

Deterministic corpora -> real CLI -> byte-compare against committed
goldens.  Any refactor that changes a hit line fails here.  Regenerate
intentionally with SAHARA_REGEN_GOLDENS=1."""

import os

import numpy as np
import pytest

from sahara_jax.cli.main import main
from sahara_jax.io.fasta import FastaRecord, write_fasta

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
REGEN = os.environ.get("SAHARA_REGEN_GOLDENS") == "1"


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("conformance")
    rng = np.random.default_rng(20260817)
    seqs = [
        FastaRecord(id=f"chr{i}", seq=bytes(b"ACGT"[j] for j in rng.integers(0, 4, size=n)))
        for i, n in enumerate((700, 400, 250))
    ]
    ref = tmp / "ref.fasta"
    write_fasta(ref, seqs)
    reads = {}
    for name, (n, length, e, seed) in {
        "r0": (10, 50, 0, 1),
        "r1": (10, 60, 1, 2),
        "r2": (12, 80, 2, 3),
    }.items():
        p = tmp / f"{name}.fasta"
        assert main(["read_simulator", "-i", str(ref), "-o", str(p),
                     "-n", str(n), "-l", str(length), "-e", str(e), "--seed", str(seed)]) == 0
    # indexes
    assert main(["index", str(ref)]) == 0
    assert main(["uni-index", str(ref)]) == 0
    assert main(["rbi-index", str(ref)]) == 0
    assert main(["rbi-index-dna4", str(ref)]) == 0
    assert main(["kmer-index", str(ref), "--kmer", "1"]) == 0
    return tmp, str(ref)


def _check(tmp, name: str, out_path):
    golden = os.path.join(GOLDEN_DIR, name)
    data = open(out_path).read()
    if REGEN:
        os.makedirs(GOLDEN_DIR, exist_ok=True)
        with open(golden, "w") as fh:
            fh.write(data)
        return
    assert os.path.exists(golden), f"golden {name} missing — run with SAHARA_REGEN_GOLDENS=1"
    want = open(golden).read()
    assert data == want, f"output for {name} deviates from the frozen golden (see CONFORMANCE.md)"


CASES = [
    ("e0_exact_ham.txt", "r0", ["-e", "0", "-d", "ham", "-g", "optimum"]),
    ("e1_lev_optimum.txt", "r1", ["-e", "1", "-d", "lev", "-g", "optimum"]),
    ("e2_lev_h2k2.txt", "r2", ["-e", "2", "-d", "lev", "-g", "h2-k2"]),
    ("e2_ham_pigeonopt.txt", "r2", ["-e", "2", "-d", "ham", "-g", "pigeon_opt"]),
    ("e2_lev_besthits.txt", "r2", ["-e", "2", "-d", "lev", "-g", "optimum", "-m", "besthits"]),
    # besthits+ham: pure Hamming semantics (deliberate deviation #6 — the
    # reference ignores -d ham in besthits mode, search.cpp:232-240)
    ("besthits_ham.txt", "r2", ["-e", "2", "-d", "ham", "-g", "optimum", "-m", "besthits"]),
    ("e2_lev_maxhits2.txt", "r2", ["-e", "2", "-d", "lev", "-g", "optimum", "--max_hits", "2"]),
    # --dynamic_generator: WNC-top-down partition (search.cpp:193-205); a
    # complete scheme stays complete under repartitioning, so the hit set
    # must equal the static golden's (asserted in test_dynamic_generator)
    ("e2_lev_dynamic.txt", "r2", ["-e", "2", "-d", "lev", "-g", "h2-k2", "--dynamic_generator"]),
    ("e1_lev_noreverse.txt", "r1", ["-e", "1", "-d", "lev", "-g", "optimum", "--no-reverse"]),
]


@pytest.mark.parametrize("name,reads,flags", CASES, ids=[c[0] for c in CASES])
def test_search_goldens(corpus, tmp_path, name, reads, flags):
    tmp, ref = corpus
    out = tmp_path / "out.txt"
    assert main(["search", "-q", str(tmp / f"{reads}.fasta"), "-i", ref + ".idx",
                 "-o", str(out)] + flags) == 0
    _check(tmp, name, out)


def test_uni_search_golden(corpus, tmp_path):
    tmp, ref = corpus
    out = tmp_path / "uni.txt"
    assert main(["uni-search", "-q", str(tmp / "r0.fasta"), "-i", ref + ".single.idx",
                 "-o", str(out)]) == 0
    _check(tmp, "uni_exact.txt", out)


def test_rbi_search_goldens(corpus, tmp_path):
    tmp, ref = corpus
    out = tmp_path / "rbi.txt"
    assert main(["rbi-search", "-q", str(tmp / "r1.fasta"), "-i", ref + ".rbi.idx",
                 "-o", str(out), "-e", "1", "-g", "optimum"]) == 0
    _check(tmp, "rbi_e1.txt", out)
    out4 = tmp_path / "rbi4.txt"
    assert main(["rbi-search-dna4", "-q", str(tmp / "r1.fasta"), "-i", ref + ".rbi4.idx",
                 "-o", str(out4), "-e", "1", "-g", "optimum"]) == 0
    _check(tmp, "rbi4_e1.txt", out4)


def test_kmer_search_golden(corpus, tmp_path):
    tmp, ref = corpus
    out = tmp_path / "kmer.txt"
    assert main(["kmer-search", "--query", str(tmp / "r0.fasta"), "--index", ref + ".kmer.idx",
                 "--output", str(out)]) == 0
    _check(tmp, "kmer_exact.txt", out)


def test_dynamic_generator_hit_set_matches_static(corpus, tmp_path):
    """--dynamic_generator changes the partition, never the hit set: a
    complete scheme remains complete under WNC repartitioning, so sorted
    output must equal the static run's (search.cpp:193-205)."""
    tmp, ref = corpus
    outs = []
    for flags in ([], ["--dynamic_generator"]):
        out = tmp_path / f"dyn{len(flags)}.txt"
        assert main(["search", "-q", str(tmp / "r2.fasta"), "-i", ref + ".idx",
                     "-o", str(out), "-e", "2", "-d", "lev", "-g", "h2-k2"] + flags) == 0
        outs.append(sorted(open(out).read().splitlines()))
    assert outs[0] == outs[1]
