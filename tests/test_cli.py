"""End-to-end CLI tests: the reference's de-facto integration harness
(SURVEY.md §4: read_simulator generates ground-truthed reads; `search -e k`
must recover every planted read)."""

import re

import numpy as np
import pytest

from sahara_jax.cli.main import main
from sahara_jax.io.fasta import FastaRecord, read_fasta, write_fasta


@pytest.fixture(scope="module")
def ref_fasta(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref")
    rng = np.random.default_rng(5)
    seqs = [
        FastaRecord(id=f"chr{i}", seq=bytes(b"ACGT"[j] for j in rng.integers(0, 4, size=n)))
        for i, n in enumerate((500, 300))
    ]
    path = tmp / "ref.fasta"
    write_fasta(path, seqs)
    return str(path), seqs


def _parse_ground_truth(rec_id):
    m = re.search(r"seqid:(\d+), pos:(\d+), trans:([MSID]+)", rec_id)
    return int(m.group(1)), int(m.group(2)), m.group(3)


def test_index_and_search_recovers_planted_reads(ref_fasta, tmp_path):
    ref_path, _ = ref_fasta
    reads = tmp_path / "reads.fasta"
    out = tmp_path / "out.txt"

    assert main(["read_simulator", "-i", ref_path, "-o", str(reads),
                 "-n", "12", "-l", "40", "-e", "2", "--seed", "9"]) == 0
    assert main(["index", ref_path]) == 0
    assert main(["search", "-q", str(reads), "-i", ref_path + ".idx",
                 "-o", str(out), "-e", "2", "-g", "optimum"]) == 0

    hits = set()
    for line in open(out):
        q, s, p = map(int, line.split())
        hits.add((q, s, p))

    for i, rec in enumerate(read_fasta(reads)):
        sid, pos, trans = _parse_ground_truth(rec.id)
        qid = i * 2  # revcomp expansion doubles ids (search.cpp:121-123)
        assert (qid, sid, pos) in hits, f"read {i} not recovered at ({sid},{pos})"


def test_search_cli_mesh_and_engine_parity(ref_fasta, tmp_path):
    """`--devices 8` (local data mesh over the 8 virtual CPU devices) and
    `--engine workq` both produce byte-identical output to the default
    single-device auto-engine run."""
    ref_path, _ = ref_fasta
    reads = tmp_path / "reads.fasta"
    assert main(["read_simulator", "-i", ref_path, "-o", str(reads),
                 "-n", "10", "-l", "40", "-e", "1", "--seed", "4"]) == 0
    assert main(["index", ref_path]) == 0

    outs = {}
    for name, extra in {
        "seq": [],
        "mesh": ["--devices", "8"],
        "workq": ["--engine", "workq"],
        "mesh_workq": ["--devices", "8", "--engine", "workq"],
    }.items():
        out = tmp_path / f"out_{name}.txt"
        assert main(["search", "-q", str(reads), "-i", ref_path + ".idx",
                     "-o", str(out), "-e", "2", "-g", "optimum"] + extra) == 0
        outs[name] = out.read_text()
    assert outs["seq"] == outs["mesh"]
    assert outs["seq"] == outs["workq"]
    assert outs["seq"] == outs["mesh_workq"]
    assert outs["seq"].strip()  # non-empty


def test_search_hamming_exact_only(ref_fasta, tmp_path):
    ref_path, _ = ref_fasta
    reads = tmp_path / "reads0.fasta"
    out = tmp_path / "out0.txt"
    assert main(["read_simulator", "-i", ref_path, "-o", str(reads), "-n", "6", "-l", "30"]) == 0
    assert main(["index", ref_path]) == 0
    assert main(["search", "-q", str(reads), "-i", ref_path + ".idx",
                 "-o", str(out), "-e", "0", "-d", "ham"]) == 0
    hits = set()
    for line in open(out):
        q, s, p = map(int, line.split())
        hits.add((q, s, p))
    for i, rec in enumerate(read_fasta(reads)):
        sid, pos, _ = _parse_ground_truth(rec.id)
        assert (i * 2, sid, pos) in hits


def test_uni_search_exact(ref_fasta, tmp_path):
    ref_path, seqs = ref_fasta
    reads = tmp_path / "ureads.fasta"
    out = tmp_path / "uout.txt"
    # exact substrings as reads
    recs = [FastaRecord(id=f"r{i}", seq=seqs[0].seq[10 * i : 10 * i + 25]) for i in range(4)]
    write_fasta(reads, recs)
    assert main(["uni-index", ref_path]) == 0
    assert main(["uni-search", "-q", str(reads), "-i", ref_path + ".single.idx", "-o", str(out)]) == 0
    hits = set()
    for line in open(out):
        q, s, p = map(int, line.split())
        hits.add((q, s, p))
    for i in range(4):
        assert (2 * i, 0, 10 * i) in hits


def test_rbi_search_finds_both_strands(ref_fasta, tmp_path):
    ref_path, seqs = ref_fasta
    reads = tmp_path / "rreads.fasta"
    out = tmp_path / "rout.txt"
    comp = dict(zip(b"ACGT", b"TGCA"))
    fwd = seqs[0].seq[50:80]
    rc = bytes(comp[c] for c in fwd[::-1])
    write_fasta(reads, [FastaRecord(id="f", seq=fwd), FastaRecord(id="r", seq=rc)])
    assert main(["rbi-index", ref_path]) == 0
    assert main(["rbi-search", "-q", str(reads), "-i", ref_path + ".rbi.idx",
                 "-o", str(out), "-e", "0", "-g", "optimum"]) == 0
    hits = set()
    for line in open(out):
        q, s, p = map(int, line.split())
        hits.add((q, s, p))
    # fwd read found in original copy (seqId 0)
    assert (0, 0, 50) in hits
    # rc read maps to the mirror copy (seqId = num_seqs + 0) at the mirrored
    # position, or to the original via strand-reduction coincidence
    assert any(q == 1 for q, _, _ in hits)


def test_kmer_index_and_search(ref_fasta, tmp_path):
    ref_path, seqs = ref_fasta
    reads = tmp_path / "kreads.fasta"
    out = tmp_path / "kout.txt"
    recs = [FastaRecord(id=f"r{i}", seq=seqs[0].seq[30 * i : 30 * i + 120]) for i in range(3)]
    write_fasta(reads, recs)
    # small k keeps the dense kmer vocabulary under the 128-value cap the
    # reference also enforces (AdaptiveKmerIndex.cpp:52-54)
    assert main(["kmer-index", ref_path, "--kmer", "3", "--kmer_mode", "winnowing", "--window", "4"]) == 0
    assert main(["kmer-search", "--query", str(reads), "--index", ref_path + ".kmer.idx",
                 "--output", str(out)]) == 0
    lines = open(out).read().strip().splitlines()
    assert lines, "kmer search produced no hits"


def test_search_scheme_info(capsys):
    assert main(["search_scheme", "-g", "optimum", "-k", "2"]) == 0
    out = capsys.readouterr().out
    assert "valid:                      True" in out
    assert "complete:                   True" in out
    assert "non-redundant:              True" in out


def test_search_scheme_list_generators(capsys):
    assert main(["search_scheme", "list-generators"]) == 0
    out = capsys.readouterr().out
    for name in ("backtracking", "optimum", "h2-k2", "pex-bu-l"):
        assert name in out


def test_search_scheme_yaml_and_columba(tmp_path, capsys):
    assert main(["search_scheme", "-a", "-y", "-k", "1"]) == 0
    out = capsys.readouterr().out
    assert "searchCt:" in out
    cdir = tmp_path / "columba"
    assert main(["search_scheme", "-a", "--columba", str(cdir), "-k", "1"]) == 0
    assert (cdir / "optimum" / "1" / "searches.txt").exists()


def test_search_scheme_tikz(tmp_path):
    prefix = tmp_path / "tree"
    assert main(["search_scheme", "-g", "optimum", "-k", "1", "--tikz", str(prefix)]) == 0
    content = open(f"{prefix}-00.tikz").read()
    assert r"\begin{tikzpicture}" in content


def test_columba_prepare(ref_fasta, tmp_path):
    ref_path, seqs = ref_fasta
    base = tmp_path / "col"
    assert main(["columba_prepare", "-i", ref_path, "-o", str(base)]) == 0
    text = open(f"{base}.txt", "rb").read()
    assert text.endswith(b"$")
    assert len(text) == sum(len(s.seq) for s in seqs) + 1
    sa = list(map(int, open(f"{base}.sa").read().split()))
    assert sorted(sa) == list(range(len(text)))
    # spot-check SA order
    for a, b in zip(sa[:200], sa[1:200]):
        assert text[a:] < text[b:]


def test_besthits_cli(ref_fasta, tmp_path):
    ref_path, seqs = ref_fasta
    reads = tmp_path / "breads.fasta"
    out = tmp_path / "bout.txt"
    write_fasta(reads, [FastaRecord(id="x", seq=seqs[0].seq[100:130])])
    assert main(["index", ref_path]) == 0
    assert main(["search", "-q", str(reads), "-i", ref_path + ".idx", "-o", str(out),
                 "-e", "2", "-m", "besthits", "-g", "optimum"]) == 0
    hits = [tuple(map(int, line.split())) for line in open(out)]
    assert (0, 0, 100) in hits
