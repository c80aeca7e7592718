"""rbi family end-to-end: e>=1 recovery, the dna4 variant, and the mirror
seqId contract (CONFORMANCE.md §4: ids [m, 2m) are reverse-orientation
hits in the mirrored copy's coordinates)."""

import re

import numpy as np
import pytest

from sahara_jax.cli.main import main
from sahara_jax.io.fasta import FastaRecord, read_fasta, write_fasta

_COMP = bytes.maketrans(b"ACGT", b"TGCA")


@pytest.fixture(scope="module")
def rbi_corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rbi")
    rng = np.random.default_rng(23)
    seqs = [
        FastaRecord(id=f"chr{i}", seq=bytes(b"ACGT"[j] for j in rng.integers(0, 4, size=n)))
        for i, n in enumerate((600, 300))
    ]
    ref = tmp / "ref.fasta"
    write_fasta(ref, seqs)
    reads = tmp / "reads.fasta"
    assert main(["read_simulator", "-i", str(ref), "-o", str(reads),
                 "-n", "10", "-l", "40", "-e", "1", "--seed", "12"]) == 0
    assert main(["rbi-index", str(ref)]) == 0
    assert main(["rbi-index-dna4", str(ref)]) == 0
    return tmp, str(ref), seqs


def _hits(path):
    out = set()
    for line in open(path):
        q, s, p = map(int, line.split())
        out.add((q, s, p))
    return out


def _truth(reads_path):
    for i, rec in enumerate(read_fasta(reads_path)):
        m = re.search(r"seqid:(\d+), pos:(\d+), trans:([MSID]+)", rec.id)
        yield i, int(m.group(1)), int(m.group(2)), rec.seq


def test_rbi_search_e1_recovers_planted_reads(rbi_corpus, tmp_path):
    tmp, ref, seqs = rbi_corpus
    out = tmp_path / "out.txt"
    assert main(["rbi-search", "-q", str(tmp / "reads.fasta"), "-i", ref + ".rbi.idx",
                 "-o", str(out), "-e", "1", "-g", "optimum"]) == 0
    hits = _hits(out)
    for qid, sid, pos, _ in _truth(tmp / "reads.fasta"):
        assert (qid, sid, pos) in hits, f"read {qid} not recovered at ({sid},{pos})"


def test_rbi_dna4_search_e1_recovers_planted_reads(rbi_corpus, tmp_path):
    tmp, ref, seqs = rbi_corpus
    out = tmp_path / "out4.txt"
    assert main(["rbi-search-dna4", "-q", str(tmp / "reads.fasta"), "-i", ref + ".rbi4.idx",
                 "-o", str(out), "-e", "1", "-g", "optimum"]) == 0
    hits = _hits(out)
    for qid, sid, pos, _ in _truth(tmp / "reads.fasta"):
        assert (qid, sid, pos) in hits, f"read {qid} not recovered at ({sid},{pos})"


def test_rbi_mirror_seqid_contract(rbi_corpus, tmp_path):
    """A reverse-complement query hits the mirror copy: seqId = sid + m,
    pos = len(seq) - pos - span (exact match, e=0)."""
    tmp, ref, seqs = rbi_corpus
    span = 30
    sid, pos = 0, 100
    fwd = seqs[sid].seq[pos : pos + span]
    rc = fwd.translate(_COMP)[::-1]
    qpath = tmp_path / "rc.fasta"
    write_fasta(qpath, [FastaRecord(id="rc0", seq=rc)])
    out = tmp_path / "rc_out.txt"
    assert main(["rbi-search", "-q", str(qpath), "-i", ref + ".rbi.idx",
                 "-o", str(out), "-e", "0", "-g", "optimum"]) == 0
    hits = _hits(out)
    m = len(seqs)
    mirror_pos = len(seqs[sid].seq) - pos - span
    assert (0, sid + m, mirror_pos) in hits, sorted(hits)[:10]

def test_rbi_orig_coords_flag(rbi_corpus, tmp_path):
    """--orig_coords maps mirror hits to original-sequence coordinates:
    seqId < m always; the reported base is the original-strand position
    aligned to the query's first character (for an exact reverse hit of
    span L at forward position pos: pos + L - 1)."""
    tmp, ref, seqs = rbi_corpus
    span = 30
    sid, pos = 0, 100
    fwd = seqs[sid].seq[pos : pos + span]
    rc = fwd.translate(_COMP)[::-1]
    qpath = tmp_path / "rc.fasta"
    write_fasta(qpath, [FastaRecord(id="rc0", seq=rc), FastaRecord(id="f0", seq=fwd)])
    out = tmp_path / "oc_out.txt"
    assert main(["rbi-search", "-q", str(qpath), "-i", ref + ".rbi.idx",
                 "-o", str(out), "-e", "0", "-g", "optimum", "--orig_coords"]) == 0
    hits = _hits(out)
    m = len(seqs)
    assert all(s < m for _, s, _ in hits), sorted(hits)[:10]
    # query 0 (the revcomp read) hits the mirror; remapped coordinate =
    # L - 1 - mirror_pos = pos + span - 1
    assert (0, sid, pos + span - 1) in hits, sorted(hits)[:10]
    # query 1 (the forward read) hits forward with its start coordinate
    assert (1, sid, pos) in hits, sorted(hits)[:10]


def test_mirrored_index_matches_double_table():
    """MirroredBiFMIndex optimization: an rbi-style reverse-closed
    collection indexed WITHOUT the reversed-text table produces identical
    hit sets to the double-table build, at half the occ footprint."""
    import numpy as np

    from sahara_jax.engine.device import DeviceIndex
    from sahara_jax.engine.driver import search_queries
    from sahara_jax.index.build import build_bifmindex

    rng = np.random.default_rng(13)
    seqs = [rng.integers(1, 4, size=300).astype(np.uint8) for _ in range(2)]
    closed = seqs + [s[::-1].copy() for s in seqs]  # reverse closure
    full = build_bifmindex(closed, 4, "dr_dna5", rate=16)
    mir = build_bifmindex(closed, 4, "dr_dna5", rate=16, mirrored=True)
    assert mir.occ_rev is None and full.occ_rev is not None

    dev_full = DeviceIndex.from_host(full)
    dev_mir = DeviceIndex.from_host(mir)
    assert dev_mir.mirrored and dev_mir.rev_rows == 0 and dev_mir.bidirectional
    assert dev_mir.occ.shape[0] * 2 == dev_full.occ.shape[0]

    m, k = 30, 1
    queries = []
    for i in range(10):
        q = np.asarray(closed[i % 4][7 * i : 7 * i + m], dtype=np.uint8).copy()
        if i % 2:
            q[4] = 1 + (q[4] - 1 + 1) % 3
        queries.append(q)
    # force the scheme engine too (the SV engine never touches the rev
    # table, so workq is the path the optimization must prove itself on)
    for engine in ("auto", "workq", "approx"):
        a = search_queries(dev_full, queries, k=k, edit=True, engine=engine)
        b = search_queries(dev_mir, queries, k=k, edit=True, engine=engine)
        assert a.rows() == b.rows(), engine
        assert len(a.query_id) >= 10


def test_mirrored_index_roundtrip(tmp_path):
    """Mirrored indexes save/load without the rev table and search equal."""
    import numpy as np

    from sahara_jax.engine.device import DeviceIndex
    from sahara_jax.engine.driver import search_queries
    from sahara_jax.index.build import build_bifmindex
    from sahara_jax.index.fmindex import load_index, save_index

    rng = np.random.default_rng(14)
    seqs = [rng.integers(1, 4, size=200).astype(np.uint8)]
    closed = seqs + [s[::-1].copy() for s in seqs]
    mir = build_bifmindex(closed, 4, "dr_dna5", rate=16, mirrored=True)
    p = tmp_path / "m.idx"
    save_index(str(p), mir)
    back = load_index(str(p))
    assert back.mirrored and back.occ_rev is None
    q = [np.asarray(closed[0][50:80], dtype=np.uint8)]
    a = search_queries(DeviceIndex.from_host(mir), q, k=1, edit=True)
    b = search_queries(DeviceIndex.from_host(back), q, k=1, edit=True)
    assert a.rows() == b.rows() and len(a.query_id) >= 1
