"""Streaming CLI search: byte-parity with the buffered path.

The streaming driver (cli/search_cmd._try_stream_search) parses FASTA
blocks on a reader thread, searches them as 2-D matrices, and appends
per-block canonical output — the concatenation must be byte-identical to
the buffered path because blocks arrive in ascending queryId order and
every output contract is per-query."""

from __future__ import annotations

import numpy as np
import pytest

from sahara_jax.cli.main import main
from sahara_jax.io.fasta import (
    FastaRecord,
    NotSimpleFasta,
    iter_fasta_seq_matrix_blocks,
    read_fasta_seq_matrix,
    write_fasta,
)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stream")
    rng = np.random.default_rng(31)
    seqs = [FastaRecord(id="chr0", seq=bytes(b"ACGT"[j] for j in rng.integers(0, 4, size=3000)))]
    ref = tmp / "ref.fasta"
    write_fasta(ref, seqs)
    reads = tmp / "reads.fasta"
    assert main(["read_simulator", "-i", str(ref), "-o", str(reads),
                 "-n", "300", "-l", "50", "-e", "1", "--seed", "21"]) == 0
    assert main(["index", str(ref)]) == 0
    return tmp, str(ref), str(reads)


def test_block_iter_matches_full_parse(corpus):
    tmp, ref, reads = corpus
    full = read_fasta_seq_matrix(reads)
    # tiny blocks force many chunk boundaries incl. mid-record cuts
    parts = list(iter_fasta_seq_matrix_blocks(reads, block_bytes=257))
    got = np.concatenate(parts, axis=0)
    np.testing.assert_array_equal(got, full)


def test_block_iter_rejects_ragged(tmp_path):
    p = tmp_path / "ragged.fasta"
    p.write_text(">a\nACGT\n>b\nACG\n")
    with pytest.raises(NotSimpleFasta):
        list(iter_fasta_seq_matrix_blocks(p, block_bytes=4))


@pytest.mark.parametrize("extra", [[], ["-m", "besthits"], ["--max_hits", "2"],
                                   ["--limit_queries", "101"], ["--no-reverse"]])
def test_stream_matches_buffered(corpus, tmp_path, monkeypatch, extra):
    tmp, ref, reads = corpus
    base = ["search", "-q", reads, "-i", ref + ".idx", "-e", "1", "-g", "optimum"] + extra
    out_buf = tmp_path / "buf.txt"
    monkeypatch.setenv("SAHARA_STREAM", "0")
    assert main(base + ["-o", str(out_buf)]) == 0
    out_str = tmp_path / "str.txt"
    monkeypatch.setenv("SAHARA_STREAM", "1")
    # tiny block size via a monkeypatched iterator so several blocks flow
    import sahara_jax.io.fasta as fa

    orig = fa.iter_fasta_seq_matrix_blocks
    monkeypatch.setattr(
        fa, "iter_fasta_seq_matrix_blocks",
        lambda path, block_bytes=0: orig(path, block_bytes=4096),
    )
    assert main(base + ["-o", str(out_str)]) == 0
    assert out_str.read_text() == out_buf.read_text()
