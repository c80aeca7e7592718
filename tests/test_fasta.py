from sahara_jax.io import FastaRecord, read_fasta, write_fasta


def test_roundtrip(tmp_path):
    p = tmp_path / "t.fasta"
    recs = [FastaRecord("a desc", b"ACGT" * 50), FastaRecord("b", b""), FastaRecord("c", b"NNN")]
    write_fasta(p, recs, line_length=80)
    back = list(read_fasta(p))
    assert [(r.id, r.seq) for r in back] == [(r.id, r.seq) for r in recs]
    # wrapping at 80
    lines = p.read_bytes().split(b"\n")
    assert lines[0] == b">a desc"
    assert len(lines[1]) == 80 and len(lines[2]) == 80 and len(lines[3]) == 40


def test_no_wrap(tmp_path):
    p = tmp_path / "t.fasta"
    write_fasta(p, [FastaRecord("x", b"ACGT" * 100)], line_length=0)
    lines = p.read_bytes().split(b"\n")
    assert len(lines[1]) == 400
