"""chip_smoke.py on the CPU: the script itself refuses to report without a
GPU, while each of its phases runs here at a tiny size (the same code the
card runs, with the device being a CPU and the CPU children alike)."""

import json

import pytest

import chip_smoke
from sahara_jax.io.fasta import FastaRecord


def test_main_exits_nonzero_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    assert chip_smoke.main(["--multi"]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out
    for line in out.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


@pytest.mark.parametrize(
    "trans, want",
    [("MMSMM", 10), ("DMMMM", 11), ("IDMMM", 11), ("DDIMM", 12), ("MMMMD", 10), ("ISMMM", 10)],
)
def test_expected_hit_skips_leading_deletions(trans, want):
    rec = FastaRecord(id=f"simulated-3 (seqid:2, pos:10, trans:{trans})", seq=b"ACGT")
    assert chip_smoke.expected_hit(rec) == (2, want)


def test_backend_equality_phase_on_cpu():
    chip_smoke.phase_backend_equality()


def test_main_path_phase_on_cpu(tmp_path, capsys):
    chip_smoke.phase_main_path(str(tmp_path), ref_mb=0.2, n_reads=128, subset=32)
    out = capsys.readouterr().out
    assert "recall: 128/128" in out
    assert "device hits == CPU hits" in out


def test_multi_phase_on_cpu(tmp_path, capsys):
    chip_smoke.phase_multi(
        str(tmp_path), ref_mb=0.2, n_reads=128, n_iv_reads=32, shard_mb=0.06, n_dev=4
    )
    out = capsys.readouterr().out
    assert "--devices 4 hits == --devices 1 hits" in out
    assert "interval-mesh hits == single-device hits" in out
