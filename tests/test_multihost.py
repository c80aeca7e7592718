"""Multi-host execution: a real 2-process ``jax.distributed`` run must
produce byte-identical output to the single-process run on the same corpus
(the reference is single-process, SURVEY.md §2.3).

The worker processes run the actual CLI with the ``--mh_*`` extension
flags on the CPU backend."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from sahara_jax.cli.main import main
from sahara_jax.io.fasta import FastaRecord, write_fasta


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _worker_env() -> dict:
    env = dict(os.environ)
    # hermetic CPU backend without virtual-device forcing, so
    # jax.distributed sees one local CPU device per process
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + env.get("PYTHONPATH", "").split(os.pathsep)
    )
    return env


def test_two_process_run_matches_single_process(tmp_path):
    rng = np.random.default_rng(11)
    seqs = [FastaRecord(id="chr0", seq=bytes(b"ACGT"[j] for j in rng.integers(0, 4, size=600)))]
    ref = tmp_path / "ref.fasta"
    write_fasta(ref, seqs)
    reads = tmp_path / "reads.fasta"
    assert main(["read_simulator", "-i", str(ref), "-o", str(reads),
                 "-n", "10", "-l", "36", "-e", "1", "--seed", "4"]) == 0
    assert main(["index", str(ref)]) == 0

    single_out = tmp_path / "single.txt"
    assert main(["search", "-q", str(reads), "-i", str(ref) + ".idx",
                 "-o", str(single_out), "-e", "1", "-g", "optimum"]) == 0

    port = _free_port()
    multi_out = tmp_path / "multi.txt"
    procs = []
    for rank in range(2):
        cmd = [
            sys.executable, "-m", "sahara_jax", "search",
            "-q", str(reads), "-i", str(ref) + ".idx", "-o", str(multi_out),
            "-e", "1", "-g", "optimum",
            "--mh_coordinator", f"127.0.0.1:{port}",
            "--mh_num_processes", "2", "--mh_process_id", str(rank),
        ]
        procs.append(subprocess.Popen(cmd, env=_worker_env(),
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for p in procs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, out.decode(errors="replace")[-2000:]

    assert multi_out.exists(), "rank 0 did not merge the per-host outputs"
    assert multi_out.read_text() == single_out.read_text()


def test_four_process_uneven_slices_match_single_process(tmp_path):
    """4 ranks over a query count that does NOT divide evenly (13 reads ->
    26 strand queries -> slices 7/7/6/6): global queryIds must survive the
    uneven partition and the rank-0 merge must be byte-identical to the
    single-process run (>2 ranks + uneven slices)."""
    rng = np.random.default_rng(13)
    seqs = [FastaRecord(id=f"chr{i}", seq=bytes(b"ACGT"[j] for j in rng.integers(0, 4, size=n)))
            for i, n in enumerate((500, 350))]
    ref = tmp_path / "ref.fasta"
    write_fasta(ref, seqs)
    reads = tmp_path / "reads.fasta"
    assert main(["read_simulator", "-i", str(ref), "-o", str(reads),
                 "-n", "13", "-l", "36", "-e", "1", "--seed", "9"]) == 0
    assert main(["index", str(ref)]) == 0

    single_out = tmp_path / "single.txt"
    assert main(["search", "-q", str(reads), "-i", str(ref) + ".idx",
                 "-o", str(single_out), "-e", "1", "-g", "optimum"]) == 0

    port = _free_port()
    multi_out = tmp_path / "multi.txt"
    procs = []
    for rank in range(4):
        cmd = [
            sys.executable, "-m", "sahara_jax", "search",
            "-q", str(reads), "-i", str(ref) + ".idx", "-o", str(multi_out),
            "-e", "1", "-g", "optimum",
            "--mh_coordinator", f"127.0.0.1:{port}",
            "--mh_num_processes", "4", "--mh_process_id", str(rank),
        ]
        procs.append(subprocess.Popen(cmd, env=_worker_env(),
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for p in procs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, out.decode(errors="replace")[-2000:]

    assert multi_out.exists(), "rank 0 did not merge the per-host outputs"
    assert multi_out.read_text() == single_out.read_text()


def test_two_process_with_local_mesh_matches_single(tmp_path):
    """Multihost + per-host local data mesh (--devices, opt-in under
    --mh_*): each process searches its query slice data-parallel over its
    own 2 virtual devices; merged output is byte-identical."""
    rng = np.random.default_rng(12)
    seqs = [FastaRecord(id="chr0", seq=bytes(b"ACGT"[j] for j in rng.integers(0, 4, size=700)))]
    ref = tmp_path / "ref.fasta"
    write_fasta(ref, seqs)
    reads = tmp_path / "reads.fasta"
    assert main(["read_simulator", "-i", str(ref), "-o", str(reads),
                 "-n", "10", "-l", "36", "-e", "1", "--seed", "6"]) == 0
    assert main(["index", str(ref)]) == 0

    single_out = tmp_path / "single.txt"
    assert main(["search", "-q", str(reads), "-i", str(ref) + ".idx",
                 "-o", str(single_out), "-e", "1", "-g", "optimum"]) == 0

    port = _free_port()
    multi_out = tmp_path / "multi.txt"
    procs = []
    for rank in range(2):
        env = _worker_env()
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        cmd = [
            sys.executable, "-m", "sahara_jax", "search",
            "-q", str(reads), "-i", str(ref) + ".idx", "-o", str(multi_out),
            "-e", "1", "-g", "optimum", "--devices", "2",
            "--mh_coordinator", f"127.0.0.1:{port}",
            "--mh_num_processes", "2", "--mh_process_id", str(rank),
        ]
        procs.append(subprocess.Popen(cmd, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for p in procs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, out.decode(errors="replace")[-2000:]

    assert multi_out.exists(), "rank 0 did not merge the per-host outputs"
    assert multi_out.read_text() == single_out.read_text()
