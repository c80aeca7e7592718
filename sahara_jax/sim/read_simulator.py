"""Read simulator: sample reads from a reference and plant an exact number
of substitution/insertion/deletion errors via an explicit edit transcript.

Port of the reference's fixture generator / integration-test oracle
(/root/reference/src/sahara/read_simulator.cpp:119-241): reads carry their
ground truth (seqId, position, transcript) in the FASTA id, enabling
end-to-end validation that ``search -e k`` recovers every planted read.

Semantics mirrored from the reference:
- transcript starts as ``M`` * read_length; substitutions and insertions
  *replace* a random ``M`` (so the read length is always ``read_length``);
  deletions are inserted at a random position (read_simulator.cpp:131-152);
- the reference span length is read_length + #D - #I
  (``lengthOfRef``, read_simulator.cpp:158-166);
- non-ACGT reference characters are replaced by random ACGT on load
  (read_simulator.cpp:99-114);
- substituted characters are always different from the original
  ((rank + r + 1) % 4, read_simulator.cpp:212-215).

RNG: a seeded ``numpy.random.Generator`` replaces the reference's
``std::mt19937_64``/``rand()`` pair — fixture *distribution* parity, not
bit parity (the reference's default-seeded global generator makes its exact
streams an implementation accident, read_simulator.cpp:119,170).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sahara_jax.alphabet import dna4_char_to_rank, dna4_rank_to_char, INVALID_RANK
from sahara_jax.io.fasta import FastaRecord

_ACGT = b"ACGT"


@dataclasses.dataclass
class Transcript:
    """Edit transcript: a string over M/S/I/D (read_simulator.cpp:119-167)."""

    ops: str

    @staticmethod
    def generate(rng: np.random.Generator, length: int, sub: int = 0, ins: int = 0, dele: int = 0) -> "Transcript":
        ops = ["M"] * length
        matches = length

        def replace_match(op: str):
            nonlocal matches
            if matches == 0:
                raise RuntimeError("no more matches for this transcript possible")
            pos = int(rng.integers(0, len(ops)))
            while ops[pos] != "M":
                pos = int(rng.integers(0, len(ops)))
            ops[pos] = op
            matches -= 1

        for _ in range(sub):
            replace_match("S")
        for _ in range(ins):
            replace_match("I")
        for _ in range(dele):
            pos = int(rng.integers(0, len(ops) + 1))
            ops.insert(pos, "D")
        return Transcript("".join(ops))

    @property
    def length_of_ref(self) -> int:
        """Length of the reference span this transcript consumes."""
        return len(self.ops) - self.ops.count("I")

    def apply(self, span: bytes, rng: np.random.Generator) -> bytes:
        """Mutate a reference span into a read (read_simulator.cpp:204-240)."""
        out = bytearray()
        p = 0
        for t in self.ops:
            if t == "M":
                out.append(span[p])
                p += 1
            elif t == "S":
                r = int(rng.integers(0, 3))
                rank = int(dna4_char_to_rank(bytes([span[p]]))[0])
                out += dna4_rank_to_char(np.array([(rank + r + 1) % 4]))
                p += 1
            elif t == "I":
                out.append(_ACGT[int(rng.integers(0, 4))])
            elif t == "D":
                p += 1
            else:
                raise ValueError(f'Invalid transcript "{t}"')
        return bytes(out)


def normalize_reference(seq: bytes, rng: np.random.Generator) -> bytes:
    """Uppercase-normalize; replace non-ACGT with random ACGT
    (read_simulator.cpp:99-114)."""
    arr = np.frombuffer(seq, dtype=np.uint8)
    ranks = dna4_char_to_rank(seq)
    bad = ranks == INVALID_RANK
    out = np.frombuffer(dna4_rank_to_char(np.where(bad, 0, ranks)), dtype=np.uint8).copy()
    n_bad = int(bad.sum())
    if n_bad:
        out[bad] = np.frombuffer(_ACGT, dtype=np.uint8)[rng.integers(0, 4, size=n_bad)]
    return out.tobytes()


def simulate_reads(
    sequences: list[bytes],
    *,
    num_reads: int = 1000,
    read_length: int = 150,
    sub_errors: int = 0,
    ins_errors: int = 0,
    del_errors: int = 0,
    random_errors: int = 0,
    seed: int = 0,
) -> list[FastaRecord]:
    """Simulate reads with ground truth in the id line:
    ``simulated-{i} (seqid:{}, pos:{}, trans:{})`` (read_simulator.cpp:272-275)."""
    rng = np.random.default_rng(seed)
    seqs = [normalize_reference(s, rng) for s in sequences]
    total = sum(len(s) for s in seqs)
    if total == 0:
        raise ValueError("empty reference")

    records = []
    for i in range(num_reads):
        sub, ins, dele = sub_errors, ins_errors, del_errors
        for _ in range(random_errors):
            r = int(rng.integers(0, 3))
            if r == 0:
                sub += 1
            elif r == 1:
                ins += 1
            else:
                dele += 1
        tr = Transcript.generate(rng, read_length, sub, ins, dele)
        span_len = tr.length_of_ref

        # uniform position over the concatenation, rejecting spans that
        # overrun their sequence (read_simulator.cpp:183-202)
        while True:
            pos = int(rng.integers(0, total))
            seq_id, found = 0, False
            for seq in seqs:
                if pos + span_len <= len(seq):
                    found = True
                    break
                if pos < len(seq):
                    break
                pos -= len(seq)
                seq_id += 1
            if found:
                break

        span = seqs[seq_id][pos : pos + span_len]
        read = tr.apply(span, rng)
        records.append(
            FastaRecord(
                id=f"simulated-{i} (seqid:{seq_id}, pos:{pos}, trans:{tr.ops})",
                seq=read,
            )
        )
    return records


def random_reads(num_reads: int, read_length: int, seed: int = 0) -> list[FastaRecord]:
    """Pure random reads (reference path without input FASTA,
    read_simulator.cpp:277-291)."""
    rng = np.random.default_rng(seed)
    return [
        FastaRecord(
            id=f"simulated-{i}",
            seq=bytes(_ACGT[j] for j in rng.integers(0, 4, size=read_length)),
        )
        for i in range(num_reads)
    ]
