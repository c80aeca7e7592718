"""Shared CLI plumbing: timing/stats blocks, FASTA-to-rank loading.

Reproduces the reference's console conventions: a ``config:`` block echoing
flags, phase timings accumulated into a ``stats:`` block with derived
queries/sec (e.g. search.cpp:134-147, 265-273)."""

from __future__ import annotations

import sys

import numpy as np

from sahara_jax.alphabet import INVALID_RANK, Alphabet
from sahara_jax.io.fasta import read_fasta
from sahara_jax.utils.errors import SaharaError
from sahara_jax.utils.stopwatch import Timings  # noqa: F401  (re-exported for commands)


def load_queries_ranked(
    path, alphabet: Alphabet, *, add_revcomp: bool, context: str = "query"
) -> list[np.ndarray]:
    """Load a FASTA into rank arrays, optionally appending the reverse
    complement after each record (search.cpp:115-124: queryIds count both
    strands)."""
    from sahara_jax.io.fasta import read_fasta_seq_matrix

    mat = read_fasta_seq_matrix(path)
    if mat is not None:
        # fully-vectorized uniform-read path: no per-record Python at all
        ranks = alphabet.char_to_rank_table[mat]
        bad_r, bad_c = np.nonzero(ranks == INVALID_RANK)
        if len(bad_r):
            # re-read with ids only to produce the reference-style error
            recs = list(read_fasta(path))
            i, pos = int(bad_r[0]), int(bad_c[0])
            ch = int(mat[i, pos])
            n_prev = i * (2 if add_revcomp else 1)
            raise SaharaError(
                f"{context} '{recs[i].id}' ({n_prev + 1}) has invalid character at "
                f"position {pos} '{chr(ch)}'({ch:x})"
            )
        if add_revcomp:
            rc = alphabet.complement[ranks[:, ::-1]]
            out = np.empty((2 * len(ranks), ranks.shape[1]), dtype=np.uint8)
            out[0::2] = ranks
            out[1::2] = rc
            return list(out)
        return list(ranks)
    records = list(read_fasta(path))
    lengths = {len(r.seq) for r in records}
    if len(lengths) == 1 and records and next(iter(lengths)) > 0:
        # uniform-length fast path (the overwhelmingly common read-file
        # shape): ONE table lookup over the concatenated bytes and a
        # matrix revcomp — per-record numpy-call overhead is ~8us, which
        # is minutes at configs[4]'s 10M reads
        m = next(iter(lengths))
        flat = np.frombuffer(b"".join(r.seq for r in records), dtype=np.uint8)
        ranks = alphabet.char_to_rank_table[flat].reshape(len(records), m)
        bad_r, bad_c = np.nonzero(ranks == INVALID_RANK)
        if len(bad_r):
            i, pos = int(bad_r[0]), int(bad_c[0])
            ch = records[i].seq[pos]
            n_prev = i * (2 if add_revcomp else 1)
            raise SaharaError(
                f"{context} '{records[i].id}' ({n_prev + 1}) has invalid character at "
                f"position {pos} '{chr(ch)}'({ch:x})"
            )
        if add_revcomp:
            rc = alphabet.complement[ranks[:, ::-1]]
            out = np.empty((2 * len(records), m), dtype=np.uint8)
            out[0::2] = ranks
            out[1::2] = rc
            return list(out)
        return list(ranks)
    queries: list[np.ndarray] = []
    for record in records:
        ranks = alphabet.char_to_rank(record.seq)
        if (pos := alphabet.verify_rank(ranks)) is not None:
            raise SaharaError(
                f"{context} '{record.id}' ({len(queries) + 1}) has invalid character at "
                f"position {pos} '{chr(record.seq[pos])}'({record.seq[pos]:x})"
            )
        queries.append(ranks)
        if add_revcomp:
            queries.append(alphabet.reverse_complement_rank(ranks))
    return queries


def load_reference_ranked(
    path, alphabet: Alphabet, *, ignore_unknown: bool, unknown_policy: str = "N", rng=None
) -> list[np.ndarray]:
    """Load reference FASTA into rank arrays.

    unknown_policy 'N': invalid chars become the N rank (index.cpp:63-67);
    'random-acgt': invalid (incl. N) become random A/C/G/T ranks
    (index.cpp:56-61); 'random-12': random rank 1/2 for dr_dna4
    (rbi-index-dna4.cpp:52-56)."""
    from sahara_jax.alphabet import INVALID_RANK

    seqs: list[np.ndarray] = []
    for record in read_fasta(path):
        ranks = alphabet.char_to_rank(record.seq)
        if ignore_unknown:
            bad = ranks == INVALID_RANK
            if unknown_policy == "random-acgt":
                n_rank = alphabet.char_to_rank(b"N")[0]
                bad = bad | (ranks == n_rank)
            if bad.any():
                ranks = ranks.copy()
                if unknown_policy == "N":
                    ranks[bad] = alphabet.char_to_rank(b"N")[0]
                elif unknown_policy == "random-acgt":
                    r = np.random.default_rng(0) if rng is None else rng
                    ranks[bad] = r.integers(1, 5, size=int(bad.sum()))
                elif unknown_policy == "random-12":
                    r = np.random.default_rng(0) if rng is None else rng
                    ranks[bad] = r.integers(1, 3, size=int(bad.sum()))
                else:
                    raise ValueError(unknown_policy)
        if (pos := alphabet.verify_rank(ranks)) is not None:
            raise SaharaError(
                f"ref '{record.id}' ({len(seqs) + 1}) has invalid character "
                f"'{chr(record.seq[pos])}' (0x{record.seq[pos]:02x}) at position {pos}"
            )
        seqs.append(ranks)
    return seqs


def format_hit_block(q: np.ndarray, s: np.ndarray, p: np.ndarray) -> str:
    """Vectorized ``queryId seqId pos`` lines for one hit block (a per-row
    f-string loop costs ~1.5us/row — minutes at 10^7+ hits)."""
    if len(q) == 0:
        return ""
    cols = np.char.mod("%d", np.stack([q, s, p], axis=1))
    lines = np.char.add(np.char.add(np.char.add(np.char.add(cols[:, 0], " "), cols[:, 1]), " "), cols[:, 2])
    return "\n".join(lines.tolist()) + "\n"


def write_hits(path, rows) -> int:
    """Write ``queryId seqId pos`` lines (search.cpp:256-261).

    ``rows`` is an iterable of (queryId, seqId, pos[, ...]) tuples or a
    3-tuple of parallel numpy arrays (the vectorized form drivers pass at
    configs[4] scale)."""
    if (
        isinstance(rows, tuple)
        and len(rows) == 3
        and all(isinstance(c, np.ndarray) for c in rows)
    ):
        q, s, p = rows
        with open(path, "w") as fh:
            fh.write(format_hit_block(q, s, p))
        return len(q)
    n = 0
    with open(path, "w") as fh:
        for query_id, seq_id, pos, *_ in rows:
            fh.write(f"{query_id} {seq_id} {pos}\n")
            n += 1
    return n


def die(msg: str) -> None:
    print(msg, file=sys.stderr)
    raise SystemExit(1)
