"""Streaming FASTA reader/writer.

This framework's equivalent of the ivio FASTA layer used by the
reference (e.g. /root/reference/src/sahara/search.cpp:115,
read_simulator.cpp:254-256: writer wraps sequence lines at a configurable
length).
"""

from __future__ import annotations

import dataclasses
import io
import os
from collections.abc import Iterator


@dataclasses.dataclass
class FastaRecord:
    id: str
    seq: bytes


def read_fasta(path: str | os.PathLike) -> Iterator[FastaRecord]:
    """Iterate records of a FASTA file (sequence returned as bytes).

    Block-wise parser: records are split on ``\\n>`` boundaries with
    C-level bytes ops instead of a per-line Python loop — at configs[4]
    scale (10M+ short reads, 20M+ lines) the per-line loop costs minutes
    of single-core time in front of the search (SURVEY §2.2 ivio::fasta;
    semantics unchanged, incl. legacy ';' comment lines)."""
    _BLOCK = 1 << 26  # 64MB
    with open(path, "rb") as fh:
        buf = fh.read(_BLOCK)
        if not buf:
            return
        # anything before the first line-start '>' must be blank/comment
        # lines only ('>' inside a ';' comment is not a record start)
        if buf.startswith(b">"):
            first = 0
        else:
            p = buf.find(b"\n>")
            first = p + 1 if p >= 0 else -1
        head = buf[:first] if first >= 0 else buf
        if any(ln and not ln.startswith(b";") for ln in head.split(b"\n")):
            raise ValueError(f"{path}: sequence data before first '>' header")
        if first < 0:
            return
        buf = buf[first + 1 :]  # drop the leading '>'
        while True:
            nxt = fh.read(_BLOCK)
            if nxt:
                buf += nxt
                # keep reading until the block holds at least one full record
                if b"\n>" not in buf:
                    continue
            recs = buf.split(b"\n>")
            tail = recs.pop() if nxt else None
            if tail is not None:
                buf = tail
            for rec in recs:
                nl = rec.find(b"\n")
                if nl < 0:
                    yield FastaRecord(rec.rstrip(b"\r").decode(), b"")
                    continue
                rec_id = rec[:nl].rstrip(b"\r").decode()
                body = rec[nl + 1 :]
                if b";" in body:  # rare: strip legacy comment lines
                    body = b"\n".join(
                        ln for ln in body.split(b"\n") if not ln.startswith(b";")
                    )
                yield FastaRecord(
                    rec_id, body.replace(b"\n", b"").replace(b"\r", b"")
                )
            if not nxt:
                return


def read_fasta_seq_matrix(path: str | os.PathLike):
    """Fully-vectorized load of a uniform short-read FASTA: returns a
    uint8[n_records, L] matrix of sequence BYTES, or None when the file is
    not the simple shape (one '>' header line + exactly one equal-length
    sequence line per record, no comments).

    Record ids are deliberately not materialized — the search path never
    uses them, and skipping 10M+ Python string decodes turns a ~107s parse
    into a ~3s one (measured at configs[4] scale).  Callers needing ids
    (or any other FASTA shape) use :func:`read_fasta`."""
    import numpy as np

    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith(b">"):
        return None
    arr = np.frombuffer(data, dtype=np.uint8)
    if arr[-1] != 0x0A:  # simplify: require a trailing newline
        return None
    nl = np.flatnonzero(arr == 0x0A)
    if len(nl) % 2:
        return None
    starts = np.r_[0, nl[:-1] + 1]
    is_hdr = arr[starts] == ord(">")
    # strict alternation: header, seq, header, seq, ...
    if not (is_hdr[0::2].all() and not is_hdr[1::2].any()):
        return None
    seq_start = starts[1::2]
    seq_end = nl[1::2]
    lens = seq_end - seq_start
    L = int(lens[0])
    if L == 0 or not (lens == L).all():
        return None
    mat = arr[seq_start[:, None] + np.arange(L, dtype=np.int64)[None, :]]
    if (mat == 0x0D).any():  # CRLF files take the slow path
        return None
    return mat


def write_fasta(
    path: str | os.PathLike | io.IOBase,
    records: Iterator[FastaRecord] | list[FastaRecord],
    line_length: int = 80,
) -> None:
    """Write records, wrapping sequence lines at ``line_length`` (0 = no wrap).

    Matches the reference writer semantics (read_simulator.cpp:254-256).
    """
    own = not isinstance(path, io.IOBase)
    fh = open(path, "wb") if own else path
    try:
        for rec in records:
            fh.write(b">" + rec.id.encode() + b"\n")
            seq = rec.seq
            if line_length <= 0:
                fh.write(seq + b"\n")
            else:
                for i in range(0, len(seq), line_length):
                    fh.write(seq[i : i + line_length] + b"\n")
                if not seq:
                    fh.write(b"\n")
    finally:
        if own:
            fh.close()


class NotSimpleFasta(Exception):
    """File is not the uniform 2-line-per-record shape the vectorized
    block parser requires; callers fall back to :func:`read_fasta`."""


def iter_fasta_seq_matrix_blocks(
    path: str | os.PathLike, block_bytes: int = 64 << 20
):
    """Incrementally yield uint8[n, L] sequence-byte matrices from a
    uniform 2-line-per-record FASTA, reading ``block_bytes`` of the file
    at a time.

    The streaming complement of :func:`read_fasta_seq_matrix` (same
    restrictions: '>' header + exactly one equal-length sequence line per
    record, trailing newline, no CR).  Raises :class:`NotSimpleFasta` as
    soon as a chunk violates the shape — on the FIRST chunk callers fall
    back to the load-everything path cheaply; a mid-file violation aborts
    the stream (the caller restarts non-streaming).

    Why: at configs[4] scale the disk read + parse of a multi-GB read
    file costs ~100s; yielding blocks lets a reader thread overlap that
    with device search."""
    import numpy as np

    L = None
    tail = b""
    with open(path, "rb") as fh:
        while True:
            data = fh.read(block_bytes)
            if not data:
                break
            data = tail + data
            cut = data.rfind(b"\n")
            if cut < 0:
                tail = data
                continue
            tail = data[cut + 1 :]
            seg = data[: cut + 1]
            arr = np.frombuffer(seg, dtype=np.uint8)
            nl = np.flatnonzero(arr == 0x0A)
            if len(nl) % 2:
                # odd line count: keep the last (header) line for the
                # next chunk so records never split
                keep_from = nl[-2] + 1 if len(nl) >= 2 else 0
                tail = seg[keep_from:] + tail
                arr = arr[:keep_from]
                nl = nl[: len(nl) - 1]
                if len(arr) == 0:
                    continue
            starts = np.r_[0, nl[:-1] + 1]
            if arr[0] != ord(">"):
                raise NotSimpleFasta("chunk does not start at a record boundary")
            is_hdr = arr[starts] == ord(">")
            if not (is_hdr[0::2].all() and not is_hdr[1::2].any()):
                raise NotSimpleFasta("not strict header/sequence alternation")
            seq_start = starts[1::2]
            seq_end = nl[1::2]
            lens = seq_end - seq_start
            if L is None:
                if len(lens) == 0:
                    continue
                L = int(lens[0])
                if L == 0:
                    raise NotSimpleFasta("empty sequence line")
            if not (lens == L).all():
                raise NotSimpleFasta("ragged sequence lengths")
            mat = arr[seq_start[:, None] + np.arange(L, dtype=np.int64)[None, :]]
            if (mat == 0x0D).any():
                raise NotSimpleFasta("CRLF line endings")
            yield mat
    if tail.strip():
        raise NotSimpleFasta("trailing bytes without final newline")
