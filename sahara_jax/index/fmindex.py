"""FM-index containers (host-side NumPy arrays) + versioned serialization.

Equivalents of ``fmc::FMIndex`` / ``fmc::BiFMIndex`` +
``fmc::DenseCSA`` (reference construction sites: index.cpp:87,
uni-index.cpp:70).  The cereal binary archives of the reference become a
flat ``.npz`` container with an explicit format version — the reference only
requires *search output* parity, not index file compatibility (SURVEY.md §2.2).

Text layout invariant: sequences are concatenated, each padded with sentinel
zeros so every sequence starts at a multiple of the SA sampling rate.  Hence
every LF-walk from a hit (which always starts inside a sequence — matched
substrings never contain rank 0) terminates at a sampled text position inside
the *same* sequence after < rate steps.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

FORMAT_VERSION = 2  # v2 adds the optional packed text store (text4)
_READABLE_VERSIONS = (1, 2)


@dataclasses.dataclass
class FMIndex:
    """Unidirectional FM-index over a sequence collection."""

    sigma: int
    alphabet_name: str
    rate: int  # SA sampling rate (reference default 16, index.cpp:87)
    n: int  # total text length (reference `index.size()`, search.cpp:193)
    occ: np.ndarray  # int32[W, 2*sigma] — see occtable.build_occ
    c_arr: np.ndarray  # int32[sigma+1] — C[c] = #symbols < c in the text
    sampled: np.ndarray  # int32[W, 2] — occ-structure over the sampled-row bitvector
    sample_seq: np.ndarray  # int32[S] — seqId per sampled row (row-rank order)
    sample_pos: np.ndarray  # int32[S] — seqPos per sampled row
    seq_lens: np.ndarray  # int64[m] — original sequence lengths
    # packed indexed text (index/textstore.py), int32[ceil(n/8)] or None for
    # indexes built before v2 / with sigma > 15.  Feeds the seed-and-verify
    # engine; every search path works without it (workq fallback).
    text4: np.ndarray | None = None
    # OPTIONAL full suffix array (absolute padded-text positions, int32[n]):
    # saved at build time for texts up to SAHARA_FULL_SA_MAX chars (default
    # 2^27).  Collapses the locate LF-walk (rate gather trips per hit) into
    # ONE gather on device — the reference trades the same memory/time axis
    # with its CSA sampling rate (index.cpp:87); we additionally keep the
    # dense row->position map where it fits: one gather replaces the walk's
    # pointer chase.  Absent on big
    # (sharded/genome-scale) builds and on pre-existing containers; every
    # consumer falls back to the sampled walk.
    sa_abs: np.ndarray | None = None

    @property
    def num_seqs(self) -> int:
        return len(self.seq_lens)

    def size(self) -> int:
        return self.n

    def seq_starts(self) -> np.ndarray:
        """Start offset of each sequence in the padded text layout
        (recomputed from seq_lens — the layout is deterministic,
        see build.build_text)."""
        padded = (self.seq_lens + self.rate) // self.rate * self.rate
        return np.concatenate([[0], np.cumsum(padded)[:-1]]).astype(np.int64)


@dataclasses.dataclass
class BiFMIndex(FMIndex):
    """Bidirectional FM-index: adds the reversed-text occ table.

    ``mirrored=True`` realizes the reference's MirroredBiFMIndex memory
    optimization (rbi-index.cpp:76): when the sequence collection is
    closed under reversal (each sequence's reverse is also present — the
    rbi build appends mirrors), the reverse cursor of any pattern P is
    itself a FORWARD-index interval (of reverse(P), equal size by mirror
    closure), so right extensions rank the forward table too and
    ``occ_rev`` is never needed — HALF the occ footprint on host, disk,
    and HBM."""

    occ_rev: np.ndarray | None = None  # int32[W, 2*sigma]; None iff mirrored
    mirrored: bool = False


def save_index(path: str, index: FMIndex) -> None:
    meta = {
        "format_version": FORMAT_VERSION,
        "kind": "bi" if isinstance(index, BiFMIndex) else "uni",
        "sigma": index.sigma,
        "alphabet": index.alphabet_name,
        "rate": index.rate,
        "n": index.n,
        "mirrored": bool(getattr(index, "mirrored", False)),
    }
    arrays = {
        "occ": index.occ,
        "c_arr": index.c_arr,
        "sampled": index.sampled,
        "sample_seq": index.sample_seq,
        "sample_pos": index.sample_pos,
        "seq_lens": index.seq_lens,
        "meta": np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
    }
    if isinstance(index, BiFMIndex) and index.occ_rev is not None:
        arrays["occ_rev"] = index.occ_rev
    if index.text4 is not None:
        arrays["text4"] = index.text4
    if index.sa_abs is not None:
        arrays["sa_abs"] = index.sa_abs
    if hasattr(path, "write"):
        np.savez(path, **arrays)
    else:
        with open(path, "wb") as fh:
            np.savez(fh, **arrays)


class FastNpz:
    """npz reader tuned for multi-GB members.

    Both NumPy's NpzFile and plain ``zipfile.ZipExtFile`` stream members
    through a 64KB-chunk Python loop (measured: a 10.6GB sharded container
    took 420-480s to load THROUGH PAGE CACHE).  ``np.savez`` stores members
    uncompressed (ZIP_STORED), so each member's bytes can be sliced straight
    out of the archive: parse the central directory with zipfile, read each
    member's local header for its data offset, then take the payload with
    ONE read (file sources) or a zero-copy memoryview slice (in-memory
    sources).  Compressed members fall back to zipfile.read."""

    def __init__(self, source):
        import io as _io
        import zipfile

        self._io = _io
        self._zipfile = zipfile
        self._own = not hasattr(source, "read")
        fh = open(source, "rb") if self._own else source
        self._fh = fh
        self._buf = fh.getbuffer() if isinstance(fh, _io.BytesIO) else None
        self.zf = zipfile.ZipFile(fh)
        self.files = [n[:-4] for n in self.zf.namelist() if n.endswith(".npy")]

    def _member_bytes(self, name: str):
        import struct

        info = self.zf.getinfo(name)
        if info.compress_type != self._zipfile.ZIP_STORED:
            return self.zf.read(name)  # rare: not produced by np.savez
        # local file header: 30 fixed bytes, then name + extra (lengths in
        # the LOCAL header can differ from the central directory's)
        if self._buf is not None:
            h = self._buf[info.header_offset : info.header_offset + 30]
            nlen, elen = struct.unpack("<HH", bytes(h[26:30]))
            off = info.header_offset + 30 + nlen + elen
            return self._buf[off : off + info.file_size]  # zero-copy view
        self._fh.seek(info.header_offset + 26)
        nlen, elen = struct.unpack("<HH", self._fh.read(4))
        self._fh.seek(info.header_offset + 30 + nlen + elen)
        return self._fh.read(info.file_size)

    def __getitem__(self, key: str) -> np.ndarray:
        """Parse the .npy header and view the payload with ONE frombuffer:
        numpy's read_array copies file-likes through a 256K-element Python
        chunk loop (168s for this 10.6GB container).  Returned arrays are
        read-only views of the member buffer (zero-copy for in-memory
        sources) — index arrays are never mutated after load."""
        import numpy.lib.format as npf

        raw = self._member_bytes(key + ".npy")
        head = self._io.BytesIO(bytes(raw[:4096]))
        version = npf.read_magic(head)
        if version == (1, 0):
            shape, fortran, dtype = npf.read_array_header_1_0(head)
        elif version == (2, 0):
            shape, fortran, dtype = npf.read_array_header_2_0(head)
        else:  # unknown version: let numpy handle it
            return np.load(self._io.BytesIO(bytes(raw)), allow_pickle=False)
        off = head.tell()
        if dtype.hasobject or off >= 4096:
            return np.load(self._io.BytesIO(bytes(raw)), allow_pickle=False)
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        arr = np.frombuffer(raw, dtype=dtype, count=count, offset=off)
        if fortran:
            return arr.reshape(shape[::-1]).T
        return arr.reshape(shape)

    def __contains__(self, key: str) -> bool:
        return key in self.files

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.zf.close()
        if self._own:
            self._fh.close()


def load_index(path: str) -> FMIndex:
    with FastNpz(path) as data:
        meta = json.loads(bytes(data["meta"]).decode())
        if meta["format_version"] not in _READABLE_VERSIONS:
            raise ValueError(f"unknown file format version for index: {meta['format_version']}")
        common = dict(
            text4=data["text4"] if "text4" in data.files else None,
            sa_abs=data["sa_abs"] if "sa_abs" in data.files else None,
            sigma=meta["sigma"],
            alphabet_name=meta["alphabet"],
            rate=meta["rate"],
            n=meta["n"],
            occ=data["occ"],
            c_arr=data["c_arr"],
            sampled=data["sampled"],
            sample_seq=data["sample_seq"],
            sample_pos=data["sample_pos"],
            seq_lens=data["seq_lens"],
        )
        if meta["kind"] == "bi":
            return BiFMIndex(
                **common,
                occ_rev=data["occ_rev"] if "occ_rev" in data.files else None,
                mirrored=bool(meta.get("mirrored", False)),
            )
        return FMIndex(**common)


def peek_sigma(path: str) -> int:
    """Read just the alphabet size from an index file (search.cpp:278-283)."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["meta"]).decode())
        return int(meta["sigma"])
