"""Alphabet machinery: char<->rank tables, reverse complement, verification.

Equivalent of the ivsigma alphabet layer consumed by the reference
(e.g. /root/reference/src/sahara/search.cpp:117-122 uses
``ivs::convert_char_to_rank``, ``ivs::verify_rank``,
``ivs::reverse_complement_rank``) and of the reduced "dr" alphabets declared
in /root/reference/src/sahara/dr_dna.h:8-21.

Everything here is NumPy lookup tables — conversion happens host-side during
IO; the search engine only ever sees rank arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np

INVALID_RANK = 255


@dataclasses.dataclass(frozen=True)
class Alphabet:
    """A ranked alphabet with a 0-rank sentinel ('$').

    rank 0 is always the sequence delimiter; real symbols are 1..sigma-1.
    ``complement[r]`` gives the complement rank (identity where undefined).
    """

    name: str
    sigma: int
    char_to_rank_table: np.ndarray  # uint8[256], INVALID_RANK = invalid
    rank_to_char_table: np.ndarray  # uint8[sigma], canonical char per rank
    complement: np.ndarray  # uint8[sigma]

    def char_to_rank(self, data: bytes | str | np.ndarray) -> np.ndarray:
        if isinstance(data, str):
            data = data.encode()
        arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, bytes) else np.asarray(data, dtype=np.uint8)
        return self.char_to_rank_table[arr]

    def rank_to_char(self, ranks: np.ndarray) -> bytes:
        return self.rank_to_char_table[np.asarray(ranks, dtype=np.uint8)].tobytes()

    def verify_rank(self, ranks: np.ndarray) -> int | None:
        """Return index of first invalid rank, or None if all valid.

        Mirrors ``ivs::verify_rank`` (call sites: search.cpp:118, index.cpp:69).
        """
        bad = np.nonzero(ranks == INVALID_RANK)[0]
        return int(bad[0]) if bad.size else None

    def reverse_complement_rank(self, ranks: np.ndarray) -> np.ndarray:
        """Reverse-complement in rank space (search.cpp:122)."""
        return self.complement[ranks[::-1]]


def _make_table(mapping: dict[int, str]) -> tuple[np.ndarray, np.ndarray]:
    c2r = np.full(256, INVALID_RANK, dtype=np.uint8)
    r2c = np.zeros(max(mapping) + 1, dtype=np.uint8)
    for rank, chars in mapping.items():
        r2c[rank] = ord(chars[0])
        for ch in chars:
            c2r[ord(ch)] = rank
    return c2r, r2c


def _alphabet(name: str, mapping: dict[int, str], complement_pairs: dict[int, int]) -> Alphabet:
    c2r, r2c = _make_table(mapping)
    sigma = max(mapping) + 1
    comp = np.arange(sigma, dtype=np.uint8)
    for a, b in complement_pairs.items():
        comp[a] = b
        comp[b] = a
    return Alphabet(name=name, sigma=sigma, char_to_rank_table=c2r, rank_to_char_table=r2c, complement=comp)


# ivsigma-convention DNA alphabets with '$' delimiter at rank 0.
# d_dna4: sigma=5 ($,A,C,G,T); d_dna5: sigma=6 (+N).  U/u are T-synonyms.
# (Sigma dispatch in the reference: search.cpp:284-287 — sigma 5 -> d_dna4,
#  sigma 6 -> d_dna5.)
D_DNA4 = _alphabet(
    "d_dna4",
    {0: "$", 1: "Aa", 2: "Cc", 3: "Gg", 4: "TtUu"},
    {1: 4, 2: 3},
)
D_DNA5 = _alphabet(
    "d_dna5",
    {0: "$", 1: "Aa", 2: "Cc", 3: "Gg", 4: "TtUu", 5: "Nn"},
    {1: 4, 2: 3},
)

# Strand-reduced alphabets (dr_dna.h:8-21): A/T/U/W -> 1, C/G/S -> 2 (+N -> 3
# for dr_dna5).  Complement is the identity, so revcomp == reverse.
DR_DNA4 = _alphabet(
    "dr_dna4",
    {0: "$", 1: "WAaTtUu", 2: "SCcGg"},
    {},
)
DR_DNA5 = _alphabet(
    "dr_dna5",
    {0: "$", 1: "WAaTtUu", 2: "SCcGg", 3: "Nn"},
    {},
)

# Plain dna4 (no delimiter) — used by the read simulator
# (read_simulator.cpp:105-107 uses ivs::dna4::normalize_char / verify_char).
_DNA4_C2R, _DNA4_R2C = _make_table({0: "Aa", 1: "Cc", 2: "Gg", 3: "TtUu"})


def dna4_normalize_char(data: bytes) -> bytes:
    """Uppercase-normalize ACGT (U->T); leave other bytes untouched."""
    arr = np.frombuffer(data, dtype=np.uint8)
    ranks = _DNA4_C2R[arr]
    ok = ranks != INVALID_RANK
    out = arr.copy()
    out[ok] = _DNA4_R2C[ranks[ok]]
    return out.tobytes()


def dna4_verify_char(data: bytes) -> np.ndarray:
    """Boolean mask of which bytes are valid dna4 characters."""
    arr = np.frombuffer(data, dtype=np.uint8)
    return _DNA4_C2R[arr] != INVALID_RANK


def dna4_char_to_rank(data: bytes) -> np.ndarray:
    return _DNA4_C2R[np.frombuffer(data, dtype=np.uint8)]


def dna4_rank_to_char(ranks: np.ndarray) -> bytes:
    return _DNA4_R2C[np.asarray(ranks, dtype=np.uint8)].tobytes()


BY_NAME: dict[str, Alphabet] = {a.name: a for a in (D_DNA4, D_DNA5, DR_DNA4, DR_DNA5)}


def by_sigma(sigma: int) -> Alphabet:
    """Sigma -> alphabet dispatch mirroring search.cpp:284-287."""
    if sigma == 5:
        return D_DNA4
    if sigma == 6:
        return D_DNA5
    raise ValueError(f"unknown index with {sigma} letters")
