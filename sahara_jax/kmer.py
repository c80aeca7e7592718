"""Kmer sketching: compact encoding, winnowing minimizers, mod-mers.

Equivalent of the ivsigma kmer layer the reference consumes
(``ivs::compact_encoding`` / ``ivs::winnowing_minimizer`` call sites:
kmer-index.cpp:91-115, kmer-search.cpp:160-203).  ivsigma is not vendored in
the reference checkout, so these are *documented re-derivations* of the
published minimizer/mod-mer constructions with this framework's own
bit-level choices (kmers encoded base-(sigma-1) over ranks-1, canonical =
min(fwd, revcomp), minimizer ordering by XXH64): self-consistent between
index and search, which is the property the pipeline actually needs
(kmer-search kmerizes queries with the *index's* stored config).
"""

from __future__ import annotations

import numpy as np

from sahara_jax.native import xxh64_batch_u64

# d_dna5 rank complements (1=A, 2=C, 3=G, 4=T, 5=N): A<->T, C<->G, N->N
_COMPLEMENT = np.array([0, 4, 3, 2, 1, 5], dtype=np.uint64)


def compact_encoding(ranks: np.ndarray, k: int, sigma: int = 6, canonical: bool = False) -> np.ndarray:
    """Encode every length-k window of a rank sequence as an integer in
    base (sigma-1) over (rank-1) digits, most-significant-first.

    With ``canonical=True`` each kmer is the minimum of its own encoding and
    its reverse-complement's (strand-independent kmers, the reference's
    mod-mer query path, kmer-search.cpp:169)."""
    ranks = np.asarray(ranks, dtype=np.uint64)
    n = len(ranks)
    if n < k or k == 0:
        return np.zeros(0, dtype=np.uint64)
    base = np.uint64(sigma - 1)
    digits = ranks - 1  # ranks are 1..sigma-1 (sentinel never appears in data)

    out = np.zeros(n - k + 1, dtype=np.uint64)
    for j in range(k):
        out = out * base + digits[j : n - k + 1 + j]
    if canonical:
        rc_digits = _COMPLEMENT[ranks.astype(np.int64)] - 1
        rc = np.zeros(n - k + 1, dtype=np.uint64)
        for j in range(k - 1, -1, -1):  # reverse order
            rc = rc * base + rc_digits[j : n - k + 1 + j]
        out = np.minimum(out, rc)
    return out


def winnowing_minimizers(
    ranks: np.ndarray, k: int, window: int, sigma: int = 6, canonical: bool = True
) -> np.ndarray:
    """Winnowing minimizer values: hash every kmer (XXH64 of its canonical
    compact encoding), slide a ``window`` of consecutive kmers, emit the
    minimum hash of each window; consecutive duplicate selections collapse
    (DuplicatesAllowed=false, kmer-index.cpp:92)."""
    encs = compact_encoding(ranks, k, sigma, canonical=canonical)
    if len(encs) == 0:
        return np.zeros(0, dtype=np.uint64)
    hashes = xxh64_batch_u64(encs)
    w = max(1, min(window, len(hashes)))
    if w == 1:
        mins = hashes
    else:
        from numpy.lib.stride_tricks import sliding_window_view

        mins = sliding_window_view(hashes, w).min(axis=1)
    # collapse consecutive duplicates (same minimizer spanning windows)
    keep = np.ones(len(mins), dtype=bool)
    keep[1:] = mins[1:] != mins[:-1]
    return mins[keep]


def mod_mers(ranks: np.ndarray, k: int, mod_exp: int, sigma: int = 6, canonical: bool = True) -> np.ndarray:
    """Mod-mer values: canonical kmer encodings whose XXH64 hash has its low
    ``mod_exp`` bits zero (``hash(v) & mask == 0``, kmer-index.cpp:101-104).
    Returns the *hash* values (the reference also keys its dense map by the
    hash in mod mode)."""
    encs = compact_encoding(ranks, k, sigma, canonical=canonical)
    if len(encs) == 0:
        return np.zeros(0, dtype=np.uint64)
    hashes = xxh64_batch_u64(encs)
    mask = np.uint64((1 << mod_exp) - 1)
    return hashes[(hashes & mask) == 0]


def kmerize(
    ranks: np.ndarray, *, mode: str, k: int, window: int = 1, mod_exp: int = 4, sigma: int = 6
) -> np.ndarray:
    """Dispatch on kmer mode ('winnowing' or 'mod')."""
    if mode == "winnowing":
        return winnowing_minimizers(ranks, k, window, sigma)
    if mode == "mod":
        return mod_mers(ranks, k, mod_exp, sigma)
    raise ValueError(f"unknown kmer mode: {mode}")
