"""j-mer prefix lookup table: skip the first j steps of exact backward
search.

Backward search extends one symbol per step, and each step costs one
occ-row gather pass over every lane, and the first j steps of EVERY part are
the same computation for at most 4^j distinct suffixes.  This table
precomputes the (lo, hi) SA interval of every length-j pattern over the
DNA ranks {1..4} once per index upload (vectorized NumPy over the host
occ table), letting the seed scan (engine/seedverify.py) start at
step j.

Codes are little-endian in CONSUMPTION order: digit i (weight 4^i) is the
(rank - 1) of the i-th character consumed, i.e. the part's (len-1-i)-th
character.  Patterns containing ranks outside 1..4 (N, sentinels) are not
representable; the SV driver routes such queries to the scheme-engine
fallback (exact), so seed lanes are always table-eligible.
"""

from __future__ import annotations

import numpy as np

from sahara_jax.index.occtable import rank_all_np


def pick_lut_j(n: int, max_j: int = 10) -> int:
    """Table depth: deep enough to be selective (4^j >= n is pointless for
    tiny tests), capped at MIN_PART so every seed part covers it."""
    j = max(int(np.log2(max(n, 16)) / 2), 2)
    return min(j, max_j)


def build_jmer_lut(occ: np.ndarray, c_arr: np.ndarray, sigma: int, n: int, j: int) -> np.ndarray:
    """(lo | hi) intervals for all 4^j base-4 codes: int32[2 * 4^j].

    Level l extends every level-(l-1) interval with each digit d in 1..4
    (rank d), exactly the LF-update the device seed scan performs
    (seedverify.seed_parts): lo' = C[d] + rank_d(lo).  Digits with rank
    >= sigma yield empty intervals (unreachable: queries carrying such
    ranks never take the table path)."""
    c_arr = np.asarray(c_arr, dtype=np.int64)
    lo = np.zeros(1, dtype=np.int64)
    hi = np.full(1, n, dtype=np.int64)
    for level in range(j):
        sz = 4**level
        r_lo = rank_all_np(occ, sigma, lo)  # [sz, sigma]
        r_hi = rank_all_np(occ, sigma, hi)
        new_lo = np.zeros(4 * sz, dtype=np.int64)
        new_hi = np.zeros(4 * sz, dtype=np.int64)
        for d in range(1, 5):
            blk = slice((d - 1) * sz, d * sz)
            if d < sigma:
                new_lo[blk] = c_arr[d] + r_lo[:, d]
                new_hi[blk] = c_arr[d] + r_hi[:, d]
            # else: empty (lo == hi == 0)
        lo, hi = new_lo, new_hi
    return np.concatenate([lo, hi]).astype(np.int32)
