"""Host-side FM-index construction: text layout, SA (native SA-IS), BWT,
occ bit-planes, sampled suffix array.

The reference builds its index inside ``fmc::BiFMIndex{ref, samplingRate,
threadNbr}`` (index.cpp:87); here construction is an explicit offline NumPy +
native-C++ pipeline producing flat arrays (SURVEY.md §7 "index build strictly
offline/host-side").
"""

from __future__ import annotations

import numpy as np

from sahara_jax.index.fmindex import BiFMIndex, FMIndex
from sahara_jax.index.occtable import build_occ
from sahara_jax.index.textstore import pack_text4
from sahara_jax.native import suffix_array


def _pack_text_opt(text: np.ndarray, sigma: int) -> np.ndarray | None:
    """Packed text store for the seed-and-verify engine (sigma <= 15 only —
    large-alphabet kmer indexes search exact and never need it)."""
    return pack_text4(text) if sigma <= 15 else None


def build_text(seqs: list[np.ndarray], rate: int) -> tuple[np.ndarray, np.ndarray]:
    """Concatenate sequences, padding each with sentinel zeros so that the
    next sequence starts at a multiple of ``rate`` (>=1 sentinel per seq).

    Returns (text uint8[N], starts int64[m]).  N is a multiple of rate.
    """
    starts = np.zeros(len(seqs), dtype=np.int64)
    pos = 0
    chunks = []
    for i, s in enumerate(seqs):
        starts[i] = pos
        padded = (len(s) + rate) // rate * rate  # ceil to next multiple, >=1 pad
        chunk = np.zeros(padded, dtype=np.uint8)
        chunk[: len(s)] = s
        chunks.append(chunk)
        pos += padded
    return np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.uint8), starts


def _full_sa_max() -> int:
    import os

    return int(os.environ.get("SAHARA_FULL_SA_MAX", 1 << 27))


def _build_core(text: np.ndarray, sigma: int, rate: int, starts: np.ndarray, seq_lens: np.ndarray):
    """SA -> BWT -> occ + sampled CSA for one direction (the forward text)."""
    n = len(text)
    sa = suffix_array(text)
    bwt = text[(sa - 1) % n]
    occ = build_occ(bwt, sigma)

    counts = np.bincount(text, minlength=sigma).astype(np.int64)
    c_arr = np.zeros(sigma + 1, dtype=np.int64)
    c_arr[1:] = np.cumsum(counts)
    c_arr = c_arr.astype(np.int32)

    # sampled CSA: rows whose suffix position is a multiple of rate
    is_sampled = (sa % rate) == 0
    sampled = build_occ(is_sampled.astype(np.uint8), 2)[:, [1, 3]]  # keep plane for value==1
    sampled_positions = sa[is_sampled]
    seq_id = np.searchsorted(starts, sampled_positions, side="right") - 1
    seq_pos = sampled_positions - starts[seq_id]
    # full-SA locate sidecar (fmindex.FMIndex.sa_abs): kept for texts up to
    # SAHARA_FULL_SA_MAX chars (4 bytes/char on disk and HBM) so locate is
    # one gather instead of a rate-trip LF pointer chase
    sa_abs = sa.astype(np.int32) if n <= _full_sa_max() else None
    return occ, c_arr, sampled.astype(np.int32), seq_id.astype(np.int32), seq_pos.astype(np.int32), sa_abs


def _ranks_of(seqs: list[np.ndarray]) -> list[np.ndarray]:
    return [np.asarray(s, dtype=np.uint8) for s in seqs]


def _rev_occ(text: np.ndarray, sigma: int) -> np.ndarray:
    """Reversed-text occ table for right extensions (no CSA on this side)."""
    rev = text[::-1].copy()
    sa_r = suffix_array(rev)
    bwt_r = rev[(sa_r - 1) % len(rev)]
    return build_occ(bwt_r, sigma)


def build_fmindex(seqs: list[np.ndarray], sigma: int, alphabet_name: str, rate: int = 16) -> FMIndex:
    seqs = _ranks_of(seqs)
    seq_lens = np.array([len(s) for s in seqs], dtype=np.int64)
    text, starts = build_text(seqs, rate)
    occ, c_arr, sampled, sseq, spos, sa_abs = _build_core(text, sigma, rate, starts, seq_lens)
    return FMIndex(
        sigma=sigma,
        alphabet_name=alphabet_name,
        rate=rate,
        n=len(text),
        occ=occ,
        c_arr=c_arr,
        sampled=sampled,
        sample_seq=sseq,
        sample_pos=spos,
        seq_lens=seq_lens,
        text4=_pack_text_opt(text, sigma),
        sa_abs=sa_abs,
    )


def build_bifmindex(
    seqs: list[np.ndarray],
    sigma: int,
    alphabet_name: str,
    rate: int = 16,
    threads: int = 1,
    mirrored: bool = False,
) -> BiFMIndex:
    """``threads`` >= 2 builds the forward and reversed suffix arrays
    concurrently (the two SA-IS calls dominate build wall-clock and the
    native code + NumPy release the GIL) — the reference's ``threadNbr``
    ctor analogue (rbi-index-dna4.cpp:75 uses 10 threads).

    ``mirrored=True`` asserts the caller's collection is closed under
    reversal (rbi builds: mirrors appended) and SKIPS the reversed-text
    table entirely — the MirroredBiFMIndex optimization (fmindex.py),
    which also halves build work."""
    seqs = _ranks_of(seqs)
    seq_lens = np.array([len(s) for s in seqs], dtype=np.int64)
    text, starts = build_text(seqs, rate)
    if mirrored:
        occ, c_arr, sampled, sseq, spos, sa_abs = _build_core(text, sigma, rate, starts, seq_lens)
        occ_rev = None
    elif threads >= 2 and len(text) >= 1 << 22:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(2) as ex:
            fwd_fut = ex.submit(_build_core, text, sigma, rate, starts, seq_lens)
            rev_fut = ex.submit(_rev_occ, text, sigma)
            occ, c_arr, sampled, sseq, spos, sa_abs = fwd_fut.result()
            occ_rev = rev_fut.result()
    else:
        occ, c_arr, sampled, sseq, spos, sa_abs = _build_core(text, sigma, rate, starts, seq_lens)
        occ_rev = _rev_occ(text, sigma)

    return BiFMIndex(
        sigma=sigma,
        alphabet_name=alphabet_name,
        rate=rate,
        n=len(text),
        occ=occ,
        c_arr=c_arr,
        sampled=sampled,
        sample_seq=sseq,
        sample_pos=spos,
        seq_lens=seq_lens,
        text4=_pack_text_opt(text, sigma),
        sa_abs=sa_abs,
        occ_rev=occ_rev,
        mirrored=mirrored,
    )
