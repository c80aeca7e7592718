"""Rank/LF primitives on the combined occ layout (jnp; XLA-fused gathers).

A rank-all query is one row gather plus a popcount.  This module is the
only implementation and the correctness reference.

Folded layout (a redesign of the reference's ``InterleavedBitvector16``,
index.cpp:87): the device occ table packs ``fold`` consecutive
2*sigma-lane occ words into one wide row ([W/fold, 2*sigma*fold]); a rank
query gathers the wide row once and selects its word group with a
constant-mask fold — pure elementwise math.  ``fold`` is chosen per sigma
to make rows at least 96 lanes wide (`pick_fold`), and 1 disables folding
(large-sigma kmer indexes, whose rows are already wide).  The 96-lane band
was tuned on another chip and has not been re-measured on the GPU.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def pick_fold(sigma: int) -> int:
    """Power-of-two words per folded occ row: lands 2*sigma*fold in the
    band of >= 96 lanes (tuned on another chip); 1 (no folding) once rows
    are wide."""
    width = 2 * sigma
    if width >= 96:
        return 1
    fold = 1
    while width * fold < 96:
        fold *= 2
    return fold


def fold_occ_rows(planar: np.ndarray, fold: int, pad_rows: int | None = None) -> np.ndarray:
    """Host-side re-layout: [W, c] -> [ceil(W/fold), c*fold] (zero-padded).
    ``pad_rows`` forces the padded word count (stacked fwd+rev tables must
    share one static offset)."""
    planar = np.asarray(planar)
    w, c = planar.shape
    wp = pad_rows if pad_rows is not None else -(-w // fold) * fold
    assert wp % fold == 0 and wp >= w
    out = np.zeros((wp, c), planar.dtype)
    out[:w] = planar
    return np.ascontiguousarray(out.reshape(wp // fold, fold * c))


def occ_row_word(occ: jax.Array, word: jax.Array, fold: int, width: int) -> jax.Array:
    """Fetch occ word rows by absolute word index from a folded table.
    ``width`` = 2*sigma (the logical row width).  Returns int32[..., width]."""
    if fold == 1:
        return jnp.take(occ, word, axis=0)
    wide = jnp.take(occ, word >> (fold.bit_length() - 1), axis=0)  # [..., width*fold]
    grp = (word & (fold - 1))[..., None]
    lane_grp = jnp.asarray(np.arange(width * fold, dtype=np.int32) // width)
    masked = jnp.where(lane_grp == grp, wide, 0)
    row = masked[..., :width]
    for g in range(1, fold):
        row = row + masked[..., g * width : (g + 1) * width]
    return row


def occ_row(occ: jax.Array, i: jax.Array, fold: int = 1, sigma: int | None = None) -> jax.Array:
    """Gather the occ rows containing position(s) i. Returns int32[..., 2s]."""
    width = occ.shape[-1] // fold if sigma is None else 2 * sigma
    return occ_row_word(occ, i >> 5, fold, width)


def rank_all_from_row(row: jax.Array, sigma: int, i: jax.Array) -> jax.Array:
    """rank-all given a pre-gathered row: int32[..., sigma] counts in bwt[0:i]."""
    ckpt = row[..., :sigma]
    bits = lax.bitcast_convert_type(row[..., sigma : 2 * sigma], jnp.uint32)
    off = (i & 31).astype(jnp.uint32)
    mask = (jnp.uint32(1) << off) - jnp.uint32(1)
    cnt = lax.population_count(bits & mask[..., None])
    return ckpt + lax.bitcast_convert_type(cnt, jnp.int32)


def rank_all(occ: jax.Array, sigma: int, i: jax.Array, fold: int = 1) -> jax.Array:
    """All-sigma ranks at position(s) i: count of each symbol in bwt[0:i]."""
    return rank_all_from_row(occ_row(occ, i, fold, sigma), sigma, i)


def rank_sym_word(
    occ: jax.Array, word: jax.Array, sym: jax.Array, i: jax.Array, fold: int, sigma: int
) -> jax.Array:
    """Rank of ONE known symbol per lane, straight from the folded wide row.

    Exact backward extension consumes a single query symbol per step;
    computing all sigma ranks (occ_row_word + rank_all_from_row) then
    selecting one wastes ~2x the elementwise work of the seed scan's hot
    step.  Here the (checkpoint, bit-plane) pair of the lane's symbol is
    selected with two one-hot folds over the RAW wide row — one pass each
    over [n, 2*sigma*fold] instead of the 8-slice fold + 6-plane popcount.

    ``word`` = absolute occ word index (i >> 5 [+ sub-table offset]),
    ``sym`` = symbol per lane, ``i`` = bit position (only i & 31 is used).
    Returns int32[n] = rank_sym(i)."""
    width = 2 * sigma
    if fold == 1:
        wide = jnp.take(occ, word, axis=0)  # [n, width]
        base = sym
    else:
        wide = jnp.take(occ, word >> (fold.bit_length() - 1), axis=0)  # [n, width*fold]
        base = (word & (fold - 1)) * width + sym
    lane = jnp.asarray(np.arange(wide.shape[-1], dtype=np.int32))[None, :]
    ckpt = jnp.where(lane == base[:, None], wide, 0).sum(axis=-1)
    bits = jnp.where(lane == (base + sigma)[:, None], wide, 0).sum(axis=-1)
    ubits = lax.bitcast_convert_type(bits, jnp.uint32)
    off = (i & 31).astype(jnp.uint32)
    mask = (jnp.uint32(1) << off) - jnp.uint32(1)
    cnt = lax.population_count(ubits & mask)
    return ckpt + lax.bitcast_convert_type(cnt, jnp.int32)


def rank_all_offset(
    occ: jax.Array, sigma: int, i: jax.Array, word_off: jax.Array, fold: int = 1
) -> jax.Array:
    """rank-all against a stacked occ table: ``word_off`` selects the
    sub-table (0 = forward, rev_rows = reversed) per query position."""
    row = occ_row_word(occ, (i >> 5) + word_off, fold, 2 * sigma)
    return rank_all_from_row(row, sigma, i)


def symbol_from_row(row: jax.Array, sigma: int, i: jax.Array) -> jax.Array:
    """BWT symbol at row position i, decoded from the bit-planes."""
    bits = lax.bitcast_convert_type(row[..., sigma : 2 * sigma], jnp.uint32)
    off = (i & 31).astype(jnp.uint32)
    sel = (bits >> off[..., None]) & jnp.uint32(1)
    return jnp.argmax(sel, axis=-1).astype(jnp.int32)


def lf(occ: jax.Array, c_arr: jax.Array, sigma: int, i: jax.Array, fold: int = 1) -> jax.Array:
    """LF-mapping: row of the suffix one position earlier in the text."""
    row = occ_row(occ, i, fold, sigma)
    c = symbol_from_row(row, sigma, i)
    r = rank_all_from_row(row, sigma, i)
    rank_c = jnp.take_along_axis(r, c[..., None], axis=-1)[..., 0]
    return jnp.take(c_arr, c) + rank_c


def sampled_bit(sampled: jax.Array, i: jax.Array, fold: int = 1) -> jax.Array:
    """1 iff SA row i is sampled (int32)."""
    row = occ_row_word(sampled, i >> 5, fold, 2)
    bits = lax.bitcast_convert_type(row[..., 1], jnp.uint32)
    off = (i & 31).astype(jnp.uint32)
    return lax.bitcast_convert_type((bits >> off) & jnp.uint32(1), jnp.int32)


def sampled_rank(sampled: jax.Array, i: jax.Array, fold: int = 1) -> jax.Array:
    """Number of sampled rows before row i (the sample slot of row i)."""
    row = occ_row_word(sampled, i >> 5, fold, 2)
    ckpt = row[..., 0]
    bits = lax.bitcast_convert_type(row[..., 1], jnp.uint32)
    off = (i & 31).astype(jnp.uint32)
    mask = (jnp.uint32(1) << off) - jnp.uint32(1)
    cnt = lax.population_count(bits & mask)
    return ckpt + lax.bitcast_convert_type(cnt, jnp.int32)
