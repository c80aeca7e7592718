import numpy as np
import pytest

from sahara_jax.index import build_bifmindex, build_fmindex, build_text, load_index, save_index
from sahara_jax.index.fmindex import BiFMIndex, peek_sigma
from sahara_jax.index.occtable import build_occ, rank_all_np, symbol_at_np

from tests.util import random_seqs


def test_build_text_alignment():
    seqs = [np.ones(5, dtype=np.uint8), np.ones(16, dtype=np.uint8), np.ones(1, dtype=np.uint8)]
    text, starts = build_text(seqs, 16)
    assert list(starts) == [0, 16, 48]
    assert len(text) % 16 == 0
    # at least one sentinel after each sequence
    assert text[5] == 0 and text[32] == 0 and text[49] == 0


def test_occ_rank_matches_naive():
    rng = np.random.default_rng(1)
    bwt = rng.integers(0, 6, 1000).astype(np.uint8)
    occ = build_occ(bwt, 6)
    idx = np.arange(0, 1001)
    got = rank_all_np(occ, 6, idx)
    for c in range(6):
        naive = np.concatenate([[0], np.cumsum(bwt == c)])
        assert (got[:, c] == naive).all()
    sym = symbol_at_np(occ, 6, np.arange(1000))
    assert (sym == bwt).all()


def test_index_roundtrip(tmp_path):
    rng = np.random.default_rng(2)
    seqs = random_seqs(rng, 3)
    idx = build_bifmindex(seqs, 6, "d_dna5", rate=16)
    p = tmp_path / "x.idx"
    save_index(p, idx)
    back = load_index(p)
    assert isinstance(back, BiFMIndex)
    assert back.sigma == 6 and back.rate == 16 and back.n == idx.n
    assert (back.occ == idx.occ).all()
    assert (back.occ_rev == idx.occ_rev).all()
    assert (back.sample_pos == idx.sample_pos).all()
    assert peek_sigma(p) == 6


def test_uni_index_roundtrip(tmp_path):
    rng = np.random.default_rng(4)
    seqs = random_seqs(rng, 2)
    idx = build_fmindex(seqs, 6, "d_dna5")
    p = tmp_path / "y.idx"
    save_index(p, idx)
    back = load_index(p)
    assert not isinstance(back, BiFMIndex)
    assert (back.occ == idx.occ).all()


def test_threaded_build_byte_identical():
    """threads>1 parallelizes the build (shards concurrent, fwd/rev SA
    overlapped) without changing a single byte of the index arrays."""
    import numpy as np

    from sahara_jax.index.build import build_bifmindex
    from sahara_jax.index.shard import build_sharded_bifmindex

    rng = np.random.default_rng(3)
    seqs = [rng.integers(1, 5, size=5000).astype(np.uint8) for _ in range(3)]
    a = build_bifmindex(seqs, 6, "d_dna5", threads=1)
    b = build_bifmindex(seqs, 6, "d_dna5", threads=4)
    for f in ("occ", "occ_rev", "sampled", "sample_seq", "sample_pos", "c_arr"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f

    sa = build_sharded_bifmindex(seqs, 6, "d_dna5", max_chars=6000, threads=1)
    sb = build_sharded_bifmindex(seqs, 6, "d_dna5", max_chars=6000, threads=4)
    assert sa.num_shards == sb.num_shards > 1
    for s1, s2 in zip(sa.shards, sb.shards):
        assert np.array_equal(s1.occ, s2.occ)
        assert np.array_equal(s1.occ_rev, s2.occ_rev)
