"""Kmer sketch differential tests + AdaptiveKmerIndex sigma buckets.

CONFORMANCE.md deviation 6: the sketch is a documented re-derivation (not
bit-compatible with ivsigma), so its correctness story is (a) differential
tests of every selection rule against an independent brute-force second
implementation (this file — the vectorized production code in
sahara_jax/kmer.py shares no code with the reference loops below), and
(b) index<->search self-consistency across ALL the reference's sigma
buckets {3,4,5,6,16,32,64,128} (AdaptiveKmerIndex.cpp:27-41) and both
kmer modes (winnowing + mod, kmer-index.cpp:91-115).
"""

from __future__ import annotations

import numpy as np
import pytest

from sahara_jax.adaptive_kmer_index import AdaptiveKmerIndex, KmerConfig, _bucket_sigma
from sahara_jax.kmer import compact_encoding, mod_mers, winnowing_minimizers
from sahara_jax.native import xxh64_batch_u64

_COMP = {1: 4, 2: 3, 3: 2, 4: 1, 5: 5}


# --------------------------------------------------------------------------
# independent brute-force second implementation (pure Python loops)
# --------------------------------------------------------------------------


def _brute_encode_one(kmer: list[int], sigma: int) -> int:
    v = 0
    for r in kmer:
        v = v * (sigma - 1) + (int(r) - 1)
    return v


def _brute_compact(ranks, k, sigma, canonical):
    out = []
    ranks = list(ranks)
    for i in range(len(ranks) - k + 1):
        w = [int(r) for r in ranks[i : i + k]]
        v = _brute_encode_one(w, sigma)
        if canonical:
            rc = [_COMP[r] for r in reversed(w)]
            v = min(v, _brute_encode_one(rc, sigma))
        out.append(v)
    return out


def _hash_one(v: int) -> int:
    return int(xxh64_batch_u64(np.asarray([v], dtype=np.uint64))[0])


def _brute_winnowing(ranks, k, window, sigma):
    encs = _brute_compact(ranks, k, sigma, canonical=True)
    hashes = [_hash_one(v) for v in encs]
    w = max(1, min(window, len(hashes)))
    out = []
    for i in range(len(hashes) - w + 1):
        m = min(hashes[i : i + w])
        if not out or out[-1] != m:
            out.append(m)
    return out


def _brute_mod(ranks, k, mod_exp, sigma):
    encs = _brute_compact(ranks, k, sigma, canonical=True)
    mask = (1 << mod_exp) - 1
    return [h for h in (_hash_one(v) for v in encs) if h & mask == 0]


@pytest.mark.parametrize("k,canonical", [(3, False), (3, True), (8, True), (16, True)])
def test_compact_encoding_matches_brute(k, canonical):
    rng = np.random.default_rng(11)
    for n in (k, k + 1, 40, 200):
        ranks = rng.integers(1, 5, size=n).astype(np.uint8)
        got = compact_encoding(ranks, k, 6, canonical=canonical)
        want = _brute_compact(ranks, k, 6, canonical)
        assert got.tolist() == want


def test_compact_encoding_canonical_is_strand_symmetric():
    rng = np.random.default_rng(12)
    ranks = rng.integers(1, 5, size=64).astype(np.uint8)
    rc = np.asarray([_COMP[int(r)] for r in ranks[::-1]], dtype=np.uint8)
    fwd = sorted(compact_encoding(ranks, 9, 6, canonical=True).tolist())
    rev = sorted(compact_encoding(rc, 9, 6, canonical=True).tolist())
    assert fwd == rev


@pytest.mark.parametrize("k,window", [(8, 1), (8, 5), (8, 12), (16, 8)])
def test_winnowing_matches_brute(k, window):
    rng = np.random.default_rng(13)
    for n in (k, 30, 173):
        ranks = rng.integers(1, 5, size=n).astype(np.uint8)
        got = winnowing_minimizers(ranks, k, window, 6)
        assert got.tolist() == _brute_winnowing(ranks, k, window, 6)


def test_winnowing_collapses_repeat_selections():
    # a long tandem repeat: the same minimizer wins many consecutive
    # windows and must be emitted once per run, not per window
    unit = np.asarray([1, 3, 2, 4, 2, 1, 4, 3, 1, 2], dtype=np.uint8)
    ranks = np.tile(unit, 12)
    got = winnowing_minimizers(ranks, 8, 6, 6)
    assert len(got) < len(ranks) - 8 + 1 - 6 + 1  # strictly fewer than windows
    assert all(a != b for a, b in zip(got.tolist(), got.tolist()[1:]))


@pytest.mark.parametrize("mod_exp", [1, 3, 5])
def test_mod_mers_match_brute(mod_exp):
    rng = np.random.default_rng(14)
    ranks = rng.integers(1, 5, size=400).astype(np.uint8)
    got = mod_mers(ranks, 10, mod_exp, 6)
    assert got.tolist() == _brute_mod(ranks, 10, mod_exp, 6)
    mask = np.uint64((1 << mod_exp) - 1)
    assert not np.any(got & mask)


# --------------------------------------------------------------------------
# AdaptiveKmerIndex sigma buckets (synthetic dense vocabularies)
# --------------------------------------------------------------------------


def test_bucket_sigma_boundaries():
    assert _bucket_sigma(2) == 3
    assert _bucket_sigma(3) == 4
    assert _bucket_sigma(5) == 6
    assert _bucket_sigma(6) == 16
    assert _bucket_sigma(15) == 16
    assert _bucket_sigma(16) == 32
    assert _bucket_sigma(127) == 128
    from sahara_jax.utils.errors import SaharaError

    with pytest.raises(SaharaError):
        _bucket_sigma(128)


@pytest.mark.parametrize("vocab", [2, 5, 14, 30, 62, 126])
def test_adaptive_index_buckets_roundtrip(tmp_path, vocab):
    """Every sigma bucket: build over a dense synthetic kmer vocabulary,
    exact-search planted subsequences, check located positions, and
    save/load roundtrip (PairedFlattenedBitvectors_512_64k analogue —
    the occ layout must hold large alphabets, SURVEY.md §2.2)."""
    rng = np.random.default_rng(100 + vocab)
    seqs = [rng.integers(1, vocab + 1, size=ln).astype(np.int64) for ln in (300, 180)]
    cfg = KmerConfig(mode="winnowing", kmer_len=8, window=4, mod_exp=4, largest_value=vocab)
    idx = AdaptiveKmerIndex(cfg, kmer_seqs=seqs)
    assert idx.sigma == _bucket_sigma(vocab)

    queries = []
    want = []
    for sid, s in enumerate(seqs):
        for p in (0, 37, len(s) - 12):
            queries.append(s[p : p + 12].copy())
            want.append((sid, p))
    res = idx.search(queries)
    for (sid, p), hits in zip(want, res):
        assert (sid, p) in hits, f"vocab={vocab}: planted ({sid},{p}) missing"

    # save/load roundtrip preserves search results + the uniq map
    uniq = {int(i): int(i) for i in range(1, vocab + 1)}
    path = str(tmp_path / f"bucket{vocab}.kmer.idx")
    idx.save(path, uniq)
    idx2, uniq2 = AdaptiveKmerIndex.load(path)
    assert uniq2 == uniq
    assert idx2.sigma == idx.sigma
    res2 = idx2.search(queries)
    assert [sorted(h) for h in res2] == [sorted(h) for h in res]


def test_kmer_cli_mod_mode_end_to_end(tmp_path, capsys):
    """mod-mer mode through the real CLI: index + search, planted reads
    recovered (kmer-index.cpp:101-104 mod path; previously only winnowing
    had CLI coverage)."""
    from sahara_jax.cli.main import main

    rng = np.random.default_rng(77)
    chars = np.asarray(list("ACGT"))
    ref = "".join(chars[rng.integers(0, 4, size=4000)])
    ref_fa = tmp_path / "ref.fasta"
    ref_fa.write_text(f">chr1\n{ref}\n")
    reads = []
    for i in range(8):
        p = int(rng.integers(0, len(ref) - 600))
        reads.append(f">r{i}\n{ref[p : p + 600]}\n")
    q_fa = tmp_path / "q.fasta"
    q_fa.write_text("".join(reads))

    out = tmp_path / "out.txt"
    # mod 2^6 keeps ~1/64 of kmers: the dense vocabulary stays under the
    # 128 sigma ceiling (the reference enforces the same limit) while each
    # 600bp read still carries >= 6 selected kmers
    assert main(["kmer-index", str(ref_fa), "--kmer_mode", "mod", "--mod", "6", "--kmer", "10"]) == 0
    assert main([
        "kmer-search", "--index", str(ref_fa) + ".kmer.idx", "--query", str(q_fa),
        "--output", str(out),
    ]) == 0
    lines = out.read_text().strip().splitlines()
    assert lines, "mod-mer search produced no hits"
    hit_q = {int(ln.split()[0]) for ln in lines}
    # every read is a verbatim slice: its kmer stream must be found
    # (reads are doubled by the reverse-seq expansion: even ids = forward)
    assert {2 * i for i in range(8)} <= hit_q
