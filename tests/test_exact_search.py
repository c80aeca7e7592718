import numpy as np

from sahara_jax.engine.device import DeviceIndex, queries_to_device
from sahara_jax.engine.exact import exact_search
from sahara_jax.engine.locate import locate
from sahara_jax.index import build_fmindex

from tests.util import brute_exact_hits, random_seqs


def _located_sets(dev, lb, ln, n_queries, cap=4096):
    src, seq_id, pos, valid, total = locate(dev, lb, ln, cap)
    assert int(total) <= cap
    out = [set() for _ in range(n_queries)]
    src, seq_id, pos, valid = map(np.asarray, (src, seq_id, pos, valid))
    for s, sid, p, v in zip(src, seq_id, pos, valid):
        if v:
            out[s].add((int(sid), int(p)))
    return out


def test_exact_search_and_locate():
    rng = np.random.default_rng(11)
    seqs = random_seqs(rng, 4, 50, 300)
    idx = build_fmindex(seqs, 6, "d_dna5", rate=16)
    dev = DeviceIndex.from_host(idx)

    # positive queries: substrings; negatives: random
    queries = []
    for _ in range(30):
        sid = int(rng.integers(0, len(seqs)))
        s = seqs[sid]
        ln = int(rng.integers(5, min(30, len(s))))
        start = int(rng.integers(0, len(s) - ln + 1))
        queries.append(s[start : start + ln].copy())
    for _ in range(10):
        queries.append(rng.integers(1, 6, int(rng.integers(5, 30))).astype(np.uint8))

    q, qlens = queries_to_device(queries)
    lb, ln = exact_search(dev, q, qlens)
    got = _located_sets(dev, lb, ln, len(queries))
    for i, query in enumerate(queries):
        expected = brute_exact_hits(seqs, query)
        assert got[i] == expected, f"query {i}"


def test_exact_search_variable_lengths():
    rng = np.random.default_rng(12)
    seqs = [np.array([1, 2, 3, 4, 1, 2, 3, 4, 1, 2], dtype=np.uint8)]
    idx = build_fmindex(seqs, 6, "d_dna5", rate=4)
    dev = DeviceIndex.from_host(idx)
    queries = [np.array([1, 2], dtype=np.uint8), np.array([1, 2, 3, 4, 1], dtype=np.uint8)]
    q, qlens = queries_to_device(queries)
    lb, ln = exact_search(dev, q, qlens)
    got = _located_sets(dev, lb, ln, 2)
    assert got[0] == {(0, 0), (0, 4), (0, 8)}
    assert got[1] == {(0, 0), (0, 4)}


def test_empty_interval_locate():
    rng = np.random.default_rng(13)
    seqs = random_seqs(rng, 1, 40, 60)
    idx = build_fmindex(seqs, 6, "d_dna5")
    dev = DeviceIndex.from_host(idx)
    lb = np.array([0, 5], dtype=np.int32)
    ln = np.array([0, 0], dtype=np.int32)
    src, seq_id, pos, valid, total = locate(dev, lb, ln, 64)
    assert int(total) == 0
    assert not np.asarray(valid).any()
