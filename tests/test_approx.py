"""Conformance tests for the lockstep scheme-search engine against
brute-force oracles (SURVEY.md §4: unit-test kernels against a naive
FM-index; planted-read recovery as the integration oracle)."""

import numpy as np
import pytest

from sahara_jax.engine.device import DeviceIndex
from sahara_jax.engine.driver import search_queries
from sahara_jax.index.build import build_bifmindex
from tests.util import brute_approx_hits, brute_edit_hits_minimal, random_seqs

SIGMA = 6  # d_dna5


@pytest.fixture(scope="module")
def small_index():
    rng = np.random.default_rng(7)
    # DNA-like: symbols 1..4 only (N rare in practice)
    seqs = [rng.integers(1, 5, size=ln).astype(np.uint8) for ln in (300, 150, 80)]
    host = build_bifmindex(seqs, SIGMA, "d_dna5", rate=16)
    dev = DeviceIndex.from_host(host)
    return seqs, dev


def _mutate(rng, q, n_sub):
    q = q.copy()
    pos = rng.choice(len(q), size=n_sub, replace=False)
    for p in pos:
        q[p] = 1 + (q[p] - 1 + rng.integers(1, 4)) % 4
    return q


def _make_queries(rng, seqs, m, count):
    qs = []
    for _ in range(count):
        s = seqs[rng.integers(0, len(seqs))]
        p = rng.integers(0, len(s) - m + 1)
        qs.append(s[p : p + m].copy())
    return qs


def _hit_set(result):
    return set(zip(result.query_id.tolist(), result.seq_id.tolist(), result.pos.tolist()))


@pytest.mark.parametrize("gen", ["optimum", "pigeon_opt", "h2-k2", "backtracking"])
@pytest.mark.parametrize("k", [0, 1, 2])
def test_hamming_matches_oracle(small_index, gen, k):
    seqs, dev = small_index
    rng = np.random.default_rng(k * 31 + 5)
    m = 20
    queries = _make_queries(rng, seqs, m, 6)
    queries = [
        _mutate(rng, q, min(k, j % (k + 1))) if k else q for j, q in enumerate(queries)
    ]
    res = search_queries(dev, queries, k=k, generator_name=gen, edit=False)
    got = _hit_set(res)
    want = set()
    for qi, q in enumerate(queries):
        for sid, pos in brute_approx_hits(seqs, q, k, hamming=True):
            want.add((qi, sid, pos))
    assert got == want


@pytest.mark.parametrize("gen", ["optimum", "pigeon_opt", "h2-k2"])
@pytest.mark.parametrize("k", [1, 2])
def test_edit_matches_minimal_span_oracle(small_index, gen, k):
    seqs, dev = small_index
    rng = np.random.default_rng(k * 17 + 3)
    m = 16
    queries = _make_queries(rng, seqs, m, 5)
    # plant substitutions and indels
    mutated = []
    for j, q in enumerate(queries):
        q = q.copy()
        if j % 3 == 1 and k >= 1:
            q = np.delete(q, len(q) // 2)  # read deletion == text insertion side
        elif j % 3 == 2 and k >= 1:
            q = np.insert(q, len(q) // 2, rng.integers(1, 5))
        mutated.append(q.astype(np.uint8))
    res = search_queries(dev, mutated, k=k, generator_name=gen, edit=True)
    got = _hit_set(res)
    want = set()
    for qi, q in enumerate(mutated):
        for sid, pos in brute_edit_hits_minimal(seqs, q, k):
            want.add((qi, sid, pos))
    assert got == want


def test_edit_hits_subset_of_permissive_oracle(small_index):
    seqs, dev = small_index
    rng = np.random.default_rng(11)
    m, k = 14, 2
    queries = _make_queries(rng, seqs, m, 4)
    res = search_queries(dev, queries, k=k, generator_name="pigeon_opt", edit=True)
    for qi, sid, pos in _hit_set(res):
        ok = (sid, pos) in brute_approx_hits(seqs, queries[qi], k, hamming=False)
        assert ok, f"engine reported ({qi},{sid},{pos}) beyond edit distance {k}"


def test_planted_reads_recovered_hamming(small_index):
    seqs, dev = small_index
    rng = np.random.default_rng(23)
    m, k = 24, 2
    hits_expected = []
    queries = []
    for i in range(8):
        sid = int(rng.integers(0, len(seqs)))
        p = int(rng.integers(0, len(seqs[sid]) - m + 1))
        q = _mutate(rng, seqs[sid][p : p + m], k)
        queries.append(q)
        hits_expected.append((i, sid, p))
    res = search_queries(dev, queries, k=k, generator_name="h2-k2", edit=False)
    got = _hit_set(res)
    for exp in hits_expected:
        assert exp in got, f"planted read not recovered: {exp}"


def test_besthits_reports_only_lowest_stratum(small_index):
    seqs, dev = small_index
    rng = np.random.default_rng(29)
    m, k = 20, 2
    # query 0: exact; query 1: 1 substitution
    s = seqs[0]
    q0 = s[10 : 10 + m].copy()
    q1 = _mutate(rng, s[40 : 40 + m], 1)
    res = search_queries(dev, [q0, q1], k=k, generator_name="optimum", edit=False, mode="besthits")
    errs_q0 = res.errors[res.query_id == 0]
    errs_q1 = res.errors[res.query_id == 1]
    assert len(errs_q0) > 0 and errs_q0.max() == 0
    assert len(errs_q1) > 0 and errs_q1.max() == errs_q1.min()


def test_max_hits_caps_per_query(small_index):
    seqs, dev = small_index
    rng = np.random.default_rng(31)
    m = 12
    queries = _make_queries(rng, seqs, m, 3)
    res = search_queries(dev, queries, k=2, generator_name="pigeon_opt", edit=False, max_hits=2)
    for qi in set(res.query_id.tolist()):
        assert (res.query_id == qi).sum() <= 2


def test_mixed_length_queries_bucketed(small_index):
    seqs, dev = small_index
    rng = np.random.default_rng(37)
    queries = _make_queries(rng, seqs, 15, 2) + _make_queries(rng, seqs, 22, 2)
    res = search_queries(dev, queries, k=1, generator_name="optimum", edit=False)
    got = _hit_set(res)
    want = set()
    for qi, q in enumerate(queries):
        for sid, pos in brute_approx_hits(seqs, q, 1, hamming=True):
            want.add((qi, sid, pos))
    assert got == want


# ---------------------------------------------------------------------------
# extended oracle surface (round 3): longer reads, higher k, dna4 corpora
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["auto", "workq"])
def test_long_reads_k3_matches_oracle(small_index, engine):
    """150bp reads at k=3 (the configs[3] shape) against both the SV and
    scheme engines; S/I/D-planted and random-miss queries."""
    seqs, dev = small_index
    rng = np.random.default_rng(31)
    m, k = 150, 3
    queries = []
    for i in range(6):
        s = seqs[0] if len(seqs[0]) >= m + k + 1 else seqs[1]
        p = int(rng.integers(0, len(s) - m - k))
        q = np.array(s[p : p + m], dtype=np.uint8)
        for _ in range(int(rng.integers(0, k + 1))):
            kind = int(rng.integers(0, 3))
            at = int(rng.integers(0, len(q)))
            if kind == 0:
                q[at] = 1 + (q[at] - 1 + 1) % 4
            elif kind == 1 and len(q) > 1:
                q = np.delete(q, at)
            else:
                q = np.insert(q, at, rng.integers(1, 5))
        q = q[:m]
        if len(q) < m:
            q = np.concatenate([q, rng.integers(1, 5, m - len(q)).astype(np.uint8)])
        queries.append(q.astype(np.uint8))
    queries.append(rng.integers(1, 5, m).astype(np.uint8))  # miss

    res = search_queries(dev, queries, k=k, generator_name="optimum", edit=True, engine=engine)
    got = _hit_set(res)
    want = set()
    for qi, q in enumerate(queries):
        for sid, pos in brute_edit_hits_minimal(seqs, q, k):
            want.add((qi, sid, pos))
    assert got == want


@pytest.mark.parametrize("edit", [True, False])
def test_dna4_corpus_matches_oracle(edit):
    """d_dna4 (sigma=5) corpus end-to-end: ranks 1..4, no N rank at all."""
    rng = np.random.default_rng(32)
    seqs = [rng.integers(1, 5, size=ln).astype(np.uint8) for ln in (250, 120)]
    host = build_bifmindex(seqs, 5, "d_dna4", rate=16)
    dev = DeviceIndex.from_host(host)
    m, k = 40, 2
    queries = _make_queries(rng, seqs, m, 8)
    queries = [_mutate(rng, q, int(rng.integers(0, k + 1))) for q in queries]
    res = search_queries(dev, queries, k=k, generator_name="optimum", edit=edit)
    got = _hit_set(res)
    want = set()
    for qi, q in enumerate(queries):
        oracle = (
            brute_edit_hits_minimal(seqs, q, k)
            if edit
            else brute_approx_hits(seqs, q, k, hamming=True)
        )
        for sid, pos in oracle:
            want.add((qi, sid, pos))
    assert got == want


def test_k4_workq_matches_oracle(small_index):
    """k=4 (beyond every generator table in common use) via the solver
    generators, workq engine, Hamming + edit."""
    seqs, dev = small_index
    rng = np.random.default_rng(33)
    m, k = 60, 4
    queries = _make_queries(rng, seqs, m, 4)
    queries = [_mutate(rng, q, int(rng.integers(0, 4))) for q in queries]
    for edit in (False, True):
        res = search_queries(
            dev, queries, k=k, generator_name="pigeon_opt", edit=edit, engine="workq"
        )
        got = _hit_set(res)
        want = set()
        for qi, q in enumerate(queries):
            oracle = (
                brute_edit_hits_minimal(seqs, q, k)
                if edit
                else brute_approx_hits(seqs, q, k, hamming=True)
            )
            for sid, pos in oracle:
                want.add((qi, sid, pos))
        assert got == want, f"edit={edit}"
