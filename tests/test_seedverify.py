"""Seed-and-verify engine: oracle equality (the engine's hit contract is
identical to the scheme engines' — tests/util.py::brute_edit_hits_minimal
and brute_approx_hits(hamming) are the spec)."""

import numpy as np
import pytest

from sahara_jax.engine.device import DeviceIndex
from sahara_jax.engine.seedverify import plan_parts, run_sv_search, sv_eligible
from sahara_jax.index.build import build_bifmindex
from sahara_jax.index.textstore import pack_text4, unpack_text4

from tests.util import brute_approx_hits, brute_edit_hits_minimal, random_seqs


def _hits_as_set(host, sv):
    starts = host.seq_starts()
    seq = np.searchsorted(starts, sv.abs_pos, side="right") - 1
    pos = sv.abs_pos - starts[seq]
    return set(zip(seq.tolist(), pos.tolist(), sv.q_idx.tolist()))


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 8, 9, 1000):
        t = rng.integers(0, 16, n).astype(np.uint8)
        assert np.array_equal(unpack_text4(pack_text4(t), n), t)


def test_plan_parts():
    assert plan_parts(100, 2) == ((0, 34), (34, 33), (67, 33))
    assert plan_parts(36, 2) == ((0, 12), (12, 12), (24, 12))
    assert plan_parts(20, 2) is None  # parts would be < MIN_PART
    assert plan_parts(12, 0) == ((0, 12),)


@pytest.mark.parametrize("edit", [True, False])
@pytest.mark.parametrize("k", [0, 1, 2])
def test_sv_matches_oracle(edit, k):
    rng = np.random.default_rng(42 + k + (100 if edit else 0))
    seqs = random_seqs(rng, 4, min_len=60, max_len=160, sigma=5)
    host = build_bifmindex(seqs, 6, "d_dna5", rate=16)
    dev = DeviceIndex.from_host(host)
    m = 36
    assert sv_eligible(dev, m, k)

    queries = []
    for _ in range(24):
        sid = int(rng.integers(0, len(seqs)))
        s = seqs[sid]
        if len(s) < m + k + 1:
            continue
        p = int(rng.integers(0, len(s) - m - k))
        q = np.array(s[p : p + m], dtype=np.uint8)
        # plant up to k errors
        for _ in range(int(rng.integers(0, k + 1))):
            kind = int(rng.integers(0, 3)) if edit else 0
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
    # plus pure-random queries (mostly misses)
    queries += [rng.integers(1, 5, m).astype(np.uint8) for _ in range(8)]

    qarr = np.stack(queries).astype(np.int32)
    sv = run_sv_search(dev, qarr, k, edit=edit)
    got = _hits_as_set(host, sv)

    want = set()
    for qi, q in enumerate(queries):
        oracle = (
            brute_edit_hits_minimal(seqs, q, k)
            if edit
            else brute_approx_hits(seqs, q, k, hamming=True)
        )
        for sid, pos in oracle:
            want.add((sid, pos, qi))
    assert got == want


@pytest.mark.parametrize("edit", [True, False])
def test_sv_err_values_minimal(edit):
    """Reported error counts are the minimal distance at that position."""
    rng = np.random.default_rng(7)
    seqs = random_seqs(rng, 2, min_len=100, max_len=150, sigma=5)
    host = build_bifmindex(seqs, 6, "d_dna5", rate=16)
    dev = DeviceIndex.from_host(host)
    m, k = 36, 2
    # exact copies: minimal distance 0 must be reported even though the
    # scheme would also admit 1- and 2-error alignments
    queries = []
    for _ in range(8):
        sid = int(rng.integers(0, len(seqs)))
        p = int(rng.integers(0, len(seqs[sid]) - m))
        queries.append(np.array(seqs[sid][p : p + m], dtype=np.uint8))
    qarr = np.stack(queries).astype(np.int32)
    sv = run_sv_search(dev, qarr, k, edit=edit)
    starts = host.seq_starts()
    seq = np.searchsorted(starts, sv.abs_pos, side="right") - 1
    pos = sv.abs_pos - starts[seq]
    by_key = {}
    for qi, s, p, e in zip(sv.q_idx, seq, pos, sv.err):
        key = (int(qi), int(s), int(p))
        by_key[key] = min(by_key.get(key, 10**9), int(e))
    for qi, q in enumerate(queries):
        # the planted exact copy must be reported with err == 0
        found0 = [key for key, e in by_key.items() if key[0] == qi and e == 0]
        assert found0, f"query {qi} lost its exact hit"


def test_sv_part_cap_fallback():
    """Repeat-saturated queries are excluded from SV and flagged for
    fallback; candidate expansion stays bounded (no multi-GB host arrays)."""
    rng = np.random.default_rng(11)
    unit = rng.integers(1, 5, 40).astype(np.uint8)
    flank = rng.integers(1, 5, 500).astype(np.uint8)
    seqs = [np.concatenate([flank, np.tile(unit, 100), flank])]
    host = build_bifmindex(seqs, 6, "d_dna5", rate=16)
    dev = DeviceIndex.from_host(host)
    m, k = 36, 2
    q_repeat = np.tile(unit, 2)[3 : 3 + m].copy()  # every part occurs ~100x
    q_unique = flank[10 : 10 + m].copy()
    qarr = np.stack([q_repeat, q_unique]).astype(np.int32)
    sv = run_sv_search(dev, qarr, k, edit=True, part_cap=8)
    assert sv.fallback is not None
    assert bool(sv.fallback[0]) and not bool(sv.fallback[1])
    # the saturated query contributed no SV hits (exactness is the driver's
    # job via workq fallback); the unique query is still exact
    assert not np.any(sv.q_idx == 0)
    got = {(s, p) for (s, p, qi) in _hits_as_set(host, sv) if qi == 1}
    want = set(brute_edit_hits_minimal(seqs, q_unique, k))
    assert got == want


@pytest.mark.parametrize("edit", [True, False])
def test_search_queries_repeat_fallback_exact(edit):
    """Adversarial poly-A / tandem-repeat corpus through the full driver:
    the per-part occurrence budget routes saturated queries through the
    workq engine automatically; the combined hit set stays exact."""
    from sahara_jax.engine.driver import search_queries

    rng = np.random.default_rng(5)
    unit = rng.integers(1, 5, 12).astype(np.uint8)
    seqs = [
        np.concatenate(
            [
                rng.integers(1, 5, 300).astype(np.uint8),
                np.tile(unit, 60),
                np.ones(200, dtype=np.uint8),  # poly-A run
            ]
        ),
        rng.integers(1, 5, 400).astype(np.uint8),
    ]
    host = build_bifmindex(seqs, 6, "d_dna5", rate=16)
    dev = DeviceIndex.from_host(host)
    m, k = 36, 2
    queries = [
        np.ones(m, dtype=np.uint8),  # poly-A read
        np.tile(unit, 5)[:m].copy(),  # tandem-repeat read
        np.asarray(seqs[1][100 : 100 + m]),  # unique read
    ]
    res = search_queries(dev, queries, k=k, edit=edit, sv_part_cap=8, chunk=8)
    got = set(zip(res.query_id.tolist(), res.seq_id.tolist(), res.pos.tolist()))
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


def test_sv_jmer_table_matches_scan():
    """Seed results with the j-mer skip table == plain scan-from-zero
    (same index with the table stripped)."""
    import dataclasses

    rng = np.random.default_rng(17)
    seqs = random_seqs(rng, 3, min_len=200, max_len=400, sigma=5)
    host = build_bifmindex(seqs, 6, "d_dna5", rate=16)
    dev = DeviceIndex.from_host(host)
    assert dev.lut is not None and dev.lut_j >= 2
    dev_nolut = dataclasses.replace(dev, lut=None, lut_j=0)
    m, k = 36, 2
    queries = np.stack(
        [np.asarray(seqs[i % 3][5 * i : 5 * i + m], dtype=np.int32) for i in range(12)]
    )
    a = run_sv_search(dev, queries, k, edit=True)
    b = run_sv_search(dev_nolut, queries, k, edit=True)
    got_a = set(zip(a.q_idx.tolist(), a.abs_pos.tolist(), a.err.tolist()))
    got_b = set(zip(b.q_idx.tolist(), b.abs_pos.tolist(), b.err.tolist()))
    assert got_a == got_b and len(got_a) >= 12


@pytest.mark.parametrize("edit", [True, False])
def test_search_queries_n_query_fallback_exact(edit):
    """Queries carrying N (rank 5) in table-covered positions are routed
    to the scheme engine (the j-mer table cannot encode them); the hit
    set stays exact."""
    from sahara_jax.engine.driver import search_queries

    rng = np.random.default_rng(8)
    seqs = [rng.integers(1, 5, size=600).astype(np.uint8)]
    # plant an N (rank 5) into the reference so N-in-query can match
    seqs[0][100] = 5
    host = build_bifmindex(seqs, 6, "d_dna5", rate=16)
    dev = DeviceIndex.from_host(host)
    m, k = 36, 2
    q_n_match = np.asarray(seqs[0][80 : 80 + m]).copy()  # contains the text N
    q_n_sub = np.asarray(seqs[0][300 : 300 + m]).copy()
    q_n_sub[m - 3] = 5  # N near the end -> table-covered -> fallback
    q_clean = np.asarray(seqs[0][200 : 200 + m]).copy()
    queries = [q_n_match, q_n_sub, q_clean]
    res = search_queries(dev, queries, k=k, edit=edit)
    got = set(zip(res.query_id.tolist(), res.seq_id.tolist(), res.pos.tolist()))
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
    assert any(t[0] == 0 for t in got)  # the N-containing window was found
    assert any(t[0] == 1 for t in got)  # fallback query still exact


def test_sv_boundary_and_sentinel():
    """Hits at sequence edges; alignments must not cross sentinels."""
    # two sequences where q matches the END of seq0 and the START of seq1
    s0 = np.array([1, 2, 3, 4] * 10, dtype=np.uint8)
    s1 = np.array([2, 2, 4, 1] * 10, dtype=np.uint8)
    seqs = [s0, s1]
    host = build_bifmindex(seqs, 6, "d_dna5", rate=16)
    dev = DeviceIndex.from_host(host)
    m, k = 24, 1
    queries = [
        s0[-m:].copy(),  # suffix of seq0
        s1[:m].copy(),  # prefix of seq1
        np.concatenate([s0[-12:], s1[:12]]),  # straddles the boundary: no hit
    ]
    qarr = np.stack(queries).astype(np.int32)
    sv = run_sv_search(dev, qarr, k, edit=True)
    got = _hits_as_set(host, sv)
    want = set()
    for qi, q in enumerate(queries):
        for sid, pos in brute_edit_hits_minimal(seqs, q, k):
            want.add((sid, pos, qi))
    assert got == want
    # the straddling query found nothing
    assert not any(t[2] == 2 for t in got)


# ---------------------------------------------------------------------------
# scheme-seeded SV (one-error seeds, plan_parts_e1): short reads whose
# exact k+1-way split would drop below MIN_PART
# ---------------------------------------------------------------------------


def test_plan_parts_e1():
    from sahara_jax.engine.seedverify import plan_parts_e1

    # 36bp/k=3: exact plan needs 4 parts of 9 (< MIN_PART) -> None; e1 plan
    # is 2 parts of 18 (any <=3-error alignment leaves a part with <=1)
    assert plan_parts(36, 3) is None
    assert plan_parts_e1(36, 3) == ((0, 18), (18, 18))
    assert plan_parts_e1(25, 2) == ((0, 13), (13, 12))
    assert plan_parts_e1(100, 7) == ((0, 25), (25, 25), (50, 25), (75, 25))
    assert plan_parts_e1(18, 3) is None  # 2 parts of 9 still too short
    assert plan_parts_e1(36, 1) is None  # k<2 never needs e1


@pytest.mark.parametrize("edit", [True, False])
@pytest.mark.parametrize("m,k", [(36, 3), (25, 2)])
def test_sv_e1_matches_oracle(edit, m, k):
    """Scheme-seeded SV vs the brute oracle on reads too short for exact
    pigeonhole seeding."""
    from sahara_jax.engine.seedverify import plan_parts_e1

    rng = np.random.default_rng(1000 + m + k + (7 if edit else 0))
    seqs = random_seqs(rng, 4, min_len=80, max_len=200, sigma=5)
    host = build_bifmindex(seqs, 6, "d_dna5", rate=16)
    dev = DeviceIndex.from_host(host)
    assert plan_parts(m, k) is None and plan_parts_e1(m, k) is not None
    assert sv_eligible(dev, m, k, seed_errors=1)
    assert not sv_eligible(dev, m, k)

    queries = []
    for _ in range(20):
        sid = int(rng.integers(0, len(seqs)))
        s = seqs[sid]
        p = int(rng.integers(0, len(s) - m - k))
        q = np.array(s[p : p + m], dtype=np.uint8)
        for _ in range(int(rng.integers(0, k + 1))):
            kind = int(rng.integers(0, 3)) if edit else 0
            at = int(rng.integers(0, len(q)))
            if kind == 0:
                q[at] = 1 + (q[at] - 1 + int(rng.integers(1, 4))) % 4
            elif kind == 1 and len(q) > 1:
                q = np.delete(q, at)
            else:
                q = np.insert(q, at, rng.integers(1, 5))
        q = q[:m]
        if len(q) < m:
            q = np.concatenate([q, rng.integers(1, 5, m - len(q)).astype(np.uint8)])
        queries.append(q.astype(np.uint8))
    queries += [rng.integers(1, 5, m).astype(np.uint8) for _ in range(6)]

    qarr = np.stack(queries).astype(np.int32)
    sv = run_sv_search(dev, qarr, k, edit=edit)
    assert sv.fallback is None or not sv.fallback.any()
    got = _hits_as_set(host, sv)

    want = set()
    for qi, q in enumerate(queries):
        oracle = (
            brute_edit_hits_minimal(seqs, q, k)
            if edit
            else brute_approx_hits(seqs, q, k, hamming=True)
        )
        for sid, pos in oracle:
            want.add((sid, pos, qi))
    assert got == want


@pytest.mark.parametrize("edit", [True, False])
def test_sv_e1_driver_matches_workq(edit):
    """search_queries auto engine (scheme-seeded SV at 36bp/k=3) must equal
    the forced workq engine's hit rows, including N-containing queries."""
    from sahara_jax.engine.driver import search_queries

    rng = np.random.default_rng(77)
    seqs = random_seqs(rng, 3, min_len=100, max_len=220, sigma=5)
    host = build_bifmindex(seqs, 6, "d_dna5", rate=16)
    dev = DeviceIndex.from_host(host)
    m, k = 36, 3
    queries = []
    for i in range(12):
        sid = int(rng.integers(0, len(seqs)))
        p = int(rng.integers(0, len(seqs[sid]) - m))
        q = np.array(seqs[sid][p : p + m], dtype=np.uint8)
        for _ in range(min(i % (k + 1), k)):
            at = int(rng.integers(0, m))
            q[at] = 1 + (q[at] - 1 + int(rng.integers(1, 4))) % 4
        queries.append(q)
    queries[3] = queries[3].copy()
    queries[3][5] = 5  # an N: e1 seeds go through workq, which handles any rank
    a = search_queries(dev, queries, k=k, edit=edit, engine="auto")
    b = search_queries(dev, queries, k=k, edit=edit, engine="workq")
    assert sorted(a.rows()) == sorted(b.rows())


def test_sv_e1_part_cap_fallback():
    """Poly-A reads saturate the per-part budget under e1 seeding too; the
    driver must re-search them exactly through the scheme engine."""
    from sahara_jax.engine.driver import search_queries
    from sahara_jax.engine.seedverify import run_sv_search as _run

    rng = np.random.default_rng(5)
    base = rng.integers(1, 5, size=1500).astype(np.uint8)
    base[200:800] = 1  # long poly-A run
    host = build_bifmindex([base], 6, "d_dna5", rate=16)
    dev = DeviceIndex.from_host(host)
    m, k = 36, 3
    qs = [np.ones(m, dtype=np.uint8), np.array(base[50 : 50 + m], dtype=np.uint8)]
    sv = _run(dev, np.stack(qs).astype(np.int32), k, edit=True, part_cap=64)
    assert sv.fallback is not None and sv.fallback[0]  # poly-A flagged
    # end-to-end: auto engine (SV + workq re-search) == forced workq
    a = search_queries(dev, qs, k=k, edit=True, engine="auto", sv_part_cap=64)
    b = search_queries(dev, qs, k=k, edit=True, engine="workq")
    assert sorted(a.rows()) == sorted(b.rows())
