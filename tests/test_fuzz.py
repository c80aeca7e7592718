"""Randomized differential sweep: the three engines and the brute-force
oracle must agree on the hit set for random (corpus, m, k, metric, mode)
configurations.  Seeds are fixed — failures reproduce exactly.

This is the cross-engine safety net for interactions no targeted test
enumerates (bucket boundaries, fallback routing, mirrored indexes,
short/long parts, N handling)."""

import numpy as np
import pytest

from sahara_jax.engine.device import DeviceIndex
from sahara_jax.engine.driver import search_queries
from sahara_jax.index.build import build_bifmindex
from tests.util import brute_approx_hits, brute_edit_hits_minimal

CONFIGS = [
    # (seed, sigma, n_seqs, seq_len, m, k, edit, mode)
    (101, 6, 2, 250, 24, 1, True, "all"),
    (102, 6, 3, 180, 30, 2, True, "all"),
    (103, 6, 1, 400, 40, 2, False, "all"),
    (104, 5, 2, 300, 36, 3, True, "all"),
    (105, 6, 2, 220, 33, 2, True, "besthits"),
    (106, 6, 2, 350, 45, 1, False, "besthits"),
    (107, 5, 1, 500, 60, 4, True, "all"),
    (108, 6, 4, 120, 21, 1, True, "all"),
]


def _gen_case(seed, sigma, n_seqs, seq_len, m, k, edit):
    rng = np.random.default_rng(seed)
    hi = sigma - 1 if sigma <= 5 else 4  # rare N handled by dedicated tests
    seqs = [rng.integers(1, hi + 1, size=seq_len).astype(np.uint8) for _ in range(n_seqs)]
    queries = []
    for i in range(10):
        s = seqs[i % n_seqs]
        p = int(rng.integers(0, max(len(s) - m - k, 1)))
        q = np.array(s[p : p + m + k], dtype=np.uint8)
        for _ in range(int(rng.integers(0, k + 1))):
            kind = int(rng.integers(0, 3)) if edit else 0
            at = int(rng.integers(0, min(len(q), m)))
            if kind == 0:
                q[at] = 1 + (q[at] - 1 + int(rng.integers(1, max(hi, 2)))) % hi
            elif kind == 1 and len(q) > 1:
                q = np.delete(q, at)
            else:
                q = np.insert(q, at, int(rng.integers(1, hi + 1)))
        q = q[:m]
        if len(q) < m:
            q = np.concatenate([q, rng.integers(1, hi + 1, m - len(q)).astype(np.uint8)])
        queries.append(q.astype(np.uint8))
    queries.append(rng.integers(1, hi + 1, m).astype(np.uint8))  # likely miss
    return seqs, queries


def _oracle_rows(seqs, queries, k, edit, mode):
    rows = []
    for qi, q in enumerate(queries):
        hits = (
            brute_edit_hits_minimal(seqs, q, k, return_err=True)
            if edit
            else brute_approx_hits(seqs, q, k, hamming=True, return_err=True)
        )
        rows.extend((qi, sid, pos, err) for (sid, pos), err in hits.items())
    if mode == "besthits":
        best = {}
        for qi, sid, pos, err in rows:
            best[qi] = min(best.get(qi, 10**9), err)
        rows = [r for r in rows if r[3] == best[r[0]]]
    return {(qi, sid, pos) for qi, sid, pos, _ in rows}


@pytest.mark.parametrize("cfg", CONFIGS, ids=[str(c[0]) for c in CONFIGS])
def test_engines_agree_with_oracle(cfg):
    seed, sigma, n_seqs, seq_len, m, k, edit, mode = cfg
    seqs, queries = _gen_case(seed, sigma, n_seqs, seq_len, m, k, edit)
    host = build_bifmindex(seqs, sigma, "d_dna5" if sigma == 6 else "d_dna4", rate=16)
    dev = DeviceIndex.from_host(host)
    want = _oracle_rows(seqs, queries, k, edit, mode)
    for engine in ("auto", "workq", "approx"):
        res = search_queries(
            dev, queries, k=k, generator_name="pigeon_opt", edit=edit,
            mode=mode, engine=engine,
        )
        got = set(zip(res.query_id.tolist(), res.seq_id.tolist(), res.pos.tolist()))
        assert got == want, f"seed={seed} engine={engine}"


ENRICHED_CONFIGS = [
    # (seed, m, k, edit, mode) over a make_genome corpus (satellites,
    # LINE-like copies, poly-A/telomeric runs, N gaps — sim/corpus.py)
    (201, 30, 2, True, "all"),
    (202, 36, 3, True, "all"),   # scheme-seeded SV territory
    (203, 40, 2, False, "all"),
    (204, 33, 2, True, "besthits"),
]


@pytest.mark.parametrize("cfg", ENRICHED_CONFIGS, ids=[str(c[0]) for c in ENRICHED_CONFIGS])
def test_engines_agree_on_enriched_genome(cfg):
    """All engines vs the brute oracle on the repeat/low-complexity/N-gap
    enriched corpus (the chr21 proxy, sim/corpus.py): satellites stress the
    SV part budget + fallback routing, N gaps stress rank-5 handling."""
    from sahara_jax.sim.corpus import make_genome

    seed, m, k, edit, mode = cfg
    rng = np.random.default_rng(seed)
    ref, _ = make_genome(
        rng, 4000, satellite_frac=0.08, lowcomp_frac=0.04, n_gap_frac=0.02
    )
    seqs = [ref[:2500].copy(), ref[2500:].copy()]
    queries = []
    for i in range(12):
        s = seqs[i % 2]
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
                q = np.insert(q, at, int(rng.integers(1, 5)))
        q = q[:m]
        if len(q) < m:
            q = np.concatenate([q, rng.integers(1, 5, m - len(q)).astype(np.uint8)])
        queries.append(q.astype(np.uint8))
    queries.append(np.ones(m, dtype=np.uint8))  # poly-A: part-budget stressor

    host = build_bifmindex(seqs, 6, "d_dna5", rate=16)
    dev = DeviceIndex.from_host(host)
    want = _oracle_rows(seqs, queries, k, edit, mode)
    for engine in ("auto", "workq"):
        res = search_queries(
            dev, queries, k=k, generator_name="pigeon_opt", edit=edit,
            mode=mode, engine=engine,
        )
        got = set(zip(res.query_id.tolist(), res.seq_id.tolist(), res.pos.tolist()))
        assert got == want, f"seed={seed} engine={engine}"
