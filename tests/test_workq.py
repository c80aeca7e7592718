"""Work-queue engine (v2) must produce bit-identical hit multisets to the
frontier engine (v1), which is itself oracle-verified (tests/test_approx.py)."""

import numpy as np
import pytest

from sahara_jax.engine.approx import run_scheme_search
from sahara_jax.engine.device import DeviceIndex
from sahara_jax.engine.driver import search_queries
from sahara_jax.engine.tape import compile_tape
from sahara_jax.engine.workq import run_workq_search
from sahara_jax.index.build import build_bifmindex
from sahara_jax.schemes import GENERATORS, expand, limit_to_hamming


@pytest.fixture(scope="module")
def fixture():
    rng = np.random.default_rng(7)
    seqs = [rng.integers(1, 5, size=ln).astype(np.uint8) for ln in (300, 150, 80)]
    dev = DeviceIndex.from_host(build_bifmindex(seqs, 6, "d_dna5"))
    m = 20
    qs = []
    for i in range(6):
        s = seqs[i % 3]
        p = (i * 13) % (len(s) - m)
        q = s[p : p + m].copy()
        if i % 2:
            q[5] = 1 + (q[5] % 4)
        qs.append(q)
    return seqs, dev, np.stack(qs).astype(np.int32)


def _v1_multiset(v1):
    out = []
    nq, ns, _ = v1.lb.shape
    for q in range(nq):
        for s in range(ns):
            for h in range(v1.count[q, s]):
                out.append((q * ns + s, int(v1.lb[q, s, h]), int(v1.sz[q, s, h]), int(v1.err[q, s, h])))
    return sorted(out)


@pytest.mark.parametrize("gen", ["optimum", "h2-k2"])
@pytest.mark.parametrize("edit", [False, True])
@pytest.mark.parametrize("packed", ["wide", "fold", True, False])
def test_workq_matches_frontier_engine(fixture, gen, edit, packed):
    _, dev, qarr = fixture
    k = 2
    ess = expand(GENERATORS[gen].generator(0, k, 0, 0), qarr.shape[1])
    if not edit:
        ess = limit_to_hamming(ess)
    tape = compile_tape(ess)
    v1 = run_scheme_search(dev, qarr, tape, edit=edit, s_cap=128, h_cap=64)
    v2 = run_workq_search(dev, qarr, tape, edit=edit, packed=packed)
    s2 = sorted(zip(v2.lane.tolist(), v2.lb.tolist(), v2.sz.tolist(), v2.err.tolist()))
    assert _v1_multiset(v1) == s2


@pytest.mark.parametrize("edit", [False, True])
def test_workq_packed_gathers_match_unpacked(fixture, edit):
    """The packed row-gather step must be bit-identical to the per-column
    one under dedup (the mode the driver uses)."""
    _, dev, qarr = fixture
    ess = expand(GENERATORS["optimum"].generator(0, 2, 0, 0), qarr.shape[1])
    if not edit:
        ess = limit_to_hamming(ess)
    tape = compile_tape(ess)
    a = run_workq_search(dev, qarr, tape, edit=edit, dedup=True, packed=True)
    b = run_workq_search(dev, qarr, tape, edit=edit, dedup=True, packed=False)
    c = run_workq_search(dev, qarr, tape, edit=edit, dedup=True, packed="fold")
    d = run_workq_search(dev, qarr, tape, edit=edit, dedup=True, packed="wide")
    sa = sorted(zip(a.lane.tolist(), a.lb.tolist(), a.sz.tolist(), a.err.tolist()))
    sb = sorted(zip(b.lane.tolist(), b.lb.tolist(), b.sz.tolist(), b.err.tolist()))
    sc = sorted(zip(c.lane.tolist(), c.lb.tolist(), c.sz.tolist(), c.err.tolist()))
    sd = sorted(zip(d.lane.tolist(), d.lb.tolist(), d.sz.tolist(), d.err.tolist()))
    assert sa == sb
    assert sa == sc
    assert sa == sd


def test_workq_active_mask(fixture):
    _, dev, qarr = fixture
    tape = compile_tape(expand(GENERATORS["optimum"].generator(0, 1, 0, 0), qarr.shape[1]))
    active = np.array([True, False, True, False, True, False])
    hits = run_workq_search(dev, qarr, tape, edit=False, active=active)
    lanes_q = set((hits.lane // tape.num_searches).tolist())
    assert lanes_q <= {0, 2, 4}


def test_driver_engines_agree(fixture):
    seqs, dev, qarr = fixture
    queries = [qarr[i] for i in range(qarr.shape[0])]
    r1 = search_queries(dev, queries, k=1, generator_name="optimum", edit=True, engine="frontier")
    r2 = search_queries(dev, queries, k=1, generator_name="optimum", edit=True, engine="workq")
    # workq driver dedups identical enumeration states: compare hit SETS
    s1 = set(zip(r1.query_id.tolist(), r1.seq_id.tolist(), r1.pos.tolist()))
    s2 = set(zip(r2.query_id.tolist(), r2.seq_id.tolist(), r2.pos.tolist()))
    assert s1 == s2


def test_scheme_with_many_searches_splits_into_groups(fixture):
    """01*0 at k=3 yields 10 searches > MAX_NS=8, exercising the driver's
    tape-group splitting; results must still match the Hamming oracle."""
    from tests.util import brute_approx_hits

    seqs, dev, _ = fixture
    rng = np.random.default_rng(3)
    m, k = 18, 3
    qs = [seqs[0][i * 11 : i * 11 + m].copy() for i in range(3)]
    qs[1][4] = 1 + (qs[1][4] % 4)
    r = search_queries(dev, qs, k=k, generator_name="01*0", edit=False)
    got = set(zip(r.query_id.tolist(), r.seq_id.tolist(), r.pos.tolist()))
    want = set()
    for qi, q in enumerate(qs):
        for sid, pos in brute_approx_hits(seqs, q, k, hamming=True):
            want.add((qi, sid, pos))
    assert got == want


@pytest.mark.parametrize("edit", [False, True])
def test_exact_lane_hit_sets_identical(fixture, edit, monkeypatch):
    """SAHARA_EXACT_LANE=1 (the gated saturated-state lane): located hit
    SETS must equal the default engine's.  Raw multiplicity may differ
    (E rows escape the per-step dedup; boundary dedup recovers some),
    which is why the comparison goes through the driver merge."""
    from sahara_jax.engine.driver import search_queries

    _, dev, qarr = fixture
    qs = list(qarr.astype(np.uint8))
    kw = dict(k=2, generator_name="optimum", edit=edit, engine="workq")
    base = search_queries(dev, qs, **kw)
    monkeypatch.setenv("SAHARA_EXACT_LANE", "1")
    lane = search_queries(dev, qs, **kw)
    assert base.rows() == lane.rows()
    # and with dedup OFF the multisets are bit-identical (the lane's
    # exact extension IS the single branch the full step would take)
    ess = expand(GENERATORS["optimum"].generator(0, 2, 0, 0), qarr.shape[1])
    if not edit:
        ess = limit_to_hamming(ess)
    tape = compile_tape(ess)
    monkeypatch.delenv("SAHARA_EXACT_LANE")
    a = run_workq_search(dev, qarr, tape, edit=edit, dedup=False)
    monkeypatch.setenv("SAHARA_EXACT_LANE", "1")
    b = run_workq_search(dev, qarr, tape, edit=edit, dedup=False)
    sa = sorted(zip(a.lane.tolist(), a.lb.tolist(), a.sz.tolist(), a.err.tolist()))
    sb = sorted(zip(b.lane.tolist(), b.lb.tolist(), b.sz.tolist(), b.err.tolist()))
    assert sa == sb
