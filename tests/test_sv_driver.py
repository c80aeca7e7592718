"""Driver-level equality: the auto-selected seed-verify engine produces the
same canonical output as the workq scheme engine for all/besthits modes."""

import numpy as np
import pytest

from sahara_jax.engine.device import DeviceIndex
from sahara_jax.engine.driver import search_queries
from sahara_jax.index.build import build_bifmindex

from tests.util import random_seqs


def _rows(res):
    return sorted(zip(res.query_id.tolist(), res.seq_id.tolist(), res.pos.tolist(), res.errors.tolist()))


@pytest.fixture(scope="module")
def workload():
    rng = np.random.default_rng(11)
    seqs = random_seqs(rng, 3, min_len=80, max_len=200, sigma=5)
    host = build_bifmindex(seqs, 6, "d_dna5", rate=16)
    dev = DeviceIndex.from_host(host)
    m = 36
    queries = []
    for _ in range(20):
        sid = int(rng.integers(0, len(seqs)))
        s = seqs[sid]
        p = int(rng.integers(0, len(s) - m))
        q = np.array(s[p : p + m], dtype=np.uint8)
        nmut = int(rng.integers(0, 3))
        for _ in range(nmut):
            at = int(rng.integers(0, m))
            q[at] = 1 + (q[at] - 1 + 1) % 4
        queries.append(q)
    queries += [rng.integers(1, 5, m).astype(np.uint8) for _ in range(4)]
    return dev, queries


@pytest.mark.parametrize("mode", ["all", "besthits"])
@pytest.mark.parametrize("edit", [True, False])
def test_sv_equals_workq(workload, mode, edit):
    dev, queries = workload
    kw = dict(k=2, edit=edit, mode=mode, chunk=16)
    r_sv = search_queries(dev, queries, engine="sv", **kw)
    r_wq = search_queries(dev, queries, engine="workq", **kw)
    assert _rows(r_sv) == _rows(r_wq)


def test_sv_max_hits(workload):
    dev, queries = workload
    r_sv = search_queries(dev, queries, k=1, edit=True, max_hits=2, engine="sv", chunk=16)
    r_wq = search_queries(dev, queries, k=1, edit=True, max_hits=2, engine="workq", chunk=16)
    assert _rows(r_sv) == _rows(r_wq)
    counts = np.unique(r_sv.query_id, return_counts=True)[1]
    assert counts.max(initial=0) <= 2


def test_auto_picks_sv_and_falls_back(workload):
    dev, queries = workload
    # m=36, k=2 -> eligible; auto == sv
    r_auto = search_queries(dev, queries, k=2, edit=True, chunk=16)
    r_sv = search_queries(dev, queries, k=2, edit=True, engine="sv", chunk=16)
    assert _rows(r_auto) == _rows(r_sv)
    # 20bp/k=2: exact parts would be < MIN_PART, but the scheme-seeded
    # (one-error) plan covers it — auto routes via SV-e1, hit set identical
    short = [q[:20] for q in queries[:6]]
    r_short = search_queries(dev, short, k=2, edit=True, chunk=8)
    r_short_wq = search_queries(dev, short, k=2, edit=True, engine="workq", chunk=8)
    assert _rows(r_short) == _rows(r_short_wq)
    # 16bp/k=2: even e1 parts (2x8) fall below MIN_PART -> sv must refuse,
    # auto falls back to workq silently
    tiny = [q[:16] for q in queries[:6]]
    r_tiny = search_queries(dev, tiny, k=2, edit=True, chunk=8)
    r_tiny_wq = search_queries(dev, tiny, k=2, edit=True, engine="workq", chunk=8)
    assert _rows(r_tiny) == _rows(r_tiny_wq)
    with pytest.raises(ValueError):
        search_queries(dev, tiny, k=2, edit=True, engine="sv", chunk=8)


def test_fused_equals_two_phase(workload, monkeypatch):
    """The fused single-dispatch SV path (driver._run_sv_fused) must be
    row-identical to the two-phase dispatch/collect path, including the
    repeat-saturated fallback flags (exercised via a tiny part_cap)."""
    dev, queries = workload
    kw = dict(k=2, edit=True, mode="all", engine="sv", chunk=16)
    r_fused = search_queries(dev, queries, **kw)
    monkeypatch.setenv("SAHARA_NO_FUSED_SV", "1")
    r_two = search_queries(dev, queries, **kw)
    assert _rows(r_fused) == _rows(r_two)


def test_fused_part_cap_fallback_matches(workload, monkeypatch):
    dev, queries = workload
    # part_cap=1 saturates most parts -> wide fallback routing through the
    # workq engine; both paths must agree on the COMBINED hit set
    kw = dict(k=2, edit=True, mode="all", engine="sv", chunk=16, sv_part_cap=1)
    r_fused = search_queries(dev, queries, **kw)
    monkeypatch.setenv("SAHARA_NO_FUSED_SV", "1")
    r_two = search_queries(dev, queries, **kw)
    assert _rows(r_fused) == _rows(r_two)


def test_fused_cap_retry(monkeypatch):
    """Genuinely overflow the fused path's candidate + hit capacities (a
    tandem-repeat reference makes every part interval wide) and assert the
    retry ladder converges to the two-phase path's output."""
    from sahara_jax.engine import driver as drv

    rng = np.random.default_rng(5)
    unit = rng.integers(1, 5, 20).astype(np.uint8)
    ref = np.concatenate([np.tile(unit, 60), rng.integers(1, 5, 400).astype(np.uint8)])
    host = build_bifmindex([ref], 6, "d_dna5", rate=16)
    dev = DeviceIndex.from_host(host)
    m, k = 36, 2
    queries = [np.array(ref[i * 7 : i * 7 + m], dtype=np.uint8) for i in range(8)]

    kw = dict(k=k, edit=True, mode="all", engine="sv", chunk=8)
    drv._FUSED_CAPS.clear()
    drv._FUSED_CAPS[(m, k, True, k + 1, 8)] = {"capR": 512, "hq_cap": 512}
    r_small = search_queries(dev, queries, **kw)
    assert drv._FUSED_CAPS[(m, k, True, k + 1, 8)]["capR"] > 512  # ladder ran
    monkeypatch.setenv("SAHARA_NO_FUSED_SV", "1")
    r_two = search_queries(dev, queries, **kw)
    assert _rows(r_small) == _rows(r_two)
    drv._FUSED_CAPS.clear()
