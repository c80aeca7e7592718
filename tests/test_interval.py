"""Interval-sharded index: hit-set parity with the single-index path,
including window-split long sequences (the >int32 mechanism, scaled down)
and the mesh-distributed interval search on the virtual CPU mesh."""

import numpy as np
import pytest

from sahara_jax.engine.device import DeviceIndex
from sahara_jax.engine.driver import search_queries, search_queries_sharded
from sahara_jax.engine.tape import compile_tape
from sahara_jax.index.build import build_bifmindex
from sahara_jax.index.shard import ShardedIndex, build_sharded_bifmindex, load_any_index, plan_shards, save_sharded
from sahara_jax.schemes import GENERATORS, expand


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(17)
    # one "long" sequence (will be window-split) + two short ones
    seqs = [
        rng.integers(1, 5, size=900).astype(np.uint8),
        rng.integers(1, 5, size=200).astype(np.uint8),
        rng.integers(1, 5, size=150).astype(np.uint8),
    ]
    m = 24
    queries = []
    for i in range(8):
        s = seqs[i % 3]
        p = (i * 37) % (len(s) - m)
        q = s[p : p + m].copy()
        if i % 2:
            q[7] = 1 + (q[7] % 4)
        queries.append(q)
    # one query straddling the window boundary of the long sequence
    queries.append(seqs[0][390 : 390 + m].copy())
    return seqs, queries


def _rows(res):
    return set(zip(res.query_id.tolist(), res.seq_id.tolist(), res.pos.tolist()))


def test_plan_shards_windows():
    plan = plan_shards([1000, 300], max_chars=400, overlap=50)
    pieces = [p for shard in plan for p in shard]
    # sequence 0 split into windows covering [0, 1000) with 50 overlap
    w0 = [(s, ln) for gid, s, ln in pieces if gid == 0]
    assert w0[0][0] == 0
    ends = [s + ln for s, ln in w0]
    starts = [s for s, ln in w0]
    assert ends[-1] == 1000
    for i in range(1, len(w0)):
        assert starts[i] == ends[i - 1] - 50
    assert all(ln <= 400 for _, ln in w0)


def test_sharded_search_matches_single(corpus):
    seqs, queries = corpus
    k = 1
    single = DeviceIndex.from_host(build_bifmindex(seqs, 6, "d_dna5"))
    want = search_queries(single, queries, k=k, generator_name="optimum", edit=True)

    sharded = build_sharded_bifmindex(seqs, 6, "d_dna5", max_chars=400, overlap=64)
    assert isinstance(sharded, ShardedIndex)
    assert sharded.num_shards >= 3
    assert 0 in sharded.windowed_gids.tolist()
    got = search_queries_sharded(sharded, queries, k=k, generator_name="optimum", edit=True)
    assert _rows(got) == _rows(want)


def test_sharded_save_load_roundtrip(corpus, tmp_path):
    seqs, queries = corpus
    sharded = build_sharded_bifmindex(seqs, 6, "d_dna5", max_chars=400, overlap=64)
    path = tmp_path / "ref.idx"
    save_sharded(str(path), sharded)
    loaded = load_any_index(str(path))
    assert isinstance(loaded, ShardedIndex)
    assert loaded.num_shards == sharded.num_shards
    got = search_queries_sharded(loaded, queries, k=0, generator_name="optimum", edit=False)
    want = search_queries(
        DeviceIndex.from_host(build_bifmindex(seqs, 6, "d_dna5")),
        queries, k=0, generator_name="optimum", edit=False,
    )
    assert _rows(got) == _rows(want)


def test_distributed_interval_search_matches(corpus):
    import jax

    from sahara_jax.parallel.interval import distributed_interval_search
    from sahara_jax.parallel.mesh import data_mesh

    cpu = jax.devices("cpu")
    if len(cpu) < 8:
        pytest.skip("needs 8 virtual CPU devices")
    seqs, queries = corpus
    m = 24
    k = 1
    mesh = data_mesh(8, devices=cpu)
    sharded = build_sharded_bifmindex(seqs, 6, "d_dna5", max_chars=400, overlap=64)
    qarr = np.stack([q for q in queries if len(q) == m]).astype(np.int32)
    tape = compile_tape(expand(GENERATORS["optimum"].generator(0, k, 0, 0), m))
    got = distributed_interval_search(mesh, sharded, qarr, tape, edit=True)
    single = DeviceIndex.from_host(build_bifmindex(seqs, 6, "d_dna5"))
    want = search_queries(single, [q for q in queries if len(q) == m], k=k, generator_name="optimum", edit=True)
    assert _rows(got) == _rows(want)

def test_sharded_swap_path_matches_resident(corpus, monkeypatch):
    """A zero resident budget forces the swap path; hit sets must be
    identical to the resident-SV fast path (and to the single index)."""
    from sahara_jax.engine import driver

    seqs, queries = corpus
    k = 1
    sharded = build_sharded_bifmindex(seqs, 6, "d_dna5", max_chars=400, overlap=64)
    kw = dict(k=k, generator_name="optimum", edit=True)
    resident = search_queries_sharded(sharded, queries, **kw)
    assert getattr(sharded, "_resident_devs", None) is not None, "resident path not taken"
    monkeypatch.setattr(driver, "_resident_budget", lambda: 0)
    sharded2 = build_sharded_bifmindex(seqs, 6, "d_dna5", max_chars=400, overlap=64)
    swapped = search_queries_sharded(sharded2, queries, **kw)
    assert getattr(sharded2, "_resident_devs", None) is None, "swap path not taken"
    assert _rows(resident) == _rows(swapped)


def test_sharded_resident_fallback_deferral(corpus):
    """A tiny sv_part_cap forces every query into the repeat-saturated
    fallback: the resident driver must defer to the full-index scheme
    engine and still produce the exact hit set."""
    seqs, queries = corpus
    k = 1
    single = DeviceIndex.from_host(build_bifmindex(seqs, 6, "d_dna5"))
    want = search_queries(single, queries, k=k, generator_name="optimum", edit=True)
    sharded = build_sharded_bifmindex(seqs, 6, "d_dna5", max_chars=400, overlap=64)
    got = search_queries_sharded(
        sharded, queries, k=k, generator_name="optimum", edit=True, sv_part_cap=0
    )
    # residents were dropped for the full-index fallback swap-in
    assert getattr(sharded, "_resident_devs", None) is None
    assert _rows(got) == _rows(want)


def test_sharded_besthits_filters_globally(corpus, monkeypatch):
    """besthits across shards: a query whose best hit lives in shard A
    must not ALSO report worse hits found in shard B — the filter must
    apply after the cross-shard merge (on both driver paths)."""
    seqs, queries = corpus
    k = 1
    single = DeviceIndex.from_host(build_bifmindex(seqs, 6, "d_dna5"))
    want = search_queries(
        single, queries, k=k, generator_name="optimum", edit=True, mode="besthits"
    )
    from sahara_jax.engine import driver

    for budget in (None, 0):
        sharded = build_sharded_bifmindex(seqs, 6, "d_dna5", max_chars=400, overlap=64)
        if budget is not None:
            monkeypatch.setattr(driver, "_resident_budget", lambda: budget)
        got = search_queries_sharded(
            sharded, queries, k=k, generator_name="optimum", edit=True, mode="besthits"
        )
        assert _rows(got) == _rows(want), f"budget={budget}"
