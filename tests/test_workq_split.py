"""The workq engine's capacity ceiling must degrade, not fail.

When a chunk's live frontier exceeds workq.HARD_CAP even after the
doubling retries, the grouped driver splits the chunk's ACTIVE query set
in halves (same compiled shapes — no recompile) and searches the halves
synchronously, recursing until the frontier fits.  Output must be
bit-identical to an unconstrained run.  Reference framing: the reference
engine (search_ng24, search.cpp:227-231) has no static buffers and so no
such failure mode — ours must not either.
"""

from __future__ import annotations

import numpy as np

from sahara_jax.engine import driver as drv
from sahara_jax.engine import workq
from sahara_jax.engine.device import DeviceIndex
from sahara_jax.index.build import build_bifmindex


def _workload(seed: int = 0):
    rng = np.random.default_rng(seed)
    # a tandem-repeat text (wide intervals, many hits) with planted-error
    # reads: enough total frontier that 256 queries blow a shrunken cap
    # while any single query stays far under it
    unit = rng.integers(1, 5, size=251).astype(np.uint8)
    ref = np.tile(unit, 100)
    qs = []
    for _ in range(256):
        p = int(rng.integers(0, len(ref) - 36))
        q = ref[p : p + 36].copy()
        at = int(rng.integers(0, 36))
        q[at] = 1 + (q[at] - 1 + int(rng.integers(1, 4))) % 4
        qs.append(q)
    host = build_bifmindex([ref], 6, "d_dna5", rate=16)
    return DeviceIndex.from_host(host), qs


def test_hard_cap_split_is_hit_identical(monkeypatch):
    index, qs = _workload()
    kw = dict(k=1, generator_name="optimum", edit=True, mode="all", engine="workq")
    base = drv.search_queries(index, qs, **kw)
    assert len(base.query_id) > 256  # repeats: many hits per query

    drv._SPLITS = 0
    # measured for this workload: live-queue peak ~900 rows across the
    # 256 queries — a 512 ceiling (the engine's block size) forces the
    # queue past the retry ladder while any single query needs far less
    monkeypatch.setattr(workq, "HARD_CAP", 512)
    split = drv.search_queries(index, qs, **kw)
    assert drv._SPLITS > 0, "shrunken HARD_CAP did not force a split"
    for f in ("query_id", "seq_id", "pos", "errors"):
        np.testing.assert_array_equal(getattr(base, f), getattr(split, f))


def test_hard_cap_split_is_hit_identical_on_mesh(monkeypatch):
    """Same degrade-not-fail contract under SPMD: overflow flags OR across
    devices, so a skewed frontier (one device owning most live states)
    must drive the same global active-set halving — and converge to the
    single-chip hit set byte-for-byte."""
    from sahara_jax.parallel import data_mesh, replicate_index

    rng = np.random.default_rng(3)
    unit = rng.integers(1, 5, size=251).astype(np.uint8)
    ref = np.tile(unit, 100)
    qs = []
    for i in range(2048):
        if i < 256:  # device 0's contiguous slice: repeat-saturated reads
            p = int(rng.integers(0, len(ref) - 36))
            q = ref[p : p + 36].copy()
        else:  # the rest: random reads, tiny frontiers
            q = rng.integers(1, 5, size=36).astype(np.uint8)
        at = int(rng.integers(0, 36))
        q[at] = 1 + (q[at] - 1 + int(rng.integers(1, 4))) % 4
        qs.append(q)
    host = build_bifmindex([ref], 6, "d_dna5", rate=16)
    index = DeviceIndex.from_host(host)
    kw = dict(k=1, generator_name="optimum", edit=True, mode="all", engine="workq")
    base = drv.search_queries(index, qs, **kw)

    mesh = data_mesh(8)
    dev_m = replicate_index(host, mesh)
    drv._SPLITS = 0
    monkeypatch.setattr(workq, "HARD_CAP", 512)
    split = drv.search_queries(dev_m, qs, mesh=mesh, **kw)
    assert drv._SPLITS > 0, "shrunken HARD_CAP did not force a split on the mesh"
    for f in ("query_id", "seq_id", "pos", "errors"):
        np.testing.assert_array_equal(getattr(base, f), getattr(split, f))


def test_predict_fit_chunk_shrinks_known_blowups():
    """Capacity memory from any sibling key (same workload, different nq)
    pre-sizes the dispatch width so the frontier fits under HARD_CAP."""
    from sahara_jax.engine.tape import compile_tape
    from sahara_jax.schemes import expand, get_generator

    index, _ = _workload()
    tape = compile_tape(expand(get_generator("optimum").generator(0, 1, 0, 0), 36))
    # no sibling knowledge: width unchanged
    workq._CAP_MEMORY.clear()
    assert workq.predict_fit_chunk(index, tape, 16384, edit=True) == 16384
    # fabricate a measured sibling: 1024 queries peaked at 2M live rows
    # (~2k rows/query) -> at the 8M ceiling only ~3k queries fit; the
    # predictor must halve 16384 down to 2048 (0.75 headroom)
    ph0 = workq.phase0_length(tape, True)
    key = (1024, tape.num_searches, 36, 1, ph0, True, 4, 0, int(index.n), 0)
    prof = np.zeros(8, dtype=np.int64)
    prof[3] = 2_000_000
    workq._CAP_MEMORY[key] = {"q_cap": 2 ** 21, "hq_cap": 4096, "profile": prof, "plan": None}
    assert workq.predict_fit_chunk(index, tape, 16384, edit=True) == 2048
    workq._CAP_MEMORY.clear()
