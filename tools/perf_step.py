"""Per-op microbench of the workq step's components at production shapes.

Times each component of ``workq_search``'s expand_step as an isolated
50-iteration device scan (amortizing dispatch latency), at the shapes the
e=2/100bp bench actually runs (cap ~57k, b = 16384*3 lanes).  Prints
ns/row for each — the honest attribution for where a step's time goes.

    python tools/perf_step.py [cap]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sahara_jax import CACHE_DIR  # noqa: E402

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def timed(name, fn, *args, iters=50, rows=None):
    out = fn(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(3):
        t0 = time.monotonic()
        out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.monotonic() - t0)
    per = best / iters
    print(f"{name:34s} {per * 1e6:9.1f} us/step" + (f"  {per / rows * 1e9:7.2f} ns/row" if rows else ""))
    return per


def scan50(body):
    @jax.jit
    def fn(*args):
        def step(c, _):
            return body(*c), None
        (out, *_), _ = lax.scan(step, args, None, length=50)
        return out
    return fn


def main() -> None:
    from sahara_jax.engine.device import DeviceIndex
    from sahara_jax.engine.rank import occ_row_word, rank_all_from_row
    from sahara_jax.index.fmindex import load_index
    from sahara_jax.engine.workq import _fold_rows, _fold_take, _SF_G, _SF_F, _compact

    cap = int(sys.argv[1]) if len(sys.argv) > 1 else 57344
    host = load_index(os.path.join(CACHE_DIR, "bench_index40.0_v2.idx"))
    index = DeviceIndex.from_host(host)
    sigma, sl = index.sigma, 5
    rng = np.random.default_rng(0)
    pos0 = jnp.asarray(rng.integers(0, index.n - 200, size=cap).astype(np.int32))
    par0 = jnp.asarray(rng.integers(0, cap, size=cap).astype(np.int32))
    vec = jnp.asarray(rng.integers(1, 1 << 20, size=cap).astype(np.int32))
    occ, fold = index.occ, index.fold

    # 1. fused two-edge occ gather (the rank core): 2*cap wide rows
    def occ2(pos, par, v):
        p2 = jnp.concatenate([pos, pos + 17])
        rows = occ_row_word(occ, p2 >> 5, fold, 2 * sigma)
        r = rank_all_from_row(rows, sigma, p2)
        r = lax.optimization_barrier(r)
        return (pos + r[:cap, 0] % 7, par, v)

    timed("occ fused_rank (2 rows/state)", scan50(occ2), pos0, par0, vec, rows=cap)

    # 2. narrow stacked S5 gather (packed mode)
    def s5g(pos, par, v):
        S5 = lax.optimization_barrier(jnp.stack([pos, v, pos + v, v ^ pos, v + 1], axis=1))
        P = jnp.take(S5, par, axis=0)
        return (pos + P[:, 0] % 3, par, v + P[:, 3] % 5)

    timed("S5 narrow [cap,5] row gather", scan50(s5g), pos0, par0, vec, rows=cap)

    # 3. folded state gather (fold mode)
    def sfg(pos, par, v):
        SF = lax.optimization_barrier(_fold_rows([pos, v, pos + v, v ^ pos, v + 1], _SF_G, _SF_F))
        P = _fold_take(SF, par, _SF_G, _SF_F)
        return (pos + P[:, 0] % 3, par, v + P[:, 3] % 5)

    timed("folded state gather", scan50(sfg), pos0, par0, vec, rows=cap)

    # 4. P3 narrow [cap*sl, 3] gather
    def p3g(pos, par, v):
        cnt = jnp.stack([v + i for i in range(sl)], axis=1)
        P3 = lax.optimization_barrier(
            jnp.stack([cnt.reshape(-1), (cnt + 1).reshape(-1), (cnt ^ 2).reshape(-1)], axis=1)
        )
        G = jnp.take(P3, par * sl + (v & 3), axis=0)
        return (pos + G[:, 0] % 3, par, v + G[:, 1] % 5)

    timed("P3 narrow [cap*sl,3] gather", scan50(p3g), pos0, par0, vec, rows=cap)

    # 5. flat 1-D takes x5 (unpacked mode)
    def flat5(pos, par, v):
        a = lax.optimization_barrier(pos + v)
        out = pos
        for i in range(5):
            out = out + jnp.take(a, jnp.minimum(par + i, cap - 1))
        return (out, par, v)

    timed("5 flat 1-D takes", scan50(flat5), pos0, par0, vec, rows=cap)

    # 6. dedup block (scatter-min + winner gather + compares)
    def dd(pos, par, v):
        cb = (cap - 1).bit_length()
        ht = 1 << cb
        row_ids = jnp.arange(cap, dtype=jnp.int32)
        hsh = (pos * jnp.int32(-1640531527) ^ v * jnp.int32(-2048144777)) & (ht - 1)
        pri = (v & 3) << cb | row_ids
        table = jnp.full(ht, np.iinfo(np.int32).max, dtype=jnp.int32).at[hsh].min(pri)
        win = jnp.minimum(jnp.take(table, hsh) & (ht - 1), cap - 1)
        S5 = lax.optimization_barrier(jnp.stack([pos, v, pos + v, v ^ pos], axis=1))
        W = jnp.take(S5, win, axis=0)
        same = (W[:, 0] == pos) & (W[:, 1] == v)
        return (jnp.where(same & (win != row_ids), pos, pos + 1), par, v)

    timed("dedup (scatter-min+gather+cmp)", scan50(dd), pos0, par0, vec, rows=cap)

    # 7. compaction (integer prefix sum + scatter) at e_used=11 flags
    e_used = 11
    fl0 = jnp.asarray(rng.random(cap * e_used) < 0.08)
    payload = jnp.asarray(rng.integers(0, cap * 16, size=cap * e_used).astype(np.int32))

    def comp(fl, pay, v):
        sel, total = _compact(fl, pay, cap)
        return (jnp.roll(fl, 1), pay, v + sel % 3)

    timed("compaction (11 cols)", scan50(comp), fl0, payload, vec, rows=cap)

    # 8. candidate flag math + branch decode (elementwise block)
    def flags(pos, par, v):
        err = v & 3
        cnt = jnp.stack([pos + i for i in range(sl)], axis=1)
        qc = v & 7
        syms = jnp.arange(1, sl, dtype=jnp.int32)[None, :]
        e_ms = err[:, None] + (qc[:, None] != syms)
        ok = (cnt[:, 1:] > 0) & (e_ms <= 2) & (e_ms >= 0)
        cols = jnp.concatenate([ok, ok, ok[:, :3]], axis=1)
        return (pos + cols.sum(axis=1).astype(jnp.int32), par, v)

    timed("flag math (elementwise)", scan50(flags), pos0, par0, vec, rows=cap)

    # 9. tape-word flat gather (1 per state)
    lane_tape = jnp.asarray(rng.integers(0, 1 << 22, size=16384 * 3 * 100).astype(np.int32))

    def tw(pos, par, v):
        word = lax.optimization_barrier(jnp.take(lane_tape, jnp.minimum(v, 16384 * 300 - 1)))
        return (pos + (word & 3), par, v)

    timed("tape word flat gather", scan50(tw), pos0, par0, vec, rows=cap)


if __name__ == "__main__":
    main()


def extra():
    """Combined [cap, 20] state+product gather + sym one-hot select."""
    from sahara_jax.engine.device import DeviceIndex
    from sahara_jax.index.fmindex import load_index

    cap = int(sys.argv[1]) if len(sys.argv) > 1 else 57344
    host = load_index(os.path.join(CACHE_DIR, "bench_index40.0_v2.idx"))
    index = DeviceIndex.from_host(host)
    sl = 5
    rng = np.random.default_rng(0)
    pos0 = jnp.asarray(rng.integers(0, index.n - 200, size=cap).astype(np.int32))
    par0 = jnp.asarray(rng.integers(0, cap, size=cap).astype(np.int32))
    vec = jnp.asarray(rng.integers(1, 1 << 20, size=cap).astype(np.int32))

    def s20(pos, par, v):
        cnt = jnp.stack([v + i for i in range(sl)], axis=1)
        newp = cnt + 3
        news = cnt ^ 5
        S = lax.optimization_barrier(
            jnp.concatenate([jnp.stack([pos, v, pos + v, v ^ pos, v + 1], axis=1), cnt, newp, news], axis=1)
        )  # [cap, 20]
        P = jnp.take(S, par, axis=0)
        sym = (v & 3) + 1
        lane = jnp.asarray(np.arange(sl, dtype=np.int32))[None, :]
        oh = lane == sym[:, None]
        g_cnt = jnp.where(oh, P[:, 5:10], 0).sum(axis=1)
        g_newp = jnp.where(oh, P[:, 10:15], 0).sum(axis=1)
        g_news = jnp.where(oh, P[:, 15:20], 0).sum(axis=1)
        return (pos + P[:, 0] % 3 + g_cnt % 2, par, v + g_newp % 5 + g_news % 3)

    timed("S20 combined gather+symselect", scan50(s20), pos0, par0, vec, rows=cap)

    # dedup variant reusing the S20 matrix for the winner gather as well
    def s20dd(pos, par, v):
        cb = (cap - 1).bit_length()
        ht = 1 << cb
        row_ids = jnp.arange(cap, dtype=jnp.int32)
        S = lax.optimization_barrier(jnp.stack([pos, v, pos + v, v ^ pos], axis=1))
        hsh = (pos * jnp.int32(-1640531527) ^ v * jnp.int32(-2048144777)) & (ht - 1)
        pri = (v & 3) << cb | row_ids
        table = jnp.full(ht, np.iinfo(np.int32).max, dtype=jnp.int32).at[hsh].min(pri)
        win = jnp.minimum(jnp.take(table, hsh) & (ht - 1), cap - 1)
        W = jnp.take(S, win, axis=0)
        same = (W[:, 0] == pos) & (W[:, 1] == v)
        return (jnp.where(same & (win != row_ids), pos, pos + 1), par, v)

    timed("dedup scatter-min only", scan50(lambda pos, par, v: (
        jnp.full(1 << (cap - 1).bit_length(), np.iinfo(np.int32).max, dtype=jnp.int32)
        .at[(pos * jnp.int32(-1640531527)) & ((1 << (cap - 1).bit_length()) - 1)]
        .min((v & 3) << (cap - 1).bit_length() | jnp.arange(cap, dtype=jnp.int32))[:cap] % 7 + pos,
        par, v)), pos0, par0, vec, rows=cap)


if os.environ.get("PERF_EXTRA") == "1":
    extra()
