"""Scheme solver: branch-and-bound construction of minimum-cost complete
search schemes.

The reference library ships per-generator tables (optimum / kianfar /
kucherov families, listed at
/root/reference/src/sahara/search_scheme.cpp:192) whose exact entries live
in the non-vendored fmindex-collection dependency.  Rather than guessing
those tables, this module *solves the optimization problem the papers
solve*: pick at most S searches over P parts minimizing a node-count
objective subject to completeness (every error configuration covered —
the same predicate the reference exposes, search_scheme.cpp:133-135).

This is a weighted set-cover problem: each candidate search has a cost
(its error-tree node count at a nominal expansion) and a coverage bitmask
over the error configurations; completeness = covering all configurations.
Candidates are enumerated exhaustively (connectivity-preserving part
orders x monotone lower/upper bound ramps), dominated candidates pruned,
and the cover solved exactly by branch-and-bound (small k) with a greedy
fallback under a node budget.
"""

from __future__ import annotations

import functools

from sahara_jax.schemes.costs import _search_node_count
from sahara_jax.schemes.expand import expand
from sahara_jax.schemes.types import Scheme, Search, generate_error_configs

_NOMINAL_LENGTH = 100
_BB_NODE_BUDGET = 400_000


def connectivity_orders(parts: int) -> list[tuple[int, ...]]:
    """All part orders where every prefix is a contiguous range (the
    bidirectional-extension requirement)."""
    orders: list[tuple[int, ...]] = []

    def rec(lo: int, hi: int, acc: list[int]):
        if len(acc) == parts:
            orders.append(tuple(acc))
            return
        if lo > 0:
            rec(lo - 1, hi, acc + [lo - 1])
        if hi < parts - 1:
            rec(lo, hi + 1, acc + [hi + 1])

    for start in range(parts):
        rec(start, start, [start])
    return orders


def _monotone_seqs(parts: int, k: int) -> list[tuple[int, ...]]:
    seqs: list[tuple[int, ...]] = []

    def rec(acc: list[int]):
        if len(acc) == parts:
            seqs.append(tuple(acc))
            return
        for v in range(acc[-1] if acc else 0, k + 1):
            rec(acc + [v])

    rec([])
    return seqs


def candidate_searches(parts: int, k: int) -> list[Search]:
    """All valid searches over ``parts`` parts with bounds <= k."""
    out = []
    monos = _monotone_seqs(parts, k)
    for pi in connectivity_orders(parts):
        for u in monos:
            for l in monos:
                if all(a <= b for a, b in zip(l, u)):
                    out.append(Search(pi=pi, l=l, u=u))
    return out


def _search_cost(s: Search, objective: str, sigma: int, n_text: float, edit: bool) -> float:
    counts = [_NOMINAL_LENGTH // s.parts] * s.parts
    for i in range(_NOMINAL_LENGTH % s.parts):
        counts[i] += 1
    es = expand([s], counts)[0]
    n = n_text if objective == "wnc" else None
    return _search_node_count(es, sigma, n, edit)


@functools.cache
def solve_scheme(
    k: int,
    parts: int,
    max_searches: int,
    objective: str = "nc",
    sigma: int = 4,
    n_text: float = 1e9,
    edit: bool = False,
) -> tuple[Search, ...] | None:
    """Minimum-cost complete scheme for [0, k] errors over ``parts`` parts
    using at most ``max_searches`` searches, or None if infeasible.

    Exact for the sizes the generator registry needs (k <= 2 always; k = 3
    within the node budget, else best-found); results are cached."""
    configs = list(generate_error_configs(parts, 0, k))
    nc = len(configs)
    full = (1 << nc) - 1
    cfg_index = {c: i for i, c in enumerate(configs)}

    # candidate -> (mask, cost); dedupe identical masks by min cost, prune
    # dominated candidates (superset coverage at <= cost)
    best_by_mask: dict[int, tuple[float, Search]] = {}
    for s in candidate_searches(parts, k):
        mask = 0
        cum_errors = [0] * nc
        ok = [True] * nc
        for step, part in enumerate(s.pi):
            for i, c in enumerate(cum_errors):
                cum_errors[i] = c + configs[i][part]
                if not (s.l[step] <= cum_errors[i] <= s.u[step]):
                    ok[i] = False
        for i, o in enumerate(ok):
            if o:
                mask |= 1 << i
        if mask == 0:
            continue
        cost = _search_cost(s, objective, sigma, n_text, edit)
        cur = best_by_mask.get(mask)
        if cur is None or cost < cur[0]:
            best_by_mask[mask] = (cost, s)
    cands = [(mask, cost, s) for mask, (cost, s) in best_by_mask.items()]
    # dominance prune
    cands.sort(key=lambda t: t[1])
    pruned: list[tuple[int, float, Search]] = []
    for mask, cost, s in cands:
        if any(pm & mask == mask and pc <= cost for pm, pc, _ in pruned):
            continue
        pruned.append((mask, cost, s))
    cands = pruned

    # per-config coverer lists, cheapest first (already cost-sorted)
    coverers: list[list[int]] = [[] for _ in range(nc)]
    for ci, (mask, _, _) in enumerate(cands):
        for i in range(nc):
            if mask >> i & 1:
                coverers[i].append(ci)
    if any(not c for c in coverers):
        return None
    min_cost_for = [cands[c[0]][1] for c in coverers]

    best: list[float | tuple | None] = [float("inf"), None]
    nodes = [0]

    def bb(covered: int, cost: float, chosen: tuple[int, ...], depth: int):
        nodes[0] += 1
        if nodes[0] > _BB_NODE_BUDGET:
            return
        if covered == full:
            if cost < best[0]:
                best[0], best[1] = cost, chosen
            return
        if depth == max_searches:
            return
        # lower bound: the most expensive still-uncovered config's cheapest
        # coverer must be paid at least once
        lb = max(
            (min_cost_for[i] for i in range(nc) if not covered >> i & 1),
            default=0.0,
        )
        if cost + lb >= best[0]:
            return
        # branch on the uncovered config with fewest coverers
        pick, fewest = -1, None
        for i in range(nc):
            if not covered >> i & 1:
                n = len(coverers[i])
                if fewest is None or n < fewest:
                    pick, fewest = i, n
        for ci in coverers[pick]:
            mask, ccost, _ = cands[ci]
            if cost + ccost >= best[0]:
                break  # coverers are cost-sorted
            if ci in chosen:
                continue
            bb(covered | mask, cost + ccost, chosen + (ci,), depth + 1)

    bb(0, 0.0, (), 0)
    if best[1] is None:
        # greedy fallback: best coverage-per-cost until complete
        covered, chosen, cost = 0, [], 0.0
        while covered != full and len(chosen) < max_searches:
            pick, score = None, 0.0
            for ci, (mask, ccost, _) in enumerate(cands):
                gain = bin(mask & ~covered).count("1")
                if gain and gain / ccost > score:
                    pick, score = ci, gain / ccost
            if pick is None:
                return None
            chosen.append(pick)
            covered |= cands[pick][0]
        if covered != full:
            return None
        best[1] = tuple(chosen)
    return tuple(cands[ci][2] for ci in best[1])


def solved_scheme(k: int, parts: int, max_searches: int, **kw) -> Scheme | None:
    ss = solve_scheme(k, parts, max_searches, **kw)
    return list(ss) if ss is not None else None
