"""Search-scheme generator registry.

Equivalent of ``fmc::search_scheme::generator::all`` (reference lookup at
search.cpp:174-184; canonical name list at search_scheme.cpp:192:
backtracking, optimum, 01*0, 01*0_opt, pigeon, pigeon_opt, suffix, h2-k1,
h2-k2, h2-k3, kianfar, kucherov-k1, kucherov-k2, lam, hato, pex-td,
pex-td-l, pex-bu, pex-bu-l).

Generators are functions ``(minK, maxK, sigma, N) -> Scheme`` — sigma/N are
accepted but unused, exactly like the reference call ``generator(minK, maxK,
0, 0)`` (search.cpp:188).

Provenance: the published schemes known bit-exactly from the literature
(Kianfar et al. 2018 optimum k<=2; pigeonhole; backtracking) are encoded
directly.  Where the reference library's exact tables are not recoverable
(they live in the non-vendored fmindex-collection dependency and are only
partially published), the generator is *re-derived from its paper's
construction principle* and machine-verified: every generator must pass
``is_valid`` + ``is_complete(minK, maxK)`` (tests/test_schemes.py) — the
property the reference itself exposes as its correctness criterion
(search_scheme.cpp:133-135).
"""

from __future__ import annotations

import dataclasses

from sahara_jax.schemes.types import Generator, Scheme, Search, is_complete, raise_min_errors


def _exact_scheme() -> Scheme:
    return [Search(pi=(0,), l=(0,), u=(0,))]


def _backtracking(min_k: int, max_k: int, sigma: int = 0, n: int = 0) -> Scheme:
    """One search over one part allowing 0..k errors everywhere."""
    return [Search(pi=(0,), l=(min_k,), u=(max_k,))]


def _pigeon_scheme(parts: int, k: int, opt: bool, ramp: bool = False) -> Scheme:
    """Pigeonhole partitioning: one search per possible first-exact part.
    ``opt`` adds lower bounds: search i covers the configs whose *first*
    zero-error part is i (each part left of i then carries >= 1 error,
    giving cumulative lower bounds on the left tail).  ``ramp`` tightens
    the upper bounds to u_j = min(j, k) — complete when parts >= k + 2
    (an error budget of j suffices after j+1 parts because some window of
    j+1 parts among k+2 carries <= j errors), and far cheaper: branching
    opens one error at a time instead of all k at once."""
    searches = []
    # the first zero-error part is always <= k (k+1 parts each with >= 1
    # error would exceed the budget), so searches beyond i = k are useless
    for i in range(min(parts, k + 1)):
        pi = tuple(range(i, parts)) + tuple(range(i - 1, -1, -1))
        if ramp:
            u = tuple(min(j, k) for j in range(parts))
        else:
            u = (0,) + (k,) * (parts - 1)
        if opt:
            l = (0,) * (parts - i) + tuple(range(1, i + 1))
        else:
            l = (0,) * parts
        searches.append(Search(pi=pi, l=l, u=u))
    return searches


def _pigeon(min_k: int, max_k: int, sigma: int = 0, n: int = 0, opt: bool = False) -> Scheme:
    if max_k == 0:
        return raise_min_errors(_exact_scheme(), min_k)
    return raise_min_errors(_pigeon_scheme(max_k + 1, max_k, opt), min_k)


def _kianfar_tables(max_k: int) -> Scheme | None:
    """The published optimal solutions of Kianfar et al. 2018 for k <= 2
    (k+1 parts, non-redundant)."""
    if max_k == 0:
        return _exact_scheme()
    if max_k == 1:
        return [
            Search(pi=(0, 1), l=(0, 0), u=(0, 1)),
            Search(pi=(1, 0), l=(0, 1), u=(0, 1)),
        ]
    if max_k == 2:
        return [
            Search(pi=(0, 1, 2), l=(0, 0, 2), u=(0, 1, 2)),
            Search(pi=(2, 1, 0), l=(0, 0, 0), u=(0, 2, 2)),
            Search(pi=(1, 2, 0), l=(0, 1, 1), u=(0, 1, 2)),
        ]
    return None


def _solved(max_k: int, parts: int, max_searches: int, objective: str, edit: bool = False) -> Scheme | None:
    """Branch-and-bound solved scheme (schemes/solver.py); None when the
    instance is out of the solver's range."""
    if max_k > 3:
        return None
    from sahara_jax.schemes.solver import solved_scheme

    return solved_scheme(max_k, parts, max_searches, objective=objective, edit=edit)


def _kianfar(min_k: int, max_k: int, sigma: int = 0, n: int = 0) -> Scheme:
    """Kianfar et al. 2018 optimum search schemes, k+1 parts.

    k<=2: the published optimal solutions.  k=3: the exact published table
    is not recoverable offline — solved fresh over k+1 parts with the
    paper's objective (minimum node count subject to completeness);
    k>3 falls back to the pigeonhole construction."""
    ss = _kianfar_tables(max_k)
    if ss is None:
        ss = _solved(max_k, max_k + 1, max_k + 1, "nc")
    if ss is None:
        ss = _pigeon_scheme(max_k + 1, max_k, opt=True)
    return raise_min_errors(ss, min_k)


def _optimum(min_k: int, max_k: int, sigma: int = 0, n: int = 0) -> Scheme:
    """Optimum search schemes: the minimum-node-count complete scheme over
    either k+1 or k+2 parts (branch-and-bound, schemes/solver.py); the
    published Kianfar tables for k <= 2 (which are exactly that optimum)."""
    ss = _kianfar_tables(max_k)
    if ss is None:
        from sahara_jax.schemes.costs import node_count
        from sahara_jax.schemes.expand import expand

        cands = [
            _solved(max_k, max_k + 1, max_k + 1, "nc"),
            _solved(max_k, max_k + 2, max_k + 2, "nc"),
        ]
        cands = [c for c in cands if c is not None]
        if cands:
            ss = min(cands, key=lambda c: node_count(expand(c, 100), 4, False))
    if ss is None:
        ss = _pigeon_scheme(max_k + 1, max_k, opt=True)
    return raise_min_errors(ss, min_k)


def _zero_one_star_zero(min_k: int, max_k: int, sigma: int = 0, n: int = 0, opt: bool = False) -> Scheme:
    """'01*0' seeds (Vroland et al.): k+2 parts; every occurrence with <= k
    errors contains parts i < j with zero errors at i and j and exactly one
    error in every part between.  One search per (i, j) pair: start at part
    j, walk left to part i pinning the 0 1 ... 1 0 pattern, then finish the
    remaining parts (left tail, then right tail) with free bounds."""
    k = max_k
    parts = k + 2
    if k == 0:
        ss = [Search(pi=(1, 0), l=(0, 0), u=(0, 0))]
        return raise_min_errors(ss, min_k)
    searches = []
    for j in range(1, parts):
        for i in range(max(0, j - k - 1), j):
            run = j - i - 1  # number of exactly-1 parts between i and j
            # walk: j, j-1, ..., i  (cumulative errors pinned to 0,1,2,...,run,run)
            pi = list(range(j, i - 1, -1))
            l = [0] + list(range(1, run + 1)) + [run]
            u = list(l)
            # remaining left tail: i-1 .. 0
            for t in range(i - 1, -1, -1):
                pi.append(t)
                l.append(l[-1])
                u.append(k)
            # remaining right tail: j+1 .. parts-1
            for t in range(j + 1, parts):
                pi.append(t)
                l.append(l[-1])
                u.append(k)
            if opt and i > 0:
                # the pattern must be the leftmost one: impossible to express
                # exactly with cumulative bounds; require at least one error
                # left of part i as a partial dedup.
                l[-1] = max(l[-1], run + 1)
                if l[-1] > u[-1]:
                    continue
            searches.append(Search(pi=tuple(pi), l=tuple(l), u=tuple(u)))
    return raise_min_errors(searches, min_k)


def _suffix_filter(min_k: int, max_k: int, sigma: int = 0, n: int = 0) -> Scheme:
    """Suffix filter (Kärkkäinen & Na 2007): k+1 parts; search i scans parts
    i..p-1 with ramped thresholds ceil((j+1)*k/(p-i)) and finishes the left
    tail with free bounds."""
    k = max_k
    if k == 0:
        return raise_min_errors(_exact_scheme(), min_k)
    parts = k + 1
    searches = []
    for i in range(parts):
        span = parts - i
        pi = tuple(range(i, parts)) + tuple(range(i - 1, -1, -1))
        u = []
        for j in range(span):
            u.append(-(-((j + 1) * k) // span))  # ceil
        u[0] = 0 if span == parts else u[0]
        u += [k] * i
        # make monotone and capped
        for t in range(1, parts):
            u[t] = max(u[t], u[t - 1])
        u = [min(x, k) for x in u]
        searches.append(Search(pi=pi, l=(0,) * parts, u=tuple(u)))
    return raise_min_errors(searches, min_k)


def _h2(x: int):
    """The 'h2-kX' hand-tuned family of the reference library: re-derived
    here as schemes over k+X parts.  For X >= 2 the extra parts admit
    ramped upper bounds (u_j = min(j, k)), the main node-count saver; for
    X = 1 (no room to ramp) the scheme is solver-optimized over k+1 parts
    instead of collapsing into the plain pigeonhole."""

    def gen(min_k: int, max_k: int, sigma: int = 0, n: int = 0) -> Scheme:
        if max_k == 0:
            return raise_min_errors(_exact_scheme(), min_k)
        parts = max_k + x
        if x == 1:
            ss = _solved(max_k, parts, max_k + 2, "nc", edit=True)
            if ss is not None:
                return raise_min_errors(ss, min_k)
        return _ramped_or_fallback(parts, min_k, max_k, ramp=x >= 2)

    return gen


def _ramped_or_fallback(parts: int, min_k: int, max_k: int, ramp: bool) -> Scheme:
    """Ramped bounds when they stay complete for [minK, maxK] (the ramp +
    raised-minimum interplay can lose exact-k strata at higher k) — checked
    at generation time, falling back to the plain pigeonhole bounds."""
    if ramp:
        ss = raise_min_errors(_pigeon_scheme(parts, max_k, opt=True, ramp=True), min_k)
        if is_complete(ss, min_k, max_k):
            return ss
    return raise_min_errors(_pigeon_scheme(parts, max_k, opt=True, ramp=False), min_k)


def _kucherov(extra: int):
    """Kucherov, Salikhov & Tsur 2014 style schemes: the family's defining
    trait is the part count (k+1 or k+2 parts, exactly k+1 searches);
    the exact published tables live in the non-vendored dependency, so the
    tables are re-derived by solving that constrained instance with the
    paper's objective (expected visited nodes on random text); out of the
    solver's range, falls back to the ramped pigeonhole construction."""

    def gen(min_k: int, max_k: int, sigma: int = 0, n: int = 0) -> Scheme:
        if max_k == 0:
            return raise_min_errors(_exact_scheme(), min_k)
        if max_k == 1 and extra == 1:
            ss = [
                Search(pi=(0, 1), l=(0, 0), u=(0, 1)),
                Search(pi=(1, 0), l=(0, 1), u=(0, 1)),
            ]
            return raise_min_errors(ss, min_k)
        parts = max_k + extra
        ss = _solved(max_k, parts, max_k + 1, "wnc")
        if ss is not None:
            return raise_min_errors(ss, min_k)
        return _ramped_or_fallback(parts, min_k, max_k, ramp=extra >= 2)

    return gen


def _lam(min_k: int, max_k: int, sigma: int = 0, n: int = 0) -> Scheme:
    """Lam et al. 2009 bidirectional pigeonhole: k+1 parts, search i pins
    part i exact and expands *leftward first* (the paper's case analysis
    walks the low-index parts through the backward index before extending
    right) — no lower bounds."""
    k = max_k
    if k == 0:
        return raise_min_errors(_exact_scheme(), min_k)
    parts = k + 1
    searches = []
    for i in range(min(parts, k + 1)):
        pi = tuple(range(i, -1, -1)) + tuple(range(i + 1, parts))
        u = (0,) + (k,) * (parts - 1)
        searches.append(Search(pi=pi, l=(0,) * parts, u=u))
    return raise_min_errors(searches, min_k)


def _pex_spans_balanced(lo: int, hi: int, leaf: int) -> list[tuple[int, int]]:
    """Ancestor spans of ``leaf`` in a balanced binary partition tree over
    parts [lo, hi), innermost first."""
    if hi - lo == 1:
        return [(lo, hi)]
    mid = (lo + hi) // 2
    if leaf < mid:
        return _pex_spans_balanced(lo, mid, leaf) + [(lo, hi)]
    return _pex_spans_balanced(mid, hi, leaf) + [(lo, hi)]


def _pex_spans_chain(parts: int, leaf: int) -> list[tuple[int, int]]:
    """Ancestor spans of ``leaf`` in a left-nested chain tree
    ((((0,1),2),3)...): spans (leaf, leaf+1), (0, leaf+1), (0, leaf+2), ...,
    (0, parts)."""
    spans = [(leaf, leaf + 1)]
    if leaf > 0:
        spans.append((0, leaf + 1))
    for hi in range(leaf + 2, parts + 1):
        spans.append((0, hi))
    return spans


def _pex(balanced: bool, extra_part: bool):
    """PEX hierarchical partitioning (Navarro & Baeza-Yates): a partition
    tree whose subtree spanning s parts absorbs at most min(s-1, k) errors
    (recursive pigeonhole: a node within budget has a child within its
    budget).  One search per leaf, expanding outward through its ancestors.
    td = balanced binary tree, bu = chain tree; the -l variants use one
    extra part (k+2 leaves: shorter exact seeds, same completeness
    argument)."""

    def gen(min_k: int, max_k: int, sigma: int = 0, n: int = 0) -> Scheme:
        k = max_k
        if k == 0:
            return raise_min_errors(_exact_scheme(), min_k)
        parts = k + 1 + (1 if extra_part else 0)
        searches = []
        for leaf in range(parts):
            spans = _pex_spans_balanced(0, parts, leaf) if balanced else _pex_spans_chain(parts, leaf)
            pi: list[int] = [leaf]
            u: list[int] = [0]
            cur_lo, cur_hi = leaf, leaf + 1
            for lo, hi in spans[1:]:
                budget = min(hi - lo - 1, k)
                for p in range(cur_hi, hi):  # right additions, ascending
                    pi.append(p)
                    u.append(budget)
                for p in range(cur_lo - 1, lo - 1, -1):  # left additions
                    pi.append(p)
                    u.append(budget)
                cur_lo, cur_hi = lo, hi
            for t in range(1, parts):
                u[t] = max(u[t], u[t - 1])
            searches.append(Search(pi=tuple(pi), l=(0,) * parts, u=tuple(u)))
        return raise_min_errors(searches, min_k)

    return gen


def _hato(min_k: int, max_k: int, sigma: int = 0, n: int = 0) -> Scheme:
    """'hato' solver schemes: the reference library ships solver-produced
    tables; here we select the best complete candidate by weighted node
    count at nominal parameters (sigma=4, N=1e9, m=150)."""
    from sahara_jax.schemes.costs import weighted_node_count
    from sahara_jax.schemes.expand import expand

    candidates = [
        _optimum(min_k, max_k),
        _pigeon(min_k, max_k, opt=True),
        _h2(2)(min_k, max_k),
        _kucherov(2)(min_k, max_k),
    ]
    best, best_cost = None, float("inf")
    for ss in candidates:
        if not ss or not is_complete(ss, min_k, max_k):
            continue
        parts = ss[0].parts
        if parts > 150:
            continue
        cost = weighted_node_count(expand(ss, 150), 4, 10**9, edit=True)
        if cost < best_cost:
            best, best_cost = ss, cost
    return best if best is not None else _pigeon(min_k, max_k, opt=True)


@dataclasses.dataclass(frozen=True)
class GeneratorEntry:
    name: str
    description: str
    generator: Generator


GENERATORS: dict[str, GeneratorEntry] = {}


def _register(name: str, description: str, gen: Generator) -> None:
    GENERATORS[name] = GeneratorEntry(name=name, description=description, generator=gen)


_register("backtracking", "naive backtracking over the whole pattern", _backtracking)
_register("optimum", "optimum search schemes (branch-and-bound solved)", _optimum)
_register("01*0", "01*0 seeds (Vroland et al. 2016)", _zero_one_star_zero)
_register("01*0_opt", "01*0 seeds with partial redundancy reduction", lambda a, b, c=0, d=0: _zero_one_star_zero(a, b, c, d, opt=True))
_register("pigeon", "pigeonhole partitioning", lambda a, b, c=0, d=0: _pigeon(a, b, c, d, opt=False))
_register("pigeon_opt", "pigeonhole partitioning with lower bounds", lambda a, b, c=0, d=0: _pigeon(a, b, c, d, opt=True))
_register("suffix", "suffix filter (Kärkkäinen & Na 2007)", _suffix_filter)
_register("h2-k1", "hand-tuned schemes, k+1 parts", _h2(1))
_register("h2-k2", "hand-tuned schemes, k+2 parts", _h2(2))
_register("h2-k3", "hand-tuned schemes, k+3 parts", _h2(3))
_register("kianfar", "schemes from Kianfar et al. 2018", _kianfar)
_register("kucherov-k1", "Kucherov et al. 2014, k+1 parts", _kucherov(1))
_register("kucherov-k2", "Kucherov et al. 2014, k+2 parts", _kucherov(2))
_register("lam", "Lam et al. 2009 bidirectional pigeonhole", _lam)
_register("hato", "solver-selected schemes", _hato)
_register("pex-td", "PEX hierarchical, top-down", _pex(True, False))
_register("pex-td-l", "PEX hierarchical, top-down, level-limited", _pex(True, True))
_register("pex-bu", "PEX hierarchical, bottom-up", _pex(False, False))
_register("pex-bu-l", "PEX hierarchical, bottom-up, level-limited", _pex(False, True))


def get_generator(name: str) -> GeneratorEntry:
    if name not in GENERATORS:
        names = ", ".join(GENERATORS)
        raise ValueError(f'unknown search scheme generetaror "{name}", valid generators are: {names}')
    return GENERATORS[name]
