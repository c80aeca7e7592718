"""Search-scheme core types and correctness predicates.

This framework's equivalent of the ``fmc::search_scheme`` layer the
reference consumes (Search/Scheme shape printed at
/root/reference/src/sahara/search_scheme.cpp:146-149; predicates surfaced at
search_scheme.cpp:133-135 and isNonRedundant.h:13-40).

A ``Search`` is (pi, l, u):
  pi : the order in which the query's parts are processed (0-indexed, must
       satisfy the connectivity property: every prefix of pi is a contiguous
       range of part indices — required for bidirectional FM extension),
  l  : cumulative lower error bounds, one per processed part,
  u  : cumulative upper error bounds, one per processed part.

A ``Scheme`` is a list of Searches.  A scheme is *complete* for [minK, maxK]
if every distribution of e errors over the parts, minK <= e <= maxK, is
covered by at least one search; *non-redundant* if by exactly one
(isNonRedundant.h:13-40).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable, Iterator


@dataclasses.dataclass(frozen=True)
class Search:
    pi: tuple[int, ...]
    l: tuple[int, ...]
    u: tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "pi", tuple(int(x) for x in self.pi))
        object.__setattr__(self, "l", tuple(int(x) for x in self.l))
        object.__setattr__(self, "u", tuple(int(x) for x in self.u))

    @property
    def parts(self) -> int:
        return len(self.pi)


Scheme = list[Search]
Generator = Callable[[int, int, int, int], Scheme]


def is_valid_search(s: Search) -> bool:
    """Validity: pi is a connectivity-preserving permutation, l/u monotone
    non-decreasing, l <= u everywhere, equal lengths."""
    p = len(s.pi)
    if len(s.l) != p or len(s.u) != p or p == 0:
        return False
    if sorted(s.pi) != list(range(p)):
        return False
    lo = hi = s.pi[0]
    for x in s.pi[1:]:
        if x == hi + 1:
            hi = x
        elif x == lo - 1:
            lo = x
        else:
            return False
    for a, b in zip(s.l, s.l[1:]):
        if b < a:
            return False
    for a, b in zip(s.u, s.u[1:]):
        if b < a:
            return False
    return all(a <= b for a, b in zip(s.l, s.u))


def is_valid(ss: Scheme) -> bool:
    if not ss:
        return False
    parts = ss[0].parts
    return all(s.parts == parts and is_valid_search(s) for s in ss)


def generate_error_configs(parts: int, min_k: int, max_k: int) -> Iterator[tuple[int, ...]]:
    """All distributions of minK..maxK errors over ``parts`` parts
    (the ``generateErrorConfig`` analogue, isNonRedundant.h:30-33)."""

    def rec(prefix: list[int], remaining: int, slot: int):
        if slot == parts - 1:
            for e in range(remaining + 1):
                yield tuple(prefix + [e])
            return
        for e in range(remaining + 1):
            yield from rec(prefix + [e], remaining - e, slot + 1)

    seen_total = set()
    for cfg in rec([], max_k, 0):
        if min_k <= sum(cfg) <= max_k and cfg not in seen_total:
            seen_total.add(cfg)
            yield cfg


def covers(s: Search, config: tuple[int, ...]) -> bool:
    """Does search ``s`` enumerate the error configuration ``config``
    (errors per part, in part order)?  Cumulative errors along s.pi must lie
    within [l, u] at every step."""
    cum = 0
    for step, part in enumerate(s.pi):
        cum += config[part]
        if not (s.l[step] <= cum <= s.u[step]):
            return False
    return True


def is_complete(ss: Scheme, min_k: int, max_k: int) -> bool:
    """Every error configuration with minK..maxK total errors is covered by
    at least one search."""
    if not ss:
        return False
    parts = ss[0].parts
    return all(any(covers(s, cfg) for s in ss) for cfg in generate_error_configs(parts, min_k, max_k))


def is_non_redundant(ss: Scheme, min_k: int, max_k: int) -> bool:
    """Every error configuration is covered by *exactly one* search
    (isNonRedundant.h:13-40)."""
    if not ss:
        return False
    parts = ss[0].parts
    return all(
        sum(1 for s in ss if covers(s, cfg)) == 1 for cfg in generate_error_configs(parts, min_k, max_k)
    )


def raise_min_errors(ss: Scheme, min_k: int) -> Scheme:
    """Restrict a complete-for-[0,maxK] scheme to configs with >= minK total
    errors by raising the final lower bound (used for besthits strata — the
    reference builds exact-j schemes via generator(j, j), search.cpp:234-237)."""
    if min_k <= 0:
        return ss
    out = []
    for s in ss:
        l = list(s.l)
        l[-1] = max(l[-1], min_k)
        if l[-1] > s.u[-1]:
            continue  # search can never reach min_k errors — drop it
        # keep monotonicity (only the last entry was raised)
        out.append(Search(pi=s.pi, l=tuple(l), u=s.u))
    return out
