"""Property tests for the search-scheme layer.

Mirrors the correctness predicates the reference itself exposes
(search_scheme.cpp:133-135: valid / complete / non-redundant) — every
generator must produce valid + complete schemes for every (minK, maxK) the
search paths use: (0, k) for all-mode and (j, j) for besthits strata
(search.cpp:227-240).
"""

import pytest

from sahara_jax.schemes import (
    GENERATORS,
    expand,
    expand_count,
    is_complete,
    is_non_redundant,
    is_valid,
    limit_to_hamming,
)
from sahara_jax.schemes.costs import node_count, optimize_by_wnc, weighted_node_count
from sahara_jax.schemes.expand import part_directions
from sahara_jax.schemes.types import Search, covers, generate_error_configs


ALL_NAMES = sorted(GENERATORS)


@pytest.mark.parametrize("name", ALL_NAMES)
@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_generator_valid_and_complete(name, k):
    ss = GENERATORS[name].generator(0, k, 0, 0)
    assert ss, f"{name} produced empty scheme for k={k}"
    assert is_valid(ss), f"{name} invalid for k={k}: {ss}"
    assert is_complete(ss, 0, k), f"{name} incomplete for k={k}: {ss}"


@pytest.mark.parametrize("name", ALL_NAMES)
@pytest.mark.parametrize("k", [1, 2, 3])
def test_generator_besthits_strata(name, k):
    """besthits builds exact-j schemes via generator(j, j) (search.cpp:234-237)."""
    for j in range(k + 1):
        ss = GENERATORS[name].generator(j, j, 0, 0)
        assert ss, f"{name} produced empty scheme for ({j},{j})"
        assert is_valid(ss)
        assert is_complete(ss, j, j), f"{name} incomplete for exactly-{j}: {ss}"


def test_optimum_k2_non_redundant():
    ss = GENERATORS["optimum"].generator(0, 2, 0, 0)
    assert is_non_redundant(ss, 0, 2)


def test_optimum_k1_non_redundant():
    ss = GENERATORS["optimum"].generator(0, 1, 0, 0)
    assert is_non_redundant(ss, 0, 1)


def test_expand_count():
    assert expand_count(3, 10) == [4, 3, 3]
    assert expand_count(4, 8) == [2, 2, 2, 2]
    assert expand_count(1, 7) == [7]


def test_expand_positions_cover_query():
    ss = GENERATORS["optimum"].generator(0, 2, 0, 0)
    ess = expand(ss, 30)
    for s in ess:
        assert sorted(s.pi) == list(range(30))
        assert len(s.l) == len(s.u) == 30
        # bounds monotone
        assert list(s.l) == sorted(s.l)
        assert list(s.u) == sorted(s.u)


def test_expand_direction_consistency():
    # search (1, 2, 0): part 1 first (backward), then right part 2, then left 0
    s = Search(pi=(1, 2, 0), l=(0, 0, 0), u=(0, 1, 2))
    assert part_directions(s.pi) == [0, 1, 0]
    es = expand([s], [2, 2, 2])[0]
    # part 1 = positions 2,3 consumed right-to-left; part 2 = 4,5 left-to-right;
    # part 0 = 0,1 right-to-left
    assert es.pi == (3, 2, 4, 5, 1, 0)


def test_expanded_lower_bounds_jump_at_part_ends():
    s = Search(pi=(0, 1), l=(0, 1), u=(0, 1))
    es = expand([s], [2, 2])[0]
    # within part 1, the lower bound stays 0 until its final position
    assert es.l == (0, 0, 0, 1)
    assert es.u == (0, 0, 1, 1)


def test_limit_to_hamming_ramps_lower_bounds():
    s = Search(pi=(0, 1), l=(0, 2), u=(0, 2))
    es = expand([s], [2, 2])[0]
    hs = limit_to_hamming([es])[0]
    # final lower bound 2 over 4 positions: must have >= 1 error by position 3
    assert hs.l[-1] == 2
    assert hs.l[-2] >= 1


def test_covers_cumulative_semantics():
    s = Search(pi=(1, 2, 0), l=(0, 1, 1), u=(0, 1, 2))
    assert covers(s, (1, 0, 1))  # cum along pi=(1,2,0): 0,1,2
    assert not covers(s, (0, 0, 0))  # fails l[1]=1
    assert not covers(s, (0, 1, 0))  # e_1=1 > u[0]=0  (part 1 first)


def test_error_config_enumeration():
    cfgs = list(generate_error_configs(3, 0, 2))
    assert len(cfgs) == 10  # C(3+2-1,2)+C(3,1)+1 = 6+3+1
    assert all(0 <= sum(c) <= 2 for c in cfgs)
    cfgs = list(generate_error_configs(2, 1, 1))
    assert sorted(cfgs) == [(0, 1), (1, 0)]


def test_node_count_monotone_in_k():
    g = GENERATORS["pigeon"].generator
    n1 = node_count(expand(g(0, 1, 0, 0), 20), 4)
    n2 = node_count(expand(g(0, 2, 0, 0), 20), 4)
    assert 0 < n1 < n2


def test_weighted_node_count_less_than_node_count():
    ss = expand(GENERATORS["optimum"].generator(0, 2, 0, 0), 100)
    nc = node_count(ss, 4)
    wnc = weighted_node_count(ss, 4, 10**6)
    assert 0 < wnc < nc


def test_optimize_by_wnc_partition_sums():
    ss = GENERATORS["optimum"].generator(0, 2, 0, 0)
    counts = optimize_by_wnc(ss, 50, 4, 10**6)
    assert sum(counts) == 50
    assert len(counts) == 3
    assert all(c >= 1 for c in counts)
    # optimized partition should not be worse than uniform
    w_uniform = weighted_node_count(expand(ss, 50), 4, 10**6, edit=True)
    w_opt = weighted_node_count(expand(ss, counts), 4, 10**6, edit=True)
    assert w_opt <= w_uniform + 1e-9


def test_optimize_by_wnc_topdown_properties():
    """--dynamic_generator path (optimizeByWNCTopDown, search.cpp:193-205):
    partition sums to the query length, keeps every part non-empty, keeps
    the scheme valid+complete, and is never worse than uniform expansion."""
    from sahara_jax.schemes.costs import optimize_by_wnc_topdown

    for gen_name, k, length in [("optimum", 2, 50), ("h2-k2", 2, 100),
                                ("pigeon", 3, 60), ("h2-k3", 3, 150)]:
        ss = GENERATORS[gen_name].generator(0, k, 0, 0)
        counts = optimize_by_wnc_topdown(ss, length, 5, 10**6, edit=True)
        assert sum(counts) == length, (gen_name, counts)
        assert len(counts) == ss[0].parts
        assert all(c >= 1 for c in counts), (gen_name, counts)
        ess = expand(ss, counts)
        assert is_valid(ess)
        assert is_complete(ess, 0, k)
        w_uniform = weighted_node_count(expand(ss, length), 5, 10**6, edit=True)
        w_opt = weighted_node_count(ess, 5, 10**6, edit=True)
        assert w_opt <= w_uniform + 1e-9, (gen_name, w_opt, w_uniform)


def test_optimize_by_wnc_topdown_degenerate():
    from sahara_jax.schemes.costs import optimize_by_wnc_topdown

    assert optimize_by_wnc_topdown([], 50, 5, 10**6) == []
    ss = [Search(pi=[0], l=[0], u=[0])]
    assert optimize_by_wnc_topdown(ss, 7, 5, 10**6) == [7]
