import numpy as np

from sahara_jax import alphabet as al


def test_d_dna5_ranks():
    r = al.D_DNA5.char_to_rank(b"$ACGTNacgtnUu")
    assert list(r) == [0, 1, 2, 3, 4, 5, 1, 2, 3, 4, 5, 4, 4]


def test_d_dna4_rejects_n():
    r = al.D_DNA4.char_to_rank(b"ACGN")
    assert al.D_DNA4.verify_rank(r) == 3
    assert al.D_DNA4.verify_rank(r[:3]) is None


def test_revcomp():
    q = al.D_DNA5.char_to_rank(b"ACGTN")
    rc = al.D_DNA5.reverse_complement_rank(q)
    assert al.D_DNA5.rank_to_char(rc) == b"NACGT"


def test_dr_alphabets():
    # dr_dna.h:8-21 — A/T/U/W -> 1, C/G/S -> 2, N -> 3
    r = al.DR_DNA4.char_to_rank(b"WAaTtUuSCcGg$")
    assert list(r) == [1] * 7 + [2] * 5 + [0]
    r5 = al.DR_DNA5.char_to_rank(b"Nn")
    assert list(r5) == [3, 3]
    # complement is the identity => revcomp == reverse
    q = al.DR_DNA5.char_to_rank(b"ATCGN")
    assert list(al.DR_DNA5.reverse_complement_rank(q)) == list(q[::-1])


def test_sigma_dispatch():
    assert al.by_sigma(5) is al.D_DNA4
    assert al.by_sigma(6) is al.D_DNA5


def test_dna4_normalize():
    assert al.dna4_normalize_char(b"acgtUx") == b"ACGTTx"
    assert list(al.dna4_verify_char(b"ACGX")) == [True, True, True, False]
