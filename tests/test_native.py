import numpy as np

from sahara_jax.native import get_lib, suffix_array, xxh64, xxh64_batch_u64, _suffix_array_doubling


def brute_sa(t: np.ndarray) -> np.ndarray:
    tb = bytes(t)
    return np.array(sorted(range(len(tb)), key=lambda i: tb[i:]), dtype=np.int64)


def test_native_available():
    assert get_lib() is not None


def test_sais_random():
    rng = np.random.default_rng(7)
    for _ in range(50):
        n = int(rng.integers(1, 300))
        sigma = int(rng.integers(1, 7))
        t = rng.integers(0, sigma, n).astype(np.uint8)
        assert (suffix_array(t) == brute_sa(t)).all()


def test_sais_edge_cases():
    for t in [b"a", b"aaaa", b"abab", b"banana", bytes(10), b"\x00\x01\x00\x01\x00"]:
        arr = np.frombuffer(t, dtype=np.uint8)
        assert (suffix_array(arr) == brute_sa(arr)).all()
    assert suffix_array(np.zeros(0, dtype=np.uint8)).size == 0


def test_doubling_fallback_matches():
    rng = np.random.default_rng(3)
    for _ in range(10):
        t = rng.integers(0, 5, int(rng.integers(1, 200))).astype(np.uint8)
        assert (_suffix_array_doubling(t) == brute_sa(t)).all()


def test_xxh64_vectors():
    # published xxHash spec test vectors, seed 0
    assert xxh64(b"") == 0xEF46DB3751D8E999
    assert xxh64(b"a") == 0xD24EC4F1A98C6E5B
    assert xxh64(b"abc") == 0x44BC2CF5AD770999
    v = xxh64_batch_u64(np.array([0, 1, 2**63], dtype=np.uint64))
    assert v[0] == xxh64((0).to_bytes(8, "little"))
