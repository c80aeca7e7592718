"""ctypes bindings for the native core (SA-IS, XXH64).

Compiled on first use with g++ -O3 into ``_sahara_native.so`` beside the
source (never committed); a NumPy prefix-doubling suffix array serves
as a pure-Python fallback if no compiler is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "sahara_native.cpp")
_LIB_PATH = os.path.join(_HERE, "_sahara_native.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_failed = False


def _build() -> None:
    # portable code (no -march=native): the checkout, build output included,
    # may move to another host.  Built under a per-process name and renamed
    # into place, so processes that build at once never load a partial file.
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++20", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib() -> ctypes.CDLL | None:
    """Load (building if necessary) the native library; None if unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        try:
            if not os.path.exists(_LIB_PATH) or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC):
                _build()
            lib = ctypes.CDLL(_LIB_PATH)
        except Exception:
            _build_failed = True
            return None
        lib.sahara_sais_i32.restype = ctypes.c_int
        lib.sahara_sais_i32.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.c_int32,
        ]
        lib.sahara_sais_u8_i64.restype = ctypes.c_int
        lib.sahara_sais_u8_i64.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int64,
        ]
        lib.sahara_xxh64.restype = ctypes.c_uint64
        lib.sahara_xxh64.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64]
        lib.sahara_xxh64_batch_u64.restype = None
        lib.sahara_xxh64_batch_u64.argtypes = [
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint64,
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        _lib = lib
        return _lib


def _suffix_array_doubling(text: np.ndarray) -> np.ndarray:
    """NumPy prefix-doubling fallback, O(n log^2 n). ``text`` is the already
    sentinel-terminated rank array (sentinel unique smallest not required)."""
    n = len(text)
    rank = np.asarray(text, dtype=np.int64)
    sa = np.argsort(rank, kind="stable")
    tmp = np.empty(n, dtype=np.int64)
    k = 1
    while True:
        # rank of suffix i by (rank[i], rank[i+k])
        second = np.full(n, -1, dtype=np.int64)
        second[: n - k] = rank[k:]
        order = np.lexsort((second, rank))
        tmp[order[0]] = 0
        diff = (rank[order[1:]] != rank[order[:-1]]) | (second[order[1:]] != second[order[:-1]])
        tmp[order[1:]] = np.cumsum(diff)
        rank = tmp.copy()
        if rank[order[-1]] == n - 1:
            return order.astype(np.int64)
        k *= 2


def suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array of a rank text (uint8 values in [0, sigma)).

    The text need not end with a unique sentinel; ties are broken by suffix
    order like any general suffix sort (libsais semantics).
    Returns int64 positions.
    """
    text = np.ascontiguousarray(text, dtype=np.uint8)
    n = len(text)
    if n == 0:
        return np.empty(0, dtype=np.int64)
    lib = get_lib()
    if lib is None:
        return _suffix_array_doubling(text)
    if n + 1 < 2**31:
        # shift ranks +1 and append the unique smallest sentinel 0
        shifted = np.empty(n + 1, dtype=np.int32)
        shifted[:n] = text
        shifted[:n] += 1
        shifted[n] = 0
        sa = np.empty(n + 1, dtype=np.int32)
        rc = lib.sahara_sais_i32(
            shifted.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n + 1,
            int(shifted.max()) + 1,
        )
        if rc != 0:
            raise RuntimeError(f"sahara_sais_i32 failed ({rc})")
        # drop the sentinel suffix (always sa[0] == n)
        return sa[1:].astype(np.int64)
    else:
        shifted = np.empty(n + 1, dtype=np.uint8)
        shifted[:n] = text + 1  # requires ranks <= 254
        shifted[n] = 0
        sa = np.empty(n + 1, dtype=np.int64)
        rc = lib.sahara_sais_u8_i64(
            shifted.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n + 1,
            int(shifted.max()) + 1,
        )
        if rc != 0:
            raise RuntimeError(f"sahara_sais_u8_i64 failed ({rc})")
        return sa[1:]


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of a byte string (bit-exact with the reference's hash.h:25-27)."""
    lib = get_lib()
    if lib is None:
        return _xxh64_py(data, seed)
    return int(lib.sahara_xxh64(data, len(data), seed))


def xxh64_u64(value: int, seed: int = 0) -> int:
    """XXH64 of a single uint64 (little-endian), as used for kmer hashing."""
    return xxh64(int(value).to_bytes(8, "little"), seed)


def xxh64_batch_u64(values: np.ndarray, seed: int = 0) -> np.ndarray:
    """Vectorized XXH64 over an array of uint64 keys."""
    values = np.ascontiguousarray(values, dtype=np.uint64)
    lib = get_lib()
    if lib is None:
        return np.array([_xxh64_py(int(v).to_bytes(8, "little"), seed) for v in values], dtype=np.uint64)
    out = np.empty(len(values), dtype=np.uint64)
    lib.sahara_xxh64_batch_u64(
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(values),
        seed,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    return out


# --- pure-python XXH64 fallback (slow; for environments without g++) -------

_M = (1 << 64) - 1
_P1, _P2, _P3, _P4, _P5 = (
    0x9E3779B185EBCA87,
    0xC2B2AE3D27D4EB4F,
    0x165667B19E3779F9,
    0x85EBCA77C2B2AE63,
    0x27D4EB2F165667C5,
)


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M


def _round(acc: int, inp: int) -> int:
    return (_rotl((acc + inp * _P2) & _M, 31) * _P1) & _M


def _xxh64_py(data: bytes, seed: int) -> int:
    n = len(data)
    i = 0
    if n >= 32:
        v1, v2, v3, v4 = (seed + _P1 + _P2) & _M, (seed + _P2) & _M, seed & _M, (seed - _P1) & _M
        while i + 32 <= n:
            v1 = _round(v1, int.from_bytes(data[i : i + 8], "little"))
            v2 = _round(v2, int.from_bytes(data[i + 8 : i + 16], "little"))
            v3 = _round(v3, int.from_bytes(data[i + 16 : i + 24], "little"))
            v4 = _round(v4, int.from_bytes(data[i + 24 : i + 32], "little"))
            i += 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M
    else:
        h = (seed + _P5) & _M
    h = (h + n) & _M
    while i + 8 <= n:
        h = (_rotl(h ^ _round(0, int.from_bytes(data[i : i + 8], "little")), 27) * _P1 + _P4) & _M
        i += 8
    if i + 4 <= n:
        h = (_rotl(h ^ (int.from_bytes(data[i : i + 4], "little") * _P1) & _M, 23) * _P2 + _P3) & _M
        i += 4
    while i < n:
        h = (_rotl(h ^ (data[i] * _P5) & _M, 11) * _P1) & _M
        i += 1
    h ^= h >> 33
    h = (h * _P2) & _M
    h ^= h >> 29
    h = (h * _P3) & _M
    h ^= h >> 32
    return h
