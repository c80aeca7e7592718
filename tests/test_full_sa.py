"""Full-SA locate sidecar (index/build.py::_build_core sa_abs,
engine/locate.py::lf_walk fast path): build/save/load round trip, parity
with the sampled LF walk on every real text position, and the size gate."""

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest

from sahara_jax.engine.device import DeviceIndex
from sahara_jax.engine.locate import lf_walk
from sahara_jax.index.build import build_bifmindex, build_text
from sahara_jax.index.fmindex import load_index, save_index


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(3)
    seqs = [rng.integers(1, 5, size=ln).astype(np.uint8) for ln in (5000, 3777, 1201)]
    host = build_bifmindex(seqs, 6, "d_dna5", rate=16)
    return seqs, host


def test_roundtrip_and_gate(built, monkeypatch):
    seqs, host = built
    assert host.sa_abs is not None and len(host.sa_abs) == host.n
    buf = io.BytesIO()
    save_index(buf, host)
    buf.seek(0)
    host2 = load_index(buf)
    assert host2.sa_abs is not None
    np.testing.assert_array_equal(host2.sa_abs, host.sa_abs)
    monkeypatch.setenv("SAHARA_FULL_SA_MAX", "100")
    host3 = build_bifmindex(seqs, 6, "d_dna5", rate=16)
    assert host3.sa_abs is None  # over the gate: sidecar skipped
    monkeypatch.setenv("SAHARA_NO_FULL_SA", "1")
    assert DeviceIndex.from_host(host).sa_full is None  # upload kill switch


def test_lf_walk_parity_real_positions(built):
    seqs, host = built
    di_full = DeviceIndex.from_host(host)
    assert di_full.sa_full is not None
    di_samp = dataclasses.replace(di_full, sa_full=None)
    text, _ = build_text(seqs, 16)
    rows = np.arange(host.n, dtype=np.int32)
    valid = np.ones(host.n, dtype=bool)
    s1, p1 = lf_walk(di_full, jnp.asarray(rows), jnp.asarray(valid))
    s2, p2 = lf_walk(di_samp, jnp.asarray(rows), jnp.asarray(valid))
    # sentinel-suffix rows are unspecified (see lf_walk docstring); every
    # row that starts at a real character must agree exactly
    real = text[np.asarray(host.sa_abs)] != 0
    np.testing.assert_array_equal(np.asarray(s1)[real], np.asarray(s2)[real])
    np.testing.assert_array_equal(np.asarray(p1)[real], np.asarray(p2)[real])
    assert real.sum() > 0.9 * host.n
