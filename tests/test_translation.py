"""What running on a GPU asks of the engines: exact integer compaction, no
float32 products that a GPU may compute in TF32, no silent fallback to the
CPU, and a compile cache inside the checkout unless JAX is told otherwise."""

import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from sahara_jax.engine.device import DeviceIndex
from sahara_jax.engine.seedverify import plan_parts, sv_fused
from sahara_jax.engine.tape import compile_tape
from sahara_jax.engine.workq import _compact, main_tail_steps, phase0_length, upload_tape, workq_search
from sahara_jax.index.build import build_bifmindex
from sahara_jax.parallel.mesh import data_mesh
from sahara_jax.schemes import GENERATORS, expand

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a compaction that runs on the GPU, compared with NumPy (the gpu test below)
_GPU_COMPACT = """
import numpy as np, jax
from sahara_jax.engine.workq import _compact
assert jax.devices()[0].platform == "gpu"
cap, e_used = 1 << 17, 11
rng = np.random.default_rng(0)
fl = rng.random(cap * e_used) < 0.08
pay = ((np.arange(cap, dtype=np.int32)[None, :] << 4) | np.arange(e_used, dtype=np.int32)[:, None]).reshape(-1)
sel, total = jax.jit(_compact, static_argnums=2)(fl, pay, cap)
want = pay[fl][:cap]
assert int(total) == int(fl.sum())
assert np.array_equal(np.asarray(sel)[: len(want)], want)
print("ok")
"""


def _compact_reference(fl: np.ndarray, payload: np.ndarray, cap: int):
    sel = np.zeros(cap, dtype=np.int32)
    kept = payload[fl][:cap]
    sel[: len(kept)] = kept
    return sel, int(fl.sum())


@pytest.mark.parametrize("cap", [512, 4096, 1 << 17])
def test_compaction_matches_numpy(cap):
    """The step's compaction of (parent << 4 | branch) payloads, at caps
    whose payloads exceed 2^11 (where TF32 would round), including a flag
    count beyond ``cap`` (the overflow the driver retries)."""
    e_used = 11
    rng = np.random.default_rng(cap)
    payload = (
        (np.arange(cap, dtype=np.int32)[None, :] << 4) | np.arange(e_used, dtype=np.int32)[:, None]
    ).reshape(-1)
    assert payload.max() > 2**11
    fn = jax.jit(_compact, static_argnums=2)
    for density in (0.05, 0.5):
        fl = rng.random(cap * e_used) < density
        sel, total = fn(jnp.asarray(fl), jnp.asarray(payload), cap)
        want_sel, want_total = _compact_reference(fl, payload, cap)
        assert int(total) == want_total
        assert np.array_equal(np.asarray(sel), want_sel)


@pytest.mark.gpu
def test_compaction_on_gpu_matches_numpy(gpu_env):
    out = subprocess.run(
        [sys.executable, "-c", _GPU_COMPACT], env=gpu_env, cwd=REPO,
        capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def _walk(jaxpr):
    for eqn in jaxpr.eqns:
        yield eqn
        for param in eqn.params.values():
            for sub in param if isinstance(param, (tuple, list)) else (param,):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _walk(inner)


def _default_precision_f32_dots(jaxpr) -> list:
    """dot_general equations with a float32 operand and no precision set."""
    bad = []
    for eqn in _walk(jaxpr):
        if eqn.primitive.name != "dot_general":
            continue
        if not any(getattr(v.aval, "dtype", None) == jnp.float32 for v in eqn.invars):
            continue
        prec = eqn.params.get("precision")
        precs = prec if isinstance(prec, tuple) else (prec,)
        if all(p in (None, lax.Precision.DEFAULT) for p in precs):
            bad.append(eqn)
    return bad


@pytest.fixture(scope="module")
def small_index():
    rng = np.random.default_rng(3)
    seqs = [rng.integers(1, 5, size=ln).astype(np.uint8) for ln in (400, 200)]
    return DeviceIndex.from_host(build_bifmindex(seqs, 6, "d_dna5", rate=16))


@pytest.mark.parametrize("engine", ["workq", "sv"])
def test_no_default_precision_f32_dot_in_engine_step(small_index, engine):
    f32 = jnp.zeros((4, 4), jnp.float32)
    assert _default_precision_f32_dots(jax.make_jaxpr(jnp.dot)(f32, f32).jaxpr), "walker control"
    m, k, nq = 40, 2, 8
    queries = jnp.ones((nq, m), jnp.int32)
    if engine == "workq":
        tape = compile_tape(expand(GENERATORS["optimum"].generator(0, k, 0, 0), m))
        ph0 = phase0_length(tape, True)
        main_steps, _ = main_tail_steps(m, ph0, k, True)
        fn = partial(
            workq_search, edit=True, plan=((main_steps, 512),), tail_cap=512, hq_cap=512,
            m=m, ns=tape.num_searches, k=k, ph0=ph0, dedup_every=4, packed="wide",
        )
        jaxpr = jax.make_jaxpr(fn)(small_index, queries, *upload_tape(tape), jnp.ones(nq, bool))
    else:
        fn = partial(
            sv_fused, parts=plan_parts(m, k), m=m, k=k, edit=True, capR=512, hq_cap=512,
            part_cap=1 << 16, chunk=nq,
        )
        flags = jnp.zeros(nq, bool)
        jaxpr = jax.make_jaxpr(fn)(small_index, queries.astype(jnp.uint8), ~flags, flags, jnp.int32(0))
    assert _default_precision_f32_dots(jaxpr.jaxpr) == []


def test_data_mesh_refuses_more_devices_than_exist():
    assert len(jax.devices()) == 8
    with pytest.raises(ValueError, match="requested 16 devices"):
        data_mesh(16)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(env_set, tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([REPO] + env.get("PYTHONPATH", "").split(os.pathsep))
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
        want = str(tmp_path / "cc")
    else:
        env.pop("JAX_COMPILATION_CACHE_DIR", None)
        want = os.path.join(REPO, ".jax_cache")
    out = subprocess.run(
        [sys.executable, "-c", "import sahara_jax, jax; print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == want
