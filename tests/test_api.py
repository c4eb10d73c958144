"""High-level Problem API: init -> step -> result vs dense twin."""

import numpy as np
import pytest

from brickjax.api import Problem
from brickjax.codegen import dense_apply
from brickjax.core import compare_arrays, random_array
from brickjax.stencils import stencil_by_name


def _dense_steps(g, name, n, params):
    sd = stencil_by_name(name)[0]
    lo, hi = sd.radius()
    w = g
    for _ in range(n):
        wp = np.pad(w, [(l, h) for l, h in zip(lo, hi)], mode="wrap")
        w = dense_apply(sd, {next(iter(sd.inputs)): wp}, params, xp=np)
    return w


def test_problem_jnp_multidevice():
    g = random_array((16, 16, 32), np.float32, 4)
    p = Problem(dims=(8, 8, 16), stencil="mpi7pt", mesh=(2, 2, 2),
                bdims=(4, 4, 8), backend="jnp")
    p.init(array=g).step(2)
    want = _dense_steps(g, "mpi7pt", 2, p.params)
    assert compare_arrays(p.result(), want, 1e-4)


def test_problem_pencil_singledevice():
    g = random_array((8, 12, 16), np.float32, 9)
    p = Problem(dims=(8, 12, 16), stencil="mpi7pt", bdims=(2, 4, 16),
                mesh=(1, 1, 1), backend="pencil")
    p.init(array=g).step(2)
    want = _dense_steps(g, "mpi7pt", 2, p.params)
    assert compare_arrays(p.result(), want, 1e-4)


def test_problem_validates_shape():
    p = Problem(dims=(8, 8, 16), bdims=(4, 4, 8), backend="jnp")
    with pytest.raises(ValueError):
        p.init(array=np.zeros((4, 4, 4), np.float32))
    with pytest.raises(RuntimeError):
        Problem(dims=(8, 8, 16), bdims=(4, 4, 8), backend="jnp").step()


def test_problem_checkpoint_roundtrip(tmp_path):
    g = random_array((16, 16, 32), np.float32, 4)
    p = Problem(dims=(8, 8, 16), stencil="mpi7pt", mesh=(2, 2, 2),
                bdims=(4, 4, 8), backend="jnp")
    p.init(array=g).step(1)
    path = str(tmp_path / "ckpt")
    p.save(path)
    mid = p.result()
    p.step(1)
    end = p.result()

    q = Problem(dims=(8, 8, 16), stencil="mpi7pt", mesh=(2, 2, 2),
                bdims=(4, 4, 8), backend="jnp")
    q.load(path)
    assert compare_arrays(q.result(), mid, 1e-6)
    q.step(1)
    assert compare_arrays(q.result(), end, 1e-6)

    bad = Problem(dims=(8, 8, 16), stencil="mpi7pt", mesh=(2, 2, 2),
                  bdims=(2, 4, 8), backend="jnp")
    with pytest.raises(ValueError):
        bad.load(path)


def test_problem_st_iter_deep_ghost():
    """One step with st_iter=2 (single exchange, deep-ghost sweeps)
    equals two dense iterations, on both backends."""
    g = random_array((16, 16, 32), np.float32, 11)
    pj = Problem(dims=(8, 8, 16), stencil="mpi7pt", mesh=(2, 2, 2),
                 bdims=(4, 4, 8), backend="jnp", st_iter=2)
    want = _dense_steps(g, "mpi7pt", 2, pj.params)
    pj.init(array=g).step(1)
    assert compare_arrays(pj.result(), want, 1e-4)

    pp = Problem(dims=(8, 16, 32), stencil="mpi7pt", mesh=(2, 1, 1),
                 bdims=(4, 8, 32), backend="pencil", st_iter=2)
    pp.init(array=g).step(1)
    assert compare_arrays(pp.result(), want, 1e-4)


def test_problem_st_iter_zero_ghost_message():
    """st_iter > 1 with no ghost at all must raise the deep-ghost
    bound error, not an empty-sequence min() crash."""
    with pytest.raises(ValueError, match="ghost depth"):
        Problem(dims=(16, 16, 16), stencil="mpi7pt", backend="jnp",
                ghost=(0, 0, 0), st_iter=2)


def test_problem_auto_fuse_pass_policy():
    """No stencil fuses unless the schedule asks: fused windows are F
    composed sweeps with the same semantics, and no measurement on the
    card backs an automatic threshold."""
    kw = dict(dims=(16, 16, 32), bdims=(8, 8, 32), mesh=(1, 1, 1),
              backend="pencil")
    for name, st in (("mpi7pt", 8), ("mpi13pt", 8), ("s27pt", 8),
                     ("mpi125pt", 4), ("mpi25pt", 4)):
        assert Problem(stencil=name, st_iter=st, **kw).fuse == 1
        assert Problem(stencil=name, st_iter=st, schedule=dict(fuse=2),
                       **kw).fuse == 2


def test_problem_13pt_auto_fused_matches_dense():
    """13pt st_iter=4 as one F=4 sweep; one step equals four dense
    iterations (tiny shapes)."""
    g = random_array((16, 16, 32), np.float32, 31)
    p = Problem(dims=(16, 16, 32), stencil="mpi13pt", st_iter=4,
                bdims=(8, 8, 32), mesh=(1, 1, 1), backend="pencil",
                schedule=dict(fuse=4))
    assert p.fuse == 4
    p.init(array=g).step(1)
    want = _dense_steps(g, "mpi13pt", 4, p.params)
    assert compare_arrays(p.result(), want, 1e-4)


def test_problem_bf16_pencil_singledevice():
    """dtype=bfloat16 threads into the pencil kernels (storage bf16,
    f32 accumulation) — loose tolerance, bf16 has ~2-3 digits."""
    g = random_array((8, 8, 32), np.float32, 41)
    p = Problem(dims=(8, 8, 32), stencil="mpi7pt", bdims=(4, 4, 32),
                mesh=(1, 1, 1), backend="pencil", dtype=np.dtype("bfloat16"))
    p.init(array=g).step(1)
    want = _dense_steps(g.astype("bfloat16").astype(np.float32),
                        "mpi7pt", 1, p.params)
    got = np.asarray(p.result(), dtype=np.float32)
    assert np.abs(got - want).max() < 3e-2


def test_problem_bf16_distributed_exchange():
    """bf16 storage through the distributed step: SHIFT exchange +
    deep-ghost pencil sweeps on a (2,1,1) mesh."""
    g = random_array((16, 8, 32), np.float32, 43)
    p = Problem(dims=(8, 8, 32), stencil="mpi7pt", bdims=(4, 4, 32),
                mesh=(2, 1, 1), backend="pencil", st_iter=2,
                dtype=np.dtype("bfloat16"))
    p.init(array=g).step(1)
    want = _dense_steps(g.astype("bfloat16").astype(np.float32),
                        "mpi7pt", 2, p.params)
    got = np.asarray(p.result(), dtype=np.float32)
    assert np.abs(got - want).max() < 6e-2


def test_problem_describe_reports_plan():
    """describe() mirrors the chosen execution plan (runtime analog of
    the vecscatter report)."""
    p = Problem(dims=(16, 16, 32), stencil="mpi13pt", st_iter=4,
                bdims=(8, 8, 32), mesh=(1, 1, 1), backend="pencil")
    d = p.describe()
    assert d["backend"] == "pencil" and d["fuse"] == 1
    assert d["kernel"] == "xla" and d["platform"] == "cpu"
    assert d["exchange"] == "table" and d["table_axes"] == [0, 1, 2]
    q = Problem(dims=(8, 8, 16), bdims=(4, 4, 8), backend="jnp")
    assert q.describe()["backend"] == "jnp"
    assert Problem(dims=(16, 16, 32), stencil="mpi7pt",
                   mesh=(1, 1, 1)).describe()["backend"] == "pencil"


def test_problem_export_step_roundtrip(tmp_path):
    """jax.export round-trip of the full distributed step: the
    deserialized artifact steps identically to the live one (mesh,
    shardings and ppermute collectives all inside the export)."""
    import jax.export as jex

    g = random_array((16, 16, 32), np.float32, 47)
    p = Problem(dims=(8, 8, 16), stencil="mpi7pt", mesh=(2, 2, 2),
                bdims=(4, 4, 8), backend="jnp")
    p.init(array=g)
    blob = p.export_step(tmp_path / "step.bin")
    assert (tmp_path / "step.bin").read_bytes() == blob
    out = np.asarray(jex.deserialize(blob).call(p._dats[0]))
    p.step(1)
    np.testing.assert_allclose(out, np.asarray(p._dats[0]),
                               rtol=0, atol=0)


def test_problem_export_requires_init():
    p = Problem(dims=(8, 8, 16), bdims=(4, 4, 8), backend="jnp")
    with pytest.raises(RuntimeError):
        p.export_step()


def test_problem_rollout_matches_step_jnp_multidevice():
    # n steps in ONE dispatch (fori_loop inside the SPMD region,
    # exchange included) must equal n step() dispatches
    g = random_array((16, 16, 32), np.float32, 6)
    p = Problem(dims=(8, 8, 16), stencil="mpi7pt", mesh=(2, 2, 2),
                bdims=(4, 4, 8), backend="jnp")
    q = Problem(dims=(8, 8, 16), stencil="mpi7pt", mesh=(2, 2, 2),
                bdims=(4, 4, 8), backend="jnp")
    p.init(array=g).rollout(3)
    q.init(array=g).step(3)
    np.testing.assert_allclose(p.result(), q.result(), rtol=0, atol=0)


def test_problem_rollout_matches_step_pencil():
    g = random_array((8, 12, 16), np.float32, 7)
    p = Problem(dims=(8, 12, 16), stencil="mpi7pt", bdims=(2, 4, 16),
                mesh=(1, 1, 1), backend="pencil")
    q = Problem(dims=(8, 12, 16), stencil="mpi7pt", bdims=(2, 4, 16),
                mesh=(1, 1, 1), backend="pencil")
    p.init(array=g).rollout(2)
    q.init(array=g).step(2)
    np.testing.assert_allclose(p.result(), q.result(), rtol=0, atol=0)


def test_export_fused_rollout_roundtrip(tmp_path):
    import jax
    import jax.export as jex

    g = random_array((16, 16, 32), np.float32, 8)
    p = Problem(dims=(8, 8, 16), stencil="mpi7pt", mesh=(2, 2, 2),
                bdims=(4, 4, 8), backend="jnp")
    p.init(array=g)
    blob = p.export_step(steps=3)
    ex = jex.deserialize(bytearray(blob))
    got = ex.call(*p._dats, *p._aux)
    q = Problem(dims=(8, 8, 16), stencil="mpi7pt", mesh=(2, 2, 2),
                bdims=(4, 4, 8), backend="jnp")
    q.init(array=g).step(3)
    np.testing.assert_allclose(np.asarray(got), np.asarray(q._dats[0]),
                               rtol=0, atol=0)


def test_problem_schedule_knobs():
    """User-facing schedule overrides (the vecscatter --unroll analog,
    codegen/vecscatter:22-36): fuse reaches the plan and describe()
    reports it, and invalid requests fail loudly at construction."""
    kw = dict(dims=(16, 16, 32), bdims=(8, 8, 32), mesh=(1, 1, 1),
              backend="pencil")
    for f in (1, 2, 4):
        p = Problem(stencil="mpi7pt", st_iter=8, schedule=dict(fuse=f),
                    **kw)
        assert p.fuse == p._plan_kern0.fuse == f
        assert p.describe()["schedule"] == {"fuse": f}
    # knobs of removed kernels are rejected
    for knob in ("tile_j", "vmem_limit_mb", "lookahead", "fuse_passes"):
        with pytest.raises(ValueError, match="unknown schedule"):
            Problem(stencil="mpi7pt", schedule={knob: 1}, **kw)
    # invalid: fuse must divide the budget and fit the halo
    with pytest.raises(ValueError, match="sweep budget"):
        Problem(stencil="mpi7pt", st_iter=3, schedule=dict(fuse=2),
                **kw)
    with pytest.raises(ValueError, match="sweep budget"):
        Problem(stencil="mpi25pt", st_iter=4, schedule=dict(fuse=4),
                **kw)   # radius 4 * fuse 4 > min(bd[:-1]) = 8
    with pytest.raises(ValueError, match="unknown schedule"):
        Problem(stencil="mpi7pt", schedule=dict(unroll=2), **kw)
    with pytest.raises(ValueError, match="pencil"):
        Problem(dims=(16, 16, 32), bdims=(8, 8, 32), backend="jnp",
                schedule=dict(fuse=2))


def test_problem_schedule_fuse_matches_dense():
    """A schedule-forced fuse factor stays numerically exact: 27pt
    st_iter=2 forced F=2 equals two dense iterations (auto policy
    would run it unfused)."""
    g = random_array((16, 16, 32), np.float32, 77)
    p = Problem(dims=(16, 16, 32), stencil="s27pt", st_iter=2,
                bdims=(8, 8, 32), mesh=(1, 1, 1), backend="pencil",
                schedule=dict(fuse=2))
    assert p.fuse == 2
    p.init(array=g).step(1)
    want = _dense_steps(g, "s27pt", 2, p.params)
    assert compare_arrays(p.result(), want, 1e-4)


def test_problem_schedule_2d_fuse():
    """2-D rank takes the same schedule surface (trapezoid fuse)."""
    from brickjax.st.expr import ConstRef, Index
    from brickjax.st.grid import Grid
    from brickjax.st.loader import load_stencil_module

    i, j = Index(0), Index(1)
    gr, o = Grid("in", 2), Grid("out", 2)
    o(i, j).assign(ConstRef("a") * gr(i, j)
                   + ConstRef("b") * (gr(i + 1, j) + gr(i - 1, j)
                                      + gr(i, j + 1) + gr(i, j - 1)))
    sd = load_stencil_module({"STENCIL": [o]})[0]
    params = {"a": 0.4, "b": 0.15}
    g = random_array((16, 128), np.float32, 5)
    p = Problem(dims=(16, 128), stencil=sd, params=params, st_iter=2,
                bdims=(4, 128), backend="pencil",
                schedule=dict(fuse=2))
    assert p.fuse == 2
    p.init(array=g).step(1)
    sdl = stencil_by_name  # noqa: F841  (stencil built inline above)
    lo, hi = sd.radius()
    want = np.asarray(g)
    for _ in range(2):
        wp = np.pad(want, [(l, h) for l, h in zip(lo, hi)],
                    mode="wrap")
        want = dense_apply(sd, {"in": wp}, p.params, xp=np)
    assert compare_arrays(p.result(), want, 1e-4)
