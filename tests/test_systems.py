"""Coupled stencil systems through the Problem API.

The reference's ``STENCIL = [out1, out2, ...]`` contract allows several
outputs per module (codegen/vecscatter:165-168 loops the list); a
Problem built from a list of StencilDefs steps ALL evolving fields:
every step exchanges each field, then computes every output from the
PRE-step fields (Jacobi update), composing with deep-ghost st_iter.
"""

import numpy as np
import pytest

from brickjax.api import Problem
from brickjax.codegen import dense_apply
from brickjax.core import compare_arrays, random_array
from brickjax.st import ConstRef, Grid, Index
from brickjax.st.loader import load_stencil_module

PARAMS = {"dt": 0.05, "c1": 0.3, "c2": -0.2}


def _coupled_system():
    """u' = u + dt*lap(u) + c1*v ; v' = v + c2*(u taps) — two outputs
    reading both grids (reaction-diffusion-like coupling)."""
    u, v = Grid("u", 3), Grid("v", 3)
    ou, ov = Grid("ou", 3), Grid("ov", 3)
    i, j, k = Index(0), Index(1), Index(2)
    dt, c1, c2 = ConstRef("dt"), ConstRef("c1"), ConstRef("c2")
    lap = (u(i + 1, j, k) + u(i - 1, j, k) + u(i, j + 1, k)
           + u(i, j - 1, k) + u(i, j, k + 1) + u(i, j, k - 1)
           - 6.0 * u(i, j, k))
    ou(i, j, k).assign(u(i, j, k) + dt * lap + c1 * v(i, j, k))
    ov(i, j, k).assign(v(i, j, k)
                       + c2 * (u(i + 1, j, k) + u(i, j - 1, k)))
    return load_stencil_module({"STENCIL": [ou, ov]})


def _dense_system_steps(sdefs, fields, state, n, params):
    state = dict(state)
    for _ in range(n):
        new = {}
        for sd, f in zip(sdefs, fields):
            lo, hi = sd.radius()
            ins = {k: np.pad(w, list(zip(lo, hi)), mode="wrap")
                   for k, w in state.items()}
            new[f] = dense_apply(sd, ins, params, xp=np)
        state.update(new)
    return state


@pytest.mark.parametrize("backend,mesh,st_iter", [
    ("pencil", (1, 1, 1), 1),     # single chip, table periodicity
    ("pencil", (2, 1, 1), 2),     # distributed + deep-ghost
    ("jnp", (2, 2, 2), 2),        # 8-device mesh, rank-generic path
])
def test_coupled_system_matches_dense(backend, mesh, st_iter):
    sdefs = _coupled_system()
    gdim = (16, 16, 32)
    dims = tuple(g // m for g, m in zip(gdim, mesh))
    u0 = random_array(gdim, np.float32, 1)
    v0 = random_array(gdim, np.float32, 2)
    p = Problem(dims=dims, stencil=sdefs, field=("u", "v"),
                backend=backend, mesh=mesh, st_iter=st_iter,
                bdims=(4, 4, dims[2]) if backend == "pencil"
                else (4, 4, 8),
                params=PARAMS)
    p.init(array={"u": u0, "v": v0}).step(2)
    want = _dense_system_steps(sdefs, ("u", "v"), {"u": u0, "v": v0},
                               2 * st_iter, p.params)
    got = p.result()
    assert compare_arrays(got["u"], want["u"], 1e-4)
    assert compare_arrays(got["v"], want["v"], 1e-4)


def _small_system():
    """A <=7-tap coupled pair, so Problem's auto temporal fusion
    applies (every output from ONE sweep window)."""
    u, v = Grid("u", 3), Grid("v", 3)
    ou, ov = Grid("ou", 3), Grid("ov", 3)
    i, j, k = Index(0), Index(1), Index(2)
    dt, c1, c2 = ConstRef("dt"), ConstRef("c1"), ConstRef("c2")
    ou(i, j, k).assign(u(i, j, k)
                       + dt * (u(i, j + 1, k) + u(i, j - 1, k))
                       + c1 * v(i + 1, j, k))
    ov(i, j, k).assign(v(i, j, k)
                       + dt * (v(i, j, k + 1) + v(i, j, k - 1))
                       + c2 * u(i - 1, j, k))
    return load_stencil_module({"STENCIL": [ou, ov]})


@pytest.mark.parametrize("mesh", [(1, 1, 1), (2, 1, 1)])
def test_fused_system_matches_dense(mesh):
    """st_iter=4 on a system fused into one window (4 Jacobi rounds
    per pass) still matches the composed dense iteration —
    the reference's ST_ITER amortization extended to systems
    (ref: weak/main.cpp:203-212)."""
    sdefs = _small_system()
    gdim = (16, 16, 32)
    dims = tuple(g // m for g, m in zip(gdim, mesh))
    u0 = random_array(gdim, np.float32, 5)
    v0 = random_array(gdim, np.float32, 6)
    p = Problem(dims=dims, stencil=sdefs, field=("u", "v"),
                backend="pencil", mesh=mesh, st_iter=4,
                bdims=(4, 4, dims[2]), params=PARAMS,
                schedule=dict(fuse=4))
    assert p.fuse == 4
    p.init(array={"u": u0, "v": v0}).step(2)
    want = _dense_system_steps(sdefs, ("u", "v"), {"u": u0, "v": v0},
                               8, p.params)
    got = p.result()
    assert compare_arrays(got["u"], want["u"], 1e-4)
    assert compare_arrays(got["v"], want["v"], 1e-4)


def test_system_save_load_roundtrip(tmp_path):
    sdefs = _coupled_system()
    p = Problem(dims=(16, 16, 32), stencil=sdefs, field=("u", "v"),
                backend="jnp", bdims=(4, 4, 8), params=PARAMS)
    p.init(seed=3).step(1)
    mid = p.result()
    path = str(tmp_path / "sys.npz")
    p.save(path)
    p.step(1)
    end = p.result()

    q = Problem(dims=(16, 16, 32), stencil=sdefs, field=("u", "v"),
                backend="jnp", bdims=(4, 4, 8), params=PARAMS)
    q.load(path)
    got_mid = q.result()
    assert compare_arrays(got_mid["u"], mid["u"], 1e-6)
    assert compare_arrays(got_mid["v"], mid["v"], 1e-6)
    q.step(1)
    got_end = q.result()
    assert compare_arrays(got_end["u"], end["u"], 1e-6)
    assert compare_arrays(got_end["v"], end["v"], 1e-6)


def test_system_validation():
    sdefs = _coupled_system()
    with pytest.raises(ValueError, match="field="):
        Problem(dims=(16, 16, 32), stencil=sdefs, backend="jnp")
    with pytest.raises(ValueError, match="field name"):
        Problem(dims=(16, 16, 32), stencil=sdefs, field=("u",),
                backend="jnp")
    with pytest.raises(ValueError, match="distinct"):
        Problem(dims=(16, 16, 32), stencil=sdefs, field=("u", "u"),
                backend="pencil", mesh=(2, 1, 1), bdims=(4, 4, 32))
    p = Problem(dims=(16, 16, 32), stencil=sdefs, field=("u", "v"),
                backend="jnp", bdims=(4, 4, 8), params=PARAMS)
    with pytest.raises(ValueError, match="unknown state"):
        p.init(array={"u": None, "w": None})


def test_system_misordered_fields_rejected():
    """field= must follow STENCIL order: output idx must read
    field[idx] (a swapped tuple silently mislabels the system)."""
    u, v = Grid("u", 3), Grid("v", 3)
    ou, ov = Grid("ou", 3), Grid("ov", 3)
    i, j, k = Index(0), Index(1), Index(2)
    ou(i, j, k).assign(u(i, j, k) + u(i + 1, j, k))   # reads u only
    ov(i, j, k).assign(v(i, j, k) + v(i, j - 1, k))   # reads v only
    sdefs = load_stencil_module({"STENCIL": [ou, ov]})
    with pytest.raises(ValueError, match="STENCIL order"):
        Problem(dims=(16, 16, 32), stencil=sdefs, field=("v", "u"),
                backend="jnp", bdims=(4, 4, 8))


def test_system_init_and_result_guards():
    sdefs = _coupled_system()
    p = Problem(dims=(16, 16, 32), stencil=sdefs, field=("u", "v"),
                backend="jnp", bdims=(4, 4, 8), params=PARAMS)
    with pytest.raises(TypeError, match="array="):
        p.init(array=np.zeros((16, 16, 32), np.float32))
    with pytest.raises(RuntimeError, match="init"):
        p.result()
    with pytest.raises(RuntimeError, match="init"):
        p.result("u")


def test_system_rollout_matches_step():
    # multi-field carry through the fused-dispatch fori_loop
    sdefs = _coupled_system()
    gdim = (16, 16, 32)
    mesh = (2, 1, 1)
    dims = tuple(g // m for g, m in zip(gdim, mesh))
    u0 = random_array(gdim, np.float32, 3)
    v0 = random_array(gdim, np.float32, 4)
    kw = dict(dims=dims, stencil=sdefs, field=("u", "v"),
              backend="pencil", mesh=mesh, st_iter=1,
              bdims=(4, 4, dims[2]), params=PARAMS)
    p, q = Problem(**kw), Problem(**kw)
    p.init(array={"u": u0, "v": v0}).rollout(3)
    q.init(array={"u": u0, "v": v0}).step(3)
    for f in ("u", "v"):
        np.testing.assert_allclose(p.result(f), q.result(f),
                                   rtol=0, atol=0)
