"""Fast-tier sweep smoke: every sweep class runs once at the tiniest
legal shapes and checks against the dense twin (the reference's CI
builds every codegen target, ref: .github/workflows/cmake.yml).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from brickjax.codegen import dense_apply
from brickjax.core import (
    compare_arrays,
    from_bricks,
    init_grid,
    random_array,
    to_bricks,
)
from brickjax.st import ConstRef, Grid, Index
from brickjax.st.loader import load_stencil_module
from brickjax.stencils import DEFAULT_PARAMS, stencil_by_name

PARAMS = dict(DEFAULT_PARAMS)
PARAMS["coeff"] = [0.03 * (c + 1) for c in range(27)]
BD = (2, 2, 8)
G = (4, 3, 1)


def _periodic_data(bd, g, seed, nfields=1):
    grid, info = init_grid(g)
    core_shape = tuple((gg - 2) * bb for gg, bb in zip(g[:-1], bd[:-1]))
    core_shape += (bd[-1],)
    cores = [random_array(core_shape, np.float32, seed + f)
             for f in range(nfields)]
    views = []
    for core in cores:
        pad = [(bb, bb) for bb in bd[:-1]] + [(0, 0)]
        ext = np.pad(core, pad, mode="wrap")
        views.append(jnp.asarray(
            to_bricks(ext, grid, bd).reshape((-1,) + bd)))
    return grid, info, cores, views


def _dense_want(sd, cores, params, iters=1):
    lo, hi = sd.radius()
    named = dict(zip(sd.inputs, cores))
    out = cores[0]
    for _ in range(iters):
        padded = {n: np.pad(c, [(l, h) for l, h in zip(lo, hi)],
                            mode="wrap")
                  for n, c in {**named, list(sd.inputs)[0]: out}.items()}
        out = dense_apply(sd, padded, params, xp=np)
    return out


@pytest.mark.parametrize("fuse", [1, 2])
def test_pencil_sweep_smoke(fuse):
    from brickjax.codegen.sweep import pencil_sweep

    grid, info, cores, views = _periodic_data(BD, G, 3)
    sd = stencil_by_name("s7pt")[0]
    tgrid_info = grid
    fn = pencil_sweep(sd, tgrid_info, BD, info.nbricks, PARAMS, fuse=fuse)
    out = np.asarray(fn(views[0]))
    want = _dense_want(sd, cores, PARAMS, iters=fuse)
    got = from_bricks(out, grid[1:-1, 1:-1], BD)
    assert compare_arrays(got, want, 1e-5)


def test_pencil_multi_input_smoke():
    from brickjax.codegen.sweep import pencil_sweep

    a, b, out_g = Grid("a", 3), Grid("b", 3), Grid("out", 3)
    i, j, k = Index(0), Index(1), Index(2)
    out_g(i, j, k).assign(
        ConstRef("alpha") * a(i, j, k)
        + ConstRef("beta") * (a(i + 1, j, k) + a(i, j - 1, k)
                              + b(i, j, k) + b(i, j, k + 1)))
    sd = load_stencil_module({"STENCIL": [out_g]})[0]
    prm = {"alpha": 0.4, "beta": 0.07}
    grid, info, cores, views = _periodic_data(BD, G, 5, nfields=2)
    fn = pencil_sweep(sd, grid, BD, info.nbricks, prm)
    named = dict(zip(fn.fields, views))
    out = np.asarray(fn(*(named[n] for n in fn.fields)))
    lo, hi = sd.radius()
    padded = {n: np.pad(c, [(l, h) for l, h in zip(lo, hi)], mode="wrap")
              for n, c in zip(sd.inputs, cores)}
    want = dense_apply(sd, padded, prm, xp=np)
    got = from_bricks(out, grid[1:-1, 1:-1], BD)
    assert compare_arrays(got, want, 1e-5)


@pytest.mark.parametrize("fuse", [1, 2])
def test_pencil_system_smoke(fuse):
    """Coupled 2-output system in ONE sweep (Jacobi levels; fuse=2
    iterates both fields within the window)."""
    from brickjax.codegen.sweep import pencil_sweep

    u, v = Grid("u", 3), Grid("v", 3)
    ou, ov = Grid("ou", 3), Grid("ov", 3)
    i, j, k = Index(0), Index(1), Index(2)
    al, be, ga = ConstRef("al"), ConstRef("be"), ConstRef("ga")
    ou(i, j, k).assign(al * u(i, j, k)
                       + be * (u(i, j + 1, k) + u(i, j - 1, k))
                       + ga * v(i + 1, j, k))
    ov(i, j, k).assign(al * v(i, j, k)
                       + be * (v(i, j, k + 1) + v(i, j, k - 1))
                       + ga * u(i - 1, j, k))
    sds = load_stencil_module({"STENCIL": [ou, ov]})
    prm = {"al": 0.3, "be": 0.06, "ga": 0.02}
    grid, info, cores, views = _periodic_data(BD, G, 17, nfields=2)
    fn = pencil_sweep(sds, grid, BD, info.nbricks, prm, fuse=fuse,
                             evolve=("u", "v"))
    named = dict(zip(fn.fields, views))
    outs = fn(*(named[n] for n in fn.fields))
    state = dict(zip(["u", "v"], cores))
    for _ in range(fuse):
        new = {}
        for sd, f in zip(sds, ["u", "v"]):
            lo, hi = sd.radius()
            ins = {n: np.pad(c, [(l, h) for l, h in zip(lo, hi)],
                             mode="wrap") for n, c in state.items()}
            new[f] = dense_apply(sd, ins, prm, xp=np)
        state.update(new)
    for o_i, nm in enumerate(["u", "v"]):
        got = from_bricks(np.asarray(outs[o_i]), grid[1:-1, 1:-1], BD)
        assert compare_arrays(got, state[nm], 1e-5), (fuse, nm)


def test_pencil_multi_input_fused_smoke():
    """fuse=2 with a static aux field: the evolving grid iterates
    while the aux grid stays on its window at every level."""
    from brickjax.codegen.sweep import pencil_sweep

    a, b, out_g = Grid("a", 3), Grid("b", 3), Grid("out", 3)
    i, j, k = Index(0), Index(1), Index(2)
    out_g(i, j, k).assign(
        ConstRef("alpha") * a(i, j, k)
        + ConstRef("beta") * (a(i + 1, j, k) + a(i, j - 1, k)
                              + a(i, j, k + 1))
        + ConstRef("gamma") * b(i, j, k))
    sd = load_stencil_module({"STENCIL": [out_g]})[0]
    prm = {"alpha": 0.4, "beta": 0.07, "gamma": 0.11}
    grid, info, cores, views = _periodic_data(BD, G, 19, nfields=2)
    fn = pencil_sweep(sd, grid, BD, info.nbricks, prm, fuse=2, evolve="a")
    named = dict(zip(fn.fields, views))
    out = np.asarray(fn(*(named[n] for n in fn.fields)))
    lo, hi = sd.radius()
    state = dict(zip(sd.inputs, cores))
    for _ in range(2):
        ins = {n: np.pad(c, [(l, h) for l, h in zip(lo, hi)],
                         mode="wrap") for n, c in state.items()}
        state["a"] = dense_apply(sd, ins, prm, xp=np)
    got = from_bricks(out, grid[1:-1, 1:-1], BD)
    assert compare_arrays(got, state["a"], 1e-5)


def test_pencil_generic_cond_smoke():
    """Generic-evaluator branch (cond's If/max predication) numeric
    check in the fast tier."""
    from brickjax.codegen.sweep import pencil_sweep

    grid, info, cores, views = _periodic_data(BD, G, 23)
    sd = stencil_by_name("cond")[0]
    fn = pencil_sweep(sd, grid, BD, info.nbricks,
                               PARAMS)
    out = np.asarray(fn(views[0]))
    want = _dense_want(sd, cores, PARAMS)
    got = from_bricks(out, grid[1:-1, 1:-1], BD)
    assert compare_arrays(got, want, 1e-5)


def test_pencil_radius2_profile_smoke():
    """Radius-2 star (13pt) numeric check in the fast tier."""
    from brickjax.codegen.sweep import pencil_sweep

    bd = (4, 4, 16)
    grid, info, cores, views = _periodic_data(bd, G, 29)
    sd = stencil_by_name("mpi13pt")[0]
    fn = pencil_sweep(sd, grid, bd, info.nbricks,
                               PARAMS)
    out = np.asarray(fn(views[0]))
    want = _dense_want(sd, cores, PARAMS)
    got = from_bricks(out, grid[1:-1, 1:-1], bd)
    assert compare_arrays(got, want, 1e-5)


@pytest.mark.parametrize("fuse", [1, 2])
def test_pencil_4d_smoke(fuse):
    from brickjax.codegen.sweep import pencil_sweep

    bd4, g4 = (2, 2, 2, 8), (3, 4, 3, 1)
    grid, info, cores, views = _periodic_data(bd4, g4, 13)
    sd = stencil_by_name("mpi9pt")[0]
    fn = pencil_sweep(sd, grid, bd4, info.nbricks, DEFAULT_PARAMS,
                      fuse=fuse)
    out = np.asarray(fn(views[0]))
    want = _dense_want(sd, cores, DEFAULT_PARAMS, iters=fuse)
    got = from_bricks(out, grid[1:-1, 1:-1, 1:-1], bd4)
    assert compare_arrays(got, want, 1e-5)


def test_pencil_4d_multi_input_smoke():
    """4-D variable-coefficient stencil: one window per field
    (cross-field w/k/j offsets exercise both halo directions)."""
    from brickjax.codegen.sweep import pencil_sweep

    a, g_, out_g = Grid("a", 4), Grid("g", 4), Grid("out", 4)
    i, j, k, w = Index(0), Index(1), Index(2), Index(3)
    out_g(i, j, k, w).assign(
        a(i, j, k, w) * g_(i, j, k, w)
        + ConstRef("beta") * g_(i + 1, j, k - 1, w)
        + a(i, j - 1, k, w - 1) * g_(i, j + 1, k, w + 1))
    sd = load_stencil_module({"STENCIL": [out_g]})[0]
    prm = {"beta": 0.11}
    bd4, g4 = (2, 2, 2, 8), (3, 4, 3, 1)
    grid, info, cores, views = _periodic_data(bd4, g4, 29, nfields=2)
    fn = pencil_sweep(sd, grid, bd4, info.nbricks, prm)
    named = dict(zip(fn.fields, views))
    out = np.asarray(fn(*(named[n] for n in fn.fields)))
    lo, hi = sd.radius()
    padded = {n: np.pad(c, [(l, h) for l, h in zip(lo, hi)],
                        mode="wrap")
              for n, c in zip(sd.inputs, cores)}
    want = dense_apply(sd, padded, prm, xp=np)
    got = from_bricks(out, grid[1:-1, 1:-1, 1:-1], bd4)
    assert compare_arrays(got, want, 1e-5)
