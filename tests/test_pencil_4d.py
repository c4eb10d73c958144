"""4-D pencil streaming kernel vs dense twin + distributed driver
(ref: weak/main-4d.cpp:36-53)."""

import numpy as np
import pytest

import jax.numpy as jnp

from brickjax.codegen import dense_apply
from brickjax.codegen.sweep import pencil_sweep
from brickjax.core import (compare_arrays, from_bricks, init_grid,
                               random_array, to_bricks)
from brickjax.stencils import DEFAULT_PARAMS, stencil_by_name

BD = (2, 2, 4, 16)
G = (4, 5, 4, 1)


def test_pencil_4d_matches_dense_periodic():
    grid, info = init_grid(G)
    WI, KI, JI = (g - 2 for g in G[:3])
    core = random_array((WI * BD[0], KI * BD[1], JI * BD[2], BD[3]),
                        np.float32, 9)
    ext = np.pad(core, ((BD[0], BD[0]), (BD[1], BD[1]), (BD[2], BD[2]),
                        (0, 0)), mode="wrap")
    view = jnp.asarray(to_bricks(ext, grid, BD).reshape((-1,) + BD))
    sd = stencil_by_name("mpi9pt")[0]
    fn = pencil_sweep(sd, grid, BD, info.nbricks,
                                DEFAULT_PARAMS)
    out = np.asarray(fn(view))
    lo, hi = sd.radius()
    corep = np.pad(core, [(l, h) for l, h in zip(lo, hi)], mode="wrap")
    want = dense_apply(sd, {next(iter(sd.inputs)): corep},
                       DEFAULT_PARAMS, xp=np)
    got = from_bricks(out, grid[1:-1, 1:-1, 1:-1], BD)
    assert compare_arrays(got, want, 1e-5)


@pytest.mark.parametrize("F", [2])
def test_pencil_4d_fused_matches_composed(F):
    """fuse=F on the periodic table equals F dense iterations (the 3-D
    fused-ring semantics carried to 4-D: w rides the ring rows as
    per-level extension elements)."""
    grid, info = init_grid(G)
    WI, KI, JI = (g - 2 for g in G[:3])
    core = random_array((WI * BD[0], KI * BD[1], JI * BD[2], BD[3]),
                        np.float32, 23)
    ext = np.pad(core, ((BD[0], BD[0]), (BD[1], BD[1]), (BD[2], BD[2]),
                        (0, 0)), mode="wrap")
    view = jnp.asarray(to_bricks(ext, grid, BD).reshape((-1,) + BD))
    sd = stencil_by_name("mpi9pt")[0]
    fn = pencil_sweep(sd, grid, BD, info.nbricks,
                                DEFAULT_PARAMS, fuse=F)
    out = np.asarray(fn(view))
    want = _dense_steps_4d(sd, core, F, DEFAULT_PARAMS)
    got = from_bricks(out, grid[1:-1, 1:-1, 1:-1], BD)
    assert compare_arrays(got, want, 1e-4)


def test_pencil_4d_fused_mixed_radii():
    """fuse=2 with asymmetric radii (w=1, k=2, j=2, i=1): exercises
    multi-element k/j halos flowing through the fused ring levels."""
    from brickjax.st import FloatLiteral, Grid, Index
    from brickjax.st.loader import load_stencil_module

    inp, out = Grid("in", 4), Grid("out", 4)
    i, j, k, w = Index(0), Index(1), Index(2), Index(3)
    calc = (FloatLiteral(0.3) * inp(i, j, k, w)
            + FloatLiteral(0.11) * inp(i + 1, j, k - 2, w)
            + FloatLiteral(0.07) * inp(i - 1, j + 2, k, w - 1)
            + FloatLiteral(0.05) * inp(i, j - 1, k + 1, w + 1))
    out(i, j, k, w).assign(calc)
    sd = load_stencil_module({"STENCIL": [out]})[0]

    bd = (2, 4, 4, 16)
    G4 = (4, 4, 4, 1)
    grid, info = init_grid(G4)
    core = random_array(tuple((g - 2) * b for g, b in zip(G4[:3], bd[:3]))
                        + (bd[3],), np.float32, 31)
    ext = np.pad(core, [(b, b) for b in bd[:3]] + [(0, 0)], mode="wrap")
    view = jnp.asarray(to_bricks(ext, grid, bd).reshape((-1,) + bd))
    fn = pencil_sweep(sd, grid, bd, info.nbricks, {}, fuse=2)
    out_v = np.asarray(fn(view))
    want = _dense_steps_4d(sd, core, 2, {})
    got = from_bricks(out_v, grid[1:-1, 1:-1, 1:-1], bd)
    assert compare_arrays(got, want, 1e-5)


def test_weak_driver_4d_pencil_distributed():
    """4-D pencil on a (2,1,1,1) mesh with deep-ghost ST_ITER=2,
    validated against the array twin inside the driver."""
    from brickjax.drivers import weak

    weak.run(dims=(4, 4, 8, 16), bdim=(2, 2, 4, 16), stencil="mpi9pt",
             st_iter=2, mesh_shape=(2, 1, 1, 1), iters=1, validate=True,
             backend="pencil")


def test_weak_driver_4d_fused_deep_ghost():
    """4-D st_iter=4 as two fused F=2 sweeps on a (2,1,1,1) mesh,
    validated against the array twin inside the driver."""
    from brickjax.drivers import weak

    weak.run(dims=(8, 8, 8, 16), bdim=(4, 4, 4, 16), stencil="mpi9pt",
             st_iter=4, mesh_shape=(2, 1, 1, 1), iters=1, validate=True,
             backend="pencil", fuse=2)


def _dense_steps_4d(sd, g, n, params):
    lo, hi = sd.radius()
    w = g
    for _ in range(n):
        wp = np.pad(w, [(l, h) for l, h in zip(lo, hi)], mode="wrap")
        w = dense_apply(sd, {next(iter(sd.inputs)): wp}, params, xp=np)
    return w


def test_problem_4d_pencil():
    """Problem API on a 4-D domain picks the 4-D pencil kernel
    (single device: all-axes table periodicity)."""
    from brickjax.api import Problem

    g = random_array((4, 8, 8, 32), np.float32, 11)
    p = Problem(dims=(4, 8, 8, 32), stencil="mpi9pt",
                bdims=(2, 4, 4, 32), backend="pencil",
                mesh=(1, 1, 1, 1))
    assert p.backend == "pencil"
    p.init(array=g).step(2)
    want = _dense_steps_4d(stencil_by_name("mpi9pt")[0], g, 2, p.params)
    assert compare_arrays(p.result(), want, 1e-4)


def test_problem_4d_pencil_distributed_deep_ghost():
    """4-D pencil Problem on a (2,1,1,1) mesh with st_iter=2 deep
    ghost (ghost-inclusive first sweep, owned-only last)."""
    from brickjax.api import Problem

    g = random_array((8, 8, 8, 32), np.float32, 12)
    p = Problem(dims=(4, 8, 8, 32), stencil="mpi9pt",
                bdims=(2, 4, 4, 32), backend="pencil",
                mesh=(2, 1, 1, 1), st_iter=2)
    p.init(array=g).step(1)
    want = _dense_steps_4d(stencil_by_name("mpi9pt")[0], g, 2, p.params)
    assert compare_arrays(p.result(), want, 1e-4)


def test_problem_4d_auto_fused():
    """4-D fused: mpi9pt st_iter=4 as two F=2 window sweeps equals
    four dense iterations."""
    from brickjax.api import Problem

    g = random_array((8, 8, 8, 32), np.float32, 17)
    p = Problem(dims=(8, 8, 8, 32), stencil="mpi9pt",
                bdims=(4, 4, 4, 32), backend="pencil",
                mesh=(1, 1, 1, 1), st_iter=4, schedule=dict(fuse=2))
    assert p.fuse == 2
    p.init(array=g).step(1)
    want = _dense_steps_4d(stencil_by_name("mpi9pt")[0], g, 4, p.params)
    assert compare_arrays(p.result(), want, 1e-4)


def test_problem_4d_rollout_matches_step():
    from brickjax.api import Problem
    from brickjax.core import random_array

    g = random_array((4, 8, 8, 32), np.float32, 5)
    kw = dict(dims=(4, 8, 8, 32), stencil="mpi9pt",
              bdims=(2, 4, 4, 32), backend="pencil",
              mesh=(1, 1, 1, 1))
    p, q = Problem(**kw), Problem(**kw)
    p.init(array=g).rollout(2)
    q.init(array=g).step(2)
    np.testing.assert_allclose(p.result(), q.result(), rtol=0, atol=0)


def test_problem_4d_differentiable_step():
    """4-D Problem AD hook: grad through the 4-D pencil kernel (auto-
    fused mpi9pt, st_iter chaining) vs the dense twin."""
    import jax

    from brickjax.api import Problem
    from brickjax.core import random_array

    dims = (4, 8, 8, 32)
    p = Problem(dims=dims, stencil="mpi9pt", bdims=(2, 4, 4, 32),
                backend="pencil", mesh=(1, 1, 1, 1), st_iter=2)
    fn = p.differentiable_step()
    wmask = p.owned_mask()
    g = random_array(dims, np.float32, 11)
    w = random_array(dims, np.float32, 12)
    p.init(array=g)
    wp = Problem(dims=dims, stencil="mpi9pt", bdims=(2, 4, 4, 32),
                 backend="pencil", mesh=(1, 1, 1, 1), st_iter=2)
    wp.init(array=w)
    wb = jnp.where(wmask, wp._dats[0], 0.0)

    gb = jax.grad(lambda d: jnp.sum(fn(d) * wb))(p._dats[0])

    sd = stencil_by_name("mpi9pt")[0]
    lo, hi = sd.radius()
    pad = tuple((lo[a], hi[a]) for a in range(4))

    def dense_loss(d):
        for _ in range(2):
            d = dense_apply(sd, {next(iter(sd.inputs)):
                                 jnp.pad(d, pad, mode="wrap")},
                            p.params)
        return jnp.sum(d * jnp.asarray(w))

    gd = np.asarray(jax.grad(dense_loss)(jnp.asarray(g)))
    full = from_bricks(np.asarray(gb).reshape(p.dec.nbricks, -1),
                       p.dec.grid, p.bdims)
    # dec.gz counts grid CELLS; element offsets scale by the brick dims
    own = full[tuple(slice(z * p.bdims[a], z * p.bdims[a] + dims[a])
                     for a, z in enumerate(p.dec.gz))]
    np.testing.assert_allclose(own, gd, rtol=2e-5, atol=2e-5)


def _varcoeff_4d():
    """out = a*g + 0.11*g(i+1,k-1) + a(j-1,w-1)*g(j+1,w+1): variable
    coefficients with cross-field offsets in every outer axis."""
    from brickjax.st import FloatLiteral, Grid, Index
    from brickjax.st.loader import load_stencil_module

    g_, a, out = Grid("g", 4), Grid("a", 4), Grid("out", 4)
    i, j, k, w = Index(0), Index(1), Index(2), Index(3)
    out(i, j, k, w).assign(
        a(i, j, k, w) * g_(i, j, k, w)
        + FloatLiteral(0.11) * g_(i + 1, j, k - 1, w)
        + a(i, j - 1, k, w - 1) * g_(i, j + 1, k, w + 1))
    return load_stencil_module({"STENCIL": [out]})[0]


def test_problem_4d_aux_field_pencil():
    """4-D variable-coefficient Problem runs on the pencil backend
    (per-field rolling windows with their own w-halo slices)."""
    from brickjax.api import Problem

    sd = _varcoeff_4d()
    dims = (4, 8, 8, 32)
    g = random_array(dims, np.float32, 31)
    a = random_array(dims, np.float32, 32)
    p = Problem(dims=dims, stencil=[sd], field="g",
                bdims=(2, 4, 4, 32), backend="auto", mesh=(1, 1, 1, 1))
    assert p.backend == "pencil"
    p.init(array=g, aux={"a": a}).step(1)
    lo, hi = sd.radius()
    pad = [(l, h) for l, h in zip(lo, hi)]
    want = dense_apply(sd, {"g": np.pad(g, pad, mode="wrap"),
                            "a": np.pad(a, pad, mode="wrap")},
                       p.params, xp=np)
    assert compare_arrays(p.result(), want, 1e-5)


def test_problem_4d_poly_differentiable_step():
    """Exact 4-D polynomial pullback through the Problem hook: grads
    wrt the evolving field AND the aux coefficient field match dense
    AD (single device, all-axes table periodicity)."""
    import jax

    from brickjax.api import Problem

    sd = _varcoeff_4d()
    dims = (4, 8, 8, 32)
    g = random_array(dims, np.float32, 41)
    a = random_array(dims, np.float32, 42)
    wt = random_array(dims, np.float32, 43)
    p = Problem(dims=dims, stencil=[sd], field="g",
                bdims=(2, 4, 4, 32), backend="pencil",
                mesh=(1, 1, 1, 1))
    fn = p.differentiable_step()
    p.init(array=g, aux={"a": a})
    wp = Problem(dims=dims, stencil=[sd], field="g",
                 bdims=(2, 4, 4, 32), backend="pencil",
                 mesh=(1, 1, 1, 1))
    wp.init(array=wt, aux={"a": a})
    wb = jnp.where(p.owned_mask(), wp._dats[0], 0.0)

    gb, ab = jax.grad(
        lambda d, av: jnp.sum(fn(d, av) * wb),
        argnums=(0, 1))(p._dats[0], p._aux[0])

    lo, hi = sd.radius()
    pad = [(l, h) for l, h in zip(lo, hi)]

    def dense_loss(dg, da):
        o = dense_apply(sd, {"g": jnp.pad(dg, pad, mode="wrap"),
                             "a": jnp.pad(da, pad, mode="wrap")},
                        p.params)
        return jnp.sum(o * jnp.asarray(wt))

    dgr, dar = jax.grad(dense_loss, argnums=(0, 1))(
        jnp.asarray(g), jnp.asarray(a))
    for gv, dr in ((gb, dgr), (ab, dar)):
        full = from_bricks(np.asarray(gv).reshape(p.dec.nbricks, -1),
                           p.dec.grid, p.bdims)
        own = full[tuple(slice(z * p.bdims[x], z * p.bdims[x] + dims[x])
                         for x, z in enumerate(p.dec.gz))]
        np.testing.assert_allclose(own, np.asarray(dr), rtol=2e-5,
                                   atol=2e-5)


def test_problem_4d_poly_differentiable_step_distributed():
    """Distributed 4-D poly pullback on a (2,1,1,1) mesh: the evolving
    field's ghost cotangent AND the aux coefficient field's ghost
    gradients ride the exchanges' transposes home; grads match dense
    AD globally."""
    import jax

    from brickjax.api import Problem

    sd = _varcoeff_4d()
    mesh, dims = (2, 1, 1, 1), (4, 8, 8, 32)
    gshape = tuple(m * d for m, d in zip(mesh, dims))
    g = random_array(gshape, np.float32, 51)
    a = random_array(gshape, np.float32, 52)
    wt = random_array(gshape, np.float32, 53)
    p = Problem(dims=dims, stencil=[sd], field="g",
                bdims=(2, 4, 4, 32), backend="pencil", mesh=mesh,
                st_iter=1)
    fn = p.differentiable_step()
    p.init(array=g, aux={"a": a})
    wp = Problem(dims=dims, stencil=[sd], field="g",
                 bdims=(2, 4, 4, 32), backend="pencil", mesh=mesh,
                 st_iter=1)
    wp.init(array=wt, aux={"a": a})
    wb = jnp.where(p.owned_mask(), wp._dats[0], 0.0)

    def loss(d, av):
        d = fn(fn(d, av), av)   # two [exchange -> sweep] steps
        return jnp.sum(d * wb)

    gb, ab = jax.grad(loss, argnums=(0, 1))(p._dats[0], p._aux[0])

    lo, hi = sd.radius()
    pad = [(l, h) for l, h in zip(lo, hi)]

    def dense_loss(dg, da):
        d = dg
        for _ in range(2):
            d = dense_apply(sd, {"g": jnp.pad(d, pad, mode="wrap"),
                                 "a": jnp.pad(da, pad, mode="wrap")},
                            p.params)
        return jnp.sum(d * jnp.asarray(wt))

    dgr, dar = jax.grad(dense_loss, argnums=(0, 1))(
        jnp.asarray(g), jnp.asarray(a))
    nb = p.dec.nbricks
    for gv, dr in ((gb, dgr), (ab, dar)):
        gn, drn = np.asarray(gv), np.asarray(dr)
        for r in range(2):
            own = from_bricks(gn[r * nb:(r + 1) * nb].reshape(nb, -1),
                              p.dec.interior_grid(), p.bdims)
            np.testing.assert_allclose(
                own, drn[r * dims[0]:(r + 1) * dims[0]],
                rtol=2e-5, atol=2e-5)


def _system_4d():
    """Coupled polynomial 4-D pair: u' reads u taps and the u*v
    product; v' reads v taps and the same product (cross-coupling in
    every outer axis)."""
    from brickjax.st import Grid, Index
    from brickjax.st.loader import load_stencil_module

    u, v = Grid("u", 4), Grid("v", 4)
    ou, ov = Grid("ou", 4), Grid("ov", 4)
    i, j, k, w = Index(0), Index(1), Index(2), Index(3)
    uv = u(i, j, k, w) * v(i, j, k, w)
    ou(i, j, k, w).assign(u(i, j, k, w)
                          + 0.1 * (u(i + 1, j, k - 1, w)
                                   + u(i, j - 1, k, w + 1)) - uv)
    ov(i, j, k, w).assign(v(i, j, k, w)
                          + 0.05 * v(i - 1, j + 1, k, w - 1) + uv)
    return load_stencil_module({"STENCIL": [ou, ov]})


def _dense_system_step_4d(sds, state, params):
    new = {}
    for sd, f in zip(sds, ("u", "v")):
        lo, hi = sd.radius()
        ins = {n: np.pad(np.asarray(c),
                         [(l, h) for l, h in zip(lo, hi)],
                         mode="wrap") for n, c in state.items()}
        new[f] = dense_apply(sd, ins, params, xp=np)
    return new


def test_problem_4d_system_pencil():
    """Coupled 4-D system on the pencil backend: one multi-input
    kernel per output, Jacobi update from the pre-step fields."""
    from brickjax.api import Problem

    sds = _system_4d()
    dims = (4, 8, 8, 32)
    u0 = random_array(dims, np.float32, 61)
    v0 = random_array(dims, np.float32, 62)
    p = Problem(dims=dims, stencil=sds, field=("u", "v"),
                bdims=(2, 4, 4, 32), backend="auto", mesh=(1, 1, 1, 1))
    assert p.backend == "pencil"
    p.init(array={"u": u0, "v": v0}).step(1)
    want = _dense_system_step_4d(sds, {"u": u0, "v": v0}, p.params)
    res = p.result()
    for f in ("u", "v"):
        assert compare_arrays(res[f], want[f], 1e-5), f


def test_problem_4d_system_differentiable_step_distributed():
    """Exact 4-D coupled-system pullback on a (2,1,1,1) mesh: both
    fields' ghost cotangents ride the exchanges' transposes home;
    grads wrt both fields match dense AD globally."""
    import jax

    from brickjax.api import Problem

    sds = _system_4d()
    mesh, dims = (2, 1, 1, 1), (4, 8, 8, 32)
    gshape = tuple(m * d for m, d in zip(mesh, dims))
    u0 = random_array(gshape, np.float32, 71)
    v0 = random_array(gshape, np.float32, 72)
    wt = random_array(gshape, np.float32, 73)
    p = Problem(dims=dims, stencil=sds, field=("u", "v"),
                bdims=(2, 4, 4, 32), backend="pencil", mesh=mesh,
                st_iter=1)
    fn = p.differentiable_step()
    p.init(array={"u": u0, "v": v0})
    wp = Problem(dims=dims, stencil=sds, field=("u", "v"),
                 bdims=(2, 4, 4, 32), backend="pencil", mesh=mesh,
                 st_iter=1)
    wp.init(array={"u": wt, "v": wt})
    wb = jnp.where(p.owned_mask(), wp._dats[0], 0.0)

    gu, gv = jax.grad(
        lambda uv: jnp.sum(fn(*uv)[0] * wb))((p._dats[0], p._dats[1]))

    def dense_loss(uv):
        du, dv = uv
        lo0, hi0 = sds[0].radius()
        lo1, hi1 = sds[1].radius()
        p0 = [(l, h) for l, h in zip(lo0, hi0)]
        p1 = [(l, h) for l, h in zip(lo1, hi1)]
        ou = dense_apply(sds[0], {"u": jnp.pad(du, p0, mode="wrap"),
                                  "v": jnp.pad(dv, p0, mode="wrap")},
                         p.params)
        return jnp.sum(ou * jnp.asarray(wt))

    du, dv = jax.grad(dense_loss)((jnp.asarray(u0), jnp.asarray(v0)))
    nb = p.dec.nbricks
    for gv_, dr in ((gu, np.asarray(du)), (gv, np.asarray(dv))):
        gn = np.asarray(gv_)
        for r in range(2):
            own = from_bricks(gn[r * nb:(r + 1) * nb].reshape(nb, -1),
                              p.dec.interior_grid(), p.bdims)
            np.testing.assert_allclose(
                own, dr[r * dims[0]:(r + 1) * dims[0]],
                rtol=2e-5, atol=2e-5)


def test_problem_4d_differentiable_step_distributed():
    """Distributed 4-D pullback on a (2, 1, 1, 1) mesh: the w ghost
    cotangent rides the shift exchange's transpose home; grads match
    dense AD globally (the 3-D exchanged-axes design at rank 4)."""
    import jax

    from brickjax.api import Problem
    from brickjax.core import random_array

    mesh, dims = (2, 1, 1, 1), (4, 8, 8, 32)
    gshape = tuple(m * d for m, d in zip(mesh, dims))
    p = Problem(dims=dims, stencil="mpi9pt", bdims=(2, 4, 4, 32),
                backend="pencil", mesh=mesh, st_iter=1)
    fn = p.differentiable_step()
    g = random_array(gshape, np.float32, 21)
    w = random_array(gshape, np.float32, 22)
    p.init(array=g)
    wp = Problem(dims=dims, stencil="mpi9pt", bdims=(2, 4, 4, 32),
                 backend="pencil", mesh=mesh, st_iter=1)
    wp.init(array=w)
    wb = jnp.where(p.owned_mask(), wp._dats[0], 0.0)

    def loss(d):
        d = fn(fn(d))   # two [exchange -> sweep] steps
        return jnp.sum(d * wb)

    gb = jax.grad(loss)(p._dats[0])

    sd = stencil_by_name("mpi9pt")[0]
    lo, hi = sd.radius()
    pad = tuple((lo[a], hi[a]) for a in range(4))

    def dense_loss(d):
        for _ in range(2):
            d = dense_apply(sd, {next(iter(sd.inputs)):
                                 jnp.pad(d, pad, mode="wrap")},
                            p.params)
        return jnp.sum(d * jnp.asarray(w))

    gd = np.asarray(jax.grad(dense_loss)(jnp.asarray(g)))
    nb = p.dec.nbricks
    gn = np.asarray(gb)
    for r in range(2):
        own = from_bricks(gn[r * nb:(r + 1) * nb].reshape(nb, -1),
                          p.dec.interior_grid(), p.bdims)
        np.testing.assert_allclose(own,
                                   gd[r * dims[0]:(r + 1) * dims[0]],
                                   rtol=2e-5, atol=2e-5)
