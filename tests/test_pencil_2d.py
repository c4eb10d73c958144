"""2-D pencil sweep vs dense periodic twin.

Dimension generality for the fast path (the reference's templates are
dim-generic, ref: include/brick.h:96-127).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from brickjax.codegen import dense_apply
from brickjax.codegen.sweep import pencil_sweep
from brickjax.core import (
    compare_arrays,
    from_bricks,
    init_grid,
    random_array,
    to_bricks,
)
from brickjax.st import ConstRef, Func, Grid, Index, If
from brickjax.st.loader import load_stencil_module


def _lin5():
    i, j = Index(0), Index(1)       # i = x (innermost), j = y
    g, o = Grid("in", 2), Grid("out", 2)
    o(i, j).assign(ConstRef("a") * g(i, j)
                   + ConstRef("b") * (g(i + 1, j) + g(i - 1, j)
                                      + g(i, j + 1) + g(i, j - 1)))
    return load_stencil_module({"STENCIL": [o]})[0]


def _asym9():
    """Radius-2 asymmetric: distinct y-profiles + 4 lane rolls."""
    i, j = Index(0), Index(1)
    g, o = Grid("in", 2), Grid("out", 2)
    o(i, j).assign(1.0 * g(i, j) + 0.6 * g(i + 2, j)
                   - 0.3 * g(i - 1, j + 1) + 0.2 * g(i, j - 2)
                   + 0.9 * g(i + 1, j + 1) - 0.4 * g(i - 2, j - 1))
    return load_stencil_module({"STENCIL": [o]})[0]


def _nonlin():
    i, j = Index(0), Index(1)
    g, o = Grid("in", 2), Grid("out", 2)
    mx = Func("max", 2)
    o(i, j).assign(If(g(i, j) > 0,
                      mx(g(i + 1, j), g(i, j + 1)) * 0.5,
                      g(i - 1, j - 1)))
    return load_stencil_module({"STENCIL": [o]})[0]


def _run_case(sd, params, by=4, X=16, ny=12, seed=7, steps=1):
    grid, info = init_grid((ny // by + 2, 1))
    core = random_array((ny, X), np.float32, seed)
    ext = np.pad(core, ((by, by), (0, 0)), mode="wrap")
    view = jnp.asarray(to_bricks(ext, grid, (by, X)).reshape(-1, by, X))
    fn = pencil_sweep(sd, grid, (by, X), info.nbricks,
                                params)
    out = view
    want = core
    lo, hi = sd.radius()
    for _ in range(steps):
        out = fn(out)
        wp = np.pad(want, [(l, h) for l, h in zip(lo, hi)], mode="wrap")
        want = dense_apply(sd, {next(iter(sd.inputs)): wp}, params,
                           xp=np)
        if steps > 1:   # refresh periodic ghost rows between steps
            ng = np.asarray(out)
            g2 = np.asarray(grid)[:, 0]
            ng[g2[0]] = ng[g2[-2]]
            ng[g2[-1]] = ng[g2[1]]
            out = jnp.asarray(ng)
    got = from_bricks(np.asarray(out).reshape(info.nbricks, -1),
                      np.asarray(grid)[1:-1], (by, X))
    assert compare_arrays(got, want, 1e-5)


def test_2d_linear_5pt():
    _run_case(_lin5(), {"a": 0.4, "b": 0.15})


def test_2d_linear_asym_radius2():
    _run_case(_asym9(), {}, by=4, X=16, ny=16, seed=9)


def test_2d_nonlinear_generic():
    _run_case(_nonlin(), {}, seed=11)


def test_2d_periodic_table_chained():
    """Fully periodic via table redirection: two chained sweeps equal
    two dense periodic steps with no host ghost refresh."""
    sd = _lin5()
    params = {"a": 0.4, "b": 0.15}
    by, X, ny = 4, 16, 12
    grid, info = init_grid((ny // by + 2, 1))
    g2 = np.asarray(grid)[:, 0].copy()
    g2[0] = g2[-2]          # periodic redirection table
    g2[-1] = g2[1]
    core = random_array((ny, X), np.float32, 3)
    ext = np.pad(core, ((by, by), (0, 0)), mode="wrap")
    view = jnp.asarray(to_bricks(ext, grid, (by, X)).reshape(-1, by, X))
    fn = pencil_sweep(sd, g2, (by, X), info.nbricks, params)
    out = np.asarray(fn(fn(view)))
    lo, hi = sd.radius()
    want = core
    for _ in range(2):
        wp = np.pad(want, [(l, h) for l, h in zip(lo, hi)], mode="wrap")
        want = dense_apply(sd, {"in": wp}, params, xp=np)
    got = from_bricks(out.reshape(info.nbricks, -1),
                      np.asarray(grid)[1:-1], (by, X))
    assert compare_arrays(got, want, 1e-5)


# ---------------------------------------------------------------- Problem API


def _dense_steps(sd, g, n, params):
    want = np.asarray(g)
    lo, hi = sd.radius()
    for _ in range(n):
        wp = np.pad(want, [(l, h) for l, h in zip(lo, hi)], mode="wrap")
        want = dense_apply(sd, {next(iter(sd.inputs)): wp}, params,
                           xp=np)
    return want


def test_problem_2d_pencil_single_device():
    """Problem on a 2-D domain picks the 2-D pencil fast path (table
    periodicity on both axes) and matches the dense periodic twin."""
    from brickjax.api import Problem

    sd = _lin5()
    params = {"a": 0.4, "b": 0.15}
    g = random_array((16, 16), np.float32, 21)
    p = Problem(dims=(16, 16), stencil=sd, params=params,
                bdims=(4, 16))
    assert p.backend == "pencil"
    assert p.describe()["exchange"] == "table"
    p.init(array=g).step(2)
    assert compare_arrays(p.result(), _dense_steps(sd, g, 2, p.params),
                          1e-5)


def test_problem_2d_distributed_deep_ghost():
    """2-D pencil Problem on a (2, 1) mesh with st_iter=2 deep ghost
    (ghost-inclusive first sweep, owned-only last)."""
    from brickjax.api import Problem

    sd = _asym9()
    g = random_array((32, 16), np.float32, 22)
    p = Problem(dims=(16, 16), stencil=sd, bdims=(4, 16),
                backend="pencil", mesh=(2, 1), st_iter=2)
    p.init(array=g).step(1)
    assert compare_arrays(p.result(), _dense_steps(sd, g, 2, p.params),
                          1e-5)


def test_problem_2d_nonlinear_generic():
    """Nonlinear 2-D stencils run the generic evaluator on the 2-D
    pencil path (If/max, single input)."""
    from brickjax.api import Problem

    sd = _nonlin()
    g = random_array((16, 16), np.float32, 23)
    p = Problem(dims=(16, 16), stencil=sd, bdims=(4, 16),
                backend="pencil")
    p.init(array=g).step(1)
    assert compare_arrays(p.result(), _dense_steps(sd, g, 1, p.params),
                          1e-5)


def test_problem_2d_multi_input_pencil():
    """Variable-coefficient 2-D stencils run the pencil generic path
    with one window ring per input field (aux periodic at init),
    matching the dense twin over two steps; mesh rank is validated."""
    from brickjax.api import Problem

    i, j = Index(0), Index(1)
    g, c, o = Grid("in", 2), Grid("c", 2), Grid("out", 2)
    o(i, j).assign(c(i, j) * g(i + 1, j) + c(i, j + 1) * g(i, j - 1))
    sd = load_stencil_module({"STENCIL": [o]})[0]
    x = random_array((16, 16), np.float32, 24)
    ca = random_array((16, 16), np.float32, 25)
    p = Problem(dims=(16, 16), stencil=sd, field="in", bdims=(4, 16))
    assert p.backend == "pencil"
    p.init(array=x, aux={"c": ca}).step(2)
    lo, hi = sd.radius()
    pad = [(l, h) for l, h in zip(lo, hi)]
    want = x
    for _ in range(2):
        want = dense_apply(sd, {"in": np.pad(want, pad, mode="wrap"),
                                "c": np.pad(ca, pad, mode="wrap")},
                           {}, xp=np)
    assert compare_arrays(p.result(), want, 1e-5)
    with pytest.raises(ValueError, match="mesh needs"):
        Problem(dims=(16, 16), stencil=_lin5(), mesh=(2, 1, 1))


def test_problem_2d_differentiable_step():
    """2-D differentiable_step: exact adjoint-sweep pullback on the
    row-pencil emitter, single device (table periodic both axes)."""
    import jax

    from brickjax.api import Problem

    sd = _lin5()
    params = {"a": 0.4, "b": 0.15}
    x = random_array((16, 16), np.float32, 31)
    w = random_array((16, 16), np.float32, 32)
    p = Problem(dims=(16, 16), stencil=sd, params=params, bdims=(4, 16))
    step = p.differentiable_step()
    p.init(array=x)
    wp = Problem(dims=(16, 16), stencil=sd, params=params,
                 bdims=(4, 16))
    wp.init(array=w)
    wb = jnp.where(p.owned_mask(), wp._dats[0], 0.0)
    g = jax.grad(lambda d: jnp.sum(step(d) * wb))(p._dats[0])

    def dense_loss(d):
        wpad = jnp.pad(d, 1, mode="wrap")
        out = dense_apply(sd, {"in": wpad}, params, xp=jnp)
        return jnp.sum(out * jnp.asarray(w))

    want = np.asarray(jax.grad(dense_loss)(jnp.asarray(x)))
    got = from_bricks(np.asarray(g).reshape(p.dec.nbricks, -1),
                      p.dec.interior_grid(), p.bdims)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_problem_2d_differentiable_step_distributed():
    """Distributed 2-D pullback on a (2, 1) mesh: the y ghost cotangent
    rides the shift exchange's transpose home; grads match dense AD
    globally."""
    import jax

    from brickjax.api import Problem

    sd = _lin5()
    params = {"a": 0.4, "b": 0.15}
    mesh, dims = (2, 1), (16, 16)
    gshape = (32, 16)
    x = random_array(gshape, np.float32, 33)
    w = random_array(gshape, np.float32, 34)
    p = Problem(dims=dims, stencil=sd, params=params, bdims=(4, 16),
                mesh=mesh, backend="pencil")
    step = p.differentiable_step()
    p.init(array=x)
    wp = Problem(dims=dims, stencil=sd, params=params, bdims=(4, 16),
                 mesh=mesh, backend="pencil")
    wp.init(array=w)
    wb = jnp.where(p.owned_mask(), wp._dats[0], 0.0)
    g = jax.grad(lambda d: jnp.sum(step(d) * wb))(p._dats[0])

    def dense_loss(d):
        wpad = jnp.pad(d, 1, mode="wrap")
        out = dense_apply(sd, {"in": wpad}, params, xp=jnp)
        return jnp.sum(out * jnp.asarray(w))

    want = np.asarray(jax.grad(dense_loss)(jnp.asarray(x)))
    nb = p.dec.nbricks
    gn = np.asarray(g)
    for r in range(2):
        own = from_bricks(gn[r * nb:(r + 1) * nb].reshape(nb, -1),
                          p.dec.interior_grid(), p.bdims)
        np.testing.assert_allclose(own, want[r * 16:(r + 1) * 16],
                                   rtol=1e-5, atol=1e-5)


def test_problem_2d_differentiable_piecewise_exact():
    """2-D piecewise (If/max) stencils differentiate EXACTLY (round 5:
    the symbolic differentiator's gate masks replace the old
    non-polynomial rejection) — Problem.differentiable_step gradient
    matches dense AD."""
    import jax

    from brickjax.api import Problem
    from brickjax.core import from_bricks

    sd = _nonlin()
    N = 16

    def make():
        return Problem(dims=(N, N), stencil=sd, bdims=(4, N),
                       backend="pencil")

    p = make()
    fn = p.differentiable_step()
    rng = np.random.default_rng(9)
    u0 = (rng.random((N, N)) - 0.45).astype(np.float32)
    w = rng.random((N, N)).astype(np.float32)
    p.init(array=u0)
    q = make()
    q.init(array=w)
    wb = jnp.where(p.owned_mask(), q._dats[0], 0.0)
    gb = jax.grad(lambda d: jnp.sum(fn(d) * wb))(p._dats[0])

    def dense(v):
        lo, hi = sd.radius()
        vp = jnp.pad(v, [(l, h) for l, h in zip(lo, hi)], mode="wrap")
        return dense_apply(sd, {"in": vp}, p.params, xp=jnp)

    want = np.asarray(jax.grad(
        lambda v: jnp.sum(dense(v) * jnp.asarray(w)))(jnp.asarray(u0)))
    own = from_bricks(np.asarray(gb).reshape(p.dec.nbricks, -1),
                      p.dec.interior_grid(), p.bdims)
    np.testing.assert_allclose(own, want, rtol=2e-5, atol=2e-5)


def test_problem_2d_rollout_matches_step():
    """rollout(n) (one fused dispatch) equals step(n) on the 2-D path."""
    from brickjax.api import Problem

    sd = _lin5()
    params = {"a": 0.4, "b": 0.15}
    g = random_array((32, 16), np.float32, 41)
    kw = dict(dims=(16, 16), stencil=sd, params=params, bdims=(4, 16),
              mesh=(2, 1), backend="pencil")
    p, q = Problem(**kw), Problem(**kw)
    p.init(array=g).step(3)
    q.init(array=g).rollout(3)
    np.testing.assert_allclose(q.result(), p.result(), rtol=0, atol=0)


def test_2d_bf16_storage():
    """bf16 storage threads through the 2-D emitter (window/output in
    bf16, taps accumulate in f32) — matches the f32 sweep to bf16
    rounding."""
    sd = _lin5()
    params = {"a": 0.4, "b": 0.15}
    by, X, ny = 4, 16, 12
    grid, info = init_grid((ny // by + 2, 1))
    core = random_array((ny, X), np.float32, 13)
    ext = np.pad(core, ((by, by), (0, 0)), mode="wrap")
    view = to_bricks(ext, grid, (by, X)).reshape(-1, by, X)
    f32 = pencil_sweep(sd, grid, (by, X), info.nbricks,
                                 params)
    b16 = pencil_sweep(sd, grid, (by, X), info.nbricks,
                                 params, dtype=jnp.bfloat16)
    want = np.asarray(f32(jnp.asarray(view)))
    got = np.asarray(b16(jnp.asarray(view, jnp.bfloat16)),
                     dtype=np.float32)
    g2 = np.asarray(grid)[1:-1, 0]
    np.testing.assert_allclose(got[g2], want[g2], rtol=0, atol=2e-2)


def test_problem_2d_multi_input_distributed():
    """Var-coeff 2-D on a (2, 1) mesh: evolving field exchanged per
    step, aux ghost filled once at init (periodic, never stale)."""
    from brickjax.api import Problem

    i, j = Index(0), Index(1)
    g, c, o = Grid("in", 2), Grid("c", 2), Grid("out", 2)
    o(i, j).assign(c(i, j) * g(i + 1, j) + c(i, j + 1) * g(i, j - 1))
    sd = load_stencil_module({"STENCIL": [o]})[0]
    x = random_array((32, 16), np.float32, 26)
    ca = random_array((32, 16), np.float32, 27)
    p = Problem(dims=(16, 16), stencil=sd, field="in", bdims=(4, 16),
                mesh=(2, 1), backend="pencil")
    p.init(array=x, aux={"c": ca}).step(2)
    lo, hi = sd.radius()
    pad = [(l, h) for l, h in zip(lo, hi)]
    want = x
    for _ in range(2):
        want = dense_apply(sd, {"in": np.pad(want, pad, mode="wrap"),
                                "c": np.pad(ca, pad, mode="wrap")},
                           {}, xp=np)
    assert compare_arrays(p.result(), want, 1e-5)


def _varcoeff_2d():
    i, j = Index(0), Index(1)
    g, c, o = Grid("in", 2), Grid("c", 2), Grid("out", 2)
    o(i, j).assign(c(i, j) * g(i + 1, j) + c(i, j + 1) * g(i, j - 1)
                   + 0.3 * g(i, j) * g(i, j))
    return load_stencil_module({"STENCIL": [o]})[0]


def _poly2d_grads(mesh):
    """Gradients wrt field AND aux via the exact 2-D poly pullback
    match dense AD globally."""
    import jax

    from brickjax.api import Problem

    sd = _varcoeff_2d()
    dims = (16, 16)
    gshape = tuple(m * d for m, d in zip(mesh, dims))
    x = random_array(gshape, np.float32, 51)
    ca = random_array(gshape, np.float32, 52)
    w = random_array(gshape, np.float32, 53)
    p = Problem(dims=dims, stencil=sd, field="in", bdims=(4, 16),
                mesh=mesh, backend="pencil")
    step = p.differentiable_step()
    p.init(array=x, aux={"c": ca})
    wp = Problem(dims=dims, stencil=sd, field="in", bdims=(4, 16),
                 mesh=mesh, backend="pencil")
    wp.init(array=w, aux={"c": ca})
    wb = jnp.where(p.owned_mask(), wp._dats[0], 0.0)
    gx, gc = jax.grad(
        lambda args: jnp.sum(step(*args) * wb))((p._dats[0],
                                                 p._aux[0]))

    lo, hi = sd.radius()
    pad = [(l, h) for l, h in zip(lo, hi)]

    def dense_loss(args):
        xin, cin = args
        out = dense_apply(sd, {"in": jnp.pad(xin, pad, mode="wrap"),
                               "c": jnp.pad(cin, pad, mode="wrap")},
                          {}, xp=jnp)
        return jnp.sum(out * jnp.asarray(w))

    dx, dc = jax.grad(dense_loss)((jnp.asarray(x), jnp.asarray(ca)))
    nb = p.dec.nbricks
    ndev = int(np.prod(mesh))
    for got, want in ((gx, np.asarray(dx)), (gc, np.asarray(dc))):
        gn = np.asarray(got)
        for r in range(ndev):
            own = from_bricks(gn[r * nb:(r + 1) * nb].reshape(nb, -1),
                              p.dec.interior_grid(), p.bdims)
            np.testing.assert_allclose(
                own, want[r * dims[0]:(r + 1) * dims[0]], rtol=1e-4,
                atol=1e-4)


def test_problem_2d_poly_diff_step():
    _poly2d_grads((1, 1))


def test_problem_2d_poly_diff_step_distributed():
    _poly2d_grads((2, 1))


def _system_2d():
    """2-field coupled polynomial 2-D system (Gray-Scott-like)."""
    i, j = Index(0), Index(1)
    u, v = Grid("u", 2), Grid("v", 2)
    ou, ov = Grid("ou", 2), Grid("ov", 2)
    uv = u(i, j) * v(i, j)
    ou(i, j).assign(u(i, j) + 0.1 * (u(i + 1, j) + u(i, j - 1)) - uv)
    ov(i, j).assign(v(i, j) + 0.05 * v(i, j + 1) + uv)
    return load_stencil_module({"STENCIL": [ou, ov]})


def test_problem_2d_system(mesh=(1, 1)):
    """Coupled 2-D SYSTEM runs as one multi-output kernel on the 2-D
    pencil path (Jacobi update) and matches the dense twin."""
    from brickjax.api import Problem

    sds = _system_2d()
    gshape = tuple(m * d for m, d in zip(mesh, (16, 16)))
    u0 = random_array(gshape, np.float32, 61)
    v0 = random_array(gshape, np.float32, 62)
    p = Problem(dims=(16, 16), stencil=sds, field=("u", "v"),
                bdims=(4, 16), mesh=mesh, backend="pencil")
    assert p.backend == "pencil"
    p.init(array={"u": u0, "v": v0}).step(2)
    got = p.result()
    named = {"u": u0, "v": v0}
    for _ in range(2):
        new = {}
        for oname, s_ in (("u", sds[0]), ("v", sds[1])):
            lo, hi = s_.radius()
            pad = [(l, h) for l, h in zip(lo, hi)]
            padded = {n: np.pad(a, pad, mode="wrap")
                      for n, a in named.items()}
            new[oname] = dense_apply(s_, padded, {}, xp=np)
        named = new
    assert compare_arrays(got["u"], named["u"], 1e-5)
    assert compare_arrays(got["v"], named["v"], 1e-5)


def test_problem_2d_system_distributed():
    test_problem_2d_system(mesh=(2, 1))


def _system2d_grads(mesh):
    """Exact adjoint-system pullback for the coupled 2-D system:
    grads wrt both fields match dense AD globally."""
    import jax

    from brickjax.api import Problem

    sds = _system_2d()
    dims = (16, 16)
    gshape = tuple(m * d for m, d in zip(mesh, dims))
    u0 = random_array(gshape, np.float32, 71)
    v0 = random_array(gshape, np.float32, 72)
    w = random_array(gshape, np.float32, 73)
    kw = dict(dims=dims, stencil=sds, field=("u", "v"), bdims=(4, 16),
              mesh=mesh, backend="pencil")
    p = Problem(**kw)
    step = p.differentiable_step()
    p.init(array={"u": u0, "v": v0})
    wp = Problem(**kw)
    wp.init(array={"u": w, "v": w})
    wb = jnp.where(p.owned_mask(), wp._dats[0], 0.0)
    gu, gv = jax.grad(
        lambda uv: jnp.sum(step(*uv)[0] * wb))((p._dats[0],
                                                p._dats[1]))

    def dense_loss(uv):
        named = {"u": uv[0], "v": uv[1]}
        new = {}
        for oname, s_ in (("u", sds[0]), ("v", sds[1])):
            lo, hi = s_.radius()
            pad = tuple((l, h) for l, h in zip(lo, hi))
            padded = {n: jnp.pad(a, pad, mode="wrap")
                      for n, a in named.items()}
            new[oname] = dense_apply(s_, padded, {}, xp=jnp)
        return jnp.sum(new["u"] * jnp.asarray(w))

    du, dv = jax.grad(dense_loss)((jnp.asarray(u0), jnp.asarray(v0)))
    nb = p.dec.nbricks
    for got, want in ((gu, np.asarray(du)), (gv, np.asarray(dv))):
        gn = np.asarray(got)
        for r in range(int(np.prod(mesh))):
            own = from_bricks(gn[r * nb:(r + 1) * nb].reshape(nb, -1),
                              p.dec.interior_grid(), p.bdims)
            np.testing.assert_allclose(
                own, want[r * dims[0]:(r + 1) * dims[0]], rtol=1e-4,
                atol=1e-4)


def test_problem_2d_system_diff_step():
    _system2d_grads((1, 1))


def test_problem_2d_system_diff_step_distributed():
    _system2d_grads((2, 1))


@pytest.mark.parametrize("F", [2, 4])
def test_2d_fused_equals_composed(F):
    """fuse=F (in-window trapezoid) equals F composed sweeps on a
    fully periodic table — linear (per-level matmuls; association
    differs from the unfused triple-matmul, so to 1 ulp) and generic
    paths."""
    by, X, ny = 8, 16, 16
    grid, info = init_grid((ny // by + 2, 1))
    t1 = np.asarray(grid)[:, 0].copy()
    t1[0], t1[-1] = t1[-2], t1[1]
    core = random_array((ny, X), np.float32, 81)
    ext = np.pad(core, ((by, by), (0, 0)), mode="wrap")
    view = jnp.asarray(to_bricks(ext, grid, (by, X)).reshape(-1, by, X))
    for sd, params in ((_lin5(), {"a": 0.4, "b": 0.15}),
                       (_nonlin(), {})):
        one = pencil_sweep(sd, t1, (by, X), info.nbricks,
                                     params)
        fused = pencil_sweep(sd, t1, (by, X), info.nbricks,
                                       params, fuse=F)
        want = view
        for _ in range(F):
            want = one(want)
        got = fused(view)
        g2 = np.asarray(grid)[1:-1, 0]
        np.testing.assert_allclose(np.asarray(got)[g2],
                                   np.asarray(want)[g2],
                                   rtol=0, atol=1e-6)


def test_2d_fuse_guards():
    with pytest.raises(ValueError, match="fuse"):
        pencil_sweep(_asym9(), np.arange(6), (4, 16), 6, {},
                               fuse=4)


def test_problem_2d_auto_fuse():
    """2-D Problem with schedule fuse=4: st_iter=4 runs as one F=4
    window sweep and equals 4 dense steps (distributed deep-ghost
    included)."""
    from brickjax.api import Problem

    sd = _lin5()
    params = {"a": 0.4, "b": 0.15}
    g = random_array((32, 16), np.float32, 91)
    p = Problem(dims=(16, 16), stencil=sd, params=params,
                bdims=(8, 16), mesh=(2, 1), st_iter=4,
                schedule=dict(fuse=4))
    assert p.fuse == 4, p.describe()
    p.init(array=g).step(1)
    assert compare_arrays(p.result(), _dense_steps(sd, g, 4, p.params),
                          1e-5)
    # single-device table-periodic too
    q = Problem(dims=(16, 16), stencil=sd, params=params,
                bdims=(8, 16), st_iter=4, schedule=dict(fuse=4))
    assert q.fuse == 4
    q.init(array=g[:16]).step(1)
    assert compare_arrays(q.result(),
                          _dense_steps(sd, g[:16], 4, p.params), 1e-5)


def test_problem_2d_fused_differentiable_step():
    """Table-periodic fused diff: (A^4)^T = (A^T)^4 as the F=4 adjoint
    trapezoid — gradients match dense AD through 4 composed steps."""
    import jax

    from brickjax.api import Problem

    sd = _lin5()
    params = {"a": 0.4, "b": 0.15}
    x = random_array((16, 16), np.float32, 95)
    w = random_array((16, 16), np.float32, 96)
    p = Problem(dims=(16, 16), stencil=sd, params=params,
                bdims=(8, 16), st_iter=4, schedule=dict(fuse=4))
    assert p.fuse == 4
    step = p.differentiable_step()
    p.init(array=x)
    wp = Problem(dims=(16, 16), stencil=sd, params=params,
                 bdims=(8, 16), st_iter=4)
    wp.init(array=w)
    wb = jnp.where(p.owned_mask(), wp._dats[0], 0.0)
    g = jax.grad(lambda d: jnp.sum(step(d) * wb))(p._dats[0])

    def dense_loss(d):
        for _ in range(4):
            d = dense_apply(sd, {"in": jnp.pad(d, 1, mode="wrap")},
                            params, xp=jnp)
        return jnp.sum(d * jnp.asarray(w))

    want = np.asarray(jax.grad(dense_loss)(jnp.asarray(x)))
    got = from_bricks(np.asarray(g).reshape(p.dec.nbricks, -1),
                      p.dec.interior_grid(), p.bdims)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_2d_tall_brick_by32_fused():
    """Tall BY=32 bricks stay numerically exact fused: F=4 equals 4
    composed sweeps, and the default 2-D Problem bdims are 8 rows of
    the whole width."""
    from brickjax.api import Problem

    by, X, ny = 32, 128, 64
    grid, info = init_grid((ny // by + 2, 1))
    t1 = np.asarray(grid)[:, 0].copy()
    t1[0], t1[-1] = t1[-2], t1[1]
    core = random_array((ny, X), np.float32, 17)
    ext = np.pad(core, ((by, by), (0, 0)), mode="wrap")
    view = jnp.asarray(to_bricks(ext, grid, (by, X)).reshape(-1, by, X))
    sd, params = _lin5(), {"a": 0.4, "b": 0.15}
    one = pencil_sweep(sd, t1, (by, X), info.nbricks,
                                 params)
    fused = pencil_sweep(sd, t1, (by, X), info.nbricks,
                                   params, fuse=4)
    want = view
    for _ in range(4):
        want = one(want)
    got = fused(view)
    g2 = np.asarray(grid)[1:-1, 0]
    np.testing.assert_allclose(np.asarray(got)[g2],
                               np.asarray(want)[g2], rtol=0, atol=1e-6)
    # default-bdims heuristic
    assert Problem(dims=(128, 128), stencil=sd, params=params,
                   backend="pencil").bdims == (8, 128)
    assert Problem(dims=(48, 128), stencil=sd, params=params,
                   backend="pencil").bdims == (8, 128)
