"""Multi-input stencils on the pencil fast path.

The reference codegen handles any number of input grids (per-grid
neighbor prologues, codegen/st/codegen/backend/base.py:93-123); the
pencil emitter streams one rolling window per field over ONE shared
grid table.  Both the factorized-linear path (field-tagged k-profiles,
ir.fold_linear fields=) and the generic evaluator path (grid x grid
products = variable-coefficient stencils) are validated against the
dense twin.
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
from brickjax.st import ConstRef, Grid, Index
from brickjax.st.loader import load_stencil_module

BD = (2, 4, 16)
G = (6, 5, 1)
PARAMS = {"alpha": 0.4, "beta": 0.07, "gamma": -0.2}


def _ijk():
    return Index(0), Index(1), Index(2)


def _linear_two_grid():
    """c-weighted taps from two grids: the factorized path with
    field-tagged k-profiles (all three shift stages exercised on b)."""
    a, b, out = Grid("a", 3), Grid("b", 3), Grid("out", 3)
    i, j, k = _ijk()
    rhs = (ConstRef("alpha") * a(i, j, k)
           + ConstRef("beta") * (a(i + 1, j, k) + a(i - 1, j, k)
                                 + a(i, j + 1, k) + a(i, j - 1, k)
                                 + a(i, j, k + 1) + a(i, j, k - 1))
           + ConstRef("gamma") * (b(i, j, k) + b(i + 2, j, k)
                                  + b(i, j - 1, k) + b(i, j, k + 1)))
    out(i, j, k).assign(rhs)
    return load_stencil_module({"STENCIL": [out]})[0]


def _varcoeff_two_grid():
    """Variable-coefficient stencil: grid x grid products fall back to
    the generic evaluator (linear_decomposition returns None)."""
    a, b, out = Grid("a", 3), Grid("b", 3), Grid("out", 3)
    i, j, k = _ijk()
    rhs = (b(i, j, k) * a(i, j, k)
           + b(i + 1, j, k) * a(i + 1, j, k)
           + b(i, j, k) * a(i, j, k - 1)
           + ConstRef("alpha") * a(i, j + 1, k))
    out(i, j, k).assign(rhs)
    return load_stencil_module({"STENCIL": [out]})[0]


@pytest.mark.parametrize("make", [_linear_two_grid, _varcoeff_two_grid])
def test_two_grid_pencil_matches_dense(make):
    sd = make()
    assert len(sd.inputs) == 2
    grid, info = init_grid(G)
    KI, JI = G[0] - 2, G[1] - 2
    cores = {n: random_array((KI * BD[0], JI * BD[1], BD[2]),
                             np.float32, 5 + fi)
             for fi, n in enumerate(sd.inputs)}
    views = {}
    for n, core in cores.items():
        ext = np.pad(core, ((BD[0], BD[0]), (BD[1], BD[1]), (0, 0)),
                     mode="wrap")
        views[n] = jnp.asarray(
            to_bricks(ext, grid, BD).reshape((-1,) + BD))

    fn = pencil_sweep(sd, grid, BD, info.nbricks,
                               PARAMS)
    out = np.asarray(fn(*(views[n] for n in fn.fields)))

    lo, hi = sd.radius()
    padded = {n: np.pad(c, [(l, h) for l, h in zip(lo, hi)],
                        mode="wrap") for n, c in cores.items()}
    want = dense_apply(sd, padded, PARAMS, xp=np)
    got = from_bricks(out, grid[1:-1, 1:-1], BD)
    assert compare_arrays(got, want, 1e-5)


def test_two_grid_guards():
    """Fused multi-input sweeps build (the evolving grid iterates, aux
    stays on its window) but inplace partial sweeps reject multi-input
    stencils instead of silently merging fields."""
    from brickjax.codegen.sweep import pencil_sweep

    sd = _linear_two_grid()
    grid, _info = init_grid(G)
    fn = pencil_sweep(sd, grid, BD, 30, PARAMS, fuse=2)
    assert fn.fields == tuple(sd.inputs)
    with pytest.raises(NotImplementedError, match="one input grid"):
        pencil_sweep(sd, grid, BD, 30, PARAMS, inplace=True)


def _dense_aux_steps(sd, field, state, auxs, n, params):
    lo, hi = sd.radius()
    pads = {k: np.pad(v, list(zip(lo, hi)), mode="wrap")
            for k, v in auxs.items()}
    w = state
    for _ in range(n):
        ins = dict(pads)
        ins[field] = np.pad(w, list(zip(lo, hi)), mode="wrap")
        w = dense_apply(sd, ins, params, xp=np)
    return w


def test_problem_aux_field_pencil():
    """Variable-coefficient Problem on the pencil backend: the static
    aux field rides along unexchanged; state ping-pongs."""
    from brickjax.api import Problem

    sd = _varcoeff_two_grid()
    state = random_array((16, 16, 32), np.float32, 3)
    cfld = random_array((16, 16, 32), np.float32, 4)
    p = Problem(dims=(16, 16, 32), stencil=sd, field="a",
                backend="pencil", bdims=(4, 4, 32), params=PARAMS)
    p.init(array=state, aux={"b": cfld}).step(2)
    want = _dense_aux_steps(sd, "a", state, {"b": cfld}, 2, p.params)
    assert compare_arrays(p.result(), want, 1e-4)


def test_problem_aux_field_jnp_distributed_deep_ghost():
    """Aux fields on an 8-device mesh with st_iter=2: aux ghost filled
    once at init by wrap never goes stale, so deep-ghost composes."""
    from brickjax.api import Problem

    sd = _linear_two_grid()
    state = random_array((16, 16, 32), np.float32, 5)
    cfld = random_array((16, 16, 32), np.float32, 6)
    q = Problem(dims=(8, 8, 16), stencil=sd, field="a", mesh=(2, 2, 2),
                backend="jnp", bdims=(4, 4, 8), st_iter=2,
                params=PARAMS)
    q.init(array=state, aux={"b": cfld}).step(1)
    want = _dense_aux_steps(sd, "a", state, {"b": cfld}, 2, q.params)
    assert compare_arrays(q.result(), want, 1e-4)


def test_problem_aux_validation():
    from brickjax.api import Problem

    sd = _linear_two_grid()
    with pytest.raises(ValueError, match="not a stencil input"):
        Problem(dims=(16, 16, 32), stencil=sd, field="nope",
                backend="jnp")
    p = Problem(dims=(16, 16, 32), stencil=sd, field="a",
                backend="jnp", bdims=(8, 8, 16), params=PARAMS)
    with pytest.raises(ValueError, match="aux"):
        p.init(seed=0)          # missing aux array for "b"
    with pytest.raises(ValueError, match="unknown aux"):
        p.init(seed=0, aux={"b": np.zeros((16, 16, 32), np.float32),
                            "c": np.zeros((16, 16, 32), np.float32)})


def test_problem_aux_field_pencil_distributed():
    """Aux field on a (2,1,1) mesh with the pencil backend and
    deep-ghost st_iter: state exchanges per step, aux never does."""
    from brickjax.api import Problem

    sd = _linear_two_grid()
    state = random_array((16, 16, 32), np.float32, 7)
    cfld = random_array((16, 16, 32), np.float32, 8)
    q = Problem(dims=(8, 16, 32), stencil=sd, field="a", mesh=(2, 1, 1),
                backend="pencil", bdims=(4, 8, 32), st_iter=2,
                params=PARAMS)
    q.init(array=state, aux={"b": cfld}).step(1)
    want = _dense_aux_steps(sd, "a", state, {"b": cfld}, 2, q.params)
    assert compare_arrays(q.result(), want, 1e-4)


def test_problem_init_validation_leaves_uninitialized():
    """A failed init (missing aux) must not leave half-loaded state."""
    from brickjax.api import Problem

    sd = _linear_two_grid()
    p = Problem(dims=(16, 16, 32), stencil=sd, field="a",
                backend="jnp", bdims=(8, 8, 16), params=PARAMS)
    with pytest.raises(ValueError, match="aux"):
        p.init(seed=0)
    with pytest.raises(RuntimeError, match="init"):
        p.step(1)


def test_problem_auto_backend_4d_multigrid_falls_back_to_jnp():
    """backend='auto' must not pick a pencil configuration it will
    then reject (4-D multi-input)."""
    from brickjax.api import Problem

    a, b, out = Grid("a", 4), Grid("b", 4), Grid("out", 4)
    i, j, k, w = Index(0), Index(1), Index(2), Index(3)
    out(i, j, k, w).assign(ConstRef("alpha") * a(i, j, k, w)
                           + b(i + 1, j, k, w))
    sd = load_stencil_module({"STENCIL": [out]})[0]
    p = Problem(dims=(4, 8, 8, 32), stencil=sd, field="a",
                mesh=(1, 1, 1, 1), bdims=(2, 4, 4, 16), params=PARAMS)
    assert p.backend == "jnp"
