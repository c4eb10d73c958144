"""Golden numeric tests: brick executor vs dense twin for every corpus
stencil — the reference's array-vs-brick compare
(ref: stencils/3axis.cpp:78-86, weak/main.cpp:292-294)."""

import numpy as np
import pytest

from brickjax.codegen import brick_apply, dense_apply
from brickjax.core import (
    compare_arrays,
    from_bricks,
    init_grid,
    random_array,
    to_bricks,
)
from brickjax.stencils import DEFAULT_PARAMS, stencil_by_name

PARAMS = dict(DEFAULT_PARAMS)
PARAMS["coeff"] = [0.03 * (c + 1) for c in range(27)]

BD3 = (4, 4, 8)
G3 = (4, 4, 4)  # 16x16x32 domain, one brick of ghost each side


def _setup3(seed=5, dtype=np.float64):
    arr = random_array(tuple(g * b for g, b in zip(G3, BD3)), dtype, seed)
    grid, info = init_grid(G3)
    dat = to_bricks(arr, grid, BD3)
    return arr, grid, info, dat


def _valid_region(arr, lo, hi):
    return arr[tuple(slice(l, s - h) for l, s, h in
                     zip(lo, arr.shape, hi))]


@pytest.mark.parametrize("name", ["s7pt", "cond", "s27pt", "mpi7pt",
                                  "mpi13pt", "mpi25pt", "mpi125pt"])
def test_brick_matches_dense_3d(name):
    sd = stencil_by_name(name)[0]
    in_name = sd.inputs and next(iter(sd.inputs))
    arr, grid, info, dat = _setup3()
    view = dat.reshape((-1,) + BD3)

    out_view = brick_apply(sd, {in_name: view}, info.adj, PARAMS, xp=np)
    dense = dense_apply(sd, {in_name: arr}, PARAMS, xp=np)

    lo, hi = sd.radius()
    # compare on bricks fully covered by the dense valid region: skip the
    # outer brick ring (ghost analog)
    inner = grid[1:-1, 1:-1, 1:-1]
    got = from_bricks(out_view.reshape(len(dat), -1), inner, BD3)
    # dense valid region, trimmed to the inner-brick window
    off = [b - l for b, l in zip(BD3, lo)]
    want = dense[tuple(slice(o, o + ib * b) for o, ib, b in
                       zip(off, inner.shape, BD3))]
    assert got.shape == want.shape
    assert compare_arrays(got, want, 1e-12), name


def test_brick_matches_dense_4d():
    sd = stencil_by_name("mpi9pt")[0]
    bd = (2, 2, 4, 8)
    gd = (3, 3, 3, 3)
    arr = random_array(tuple(g * b for g, b in zip(gd, bd)), np.float64, 11)
    grid, info = init_grid(gd)
    dat = to_bricks(arr, grid, bd)
    view = dat.reshape((-1,) + bd)
    out_view = brick_apply(sd, {"in": view}, info.adj, {}, xp=np)
    dense = dense_apply(sd, {"in": arr}, {}, xp=np)
    inner = grid[1:-1, 1:-1, 1:-1, 1:-1]
    got = from_bricks(out_view.reshape(len(dat), -1), inner, bd)
    lo, hi = sd.radius()
    off = [b - l for b, l in zip(bd, lo)]
    want = dense[tuple(slice(o, o + ib * b) for o, ib, b in
                       zip(off, inner.shape, bd))]
    assert compare_arrays(got, want, 1e-12)


def test_jnp_matches_numpy():
    import jax.numpy as jnp

    sd = stencil_by_name("mpi7pt")[0]
    arr, grid, info, dat = _setup3(seed=8, dtype=np.float32)
    view = dat.reshape((-1,) + BD3)
    out_np = brick_apply(sd, {"in": view}, info.adj, PARAMS, xp=np)
    out_j = brick_apply(sd, {"in": jnp.asarray(view)},
                        jnp.asarray(info.adj), PARAMS)
    assert compare_arrays(out_np, np.asarray(out_j), 1e-6)


def test_jnp_jit_brick_apply():
    import jax
    import jax.numpy as jnp

    sd = stencil_by_name("s7pt")[0]
    arr, grid, info, dat = _setup3(seed=2, dtype=np.float32)
    view = jnp.asarray(dat.reshape((-1,) + BD3))
    adj = jnp.asarray(info.adj)

    @jax.jit
    def step(v):
        return brick_apply(sd, {"bIn": v}, adj, PARAMS)

    out = step(view)
    out_np = brick_apply(sd, {"bIn": np.asarray(view)}, info.adj, PARAMS,
                         xp=np)
    assert compare_arrays(np.asarray(out), out_np, 1e-6)


def test_dense_apply_region_semantics():
    """Valid region is arr[lo : S-hi]; a uniform field stays uniform."""
    sd = stencil_by_name("mpi13pt")[0]
    arr = np.ones((16, 16, 16))
    out = dense_apply(sd, {"in": arr}, PARAMS, xp=np)
    assert out.shape == (12, 12, 12)
    expect = PARAMS["MPI_B0"] + 6 * PARAMS["MPI_B1"] + 6 * PARAMS["MPI_B2"]
    assert compare_arrays(out, np.full((12, 12, 12), expect), 1e-12)
