"""Pencil-brick sweep vs dense periodic twin."""

import numpy as np
import pytest

import jax.numpy as jnp

from brickjax.codegen import dense_apply
from brickjax.codegen.sweep import pencil_sweep
from brickjax.core import compare_arrays, from_bricks, init_grid, random_array, to_bricks
from brickjax.stencils import DEFAULT_PARAMS, stencil_by_name

PARAMS = dict(DEFAULT_PARAMS)
PARAMS["coeff"] = [0.03 * (c + 1) for c in range(27)]
BD = (2, 4, 16)
G = (6, 5, 1)


@pytest.fixture(scope="module")
def data():
    grid, info = init_grid(G)
    KI, JI = G[0] - 2, G[1] - 2
    core = random_array((KI * BD[0], JI * BD[1], BD[2]), np.float32, 5)
    ext = np.pad(core, ((BD[0], BD[0]), (BD[1], BD[1]), (0, 0)),
                 mode="wrap")
    dat = to_bricks(ext, grid, BD)
    return grid, info, core, jnp.asarray(dat.reshape((-1,) + BD))


@pytest.mark.parametrize("name,tj", [("s7pt", None), ("mpi13pt", None),
                                     ("s7pt", 1)])
def test_pencil_matches_dense_periodic(data, name, tj):
    grid, info, core, view = data
    sd = stencil_by_name(name)[0]
    fn = pencil_sweep(sd, grid, BD, info.nbricks,
                               PARAMS)
    out = np.asarray(fn(view))
    lo, hi = sd.radius()
    corep = np.pad(core, [(l, h) for l, h in zip(lo, hi)], mode="wrap")
    want = dense_apply(sd, {next(iter(sd.inputs)): corep}, PARAMS, xp=np)
    got = from_bricks(out, grid[1:-1, 1:-1], BD)
    assert compare_arrays(got, want, 1e-5)


# full corpus incl. the i-profile factorization branch (125pt/25pt) and
# the generic-evaluator branch (cond's If/max) — the code paths behind
# the published numbers must have committed numeric tests
@pytest.mark.parametrize("name,bd", [("mpi125pt", (2, 4, 16)),
                                     ("s27pt", (2, 4, 16)),
                                     ("mpi25pt", (4, 8, 16)),
                                     ("cond", (2, 4, 16))])
def test_pencil_corpus_matches_dense(name, bd):
    grid, info = init_grid(G)
    KI, JI = G[0] - 2, G[1] - 2
    core = random_array((KI * bd[0], JI * bd[1], bd[2]), np.float32, 7)
    ext = np.pad(core, ((bd[0], bd[0]), (bd[1], bd[1]), (0, 0)),
                 mode="wrap")
    view = jnp.asarray(to_bricks(ext, grid, bd).reshape((-1,) + bd))
    sd = stencil_by_name(name)[0]
    fn = pencil_sweep(sd, grid, bd, info.nbricks,
                               PARAMS)
    out = np.asarray(fn(view))
    lo, hi = sd.radius()
    corep = np.pad(core, [(l, h) for l, h in zip(lo, hi)], mode="wrap")
    want = dense_apply(sd, {next(iter(sd.inputs)): corep}, PARAMS, xp=np)
    got = from_bricks(out, grid[1:-1, 1:-1], bd)
    assert compare_arrays(got, want, 1e-5)


def test_deep_ghost_st_iter_composition(data):
    """Ghost-inclusive sweep (skip=0) then owned sweep (skip=1) — two
    iterations per exchange; contamination from clamped edge windows
    must stay inside the ghost ring (ref: weak/main.cpp:203-212)."""
    from brickjax.codegen.sweep import pencil_sweep

    grid, info, core, view = data
    sd = stencil_by_name("s7pt")[0]
    GK, GJ = grid.shape[0], grid.shape[1]
    fn0 = pencil_sweep(sd, grid, BD, info.nbricks, PARAMS,
                              k_range=(0, GK), j_range=(0, GJ))
    fn1 = pencil_sweep(sd, grid, BD, info.nbricks, PARAMS,
                              k_range=(1, GK - 1), j_range=(1, GJ - 1))
    out = np.asarray(fn1(fn0(view)))

    gname = next(iter(sd.inputs))
    lo, hi = sd.radius()
    KI, JI = GK - 2, GJ - 2
    ext = np.pad(core, ((BD[0], BD[0]), (BD[1], BD[1]), (0, 0)),
                 mode="wrap")
    b = ext
    for _ in range(2):
        bp = np.pad(b, [(l, h) for l, h in zip(lo, hi)], mode="wrap")
        b = dense_apply(sd, {gname: bp}, PARAMS, xp=np)
    want = b[BD[0]:BD[0] + KI * BD[0], BD[1]:BD[1] + JI * BD[1], :]
    got = from_bricks(out, grid[1:-1, 1:-1], BD)
    assert compare_arrays(got, want, 1e-5)


def test_deep_ghost_i_bricked_composition():
    """Ghost-inclusive sweep INCLUDING the i-ghost brick ring (i_range
    (0, GI): out-of-table i neighbors clamp to duplicated edge bricks in
    the assembled window) then an owned sweep — deep-ghost ST_ITER for
    distributed-i layouts (ref: weak/main.cpp:203-212)."""
    from brickjax.codegen.sweep import pencil_sweep

    bd = (2, 4, 16)
    G3 = (4, 4, 4)
    grid, info = init_grid(G3)
    core = random_array(tuple(2 * b for b in bd), np.float32, 9)
    ext = np.pad(core, [(b, b) for b in bd], mode="wrap")
    view = jnp.asarray(to_bricks(ext, grid, bd).reshape((-1,) + bd))
    sd = stencil_by_name("s7pt")[0]
    fn0 = pencil_sweep(sd, grid, bd, info.nbricks, PARAMS, i_ghost=1, k_range=(0, 4), j_range=(0, 4),
                               i_range=(0, 4))
    fn1 = pencil_sweep(sd, grid, bd, info.nbricks, PARAMS, i_ghost=1)
    out = np.asarray(fn1(fn0(view)))

    gname = next(iter(sd.inputs))
    lo, hi = sd.radius()
    b = ext
    for _ in range(2):
        bp = np.pad(b, [(l, h) for l, h in zip(lo, hi)], mode="wrap")
        b = dense_apply(sd, {gname: bp}, PARAMS, xp=np)
    want = b[bd[0]:3 * bd[0], bd[1]:3 * bd[1], bd[2]:3 * bd[2]]
    got = from_bricks(out, grid[1:-1, 1:-1, 1:-1], bd)
    assert compare_arrays(got, want, 1e-5)


def test_weak_driver_distributed_pencil_st_iter():
    """Deep-ghost pencil on a real (2,1,1) mesh with ST_ITER=2,
    validated against the array twin inside the driver."""
    from brickjax.drivers import weak

    weak.run(dims=(16, 16, 32), bdim=(8, 8, 8), stencil="mpi7pt",
             st_iter=2, mesh_shape=(2, 1, 1), iters=1, validate=True,
             backend="pencil")


def test_weak_driver_overlap_pencil():
    """Interior/ring split (sep_pos interior-first, brick-mpi.h:196):
    inner sweep from pre-exchange data + in-place ring sweeps after the
    exchange must equal the monolithic step."""
    from brickjax.drivers import weak

    weak.run(dims=(32, 32, 32), bdim=(8, 8, 8), stencil="mpi7pt",
             st_iter=1, mesh_shape=(2, 2, 1), iters=1, validate=True,
             backend="pencil", overlap=True)
    weak.run(dims=(32, 16, 32), bdim=(8, 8, 8), stencil="mpi7pt",
             st_iter=4, mesh_shape=(2, 1, 1), iters=1, validate=True,
             backend="pencil", overlap=True)


@pytest.mark.parametrize("name,F", [("s7pt", 2), ("s7pt", 3),
                                    ("mpi13pt", 2)])
def test_fused_sweep_matches_dense(name, F):
    """Temporal fusion: F iterations per HBM pass == F dense iterations
    on the periodic table (exact), any radius with F*r <= BJ."""
    from brickjax.comm import BrickDecomp, skin3d_good
    from brickjax.codegen.sweep import pencil_sweep

    BDf = (8, 8, 32)
    dec = BrickDecomp(dims=(32, 32, 32), ghost_depth=(8, 8, 0),
                      bdims=BDf).initialize(skin3d_good)
    core = random_array((32, 32, 32), np.float32, 5)
    ext = np.pad(core, ((8, 8), (8, 8), (0, 0)), mode="wrap")
    dat = np.zeros((dec.nbricks, int(np.prod(BDf))), np.float32)
    to_bricks(ext, dec.grid, BDf, dat=dat)
    view = jnp.asarray(dat.reshape((-1,) + BDf))
    sd = stencil_by_name(name)[0]
    gname = next(iter(sd.inputs))
    lo, hi = sd.radius()
    fn = pencil_sweep(sd, dec.periodic_grid((0, 1, 2)), BDf,
                             dec.nbricks, PARAMS, fuse=F)
    out = np.asarray(fn(view))
    b = core
    for _ in range(F):
        bp = np.pad(b, [(l, h) for l, h in zip(lo, hi)], mode="wrap")
        b = dense_apply(sd, {gname: bp}, PARAMS, xp=np)
    got = from_bricks(out, dec.interior_grid(), BDf)
    assert compare_arrays(got, b, 1e-4)


def test_weak_driver_fused_deep_ghost():
    """st_iter=4 as two fused F=2 sweeps on a (2,1,1) mesh."""
    from brickjax.drivers import weak

    weak.run(dims=(32, 16, 32), bdim=(8, 8, 8), stencil="mpi7pt",
             st_iter=4, mesh_shape=(2, 1, 1), iters=1, validate=True,
             backend="pencil", fuse=2)


def test_fuse_k_radius_guard():
    """fuse x k-radius must fit the brick row depth: clamped-edge
    contamination grows radius elements per fused level (review
    finding: F=4, r=1, BK=2 silently corrupted owned rows)."""
    from brickjax.comm import BrickDecomp, skin3d_good
    from brickjax.codegen.sweep import pencil_sweep

    dec = BrickDecomp(dims=(8, 32, 32), ghost_depth=(2, 8, 0),
                      bdims=(2, 8, 32)).initialize(skin3d_good)
    sd = stencil_by_name("s7pt")[0]
    with pytest.raises(ValueError, match="k-radius"):
        pencil_sweep(sd, dec.periodic_grid((0, 1, 2)),
                            (2, 8, 32), dec.nbricks, PARAMS, fuse=4)


def test_problem_single_device_deep_ghost_bound():
    """The jnp path's ghost is finite on every device count; st_iter
    beyond the validity bound must raise even at mesh=(1,1,1)."""
    from brickjax.api import Problem

    with pytest.raises(ValueError, match="ghost depth"):
        Problem(dims=(8, 8, 16), stencil="mpi125pt", mesh=(1, 1, 1),
                bdims=(4, 4, 8), backend="jnp", st_iter=8)
