"""Distributed ghost exchange on an 8-device CPU mesh — the reference's
single-box mpirun validation (weak drivers compare brick exchange vs
array exchange under periodic wrap, weak/main.cpp:116-170,292-294)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from brickjax.comm import BrickDecomp, skin3d_good
from brickjax.comm.exchange import (
    exchange_array,
    exchange_put,
    exchange_shift,
)
from brickjax.comm.mesh import make_domain_mesh, shard_map
from brickjax.core import (
    compare_arrays,
    from_bricks,
    random_array,
    to_bricks,
)

MESH_SHAPE = (2, 2, 2)
DIMS = (8, 8, 16)           # per-device owned elements
BD = (4, 4, 8)
GZ = (4, 4, 8)              # one brick of ghost per axis


def _global_and_blocks(seed=0):
    """Global periodic domain + per-device ground-truth extended blocks."""
    gshape = tuple(m * d for m, d in zip(MESH_SHAPE, DIMS))
    g = random_array(gshape, np.float32, seed)
    blocks = {}
    for c in np.ndindex(*MESH_SHAPE):
        idx = []
        for a in range(3):
            start = c[a] * DIMS[a] - GZ[a]
            idx.append(np.arange(start, start + DIMS[a] + 2 * GZ[a])
                       % gshape[a])
        blocks[c] = g[np.ix_(*idx)]
    return g, blocks


def _decomp():
    return BrickDecomp(dims=DIMS, ghost_depth=GZ, bdims=BD).initialize(
        skin3d_good)


def _stack_bricks(dec, blocks, zero_ghost=True):
    """[P..., nbricks, belems] array of per-device brick storage."""
    out = np.zeros(MESH_SHAPE + (dec.nbricks, int(np.prod(BD))),
                   dtype=np.float32)
    for c, blk in blocks.items():
        dat = np.zeros((dec.nbricks, int(np.prod(BD))), np.float32)
        to_bricks(blk, dec.grid, BD, dat=dat, offset=0)
        if zero_ghost:
            dat[dec.sep_pos[1]:] = 0.0  # wipe ghost segment
            dat[0] = 0.0
        out[c] = dat
    return out


@pytest.mark.parametrize("which", ["put", "shift"])
def test_brick_exchange_fills_ghost(which):
    dec = _decomp()
    _, blocks = _global_and_blocks()
    stacked = _stack_bricks(dec, blocks, zero_ghost=True)

    mesh = make_domain_mesh(MESH_SHAPE)
    names = mesh.axis_names
    fn = exchange_put if which == "put" else exchange_shift

    def step(dat):
        d = dat[0, 0, 0]
        d = fn(d, dec, names, MESH_SHAPE)
        return d[None, None, None]

    sharded = jax.device_put(
        jnp.asarray(stacked),
        NamedSharding(mesh, P(*names)))
    out = jax.jit(shard_map(step, mesh, P(*names), P(*names)))(sharded)
    out = np.asarray(out)

    for c, blk in blocks.items():
        got = from_bricks(out[c], dec.grid, BD)
        assert compare_arrays(got, blk, 1e-7), (which, c)


def test_array_exchange_twin():
    _, blocks = _global_and_blocks(seed=3)
    ext_shape = tuple(d + 2 * g for d, g in zip(DIMS, GZ))
    stacked = np.zeros(MESH_SHAPE + ext_shape, dtype=np.float32)
    for c, blk in blocks.items():
        b = blk.copy()
        # zero the ghost shell
        core = b[GZ[0]:-GZ[0], GZ[1]:-GZ[1], GZ[2]:-GZ[2]].copy()
        b[:] = 0
        b[GZ[0]:-GZ[0], GZ[1]:-GZ[1], GZ[2]:-GZ[2]] = core
        stacked[c] = b

    mesh = make_domain_mesh(MESH_SHAPE)
    names = mesh.axis_names

    def step(arr):
        a = arr[0, 0, 0]
        a = exchange_array(a, GZ, names, MESH_SHAPE)
        return a[None, None, None]

    sharded = jax.device_put(jnp.asarray(stacked),
                             NamedSharding(mesh, P(*names)))
    out = np.asarray(jax.jit(shard_map(step, mesh, P(*names),
                                       P(*names)))(sharded))
    for c, blk in blocks.items():
        assert compare_arrays(out[c], blk, 1e-7), c


def test_weak_scaling_step_brick_vs_array():
    """Full weak-scaling step: exchange + mpi7pt stencil, brick path vs
    array path (the reference's flagship validation,
    weak/main.cpp:137-170)."""
    from brickjax.codegen import brick_apply, dense_apply
    from brickjax.stencils import DEFAULT_PARAMS, stencil_by_name

    sd = stencil_by_name("mpi7pt")[0]
    dec = _decomp()
    _, blocks = _global_and_blocks(seed=11)
    stacked = _stack_bricks(dec, blocks, zero_ghost=True)
    mesh = make_domain_mesh(MESH_SHAPE)
    names = mesh.axis_names
    adj = jnp.asarray(dec.info.adj)

    def step(dat):
        d = dat[0, 0, 0]
        d = exchange_shift(d, dec, names, MESH_SHAPE)
        view = d.reshape((-1,) + BD)
        out = brick_apply(sd, {"in": view}, adj, DEFAULT_PARAMS)
        return out.reshape(d.shape)[None, None, None]

    sharded = jax.device_put(jnp.asarray(stacked),
                             NamedSharding(mesh, P(*names)))
    out = np.asarray(jax.jit(shard_map(step, mesh, P(*names),
                                       P(*names)))(sharded))

    for c, blk in blocks.items():
        # array twin: stencil on the ground-truth extended block
        want = dense_apply(sd, {"in": blk}, DEFAULT_PARAMS, xp=np)
        lo, hi = sd.radius()
        # valid region of `want` = extended[lo : -hi]; compare the owned
        # interior (skip ghost bricks)
        own = tuple(slice(GZ[a] - lo[a], GZ[a] - lo[a] + DIMS[a])
                    for a in range(3))
        want_own = want[own]
        got = from_bricks(out[c], dec.interior_grid(), BD)
        assert compare_arrays(got, want_own, 1e-5), c


@pytest.mark.parametrize("seed", range(5))
def test_exchange_geometry_fuzz(seed):
    """Random decomp geometry (mesh shape, brick fold, skin ordering,
    PUT vs SHIFT) against the global-wrap ground truth — the exchange
    must be correct for ANY layout the planner accepts, not just the
    canonical test shapes."""
    from brickjax.comm import skinlist_by_name

    rng = np.random.default_rng(500 + seed)
    meshes = [(2, 2, 2), (2, 2, 1), (2, 1, 2), (1, 2, 2), (4, 2, 1),
              (1, 1, 8)]
    mesh_shape = meshes[int(rng.integers(len(meshes)))]
    bd = (int(rng.choice([2, 4])), int(rng.choice([2, 4])),
          int(rng.choice([4, 8])))
    gb = [int(rng.integers(2, 4)) for _ in range(3)]   # interior bricks
    dims = tuple(g * b for g, b in zip(gb, bd))
    order = str(rng.choice(["good", "normal", "bad"]))
    which = str(rng.choice(["put", "shift"]))

    dec = BrickDecomp(dims=dims, ghost_depth=bd, bdims=bd).initialize(
        skinlist_by_name(order, 3))
    gshape = tuple(m * d for m, d in zip(mesh_shape, dims))
    g = random_array(gshape, np.float32, seed)
    blocks = {}
    for c in np.ndindex(*mesh_shape):
        idx = [np.arange(c[a] * dims[a] - bd[a],
                         c[a] * dims[a] + dims[a] + bd[a]) % gshape[a]
               for a in range(3)]
        blocks[c] = g[np.ix_(*idx)]
    stacked = np.zeros(mesh_shape + (dec.nbricks, int(np.prod(bd))),
                       np.float32)
    for c, blk in blocks.items():
        dat = np.zeros((dec.nbricks, int(np.prod(bd))), np.float32)
        to_bricks(blk, dec.grid, bd, dat=dat)
        dat[dec.sep_pos[1]:] = 0.0
        dat[0] = 0.0
        stacked[c] = dat

    mesh = make_domain_mesh(mesh_shape)
    names = mesh.axis_names
    fn = exchange_put if which == "put" else exchange_shift

    def step(dat):
        d = dat[(0,) * 3]
        return fn(d, dec, names, mesh_shape)[None, None, None]

    sharded = jax.device_put(jnp.asarray(stacked),
                             NamedSharding(mesh, P(*names)))
    out = np.asarray(jax.jit(shard_map(step, mesh, P(*names),
                                       P(*names)))(sharded))
    for c, blk in blocks.items():
        got = from_bricks(out[c], dec.grid, bd)
        assert compare_arrays(got, blk, 1e-7), (seed, which, order, c)


@pytest.mark.parametrize("shape", [(4, 4, 1), (1, 1, 16)])
def test_domain_mesh_raises_with_too_few_devices(shape):
    """A mesh larger than the device count raises; it never falls back
    to devices of another platform."""
    with pytest.raises(ValueError, match="needs 16 devices"):
        make_domain_mesh(shape)
