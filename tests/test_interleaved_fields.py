"""Interleaved-field flows: two fields per chunk, exchanged together
(ref: stencils/3axis.cpp:26-28 interleaved bIn/bOut; exchange moves the
whole chunk, brick-mpi.h:466-495)."""

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from brickjax.codegen import brick_apply, dense_apply
from brickjax.comm import BrickDecomp, skin3d_good
from brickjax.comm.exchange import exchange_shift
from brickjax.comm.mesh import make_domain_mesh, shard_map
from brickjax.core import (
    compare_arrays,
    from_bricks,
    random_array,
    to_bricks,
)
from brickjax.stencils import DEFAULT_PARAMS, stencil_by_name

BD = (4, 4, 8)
BEL = 128
DIMS = (8, 8, 16)
GZ = BD
MESH = (2, 2, 2)


def test_pingpong_interleaved_exchange():
    """in/out interleaved in one chunk; ONE exchange per step moves both
    fields; two steps of 7pt ping-pong must match the dense twin."""
    sd = stencil_by_name("mpi7pt")[0]
    dec = BrickDecomp(dims=DIMS, ghost_depth=GZ, bdims=BD,
                      numfield=2).initialize(skin3d_good)
    adj = jnp.asarray(dec.info.adj)
    mesh = make_domain_mesh(MESH)
    names = mesh.axis_names

    gshape = tuple(m * d for m, d in zip(MESH, DIMS))
    g = random_array(gshape, np.float32, 7)
    stacked = np.zeros(MESH + (dec.nbricks, 2 * BEL), np.float32)
    blocks = {}
    for c in np.ndindex(*MESH):
        idx = [(np.arange(c[a] * DIMS[a] - GZ[a],
                          c[a] * DIMS[a] + DIMS[a] + GZ[a]) % gshape[a])
               for a in range(3)]
        blocks[c] = g[np.ix_(*idx)]
        dat = np.zeros((dec.nbricks, 2 * BEL), np.float32)
        to_bricks(blocks[c], dec.grid, BD, dat=dat, offset=0)
        dat[dec.sep_pos[1]:] = 0
        stacked[c] = dat

    def step(dat):
        d = dat[0, 0, 0]
        for fld in (0, 1):  # ping-pong: fld -> 1-fld
            d = exchange_shift(d, dec, names, MESH)  # moves BOTH fields
            src = d[:, fld * BEL:(fld + 1) * BEL].reshape((-1,) + BD)
            out = brick_apply(sd, {"in": src}, adj, DEFAULT_PARAMS)
            o = 1 - fld
            d = d.at[:, o * BEL:(o + 1) * BEL].set(
                out.reshape(-1, BEL))
        return d[None, None, None]

    sharded = jax.device_put(jnp.asarray(stacked),
                             NamedSharding(mesh, P(*names)))
    out = np.asarray(jax.jit(shard_map(step, mesh, P(*names),
                                       P(*names)))(sharded))

    # dense twin: two applications on the global periodic field
    w = g
    for _ in range(2):
        wp = np.pad(w, 1, mode="wrap")
        w = dense_apply(sd, {"in": wp}, DEFAULT_PARAMS, xp=np)
    for c in np.ndindex(*MESH):
        got = from_bricks(out[c], dec.interior_grid(), BD, offset=0)
        sl = tuple(slice(c[a] * DIMS[a], (c[a] + 1) * DIMS[a])
                   for a in range(3))
        assert compare_arrays(got, w[sl], 1e-4), c
