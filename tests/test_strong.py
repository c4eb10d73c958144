"""Two-level strong-scaling decomposition (ref: strong/main.cpp
validation with -v, strong/main.cpp:402-464)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from brickjax.codegen import brick_apply, dense_apply
from brickjax.comm import skin3d_good
from brickjax.comm.mesh import make_domain_mesh, shard_map
from brickjax.comm.strong import StrongDecomp, exchange_strong_shift
from brickjax.core import compare_arrays, from_bricks, random_array, to_bricks
from brickjax.stencils import DEFAULT_PARAMS, stencil_by_name

BD = (4, 4, 8)
GZ = (4, 4, 8)
SDOM = (16, 16, 16)
DOM = (64, 32, 32)
MESH = (2, 1, 1)  # 2 devices; 8 subdomains per device (4,2,2 grid)


@pytest.fixture(scope="module")
def plan():
    return StrongDecomp(dom=DOM, sdom=SDOM, mesh_shape=MESH, bdims=BD,
                        ghost_depth=GZ).initialize(skin3d_good)


def test_plan_shape(plan):
    assert plan.sub_grid == (4, 2, 2)
    assert plan.local_block == (2, 2, 2)
    assert plan.nsub_local == 8
    # Morton order within the block: first sub is the origin, second is +x
    assert tuple(plan.sub_order[0]) == (0, 0, 0)
    assert tuple(plan.sub_order[1]) == (0, 0, 1)
    assert tuple(plan.sub_order[2]) == (0, 1, 0)


def _build(plan, seed=5):
    g = random_array(DOM, np.float32, seed)
    nloc = plan.nsub_local
    dev_batches = []
    truth = {}
    for dz in range(MESH[0]):
        rows = []
        for row in range(nloc):
            c = plan.sub_order[row]
            base = (dz * plan.local_block[0] + c[0],
                    c[1], c[2])
            idx = [(np.arange(base[a] * SDOM[a] - GZ[a],
                              base[a] * SDOM[a] + SDOM[a] + GZ[a])
                    % DOM[a]) for a in range(3)]
            blk = g[np.ix_(*idx)]
            truth[(dz, row)] = blk
            dat = np.zeros((plan.sdec.nbricks, int(np.prod(BD))),
                           np.float32)
            to_bricks(blk, plan.sdec.grid, BD, dat=dat)
            dat[plan.sdec.sep_pos[1]:] = 0
            dat[0] = 0
            rows.append(dat)
        dev_batches.append(np.stack(rows))
    return g, truth, np.stack(dev_batches)[:, None, None]  # [2,1,1,...]


def test_strong_exchange_fills_ghosts(plan):
    g, truth, stacked = _build(plan)
    mesh = make_domain_mesh(MESH)
    names = mesh.axis_names

    def step(b):
        x = b[0, 0, 0]
        x = exchange_strong_shift(x, plan, names)
        return x[None, None, None]

    sharded = jax.device_put(jnp.asarray(stacked),
                             NamedSharding(mesh, P(*names)))
    out = np.asarray(jax.jit(shard_map(step, mesh, P(*names),
                                       P(*names)))(sharded))
    for (dz, row), blk in truth.items():
        got = from_bricks(out[dz, 0, 0, row], plan.sdec.grid, BD)
        assert compare_arrays(got, blk, 1e-7), (dz, row)


def test_strong_step_vs_global_dense(plan):
    sd = stencil_by_name("mpi7pt")[0]
    g, truth, stacked = _build(plan, seed=9)
    mesh = make_domain_mesh(MESH)
    names = mesh.axis_names
    adj = jnp.asarray(plan.sdec.info.adj)

    def step(b):
        x = b[0, 0, 0]
        x = exchange_strong_shift(x, plan, names)
        view = x.reshape(x.shape[0], -1, *BD)
        out = jax.vmap(
            lambda v: brick_apply(sd, {"in": v}, adj, DEFAULT_PARAMS))(view)
        return out.reshape(x.shape)[None, None, None]

    sharded = jax.device_put(jnp.asarray(stacked),
                             NamedSharding(mesh, P(*names)))
    out = np.asarray(jax.jit(shard_map(step, mesh, P(*names),
                                       P(*names)))(sharded))

    # global dense twin with periodic wrap
    gp = np.pad(g, 1, mode="wrap")
    want_g = dense_apply(sd, {"in": gp}, DEFAULT_PARAMS, xp=np)
    for (dz, row), _ in truth.items():
        c = plan.sub_order[row]
        base = (dz * plan.local_block[0] + c[0], c[1], c[2])
        sl = tuple(slice(base[a] * SDOM[a], (base[a] + 1) * SDOM[a])
                   for a in range(3))
        want = want_g[sl]
        got = from_bricks(out[dz, 0, 0, row],
                          plan.sdec.interior_grid(), BD)
        assert compare_arrays(got, want, 1e-5), (dz, row)


def test_strong_pencil_fast_path_validates():
    """Batched pencil sweep + in-place link exchange on a (2,2,1) mesh
    with deep-ghost ST_ITER=2 (ref: strong/main.cpp:204-213,288-320)."""
    from brickjax.drivers import strong

    strong.run(dom=(32, 32, 64), sdom=(8, 8, 64), bdim=(4, 4, 8),
               stencil="mpi7pt", st_iter=2, mesh_shape=(2, 2, 1),
               iters=1, validate=True, backend="pencil")


def test_strong_cubic_deep_ghost_validates():
    """CUBIC subdomains (the reference's canonical 512^3 -> 128^3 shape,
    strong/args.cpp:32) with deep-ghost ST_ITER=2: ONE exchange per
    step, ghost-inclusive sweeps on ALL axes including the i-ghost brick
    ring (i_range (0, GI))."""
    from brickjax.drivers import strong

    strong.run(dom=(32, 32, 64), sdom=(16, 16, 32), bdim=(4, 4, 8),
               stencil="mpi7pt", st_iter=2, mesh_shape=(2, 1, 1),
               iters=1, validate=True, backend="pencil")
