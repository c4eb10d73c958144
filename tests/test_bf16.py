"""Mixed-precision pencil path: bf16 storage, f32 accumulation.

Outside the reference's f64 tolerance contract (documented opt-in);
checked against the f32 dense twin at bf16-appropriate tolerance."""

import numpy as np

import jax.numpy as jnp

from brickjax.codegen import dense_apply
from brickjax.codegen.sweep import pencil_sweep
from brickjax.core import from_bricks, init_grid, random_array, to_bricks
from brickjax.stencils import DEFAULT_PARAMS, stencil_by_name


def test_pencil_bf16_matches_f32_loosely():
    BD = (2, 4, 16)
    G = (6, 5, 1)
    grid, info = init_grid(G)
    core = random_array((8, 12, 16), np.float32, 5)
    ext = np.pad(core, ((2, 2), (4, 4), (0, 0)), mode="wrap")
    dat = to_bricks(ext, grid, BD)
    view16 = jnp.asarray(dat.reshape((-1,) + BD), jnp.bfloat16)

    sd = stencil_by_name("mpi7pt")[0]
    fn = pencil_sweep(sd, grid, BD, info.nbricks,
                               DEFAULT_PARAMS, dtype=jnp.bfloat16)
    out = np.asarray(fn(view16), dtype=np.float32)

    corep = np.pad(core, 1, mode="wrap")
    want = dense_apply(sd, {"in": corep}, DEFAULT_PARAMS, xp=np)
    got = from_bricks(out.reshape(out.shape[0], -1), grid[1:-1, 1:-1], BD)
    # bf16 has ~2-3 significant decimal digits
    assert np.abs(got - want).max() < 3e-2
    assert np.abs(got - want).mean() < 5e-3
