"""Layout-core tests: adjacency structure, accessor semantics, data
round-trips, halo extension — the invariants the reference asserts in its
drivers (ref: weak/main.cpp:87-94, stencils/fake.h:376-377)."""

import numpy as np
import pytest

from brickjax.core import (
    Brick,
    BrickStorage,
    adj_index,
    adj_offsets,
    compare_arrays,
    from_bricks,
    halo_extend,
    init_grid,
    random_array,
    to_bricks,
)


def test_adj_index_roundtrip():
    for dims in (2, 3, 4):
        for col in range(3 ** dims):
            offs = adj_offsets(col, dims)
            assert adj_index(offs) == col
    # center column is the all-zero offset (ref: brick.h self = 3^d/2)
    assert adj_index((0, 0, 0)) == 13
    assert adj_offsets(13, 3) == (0, 0, 0)


def test_init_grid_dense_adjacency():
    grid, info = init_grid((4, 3, 5))
    assert info.nbricks == 60
    # self column
    assert np.array_equal(info.adj[:, info.center], np.arange(60))
    # interior involution: adj[adj[b][c]][N-1-c] == b
    interior = grid[1:-1, 1:-1, 1:-1]
    assert info.check_involution(interior)
    # a known neighbor: brick at (1,1,1) offset (0,0,+1)
    b = int(grid[1, 1, 1])
    assert info.adj[b, adj_index((0, 0, 1))] == grid[1, 1, 2]
    assert info.adj[b, adj_index((1, -1, 0))] == grid[2, 0, 1]
    # out-of-range points at garbage brick 0
    edge = int(grid[0, 0, 0])
    assert info.adj[edge, adj_index((-1, 0, 0))] == 0


def test_init_grid_4d():
    grid, info = init_grid((3, 3, 3, 3))
    assert info.adj.shape == (81, 81)
    interior = grid[1:-1, 1:-1, 1:-1, 1:-1]
    assert info.check_involution(interior)


def test_to_from_bricks_roundtrip():
    bdims = (4, 4, 8)
    gdims = (3, 5, 2)
    arr = random_array(tuple(g * b for g, b in zip(gdims, bdims)), seed=3)
    grid, info = init_grid(gdims)
    dat = to_bricks(arr, grid, bdims)
    back = from_bricks(dat, grid, bdims)
    assert np.array_equal(arr, back)
    # block placement: brick at cell (1,2,0) holds arr block
    b = int(grid[1, 2, 0])
    blk = dat[b].reshape(bdims)
    assert np.array_equal(blk, arr[4:8, 8:12, 0:8])


def test_to_bricks_interleaved_fields():
    """Two fields in one chunk via step/offset (ref: brick.h:388-394,
    stencils/3axis.cpp:26-28)."""
    bdims = (4, 4, 8)
    belems = 128
    gdims = (2, 2, 2)
    grid, info = init_grid(gdims)
    storage = BrickStorage.allocate(8, 2 * belems)
    a0 = random_array((8, 8, 16), seed=1)
    a1 = random_array((8, 8, 16), seed=2)
    to_bricks(a0, grid, bdims, dat=storage.dat, offset=0)
    to_bricks(a1, grid, bdims, dat=storage.dat, offset=belems)
    bIn = Brick(info, storage, 0, bdims)
    bOut = Brick(info, storage, belems, bdims)
    assert np.array_equal(from_bricks(storage.dat, grid, bdims, 0), a0)
    assert np.array_equal(from_bricks(storage.dat, grid, bdims, belems), a1)
    assert bIn.view().shape == (8, 4, 4, 8)
    # scalar accessor matches dense array
    assert bIn.read(int(grid[1, 1, 1]), (2, 3, 5)) == a0[6, 7, 13]
    # cross-brick accessor read walks adjacency
    assert bIn.read(int(grid[1, 1, 1]), (-1, 3, 5)) == a0[3, 7, 13]
    assert bOut.read(int(grid[0, 1, 0]), (3, 3, 9)) == a1[3, 7, 9]


def test_halo_extend_matches_dense():
    bdims = (4, 4, 8)
    gdims = (3, 3, 3)
    arr = random_array(tuple(g * b for g, b in zip(gdims, bdims)), seed=7)
    grid, info = init_grid(gdims)
    dat = to_bricks(arr, grid, bdims)
    view = dat.reshape((-1,) + bdims)
    lo = (2, 1, 3)
    hi = (1, 2, 2)
    E = halo_extend(view, info.adj, lo, hi)
    assert E.shape == (27, 7, 7, 13)
    # interior brick (1,1,1): extension must equal the dense neighborhood
    b = int(grid[1, 1, 1])
    k0, j0, i0 = 4, 4, 8
    want = arr[k0 - lo[0]:k0 + 4 + hi[0],
               j0 - lo[1]:j0 + 4 + hi[1],
               i0 - lo[2]:i0 + 8 + hi[2]]
    assert np.array_equal(E[b], want)


def test_halo_extend_jnp_matches_numpy():
    import jax.numpy as jnp

    bdims = (4, 4, 8)
    grid, info = init_grid((3, 3, 3))
    arr = random_array((12, 12, 24), seed=9)
    dat = to_bricks(arr, grid, bdims)
    view = dat.reshape((-1,) + bdims)
    En = halo_extend(view, info.adj, (1, 1, 1), (1, 1, 1))
    Ej = halo_extend(jnp.asarray(view), jnp.asarray(info.adj),
                     (1, 1, 1), (1, 1, 1))
    assert compare_arrays(En, np.asarray(Ej), 1e-7)


def test_storage_step_alignment():
    with pytest.raises(ValueError):
        BrickStorage.allocate(4, 100)
    s = BrickStorage.allocate(4, 512)
    assert s.dat.shape == (4, 512)
