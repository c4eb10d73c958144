"""Golden tests: native C++ planner core == numpy implementations."""

import numpy as np
import pytest

from brickjax.core.layout import adjacency_from_grid
from brickjax.core.native import (
    adjacency_from_grid_native,
    check_involution_native,
    load_library,
    zmort_ids_native,
)
from brickjax.utils.zmort import zmort_ids

needs_lib = pytest.mark.skipif(load_library() is None,
                               reason="no native toolchain")


def _py_adjacency(grid, nbricks):
    """Reference numpy path, bypassing the native dispatch."""
    dims = grid.ndim
    gp = np.zeros(tuple(s + 2 for s in grid.shape), dtype=np.int32)
    gp[(slice(1, -1),) * dims] = grid
    from brickjax.core.layout import adj_offsets
    ncols = 3 ** dims
    adj = np.zeros((nbricks, ncols), dtype=np.int32)
    for col in range(ncols):
        offs = adj_offsets(col, dims)
        sl = tuple(slice(1 + o, 1 + o + s) for o, s in
                   zip(offs, grid.shape))
        adj[grid.ravel(), col] = gp[sl].ravel()
    return adj


@needs_lib
def test_adjacency_matches_numpy():
    rng = np.random.default_rng(0)
    for shape in [(5, 4, 6), (3, 3, 3, 3), (7, 9)]:
        n = int(np.prod(shape))
        grid = rng.permutation(n).astype(np.int32).reshape(shape) + 1
        nb = n + 1
        a = adjacency_from_grid_native(grid, nb)
        b = _py_adjacency(grid, nb)
        assert np.array_equal(a, b), shape


@needs_lib
def test_involution_native():
    grid = np.arange(60, dtype=np.int32).reshape(4, 3, 5)
    adj = adjacency_from_grid_native(grid, 60)
    interior = grid[1:-1, 1:-1, 1:-1]
    assert check_involution_native(adj, interior)
    adj2 = adj.copy()
    adj2[int(interior.ravel()[0]), 0] = 5  # cell (0,1,0): breaks mirror
    assert not check_involution_native(adj2, interior)


@needs_lib
def test_zmort_native_matches_numpy():
    for shape in [(4, 4), (8, 4, 2), (3, 5, 7)]:
        a = zmort_ids_native(shape)
        b = zmort_ids(shape)
        assert np.array_equal(a, b), shape


@needs_lib
def test_large_grid_dispatch_uses_native():
    """adjacency_from_grid transparently dispatches to the lib for big
    grids and stays consistent with the numpy result."""
    shape = (32, 32, 32)  # 32k cells > dispatch threshold
    grid = np.arange(int(np.prod(shape)),
                     dtype=np.int32).reshape(shape)
    a = adjacency_from_grid(grid)
    b = _py_adjacency(grid, int(grid.max()) + 1)
    assert np.array_equal(a, b)


def test_native_copy_to_from_bricks_golden():
    """Native copyToBrick/copyFromBrick == the numpy blocked transpose
    (bricksetup.h:103-221), incl. interleaved-field offsets."""
    import numpy as np
    from brickjax.core import init_grid
    from brickjax.core.native import (copy_from_bricks_f32,
                                          copy_to_bricks_f32, load_library)
    from brickjax.core.setup import _blocks_from_dense

    if load_library() is None:
        import pytest
        pytest.skip("no native toolchain")
    rng = np.random.default_rng(3)
    for gshape, bd in (((4, 3, 2), (2, 4, 8)), ((3, 2, 2, 2), (2, 2, 2, 4))):
        grid, info = init_grid(gshape)
        arr = rng.random([g * b for g, b in zip(gshape, bd)],
                         dtype=np.float32)
        step = 2 * int(np.prod(bd))
        want = np.zeros((info.nbricks, step), np.float32)
        want[grid.ravel(), int(np.prod(bd)):] = _blocks_from_dense(
            arr, gshape, bd)
        got = np.zeros((info.nbricks, step), np.float32)
        assert copy_to_bricks_f32(arr, grid, bd, got,
                                  offset=int(np.prod(bd)))
        assert np.array_equal(got, want)

        back = np.empty_like(arr)
        assert copy_from_bricks_f32(back, grid, bd, got,
                                    offset=int(np.prod(bd)))
        assert np.array_equal(back, arr)
