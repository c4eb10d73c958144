"""Data import/export between dense arrays and bricks, and the halo-extend
block gather that replaces the reference's per-element adjacency accessor.

Reference equivalents: ``copyToBrick``/``copyFromBrick``/``iter_grid``
(include/bricksetup.h:103-221).  Where the reference walks the array and
brick side-by-side element-wise under OpenMP, this version is a single
vectorized blocked transpose + scatter/gather, usable on host (numpy) or
device (jnp).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _xp(arr):
    if isinstance(arr, np.ndarray):
        return np
    import jax.numpy as jnp
    return jnp


def _blocks_from_dense(arr, gshape, bdims):
    """[... dense ...] -> [ncells, prod(bdims)] in row-major cell order."""
    xp = _xp(arr)
    dims = len(bdims)
    shape = []
    for g, b in zip(gshape, bdims):
        shape += [g, b]
    a = arr.reshape(shape)
    # interleaved (g0,b0,g1,b1,...) -> (g0,g1,...,b0,b1,...)
    perm = list(range(0, 2 * dims, 2)) + list(range(1, 2 * dims, 2))
    a = xp.transpose(a, perm)
    ncells = int(np.prod(gshape))
    return a.reshape(ncells, int(np.prod(bdims)))


def _dense_from_blocks(blocks, gshape, bdims):
    xp = _xp(blocks)
    dims = len(bdims)
    a = blocks.reshape(tuple(gshape) + tuple(bdims))
    perm = []
    for d in range(dims):
        perm += [d, dims + d]
    a = xp.transpose(a, perm)
    return a.reshape(tuple(g * b for g, b in zip(gshape, bdims)))


def to_bricks(arr, grid, bdims: Sequence[int], dat=None, step: int | None = None,
              offset: int = 0):
    """Scatter a dense array into brick storage.

    ``arr`` has shape ``grid.shape * bdims`` (the caller slices out
    padding/ghost regions itself, mirroring the ``padding``/``ghost``
    arguments of the reference's copyToBrick, include/bricksetup.h:172-181).
    ``grid[cell]`` gives the destination chunk.  If ``dat`` is given
    (``[chunks, step]``), the blocks are scattered into
    ``dat[grid, offset:offset+belems]`` and the updated array is returned
    (functional on jnp, in-place on numpy); otherwise a fresh
    ``[max(grid)+1, belems]`` array is returned and ``offset`` must be 0.
    """
    grid = np.asarray(grid)
    bdims = tuple(int(b) for b in bdims)
    belems = int(np.prod(bdims))
    # native fast path (the reference's OMP copyToBrick): contiguous
    # f32 numpy in, [chunks, step] numpy storage out
    if (isinstance(arr, np.ndarray) and arr.dtype == np.float32
            and arr.flags.c_contiguous):
        from .native import copy_to_bricks_f32

        if dat is None:
            assert offset == 0
            out = np.zeros((int(grid.max()) + 1, belems), np.float32)
            if copy_to_bricks_f32(arr, grid, bdims, out, 0):
                return out
        elif (isinstance(dat, np.ndarray)
              and copy_to_bricks_f32(arr, grid, bdims, dat, offset)):
            return dat
    blocks = _blocks_from_dense(arr, grid.shape, bdims)
    idx = grid.ravel()
    if dat is None:
        assert offset == 0
        n = int(grid.max()) + 1
        xp = _xp(blocks)
        if xp is np:
            out = np.zeros((n, belems), dtype=arr.dtype)
            out[idx] = blocks
            return out
        out = xp.zeros((n, belems), dtype=arr.dtype)
        return out.at[idx].set(blocks)
    if isinstance(dat, np.ndarray):
        dat[idx, offset:offset + belems] = np.asarray(blocks)
        return dat
    return dat.at[idx, offset:offset + belems].set(blocks)


def from_bricks(dat, grid, bdims: Sequence[int], offset: int = 0):
    """Gather brick storage back into a dense array of shape
    ``grid.shape * bdims`` (ref copyFromBrick, include/bricksetup.h:183-221)."""
    grid = np.asarray(grid)
    bdims = tuple(int(b) for b in bdims)
    belems = int(np.prod(bdims))
    if (isinstance(dat, np.ndarray) and dat.dtype == np.float32
            and dat.flags.c_contiguous and dat.ndim == 2):
        from .native import copy_from_bricks_f32

        arr = np.empty(tuple(g * b for g, b in zip(grid.shape, bdims)),
                       np.float32)
        if copy_from_bricks_f32(arr, grid, bdims, dat, offset):
            return arr
    blocks = dat[grid.ravel(), offset:offset + belems]
    return _dense_from_blocks(blocks, grid.shape, bdims)


def halo_extend(view, adj, lo: Sequence[int], hi: Sequence[int],
                rows=None):
    """Per-brick halo-extended blocks via adjacency gathers.

    ``view`` is ``[nbricks, *bdims]``; returns ``[nrows, *(lo+bdims+hi)]``
    where the shell is filled from the 3^dims neighbors through ``adj``.
    This is the vectorized replacement for the reference's per-element
    ``_BrickAccessor`` indirection (include/brick.h:214-327): one block
    gather per populated adjacency column instead of an adjacency lookup
    per element.  Reads that fall off the grid resolve to brick 0 and
    return its (garbage) contents, matching reference semantics.

    ``lo[a]``/``hi[a]`` are the halo depths (≤ bdims[a]) on the low/high
    side of axis ``a``.  ``rows`` restricts output to a brick subset (the
    drivers' interior/boundary split, cf. the reference's ``skip`` ring
    and sep_pos scheduling, weak/main.cpp:26-36, brick-mpi.h:196).
    """
    from .layout import adj_index

    xp = _xp(view)
    if rows is not None:
        adj = adj[xp.asarray(rows)] if xp is not np else adj[rows]
    nb = adj.shape[0]
    bdims = view.shape[1:]
    dims = len(bdims)
    lo = tuple(int(x) for x in lo)
    hi = tuple(int(x) for x in hi)
    for a in range(dims):
        if lo[a] > bdims[a] or hi[a] > bdims[a]:
            raise ValueError("halo depth exceeds brick dim")

    eshape = tuple(l + b + h for l, b, h in zip(lo, bdims, hi))
    if xp is np:
        E = np.zeros((nb,) + eshape, dtype=view.dtype)
    else:
        E = xp.zeros((nb,) + eshape, dtype=view.dtype)

    def piece(delta):
        """source slice of neighbor-brick view, dest slice of E, per axis."""
        src, dst = [], []
        for a in range(dims):
            if delta[a] == -1:
                if lo[a] == 0:
                    return None, None
                src.append(slice(bdims[a] - lo[a], bdims[a]))
                dst.append(slice(0, lo[a]))
            elif delta[a] == 0:
                src.append(slice(0, bdims[a]))
                dst.append(slice(lo[a], lo[a] + bdims[a]))
            else:
                if hi[a] == 0:
                    return None, None
                src.append(slice(0, hi[a]))
                dst.append(slice(lo[a] + bdims[a], lo[a] + bdims[a] + hi[a]))
        return tuple(src), tuple(dst)

    def rec(a, delta):
        nonlocal E
        if a == dims:
            if all(d == 0 for d in delta):
                src = (slice(None),) * dims
                dst = tuple(slice(l, l + b) for l, b in zip(lo, bdims))
                center = view if rows is None else view[adj[:, adj_index(
                    (0,) * dims)]]
                if xp is np:
                    E[(slice(None),) + dst] = center
                else:
                    E = E.at[(slice(None),) + dst].set(center)
                return
            src, dst = piece(delta)
            if src is None:
                return
            nbr = adj[:, adj_index(delta)]
            data = view[nbr][(slice(None),) + src]
            if xp is np:
                E[(slice(None),) + dst] = data
            else:
                E = E.at[(slice(None),) + dst].set(data)
            return
        for d in (-1, 0, 1):
            rec(a + 1, delta + (d,))

    rec(0, ())
    return E
