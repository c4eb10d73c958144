"""Ghost exchange over a jax.sharding.Mesh.

The reference's MPI machinery maps onto XLA collectives (NCCL on GPUs):

- PUT exchange (ref: BrickDecomp::exchange, brick-mpi.h:466-495): one
  Irecv/Isend pair per neighbor run → one ``jax.lax.ppermute`` per run,
  moving the skin slice straight out of brick storage (pack-free: the
  slice is contiguous by construction of the skin ordering).
- SHIFT multi-stage exchange (ref: MultiStageExchangeView,
  brick-mpi.h:587-681): one ppermute pair per mesh axis, with corners
  forwarded through previously received ghosts (26 logical neighbors,
  6 messages).
- Array exchange twin (ref: exchangeArr, array-mpi.h:130-212): the same
  dimension sweep on a plain dense array with ghost shells, used to
  cross-check brick results.

All functions run *inside* ``shard_map`` over a Mesh whose axis names map
one-to-one onto domain axes (size-1 axes = undistributed; periodic wrap
makes a 1-device axis exchange with itself, which is exactly the
reference's np=1 torus trick).
"""

from __future__ import annotations

import numpy as np

from jax import lax

from ..utils.bitset import BitSet
from .decomp import BrickDecomp


def _shift_perm(size: int, shift: int) -> list[tuple[int, int]]:
    """perm pairs (src, dst) so each dst receives from dst+shift
    (periodic)."""
    return [((r + shift) % size, r) for r in range(size)]


def _delta(neighbor: BitSet, ndim: int) -> tuple[int, ...]:
    """Mesh-coordinate offset of the device a ghost region copies from."""
    d = [0] * ndim
    for t in neighbor:
        d[ndim - abs(t)] = 1 if t > 0 else -1
    return tuple(d)


def neighbor_perm(neighbor: BitSet, mesh_shape: tuple[int, ...]):
    """Linearized (src, dst) pairs for a diagonal neighbor direction —
    the SPMD analog of the reference's ``populate()`` rank map
    (brick-mpi.h:730-753)."""
    nd = len(mesh_shape)
    delta = _delta(neighbor, nd)
    pairs = []
    for c in np.ndindex(*mesh_shape):
        src = tuple((c[a] + delta[a]) % mesh_shape[a] for a in range(nd))
        lin = lambda x: int(np.ravel_multi_index(x, mesh_shape))
        pairs.append((lin(src), lin(c)))
    return pairs


def _flat_names(axis_names):
    """Flatten per-domain-axis ppermute names (entries may be COMPOSITE
    tuples — the two-level mesh's ``(slice, card)`` axis pair,
    :func:`..mesh.make_multislice_mesh`) into one mesh-axis-name tuple
    for whole-mesh collectives."""
    out = []
    for n in axis_names:
        if isinstance(n, tuple):
            out.extend(n)
        else:
            out.append(n)
    return tuple(out)


def _rows(runs) -> np.ndarray:
    """Concatenate (pos, len) runs into one row-index array (static)."""
    return np.concatenate([np.arange(r.pos, r.pos + r.len)
                           for r in runs]).astype(np.int32)


def _merge_intervals(pairs):
    """Merge (dst section, src section) pairs into maximal contiguous
    interval pairs [(d0, d1, s0, s1), ...] — static slices update in
    place under donation."""
    ivs = sorted(((d.pos, d.pos + d.len, s.pos, s.pos + s.len)
                  for d, s in pairs))
    out = []
    for d0, d1, s0, s1 in ivs:
        if out and out[-1][1] == d0 and out[-1][3] == s0:
            prev = out[-1]
            out[-1] = (prev[0], d1, prev[2], s1)
        else:
            out.append((d0, d1, s0, s1))
    return out


def exchange_put(dat, decomp: BrickDecomp, axis_names: tuple[str, ...],
                 mesh_shape: tuple[int, ...],
                 table_axes: tuple[int, ...] = ()):
    """PUT exchange: one ppermute per (ghost run, skin run) pair —
    skin and ghost runs are contiguous by construction of the skin
    ordering, so every message is a static storage slice (pack-free).
    Runs whose neighbors are all on this device are periodic
    self-copies, done as one gather and scatter.  Runs with
    a component on a ``table_axes`` axis are skipped entirely — the
    kernel reads those directions through a ``periodic_grid`` table
    redirection, so moving their ghost bricks is pure waste.

    ``dat``: per-device ``[nbricks, step]`` brick storage (all interleaved
    fields move together, like the reference exchanging whole chunks).
    """
    table = set(table_axes)
    local_ivs = []
    for gr, sr in zip(decomp.ghost, decomp.skin):
        if table and ({decomp._tag_axis(t) for t in gr.neighbor} & table):
            continue
        delta = _delta(gr.neighbor, len(mesh_shape))
        if any(d and mesh_shape[a] > 1 for a, d in enumerate(delta)):
            val = dat[sr.pos:sr.pos + sr.len]
            perm = neighbor_perm(gr.neighbor, mesh_shape)
            val = lax.ppermute(val, _flat_names(axis_names), perm)
            dat = dat.at[gr.pos:gr.pos + gr.len].set(val)
        else:
            local_ivs.append((gr.pos, gr.pos + gr.len,
                              sr.pos, sr.pos + sr.len))
    if local_ivs:
        dat = _local_copy(dat, [local_ivs])
    return dat


def _local_copy(dat, stage_ivs):
    """Periodic self-copies as one row gather and one scatter per
    stage, in stage order (corner forwarding reads ghosts an earlier
    stage filled).  Within a stage the written ghost rows and the read
    skin rows are disjoint, so one scatter is exact; under donation XLA
    updates the buffer in place."""
    for ivs in stage_ivs:
        dst = np.concatenate([np.arange(d0, d1) for d0, d1, _s0, _s1
                              in ivs])
        src = np.concatenate([np.arange(s0, s1) for _d0, _d1, s0, s1
                              in ivs])
        dat = dat.at[dst].set(dat[src], unique_indices=True)
    return dat


def exchange_shift(dat, decomp: BrickDecomp, axis_names: tuple[str, ...],
                   mesh_shape: tuple[int, ...],
                   axis_order: "list[int] | None" = None,
                   table_axes: tuple[int, ...] = ()):
    """Multi-stage SHIFT exchange: 2 ppermutes per mesh axis, corners
    forwarded (ref: MultiStageExchangeView semantics).  One message per
    axis-direction; sections merged into contiguous slice runs.  Stages
    whose mesh axis has one device are periodic self-copies, gathered
    and scattered in place (:func:`_local_copy`) — or skipped for axes
    in ``table_axes``, where the kernel reads through a
    ``decomp.periodic_grid`` table instead (zero-copy periodicity).

    ``axis_names`` entries may be COMPOSITE tuples (the multi-slice
    2-level mesh: axis 0 = ``("slice", "z")`` with ``mesh_shape[0]``
    the nodes x cards PRODUCT, :func:`..mesh.make_multislice_mesh`):
    the shift then runs over the flattened node-major device line, and
    only one pair per shift crosses a node boundary."""
    import jax.numpy as jnp

    order, stages = decomp.stage_sections(axis_order)
    table_axes = set(table_axes)

    pending_local: list[list[tuple[int, int, int, int]]] = []

    def flush_local(d):
        nonlocal pending_local
        if pending_local:
            d = _local_copy(d, pending_local)
            pending_local = []
        return d

    def owner_axes(sec):
        return {decomp._tag_axis(t) for t in sec.owner}

    for s, ax in enumerate(order):
        if ax in table_axes:
            continue
        local_ivs = []
        for sign in (+1, -1):
            pairs = [(d, sr) for d, sr in stages[s][sign]
                     if not (owner_axes(d) & table_axes)]
            if not pairs:
                continue
            ivs = _merge_intervals(pairs)
            if mesh_shape[ax] > 1:
                dat = flush_local(dat)
                send = jnp.concatenate(
                    [dat[s0:s1] for _d0, _d1, s0, s1 in ivs]) \
                    if len(ivs) > 1 else dat[ivs[0][2]:ivs[0][3]]
                perm = _shift_perm(mesh_shape[ax], sign)
                recv = lax.ppermute(send, axis_names[ax], perm)
                off = 0
                for d0, d1, _s0, _s1 in ivs:
                    dat = dat.at[d0:d1].set(recv[off:off + d1 - d0])
                    off += d1 - d0
            else:
                local_ivs.extend(ivs)
        if local_ivs:
            pending_local.append(local_ivs)
    return flush_local(dat)


def exchange_array(arr, ghost: tuple[int, ...],
                   axis_names: tuple[str, ...],
                   mesh_shape: tuple[int, ...],
                   axis_order: "list[int] | None" = None):
    """Dense-array ghost exchange twin (ref: exchangeArr,
    array-mpi.h:130-212): per-axis slab swap including previously filled
    corners.  ``arr`` is the per-device array with ``ghost[a]`` shells."""
    nd = arr.ndim
    if axis_order is None:
        axis_order = list(range(nd - 1, -1, -1))
    for ax in axis_order:
        g = ghost[ax]
        if g == 0:
            continue
        S = arr.shape[ax]
        hi_own = lax.slice_in_dim(arr, S - 2 * g, S - g, axis=ax)
        lo_own = lax.slice_in_dim(arr, g, 2 * g, axis=ax)
        if mesh_shape[ax] > 1:
            # my low ghost <- -a neighbor's high owned slab
            lo_ghost = lax.ppermute(hi_own, axis_names[ax],
                                    _shift_perm(mesh_shape[ax], -1))
            hi_ghost = lax.ppermute(lo_own, axis_names[ax],
                                    _shift_perm(mesh_shape[ax], +1))
        else:
            lo_ghost, hi_ghost = hi_own, lo_own
        arr = lax.dynamic_update_slice_in_dim(arr, lo_ghost, 0, axis=ax)
        arr = lax.dynamic_update_slice_in_dim(arr, hi_ghost, S - g, axis=ax)
    return arr
