"""Brick sweeps in plain XLA: gather a window, apply the stencil, write back.

One rank-generic form serves every sweep the drivers and :class:`Problem`
schedule (2-D, 3-D and 4-D; single input, multi-input, systems; bf16
storage; batches; in-place partial sweeps; temporal fusion):

1. gather the bricks of the computed range plus one neighbour brick on
   each side of every bricked axis through the grid table (neighbours
   outside the table clamp to the edge brick, which is what lets
   ghost-inclusive sweeps run deep-ghost ``st_iter`` chains between
   exchanges, ref: weak/main.cpp:203-212);
2. lay the window out densely and evaluate the stencil with shifted
   slices — the same evaluator :func:`.jnp_backend.dense_apply` runs;
3. scatter the range's bricks into the output storage.

Bricks that span the whole innermost axis (the "pencil" layout: the
grid table has extent 1 there) read innermost taps by periodic roll
within the brick, the analog of the reference's ``dev_shl`` funnel
shift across brick boundaries (include/dev_shl.h:11-64).  Tables with
several bricks along the innermost axis treat it like any other bricked
axis.

``fuse = F`` applies F stencil levels to one window before the write
back.  The window's one-brick halo holds the whole fusion trapezoid
while ``F * radius`` fits in a brick, and the result equals F composed
sweeps on every point whose dependencies stay inside the table
(periodic tables, and ghost rings valid to depth ``F * radius``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

import jax.numpy as jnp

from .evaluate import resolve_const_from_params
from .jnp_backend import _as_ir, _np_offsets, _run

# range keywords naming the outer (non-innermost) axes, per rank
RANGE_NAMES = {2: ("y_range",), 3: ("k_range", "j_range"),
                4: ("w_range", "k_range", "j_range")}


def pencil_sweep(stencil, grid: np.ndarray, bdims: Sequence[int],
                 nbricks: int, params: dict | None = None, *,
                 dtype=jnp.float32,
                 fuse: int = 1, inplace: bool = False, batch: int = 1,
                 batch_stride: int | None = None, i_ghost: int = 0,
                 evolve=None, **ranges):
    """Build a sweep over a half-open sub-range of the brick grid.

    ``grid`` is the brick-id table of one subdomain, numpy-ordered; it
    may omit the innermost axis (one pencil brick per outer cell).
    ``bdims`` are the brick dims; storage views are ``(nbricks,
    *bdims)``.  Ranges are keyword arguments in grid coordinates: 2-D
    ``y_range``; 3-D ``k_range``, ``j_range``; 4-D ``w_range``,
    ``k_range``, ``j_range``; plus ``i_range`` for tables with several
    innermost bricks (which also need ``i_ghost`` >= 1 ghost bricks
    there).  Each defaults to skipping one ghost brick on each side.

    Returns ``fn(view) -> out``.  Bricks outside the range keep the
    input's (or, with ``inplace=True``, ``out_prev``'s) contents, so
    ``fn(view, out_prev)`` partial sweeps compose into one output.

    ``stencil`` may be a list of StencilDefs — a coupled stencil system
    (the reference's multi-output ``STENCIL`` contract,
    codegen/vecscatter:165-168), computed as a Jacobi update from the
    pre-step fields.  ``evolve`` names the input grid each output
    replaces (default: the single stencil's first input); every other
    input is a static aux field.  Multi-input stencils and systems take
    ``fn(*views)`` in ``fn.fields`` order; systems return a tuple.

    ``batch`` > 1 sweeps ``batch`` subdomains stacked along the brick
    axis ``batch_stride`` bricks apart, all through the same table (the
    strong-scaling layout, ref: strong/main.cpp:37-50).

    ``dtype`` is the storage type; taps accumulate in float32.
    """
    sdefs = stencil if isinstance(stencil, (list, tuple)) else [stencil]
    if not sdefs:
        raise ValueError("empty stencil system")
    irs = [_as_ir(s) for s in sdefs]
    nd = irs[0].dims
    if any(r.dims != nd for r in irs):
        raise ValueError("a stencil system needs one rank")
    if nd not in RANGE_NAMES:
        raise NotImplementedError(f"pencil sweeps are 2-D/3-D/4-D, got "
                                  f"{nd}-D")
    NO = len(irs)
    fieldnames: list = []
    for r in irs:
        for n in r.sdef.inputs:
            if n not in fieldnames:
                fieldnames.append(n)
    if not fieldnames:
        raise ValueError("stencil reads no input grid")
    if evolve is None:
        if NO > 1:
            raise ValueError("a stencil system needs evolve=(name, ...)"
                             " naming each output's evolving input grid")
        evolve = (fieldnames[0],)
    elif isinstance(evolve, str):
        evolve = (evolve,)
    evolve = tuple(evolve)
    if len(evolve) != NO or len(set(evolve)) != NO:
        raise ValueError(f"{NO} output(s) need {NO} distinct evolve "
                         f"name(s), got {evolve}")
    for e in evolve:
        if e not in fieldnames:
            raise ValueError(f"evolve field {e!r} is not a stencil "
                             f"input ({fieldnames})")
    unknown = set(ranges) - set(RANGE_NAMES[nd]) - {"i_range"}
    if unknown:
        raise TypeError(f"unknown arguments {sorted(unknown)} for a "
                        f"{nd}-D sweep")

    B = tuple(int(b) for b in bdims)
    if len(B) != nd:
        raise ValueError(f"bdims {bdims} is not {nd}-D")
    g = np.asarray(grid)
    if g.ndim == nd - 1:
        g = g[..., None]
    if g.ndim != nd:
        raise ValueError(f"grid table {g.shape} is not {nd}-D")
    G = g.shape
    lane = G[-1] == 1           # pencil layout: innermost taps roll
    if lane:
        if ranges.get("i_range") not in (None, (0, 1)):
            raise ValueError("i_range applies to i-bricked layouts only")
        rng = [(0, 1)]
    else:
        if int(i_ghost) < 1:
            raise ValueError("i-bricked layouts (GI > 1) need i_ghost >= "
                             "1 ghost brick rings in i")
        rng = [tuple(ranges.get("i_range")
                     or (int(i_ghost), G[-1] - int(i_ghost)))]
    rng = [tuple(ranges.get(n) or (1, G[a] - 1))
           for a, n in enumerate(RANGE_NAMES[nd])] + rng
    rng = [(int(r0), int(r1)) for r0, r1 in rng]
    for a, (r0, r1) in enumerate(rng):
        if not 0 <= r0 < r1 <= G[a]:
            raise ValueError(f"range {rng} outside grid {G}")

    F = int(fuse)
    if F < 1:
        raise ValueError("fuse must be >= 1")
    rads = [r.radius() for r in irs]
    lo = tuple(max(r[0][a] for r in rads) for a in range(nd))
    hi = tuple(max(r[1][a] for r in rads) for a in range(nd))
    names = "yx" if nd == 2 else "wkji"[4 - nd:]
    for a in range(nd):
        if lane and a == nd - 1:
            if lo[a] >= B[a] or hi[a] >= B[a]:
                raise ValueError("innermost radius exceeds the pencil "
                                 "width")
        elif F * lo[a] > B[a] or F * hi[a] > B[a]:
            raise ValueError(
                f"fuse {F} x {names[a]}-radius ({lo[a]}, {hi[a]}) exceeds "
                f"the brick depth {B[a]}")
    batch = int(batch)
    if batch > 1 and batch_stride is None:
        raise ValueError("batch > 1 needs batch_stride (bricks per "
                         "subdomain)")
    if NO > 1 and inplace:
        raise NotImplementedError("stencil systems run the plain sweep")

    # window: the range plus one clamped neighbour brick per bricked side
    bricked = [not (lane and a == nd - 1) for a in range(nd)]
    widx = [np.clip(np.arange(r0 - 1, r1 + 1), 0, G[a] - 1) if bricked[a]
            else np.arange(r0, r1) for a, (r0, r1) in enumerate(rng)]
    oidx = [np.arange(r0, r1) for r0, r1 in rng]
    offs = np.arange(batch) * int(batch_stride or 0)
    wids = (offs.reshape((-1,) + (1,) * nd)
            + g[np.ix_(*widx)][None]).astype(np.int32)
    oids = (offs.reshape((-1,) + (1,) * nd)
            + g[np.ix_(*oidx)][None]).astype(np.int32).ravel()
    unique = np.unique(oids).size == oids.size
    W = wids.shape[1:]
    C = tuple(r1 - r0 for r0, r1 in rng)
    # crop of the dense window that the F levels consume
    crop = tuple(slice(B[a] - F * lo[a], B[a] * (1 + C[a]) + F * hi[a])
                 if bricked[a] else slice(None) for a in range(nd))

    sdt = jnp.dtype(dtype)
    cdt = jnp.dtype(jnp.float32)
    resolve = resolve_const_from_params(dict(params or {}))

    def dense(view):
        win = jnp.take(view, wids.ravel(), axis=0).reshape(
            (batch,) + W + B)
        perm = (0,) + tuple(q for a in range(nd)
                            for q in (1 + a, 1 + nd + a))
        win = win.transpose(perm).reshape(
            (batch,) + tuple(W[a] * B[a] for a in range(nd)))
        return win[(slice(None),) + crop].astype(cdt)

    def level(ir, src):
        """One stencil level over ``src`` (field -> dense array); the
        result shrinks by the system radius along bricked axes."""
        def read_tap(name, offs_edsl):
            o = _np_offsets(offs_edsl, nd)
            v = src[name]
            sl = [slice(None)]
            for a in range(nd):
                if bricked[a]:
                    n = v.shape[1 + a]
                    sl.append(slice(lo[a] + o[a], n - hi[a] + o[a]))
                else:
                    sl.append(slice(None))
            v = v[tuple(sl)]
            if not bricked[-1] and o[-1]:
                v = jnp.roll(v, -o[-1], axis=-1)
            return v

        return _run(ir, read_tap, resolve, jnp)

    def shrink(v, f):
        sl = (slice(None),) + tuple(
            slice(f * lo[a], v.shape[1 + a] - f * hi[a]) if bricked[a]
            else slice(None) for a in range(nd))
        return v[sl]

    def to_bricks(v):
        v = v.astype(sdt).reshape(
            (batch,) + tuple(q for a in range(nd) for q in (C[a], B[a])))
        perm = (0,) + tuple(1 + 2 * a for a in range(nd)) + tuple(
            2 + 2 * a for a in range(nd))
        return v.transpose(perm).reshape((-1,) + B)

    def apply(views, out_prev=None):
        wins = {n: dense(v) for n, v in zip(fieldnames, views)}
        cur = dict(wins)
        for f in range(1, F + 1):
            outs = [level(ir, cur) for ir in irs]
            cur = {n: shrink(v, f) for n, v in wins.items()}
            cur.update(zip(evolve, outs))
        res = []
        for o, e in enumerate(evolve):
            base = (out_prev if out_prev is not None
                    else views[fieldnames.index(e)])
            res.append(base.at[oids].set(to_bricks(cur[e]),
                                         unique_indices=unique,
                                         mode="promise_in_bounds"))
        return res

    if inplace:
        if len(fieldnames) > 1:
            raise NotImplementedError(
                "inplace partial sweeps support one input grid")

        def fn(view, out_prev):
            return apply([view], out_prev)[0]
    elif len(fieldnames) > 1 or NO > 1:
        def fn(*views):
            if len(views) != len(fieldnames):
                raise TypeError(f"stencil reads {len(fieldnames)} grids "
                                f"({fieldnames}), got {len(views)}")
            res = apply(list(views))
            return tuple(res) if NO > 1 else res[0]
        fn.fields = tuple(fieldnames)
        fn.evolve = evolve
    else:
        def fn(view):
            return apply([view])[0]
    fn.fuse = F
    return fn
