"""Differentiable stencil sweeps (beyond the reference).

Every sweep is plain XLA and so differentiable by ``jax.grad``; these
builders give the pencil sweep (:mod:`.sweep`) an explicit adjoint
SWEEP instead, with O(1) residual memory.  For LINEAR single-input
stencils the reverse-mode rule is exact and cheap: the operator is
``y = A x`` with ``A`` the periodic stencil matrix, so the pullback is
``x̄ = Aᵀ ȳ`` — and ``Aᵀ`` is just the stencil with every tap offset
NEGATED (same coefficients), i.e. *another pencil sweep at identical
cost*.  That turns the sweep into a building block for
differentiable simulation / PINN-style training loops.

Contract (checked at build time):

- single linear input (``linear_decomposition`` succeeds) — nonlinear
  or multi-input stencils differentiate through ``brick_apply``;
- the grid table is FULLY PERIODIC in k and j (``BrickDecomp.
  periodic_grid`` over all axes) and the layout is the pencil one
  (i periodic by rolls within the brick), so the owned bricks form a torus and
  the transpose of "periodic stencil" is "periodic stencil with
  negated offsets";
- gradients flow through the storage array only (coefficients are
  trace-time constants, as everywhere on the sweep path).

Rows the sweep never writes (ghost ring, garbage brick 0) hold
stale data in any sweep output; the pullback therefore masks
them to zero so downstream consumers (optimizers, checkpoints) never
see garbage — the true gradient there IS zero, because the forward
never reads ghost storage through a periodic table.

Temporal fusion composes cleanly: ``(A^F)ᵀ = (Aᵀ)^F``, so ``fuse=F``
builds the pullback as the F-fused adjoint sweep.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..st.expr import (
    BinOp,
    ConstRef,
    FloatLiteral,
    If,
    Index,
    IntLiteral,
    Op,
    UnOp,
    UOp,
)
from ..st.func import CallExpr
from ..st.grid import Grid, GridRef
from ..st.loader import StencilDef, load_stencil_module
from .ir import linear_decomposition


def linear_taps(sdef: StencilDef):
    """``[(sign, coeff_expr, offsets), ...]`` if ``sdef.rhs`` is LINEAR
    in its single input, else None.  Strictly more general than
    :func:`linear_decomposition`: distributive forms like
    ``c * (g(i+1) + g(i-1))`` canonicalize through monomial expansion
    (one tap per occurrence, coefficient expressions preserved)."""
    lin = linear_decomposition(sdef.rhs)
    if lin is not None:
        out = []
        for _key, cexpr, taps in lin:
            coeff = (ConstRef(cexpr.name) if hasattr(cexpr, "name")
                     else FloatLiteral(float(cexpr.val)))
            out.extend((sign, coeff, offs) for sign, _g, offs in taps)
        return out
    try:
        monos = _expand_monomials(sdef.rhs)
    except ValueError:
        return None
    out = []
    for s, c, refs in monos:
        if len(refs) != 1:
            return None     # constant or product term: not linear
        mag = abs(s)
        coeff = (FloatLiteral(mag) if c is None
                 else c if mag == 1.0
                 else BinOp(Op.MUL, FloatLiteral(mag), c))
        out.append((1 if s >= 0 else -1, coeff, refs[0][1]))
    return out


def adjoint_stencil(sdef: StencilDef) -> StencilDef:
    """The transpose stencil: same coefficients, every offset negated.

    For ``y[p] = Σ_t c_t · x[p + o_t]`` (periodic), ``(Aᵀ ȳ)[q] =
    Σ_t c_t · ȳ[q - o_t]``.  Coefficient ``ConstRef``s keep their
    names so one params dict serves both sweeps.  Involution:
    ``adjoint(adjoint(s))`` has the original taps."""
    if len(sdef.inputs) != 1:
        raise ValueError("adjoint_stencil supports single-input stencils")
    taps = linear_taps(sdef)
    if taps is None:
        raise ValueError(
            f"stencil '{sdef.output.name}' is not a pure linear tap "
            f"combination — differentiate through brick_apply instead")
    d = sdef.dims
    in_name = next(iter(sdef.inputs))
    g = Grid(in_name, d)
    og = Grid(sdef.output.name + "_adj", d)
    idx = [Index(a) for a in range(d)]
    rhs = None
    for sign, coeff, offs in taps:
        term = coeff * g(*[idx[a] - int(offs[a]) for a in range(d)])
        if sign < 0:
            term = -term
        rhs = term if rhs is None else rhs + term
    og(*idx).assign(rhs)
    return load_stencil_module({"STENCIL": [og]})[0]


def _expand_monomials(rhs):
    """Expand ``rhs`` into monomials ``(sign, const_expr|None,
    [(grid_name, offsets_edsl), ...])`` — a sum of products of grid
    taps with trace-time-constant scale factors.  Raises ValueError on
    non-polynomial structure (If/max/Func; grid-valued divisors)."""

    def mul(a, b):
        sa, ca, ra = a
        sb, cb, rb = b
        c = ca if cb is None else (cb if ca is None
                                   else BinOp(Op.MUL, ca, cb))
        return (sa * sb, c, ra + rb)

    def go(e):
        if isinstance(e, (IntLiteral, FloatLiteral)):
            return [(float(e.val), None, [])]
        if isinstance(e, ConstRef):
            return [(1.0, ConstRef(e.name), [])]
        if isinstance(e, GridRef):
            return [(1.0, None, [(e.grid.name, tuple(e.offsets))])]
        if isinstance(e, UnOp) and e.op is UOp.NEG:
            return [(-s, c, r) for s, c, r in go(e.subexpr)]
        if isinstance(e, BinOp):
            if e.op is Op.ADD:
                return go(e.lhs) + go(e.rhs)
            if e.op is Op.SUB:
                return go(e.lhs) + [(-s, c, r) for s, c, r in go(e.rhs)]
            if e.op is Op.MUL:
                return [mul(a, b) for a in go(e.lhs) for b in go(e.rhs)]
            if e.op is Op.DIV:
                den = go(e.rhs)
                if len(den) != 1 or den[0][2]:
                    raise ValueError(
                        "polynomial expansion: divisor must be a "
                        "trace-time constant expression")
                sd_, cd, _ = den[0]
                out = []
                for s, c, r in go(e.lhs):
                    if cd is None:
                        out.append((s / sd_, c, r))
                    else:
                        num = c if c is not None else FloatLiteral(1.0)
                        out.append((s / sd_, BinOp(Op.DIV, num, cd), r))
                return out
        raise ValueError(
            f"polynomial expansion: unsupported node {type(e).__name__}"
            " (If/max differentiate via the piecewise fallback of"
            " polynomial_system_adjoints)")

    return go(rhs)


def _is_zero(e) -> bool:
    return isinstance(e, (IntLiteral, FloatLiteral)) and float(e.val) == 0.0


def _is_one(e) -> bool:
    return isinstance(e, (IntLiteral, FloatLiteral)) and float(e.val) == 1.0


def _add(a, b):
    if _is_zero(a):
        return b
    if _is_zero(b):
        return a
    return BinOp(Op.ADD, a, b)


def _sub(a, b):
    if _is_zero(b):
        return a
    if _is_zero(a):
        return UnOp(UOp.NEG, b)
    return BinOp(Op.SUB, a, b)


def _mul(a, b):
    if _is_zero(a) or _is_zero(b):
        return FloatLiteral(0.0)
    if _is_one(a):
        return b
    if _is_one(b):
        return a
    return BinOp(Op.MUL, a, b)


def _neg(a):
    if _is_zero(a):
        return a
    return UnOp(UOp.NEG, a)


_PIECEWISE_CONST_OPS = frozenset((Op.EQ, Op.NE, Op.GT, Op.LT, Op.GE,
                                  Op.LE, Op.AND, Op.OR, Op.MOD))


def _diff_tap(e, f: str, u):
    """``∂e/∂ f[p+u]`` as an Expr over the ORIGINAL inputs — the
    symbolic differentiator behind the exact If/max adjoints.

    Piecewise nodes take the standard subgradient convention (the one
    ``jax.grad`` applies to ``where``/``maximum`` away from ties):
    ``If`` differentiates branch-wise with the condition held constant,
    ``max(a, b)`` → ``If(a >= b, ∂a, ∂b)``, comparisons/logic/mod are
    piecewise-constant (zero).  Non-smooth points (ties, |x| at 0) are
    measure-zero; at a tie this picks the first branch where JAX's
    ``maximum`` splits evenly.  Smooth opaque calls get their calculus
    rules (sqrt/exp/log/abs).  Raises ValueError (spelling
    "polynomial expansion" so callers' except-chains keep working) for
    functions with no registered derivative."""
    if isinstance(e, GridRef):
        hit = e.grid.name == f and tuple(e.offsets) == tuple(u)
        return FloatLiteral(1.0 if hit else 0.0)
    if isinstance(e, (IntLiteral, FloatLiteral, ConstRef)):
        return FloatLiteral(0.0)
    if isinstance(e, UnOp):
        if e.op is UOp.NOT:
            return FloatLiteral(0.0)
        d = _diff_tap(e.subexpr, f, u)
        return _neg(d) if e.op is UOp.NEG else d
    if isinstance(e, BinOp):
        if e.op in _PIECEWISE_CONST_OPS:
            return FloatLiteral(0.0)
        dl = _diff_tap(e.lhs, f, u)
        dr = _diff_tap(e.rhs, f, u)
        if e.op is Op.ADD:
            return _add(dl, dr)
        if e.op is Op.SUB:
            return _sub(dl, dr)
        if e.op is Op.MUL:
            return _add(_mul(dl, e.rhs), _mul(e.lhs, dr))
        if e.op is Op.DIV:
            if _is_zero(dr):
                return (dl if _is_zero(dl)
                        else BinOp(Op.DIV, dl, e.rhs))
            num = _sub(_mul(dl, e.rhs), _mul(e.lhs, dr))
            return BinOp(Op.DIV, num, _mul(e.rhs, e.rhs))
    if isinstance(e, If):
        da = _diff_tap(e.then, f, u)
        db = _diff_tap(e.otherwise, f, u)
        if _is_zero(da) and _is_zero(db):
            return FloatLiteral(0.0)
        return If(e.cond, da, db)
    if isinstance(e, CallExpr):
        name = e.callee.name
        args = e.children
        if name in ("max", "min"):
            da = _diff_tap(args[0], f, u)
            db = _diff_tap(args[1], f, u)
            if _is_zero(da) and _is_zero(db):
                return FloatLiteral(0.0)
            gate = Op.GE if name == "max" else Op.LE
            return If(BinOp(gate, args[0], args[1]), da, db)
        dx = _diff_tap(args[0], f, u)
        if _is_zero(dx):
            return dx
        if name == "abs":
            return If(BinOp(Op.GE, args[0], FloatLiteral(0.0)),
                      dx, _neg(dx))
        if name == "sqrt":
            return BinOp(Op.DIV, dx, _mul(FloatLiteral(2.0), e))
        if name == "exp":
            return _mul(dx, e)
        if name == "log":
            return BinOp(Op.DIV, dx, args[0])
        raise ValueError(
            f"polynomial expansion: no derivative rule for opaque "
            f"function '{name}' — differentiate via backend='jnp'")
    raise ValueError(
        f"polynomial expansion: cannot differentiate node "
        f"{type(e).__name__}")


def _taps_of(rhs, f: str):
    """Distinct offsets at which field ``f`` is read anywhere in
    ``rhs`` (condition positions included — their partials fold to
    zero in :func:`_diff_tap` and are skipped by the caller)."""
    seen: set = set()
    out = []
    for n in rhs.walk():
        if isinstance(n, GridRef) and n.grid.name == f:
            t = tuple(int(o) for o in n.offsets)
            if t not in seen:
                seen.add(t)
                out.append(t)
    return out


def _shift_rebuild(e, grids: dict, idx, shift):
    """Rebuild ``e`` with fresh nodes, every grid read shifted by
    ``shift`` (eDSL-order) and re-bound to the Grids in ``grids`` —
    the 'evaluate the factor at the occurrence's own offset' step of
    the pullback."""

    def rec(x):
        if isinstance(x, GridRef):
            g = grids[x.grid.name]
            return g(*[idx[a] + int(x.offsets[a] + shift[a])
                       for a in range(len(idx))])
        if isinstance(x, IntLiteral):
            return IntLiteral(x.val)
        if isinstance(x, FloatLiteral):
            return FloatLiteral(x.val)
        if isinstance(x, ConstRef):
            return ConstRef(x.name)
        if isinstance(x, UnOp):
            return UnOp(x.op, rec(x.subexpr))
        if isinstance(x, BinOp):
            return BinOp(x.op, rec(x.lhs), rec(x.rhs))
        if isinstance(x, If):
            return If(rec(x.cond), rec(x.then), rec(x.otherwise))
        if isinstance(x, CallExpr):
            return CallExpr(x.callee, *[rec(c) for c in x.children])
        raise ValueError(f"cannot rebuild node {type(x).__name__}")

    return rec(e)


def polynomial_adjoint_stencils(sdef: StencilDef,
                                wrt: Sequence[str] | None = None,
                                ct_name: str | None = None):
    """Exact pullback stencils for a POLYNOMIAL stencil (any products
    of grid taps — covers variable-coefficient linear stencils, and
    polynomial nonlinearities via the product rule).

    For ``y[p] = Σ_m s_m · Π_r g_{m,r}[p + u_{m,r}]`` the cotangent of
    field ``f`` is ``f̄[q] = Σ_m Σ_{r: g=f} s_m · ȳ[q - u_{m,r}] ·
    Π_{r'≠r} g_{m,r'}[q - u_{m,r} + u_{m,r'}]`` — one adjoint term per
    occurrence, every factor shifted by the occurrence's own offset.
    Each adjoint is again a polynomial stencil reading the cotangent
    grid (named ``ct_name``, default ``<output>_ct``) plus the ORIGINAL
    inputs — i.e. it runs on the same multi-input pencil fast path as
    the forward (ref for the multi-grid codegen surface:
    codegen/st/codegen/backend/base.py:93-123).

    Returns ``(adjoints, ct_name)`` where ``adjoints[field]`` is the
    StencilDef of that field's pullback (fields with no occurrence are
    omitted — their gradient is identically zero)."""
    adjs, cts = polynomial_system_adjoints(
        [sdef], wrt=wrt, ct_names=(ct_name,) if ct_name else None)
    return adjs, cts[0]


def polynomial_system_adjoints(sdefs: Sequence[StencilDef],
                               wrt: Sequence[str] | None = None,
                               ct_names: Sequence[str] | None = None):
    """Exact pullback stencils for a coupled POLYNOMIAL stencil SYSTEM
    (the reference's multi-output ``STENCIL = [out1, out2]`` contract,
    codegen/vecscatter:165-168).

    The system is one map ``(x_1..x_n) -> (y_1..y_m)`` with every
    ``y_o`` a polynomial in the shared inputs; the cotangent of input
    field ``f`` sums the single-output product-rule terms over ALL
    outputs: ``f̄[q] = Σ_o Σ_m Σ_{r: g=f} s_{o,m} · ȳ_o[q - u] ·
    Π_{r'≠r} g[q - u + u']``.  Each adjoint is one single-output
    multi-input polynomial stencil reading the cotangent grids
    (``<out>_ct``) plus the ORIGINAL inputs — i.e. it runs on the same
    multi-input pencil fast path as the forward system.

    Returns ``(adjoints, ct_names)``: ``adjoints[field]`` is that
    field's pullback StencilDef (fields with no occurrence anywhere
    are omitted — gradient identically zero); ``ct_names`` the
    cotangent grid names in STENCIL output order."""
    sdefs = list(sdefs)
    d = sdefs[0].dims
    if any(s.dims != d for s in sdefs):
        raise ValueError("system outputs must share dimensionality")
    union: list[str] = []
    for s in sdefs:
        for n in s.inputs:
            if n not in union:
                union.append(n)
    if ct_names is None:
        ct_names = tuple(s.output.name + "_ct" for s in sdefs)
    ct_names = tuple(ct_names)
    if len(ct_names) != len(sdefs):
        raise ValueError("one cotangent grid name per STENCIL output")
    if len(set(ct_names)) != len(ct_names) or set(ct_names) & set(union):
        raise ValueError(f"cotangent grid names {ct_names} must be "
                         f"distinct and disjoint from inputs {union}")
    try:
        monos = [_expand_monomials(s.rhs) for s in sdefs]
    except ValueError:
        # piecewise-polynomial outputs (If/max/abs/... — e.g. the cond
        # stencil): no monomial form exists, so each adjoint term comes
        # from the symbolic differentiator instead — the pullback is
        # again a stencil reading the cotangent plus the ORIGINAL
        # inputs (the If/max gates recompute from the residual views in
        # the same adjoint window), so it runs the same multi-input
        # pencil fast path.  Exactness caveat is only the measure-zero
        # tie convention (see _diff_tap).
        monos = None
    if wrt is None:
        wrt = tuple(union)
    adjoints: dict[str, StencilDef] = {}
    for f in wrt:
        grids = {ct: Grid(ct, d) for ct in ct_names}
        for n in union:
            grids[n] = Grid(n, d)
        idx = [Index(a) for a in range(d)]
        og = Grid(f"{sdefs[0].output.name}_adj_{f}", d)
        rhs = None
        if monos is None:
            for ct, sd in zip(ct_names, sdefs):
                for u in _taps_of(sd.rhs, f):
                    dex = _diff_tap(sd.rhs, f, u)
                    if _is_zero(dex):
                        continue     # e.g. read only inside a condition
                    ctref = grids[ct](*[idx[a] - int(u[a])
                                        for a in range(d)])
                    term = _mul(ctref,
                                _shift_rebuild(dex, grids, idx,
                                               tuple(-o for o in u)))
                    rhs = term if rhs is None else _add(rhs, term)
            if rhs is None:
                continue
            og(*idx).assign(rhs)
            adjoints[f] = load_stencil_module({"STENCIL": [og]})[0]
            continue
        for ct, out_monos in zip(ct_names, monos):
            for s, c, refs in out_monos:
                for r, (name, offs) in enumerate(refs):
                    if name != f:
                        continue
                    shifted = ([(ct, tuple(-o for o in offs))]
                               + [(n2, tuple(o2 - o for o2, o in
                                             zip(offs2, offs)))
                                  for r2, (n2, offs2) in enumerate(refs)
                                  if r2 != r])
                    if c is not None:
                        term = (c if s == 1.0
                                else BinOp(Op.MUL, FloatLiteral(s), c))
                    else:
                        term = None if s == 1.0 else FloatLiteral(s)
                    for n2, o2 in shifted:
                        ref = grids[n2](*[idx[a] + int(o2[a])
                                          for a in range(d)])
                        term = ref if term is None else term * ref
                    rhs = term if rhs is None else rhs + term
        if rhs is None:
            continue
        og(*idx).assign(rhs)
        adjoints[f] = load_stencil_module({"STENCIL": [og]})[0]
    return adjoints, ct_names


def _outer_radius(sdefs) -> int:
    """Max halo radius over the OUTER (non-lane) numpy axes of one or
    more stencils.  The last numpy axis is the lane (i) axis — always
    table-periodic inside the brick row, never exchanged — so a wide
    lane tap must not trip the exchanged-axes ghost-depth guards
    (round-4 advisor finding)."""
    rad = 0
    for sd in sdefs:
        lo, hi = sd.radius()
        rad = max([rad, *lo[:-1], *hi[:-1]])
    return rad


def _fuse_by_recompute(build_unfused, fused_fwd, F: int, evolve):
    """Give a FUSED sweep forward its exact pullback by recomputation
    (round-5: the poly/system adjoint surface at fuse > 1).

    The forward runs the F-level fused kernel (1/F the HBM traffic —
    the same amortization the linear fused adjoint already enjoys);
    the backward re-runs the F unfused exact steps under ``jax.vjp``,
    so each level's custom adjoint-sweep VJP fires in reverse level
    order.  Residuals stay O(1) (the forward's input views only); the
    F-1 intermediate fields exist transiently inside the backward.
    Exact because pencil-kernel fusion is semantically identical to F
    composed sweeps on a periodic table (the sweep's fusion
    contract) — the guard for exchanged axes stays with the caller.

    ``build_unfused()`` must return the fuse=1 differentiable step
    (its ``fields`` order defines the view signature); ``evolve`` is
    the tuple of evolving field names in STENCIL-output order (must
    match the fused kernel's ``evolve``)."""
    import jax

    unfused = build_unfused()
    fieldnames = tuple(unfused.fields)
    ev_idx = tuple(fieldnames.index(e) for e in evolve)
    nout = len(ev_idx)
    fev = getattr(fused_fwd, "evolve", None)
    if fev is not None and tuple(fev) != tuple(evolve):
        raise ValueError(f"fused forward evolves {fev}, pullback "
                         f"chain evolves {tuple(evolve)}")

    def chain(*views):
        vs = list(views)
        for _ in range(F):
            out = unfused(*vs)
            outs = out if nout > 1 else (out,)
            for i, o in zip(ev_idx, outs):
                vs[i] = o
        return (vs[ev_idx[0]] if nout == 1
                else tuple(vs[i] for i in ev_idx))

    def call_fused(views):
        return (fused_fwd(*views) if len(fieldnames) > 1
                else fused_fwd(views[0]))

    @jax.custom_vjp
    def step(*views):
        return call_fused(views)

    def step_fwd(*views):
        return call_fused(views), views

    def step_bwd(views, ct):
        _, vjp = jax.vjp(chain, *views)
        return vjp(ct)

    step.defvjp(step_fwd, step_bwd)
    step.forward = fused_fwd
    step.fields = fieldnames
    step.unfused = unfused
    step.adjoints = getattr(unfused, "adjoints", None)
    step.ct_name = getattr(unfused, "ct_name", None)
    return step


def _check_periodic_table(grid: np.ndarray, k_range, j_range,
                          axes=(0, 1)):
    """The transpose rule needs a torus on every NON-exchanged axis:
    each ghost ring cell must redirect to the wrapped owned brick
    (periodic_grid semantics)."""
    GK, GJ = grid.shape[:2]
    K0, K1 = k_range
    J0, J1 = j_range
    pk, pj = K1 - K0, J1 - J0
    ok = True
    if 0 in axes:
        for r in range(K0):
            ok &= bool(np.array_equal(grid[r], grid[r + pk]))
        for r in range(GK - K1):
            ok &= bool(np.array_equal(grid[K1 + r], grid[K0 + r]))
    if 1 in axes:
        for r in range(J0):
            ok &= bool(np.array_equal(grid[:, r], grid[:, r + pj]))
        for r in range(GJ - J1):
            ok &= bool(np.array_equal(grid[:, J1 + r], grid[:, J0 + r]))
    if not ok:
        raise ValueError(
            "differentiable_pencil_sweep needs a fully periodic grid "
            "table (BrickDecomp.periodic_grid over all axes): the "
            "transpose of the periodic stencil operator is only "
            "another stencil on a torus")


def differentiable_pencil_sweep(stencil, grid: np.ndarray,
                                bdims: Sequence[int], nbricks: int,
                                params: dict | None = None,
                                mask_ghost: bool = True,
                                exchanged_axes: Sequence[int] = (),
                                forward_fn=None,
                                **kw):
    """``fn(dat_view) -> out_view`` like :func:`pencil_sweep`,
    but registered with :func:`jax.custom_vjp`: ``jax.grad`` through it
    runs the adjoint stencil as a second pencil sweep (same schedule,
    same cost).  See the module docstring for the contract.

    ``exchanged_axes`` (numpy order: 0 = k, 1 = j) marks axes whose
    ghost ring is filled by a real exchange (``exchange_shift`` under
    ``shard_map`` — pure ppermute/slice ops, AD-transparent) instead of
    table periodicity.  On those axes the pullback runs the adjoint
    sweep over the FULL grid range: the cotangent it scatters into the
    ghost bricks is routed back to the neighbors' skins by the
    exchange's own transpose.  Exactness needs the incoming cotangent
    to vanish on the ghost ring — true whenever the loss reads owned
    rows and steps compose as ``sweep(exchange(x))`` (the exchange's
    overwrite-transpose re-zeroes ghost cotangent every step), i.e.
    one sweep per exchange.  Deep-ghost ``st_iter > 1`` chains
    ghost-INCLUSIVE sweeps whose edge-clamped windows are not exactly
    transposed — exchange every iteration when differentiating; for
    the same reason ``fuse > 1`` is rejected with exchanged axes.

    ``forward_fn``: a prebuilt :func:`pencil_sweep` with the
    SAME configuration (skips rebuilding the forward kernel — e.g.
    the one a Problem's plan already built)."""
    import jax
    import jax.numpy as jnp

    from .sweep import pencil_sweep

    for bad in ("evolve", "batch", "i_ghost", "inplace"):
        if kw.get(bad):
            raise ValueError(f"differentiable_pencil_sweep does not "
                             f"support {bad}=...")
    grid = np.asarray(grid)
    g2 = grid[:, :, 0] if grid.ndim == 3 else grid
    if grid.ndim == 3 and grid.shape[2] != 1:
        raise ValueError("pencil layout only (one brick per (k, j))")
    GK, GJ = g2.shape
    k_range = tuple(kw.get("k_range") or (1, GK - 1))
    j_range = tuple(kw.get("j_range") or (1, GJ - 1))
    exchanged_axes = tuple(exchanged_axes)
    if not set(exchanged_axes) <= {0, 1}:
        raise ValueError("exchanged_axes are numpy-order k/j axes "
                         "(0 and/or 1); i is always lane-periodic")
    if exchanged_axes and int(kw.get("fuse") or 1) > 1:
        # the fused adjoint's intermediate levels CLAMP their windows
        # at the table edge, which injects cotangent into outer ghost
        # elements where the exact transpose is zero — and the exchange
        # transpose would route that garbage into the neighbors' owned
        # gradients.  fuse=1 is immune: its only clamped reads hit
        # ghost-row cotangent, zero by contract.
        raise ValueError("exchanged_axes with fuse > 1 would compute "
                         "wrong gradients (clamped fused adjoint "
                         "levels); exchange every iteration at fuse=1")
    # every NON-exchanged axis must be table-periodic AND keep its
    # ghost ring OUT of the computed range: a ghost-inclusive range on
    # a periodic axis (e.g. the deep-ghost (0, GK)) writes each skin
    # brick twice through the ring alias — last-write-wins corruption —
    # and makes the periodicity check below vacuous
    for ax, rng, G in ((0, k_range, GK), (1, j_range, GJ)):
        if ax not in exchanged_axes and (rng[0] < 1 or rng[1] > G - 1):
            raise ValueError(
                f"axis {ax}: range {rng} includes the periodic ghost "
                f"ring (grid extent {G}); table-periodic axes must "
                f"compute owned cells only (1, {G - 1})")
    _check_periodic_table(
        g2, k_range, j_range,
        axes=tuple(a for a in (0, 1) if a not in exchanged_axes))
    sdefs = stencil if isinstance(stencil, (list, tuple)) else [stencil]
    if len(sdefs) != 1:
        raise ValueError("differentiable_pencil_sweep takes one output")
    fwd_fn = forward_fn or pencil_sweep(stencil, grid, bdims,
                                               nbricks, params, **kw)
    # pullback ranges: full span on exchanged axes (ghost cotangent is
    # real data the exchange transpose routes home), owned span on
    # table-periodic axes (their ring cells alias owned bricks — a
    # full-range write would scatter each brick twice)
    bkw = dict(kw)
    bkw["k_range"] = (0, GK) if 0 in exchanged_axes else k_range
    bkw["j_range"] = (0, GJ) if 1 in exchanged_axes else j_range
    adj_fn = pencil_sweep(adjoint_stencil(sdefs[0]), grid, bdims,
                                 nbricks, params, **bkw)

    # rows the pullback writes; everything else (the garbage brick 0,
    # and on table-periodic axes the ghost bricks) is undefined in a
    # sweep output and its true gradient is zero — mask so it never
    # leaks downstream
    written = np.zeros(nbricks, np.bool_)
    written[np.unique(g2[bkw["k_range"][0]:bkw["k_range"][1],
                         bkw["j_range"][0]:bkw["j_range"][1]])] = True
    mask = jnp.asarray(written.reshape((nbricks,) + (1,) * len(bdims)))

    @jax.custom_vjp
    def step(d):
        return fwd_fn(d)

    def step_fwd(d):
        return fwd_fn(d), None

    def step_bwd(_res, ct):
        xb = adj_fn(ct)
        # where, not multiply: the unwritten rows can hold NaN/inf and
        # garbage * 0 keeps the NaN
        return ((jnp.where(mask, xb, jnp.zeros((), xb.dtype))
                 if mask_ghost else xb),)

    step.defvjp(step_fwd, step_bwd)
    step.forward = fwd_fn
    step.adjoint = adj_fn
    return step


def differentiable_poly_sweep(stencil, grid: np.ndarray,
                              bdims: Sequence[int], nbricks: int,
                              params: dict | None = None,
                              wrt: Sequence[str] | None = None,
                              mask_ghost: bool = True,
                              exchanged_axes: Sequence[int] = (),
                              forward_fn=None,
                              **kw):
    """Exact sweep-forward / sweep-backward sweep for POLYNOMIAL
    stencils — variable-coefficient linear stencils (the common real
    case, examples/varcoeff_diffusion.py) and polynomial
    nonlinearities.  The pullback of every requested input field runs
    as another multi-input pencil sweep built from
    :func:`polynomial_adjoint_stencils`; the only residuals are the
    forward's own input views (O(1) activation memory, like the linear
    adjoint mode — no dense twin, no materialized domain).

    ``wrt``: input grid names to differentiate (default: all).  The
    returned ``fn(*views)`` takes views in ``fn.fields`` order (the
    forward's input order) and its VJP returns one gradient per view
    (zeros for fields outside ``wrt``).

    ``exchanged_axes`` as in :func:`differentiable_pencil_sweep`, with
    two additions for the multi-input case: (1) the adjoint stencils
    read RESIDUAL fields at up to 2x the forward radius, so the ghost
    ring must be at least that deep — enforced as ``2 * radius <=
    min(BK, BJ)`` (one ghost brick row); (2) gradients wrt STATIC aux
    fields accumulate contributions into their ghost bricks — route
    them home by putting an (idempotent) ``exchange_shift`` of each
    aux field INSIDE the differentiated graph: its transpose is
    exactly the ghost-to-owner fold (Problem.differentiable_step does
    this).  ``fuse=F`` on periodic tables runs the F-level fused
    forward (1/F the HBM traffic) with the pullback recomputed as F
    unfused exact steps (:func:`_fuse_by_recompute`); rejected with
    exchanged axes (clamped fused levels are not exactly
    transposed)."""
    import jax
    import jax.numpy as jnp

    from .sweep import pencil_sweep

    for bad in ("evolve", "batch", "i_ghost", "inplace"):
        if kw.get(bad):
            raise ValueError(f"differentiable_poly_sweep does not "
                             f"support {bad}=...")
    sdefs = stencil if isinstance(stencil, (list, tuple)) else [stencil]
    if len(sdefs) != 1:
        raise ValueError("differentiable_poly_sweep takes one output "
                         "(systems differentiate via "
                         "differentiable_poly_system_sweep)")
    sdef = sdefs[0]
    F = int(kw.get("fuse") or 1)
    if F > 1:
        if exchanged_axes:
            raise ValueError(
                "exchanged_axes with fuse > 1 would compute wrong "
                "gradients (clamped fused levels are not exactly "
                "transposed across a real ghost ring); exchange "
                "every iteration at fuse=1")
        kw1 = {k: v for k, v in kw.items()
               if k != "fuse"}
        fused_fwd = forward_fn or pencil_sweep(
            sdef, grid, bdims, nbricks, params, **kw)
        return _fuse_by_recompute(
            lambda: differentiable_poly_sweep(
                sdef, grid, bdims, nbricks, params, wrt=wrt,
                mask_ghost=mask_ghost, **kw1),
            fused_fwd, F,
            getattr(fused_fwd, "evolve", None)
            or tuple(getattr(fused_fwd, "fields",
                             tuple(sdef.inputs)))[:1])
    grid = np.asarray(grid)
    g2 = grid[:, :, 0] if grid.ndim == 3 else grid
    if grid.ndim == 3 and grid.shape[2] != 1:
        raise ValueError("pencil layout only (one brick per (k, j))")
    GK, GJ = g2.shape
    k_range = tuple(kw.get("k_range") or (1, GK - 1))
    j_range = tuple(kw.get("j_range") or (1, GJ - 1))
    exchanged_axes = tuple(exchanged_axes)
    if not set(exchanged_axes) <= {0, 1}:
        raise ValueError("exchanged_axes are numpy-order k/j axes "
                         "(0 and/or 1); i is always lane-periodic")
    rad = _outer_radius((sdef,))
    BK, BJ = int(bdims[0]), int(bdims[1])
    if exchanged_axes and 2 * rad > min(BK, BJ):
        # adjoint coefficient factors read residuals at shifted-by-two
        # offsets; beyond-table clamps are only provably harmless when
        # one ghost brick row covers 2x the radius (see module
        # docstring derivation)
        raise ValueError(
            f"exchanged-axes poly adjoint needs 2*radius <= "
            f"min(BK, BJ) (got radius {rad}, brick {bdims})")
    for ax, rng, G in ((0, k_range, GK), (1, j_range, GJ)):
        if ax not in exchanged_axes and (rng[0] < 1 or rng[1] > G - 1):
            raise ValueError(
                f"axis {ax}: range {rng} includes the periodic ghost "
                f"ring (grid extent {G}); table-periodic axes must "
                f"compute owned cells only (1, {G - 1})")
    _check_periodic_table(
        g2, k_range, j_range,
        axes=tuple(a for a in (0, 1) if a not in exchanged_axes))

    adjoints, ct = polynomial_adjoint_stencils(sdef, wrt=wrt)

    fwd_fn = forward_fn or pencil_sweep(sdef, grid, bdims,
                                               nbricks, params, **kw)
    fieldnames = tuple(getattr(fwd_fn, "fields",
                               tuple(sdef.inputs)))
    bkw = dict(kw)
    bkw["k_range"] = (0, GK) if 0 in exchanged_axes else k_range
    bkw["j_range"] = (0, GJ) if 1 in exchanged_axes else j_range
    adj_fns = {}
    for f, asd in adjoints.items():
        afn = pencil_sweep(asd, grid, bdims, nbricks, params,
                                  **bkw)
        adj_fns[f] = afn

    # forward-written rows: the only place incoming cotangent is
    # defined; pullback-written rows: the only defined gradient rows
    def _written(kr, jr):
        w = np.zeros(nbricks, np.bool_)
        w[np.unique(g2[kr[0]:kr[1], jr[0]:jr[1]])] = True
        return jnp.asarray(w.reshape((nbricks,) + (1,) * len(bdims)))

    ct_mask = _written(k_range, j_range)
    out_mask = _written(bkw["k_range"], bkw["j_range"])

    def _call_fwd(views):
        return (fwd_fn(*views) if len(fieldnames) > 1
                else fwd_fn(views[0]))

    @jax.custom_vjp
    def step(*views):
        return _call_fwd(views)

    def step_fwd(*views):
        return _call_fwd(views), views

    def step_bwd(views, cotan):
        # undefined (unwritten) output rows hold stale data; the
        # exact incoming cotangent there is zero by contract
        cotan = jnp.where(ct_mask, cotan, jnp.zeros((), cotan.dtype))
        byname = dict(zip(fieldnames, views))
        byname[ct] = cotan
        grads = []
        for f in fieldnames:
            afn = adj_fns.get(f)
            if afn is None:
                grads.append(jnp.zeros_like(byname[f]))
                continue
            order = getattr(afn, "fields", (ct,))
            g = (afn(*(byname[n] for n in order))
                 if len(order) > 1 else afn(byname[order[0]]))
            if mask_ghost:
                g = jnp.where(out_mask, g, jnp.zeros((), g.dtype))
            grads.append(g)
        return tuple(grads)

    step.defvjp(step_fwd, step_bwd)
    step.forward = fwd_fn
    step.adjoints = adj_fns
    step.fields = fieldnames
    step.ct_name = ct
    return step


def differentiable_poly_system_sweep(stencil, grid: np.ndarray,
                                     bdims: Sequence[int], nbricks: int,
                                     fields: Sequence[str],
                                     params: dict | None = None,
                                     wrt: Sequence[str] | None = None,
                                     mask_ghost: bool = True,
                                     exchanged_axes: Sequence[int] = (),
                                     forward_fn=None,
                                     **kw):
    """Exact sweep-forward / sweep-backward sweep for coupled
    POLYNOMIAL stencil SYSTEMS — the multi-output twin of
    :func:`differentiable_poly_sweep`, killing the oracle's dense
    twin for every system — piecewise outputs (If/max/abs) included
    via the symbolic differentiator's gate masks.

    Forward: ONE multi-output pencil kernel per step (shared inputs
    stream through HBM once — the system fast path).  Backward: one
    multi-input pencil sweep per requested input field, built from
    :func:`polynomial_system_adjoints` (each reads the output
    cotangent grids plus the original inputs; O(1) activation memory
    — the only residuals are the forward's own input views).

    ``fields``: the evolving input grid each STENCIL output replaces,
    in output order (the forward's ``evolve=``).  ``wrt``: input grid
    names to differentiate (default: all).  The returned
    ``fn(*views) -> (out1, ...)`` takes views in ``fn.fields`` order;
    its VJP returns one gradient per view (zeros outside ``wrt``).

    ``exchanged_axes`` as in :func:`differentiable_poly_sweep` — the
    same two multi-input caveats apply (adjoint residual reads at up
    to 2x the max forward radius must fit one ghost brick row; static
    aux gradients route home through an in-graph idempotent aux
    exchange whose transpose is the ghost-to-owner fold).  ``fuse=F``
    on periodic tables runs the F-level fused system forward with the
    pullback recomputed as F unfused exact steps
    (:func:`_fuse_by_recompute`); rejected with exchanged axes."""
    import jax
    import jax.numpy as jnp

    from .sweep import pencil_sweep

    for bad in ("evolve", "batch", "i_ghost", "inplace"):
        if kw.get(bad):
            raise ValueError(f"differentiable_poly_system_sweep does "
                             f"not support {bad}=...")
    sdefs = list(stencil) if isinstance(stencil, (list, tuple)) \
        else [stencil]
    fields = tuple(fields)
    if len(fields) != len(sdefs):
        raise ValueError("one evolving field per STENCIL output")
    F = int(kw.get("fuse") or 1)
    if F > 1:
        if tuple(exchanged_axes):
            raise ValueError(
                "exchanged_axes with fuse > 1 would compute wrong "
                "gradients (clamped fused levels are not exactly "
                "transposed across a real ghost ring); exchange "
                "every iteration at fuse=1")
        kw1 = {k: v for k, v in kw.items()
               if k != "fuse"}
        fused_fwd = forward_fn or pencil_sweep(
            sdefs, grid, bdims, nbricks, params, evolve=fields, **kw)
        return _fuse_by_recompute(
            lambda: differentiable_poly_system_sweep(
                sdefs, grid, bdims, nbricks, fields, params, wrt=wrt,
                mask_ghost=mask_ghost, **kw1),
            fused_fwd, F, fields)
    grid = np.asarray(grid)
    g2 = grid[:, :, 0] if grid.ndim == 3 else grid
    if grid.ndim == 3 and grid.shape[2] != 1:
        raise ValueError("pencil layout only (one brick per (k, j))")
    GK, GJ = g2.shape
    k_range = tuple(kw.get("k_range") or (1, GK - 1))
    j_range = tuple(kw.get("j_range") or (1, GJ - 1))
    exchanged_axes = tuple(exchanged_axes)
    if not set(exchanged_axes) <= {0, 1}:
        raise ValueError("exchanged_axes are numpy-order k/j axes "
                         "(0 and/or 1); i is always lane-periodic")
    rad = _outer_radius(sdefs)
    BK, BJ = int(bdims[0]), int(bdims[1])
    if exchanged_axes and 2 * rad > min(BK, BJ):
        raise ValueError(
            f"exchanged-axes system adjoint needs 2*radius <= "
            f"min(BK, BJ) (got radius {rad}, brick {bdims})")
    for ax, rng, G in ((0, k_range, GK), (1, j_range, GJ)):
        if ax not in exchanged_axes and (rng[0] < 1 or rng[1] > G - 1):
            raise ValueError(
                f"axis {ax}: range {rng} includes the periodic ghost "
                f"ring (grid extent {G}); table-periodic axes must "
                f"compute owned cells only (1, {G - 1})")
    _check_periodic_table(
        g2, k_range, j_range,
        axes=tuple(a for a in (0, 1) if a not in exchanged_axes))

    adjoints, ct_names = polynomial_system_adjoints(sdefs, wrt=wrt)

    fwd_fn = forward_fn or pencil_sweep(
        sdefs, grid, bdims, nbricks, params, evolve=fields, **kw)
    fieldnames = tuple(fwd_fn.fields)
    bkw = dict(kw)
    bkw["k_range"] = (0, GK) if 0 in exchanged_axes else k_range
    bkw["j_range"] = (0, GJ) if 1 in exchanged_axes else j_range
    adj_fns = {}
    for f, asd in adjoints.items():
        afn = pencil_sweep(asd, grid, bdims, nbricks, params,
                                  **bkw)
        if not hasattr(afn, "fields"):   # single-input adjoint (e.g.
            afn.fields = tuple(asd.inputs)  # linear one-output coupling)
        adj_fns[f] = afn

    def _written(kr, jr):
        w = np.zeros(nbricks, np.bool_)
        w[np.unique(g2[kr[0]:kr[1], jr[0]:jr[1]])] = True
        return jnp.asarray(w.reshape((nbricks,) + (1,) * len(bdims)))

    ct_mask = _written(k_range, j_range)
    out_mask = _written(bkw["k_range"], bkw["j_range"])

    @jax.custom_vjp
    def step(*views):
        return fwd_fn(*views)

    def step_fwd(*views):
        return fwd_fn(*views), views

    def step_bwd(views, cotans):
        # undefined (unwritten) output rows hold stale data; the
        # exact incoming cotangent there is zero by contract
        byname = dict(zip(fieldnames, views))
        for ct, c in zip(ct_names, cotans):
            byname[ct] = jnp.where(ct_mask, c, jnp.zeros((), c.dtype))
        grads = []
        for f in fieldnames:
            afn = adj_fns.get(f)
            if afn is None:
                grads.append(jnp.zeros_like(byname[f]))
                continue
            order = afn.fields
            g = (afn(*(byname[n] for n in order))
                 if len(order) > 1 else afn(byname[order[0]]))
            if mask_ghost:
                g = jnp.where(out_mask, g, jnp.zeros((), g.dtype))
            grads.append(g)
        return tuple(grads)

    step.defvjp(step_fwd, step_bwd)
    step.forward = fwd_fn
    step.adjoints = adj_fns
    step.fields = fieldnames
    step.evolve = fields
    step.ct_names = ct_names
    return step


def oracle_vjp_sweep(stencil, dec, bdims: Sequence[int],
                     params: dict | None = None,
                     fields: Sequence[str] | None = None,
                     **kw):
    """Sweep forward + exact ORACLE pullback — a dense-twin
    REFERENCE implementation kept for validation (tests check the
    adjoint-sweep modes against it) and for opaque functions with no
    registered derivative rule.  Every production path — linear,
    variable-coefficient, polynomial and piecewise (If/max/abs)
    nonlinear, single-output and coupled systems — gets the exact
    adjoint sweeps instead (O(1) activations, no dense twin);
    Problem.differentiable_step never dispatches here.

    On a fully periodic table the dense twin computes the same
    function as the pencil kernel (the golden equivalence every test
    asserts), so ``jax.vjp`` through the traceable dense oracle is the
    exact pullback of the sweep forward.  The forward runs at kernel
    speed; the backward runs at XLA-fused jnp speed (one dense
    periodic application per output per fused level).

    ``dec``: a :class:`~brickjax.comm.decomp.BrickDecomp` whose
    table is used fully periodic (single-device / table-periodic
    semantics — distributed meshes differentiate through the linear
    adjoint mode only).  ``fields``: evolving grid names in STENCIL
    output order (defaults to the single input).  Returns
    ``fn(*views)`` in ``fn.fields`` input order, one output view per
    STENCIL entry."""
    import jax
    import jax.numpy as jnp

    from .jnp_backend import dense_apply
    from .sweep import pencil_sweep

    sdefs = stencil if isinstance(stencil, (list, tuple)) else [stencil]
    for bad in ("evolve", "batch", "i_ghost", "inplace", "k_range",
                "j_range", "i_range"):
        if kw.get(bad):
            raise ValueError(f"oracle_vjp_sweep does not take {bad}=")
    if fields is None:
        if len(sdefs) != 1 or len(sdefs[0].inputs) != 1:
            raise ValueError("fields= is required for systems / "
                             "multi-input stencils")
        fields = (next(iter(sdefs[0].inputs)),)
    fields = tuple(fields)
    if len(fields) != len(sdefs):
        raise ValueError("one evolving field per STENCIL output")
    nd = sdefs[0].dims
    if nd != 3:
        raise ValueError("oracle_vjp_sweep is 3-D pencil only")
    kgrid = dec.periodic_grid(tuple(range(nd)))
    F = int(kw.get("fuse") or 1)

    fwd_fn = pencil_sweep(
        sdefs if len(sdefs) > 1 else sdefs[0], kgrid, bdims,
        dec.nbricks, params, evolve=fields, **kw)
    fieldnames = getattr(fwd_fn, "fields", fields)
    NO = len(sdefs)

    # traceable storage <-> dense transforms over the OWNED cells
    ids_np = dec.interior_grid()
    ids2 = ids_np[:, :, 0] if ids_np.ndim == 3 else ids_np
    gk, gj = ids2.shape
    BK, BJ, BI = (int(b) for b in bdims)
    flat_ids = jnp.asarray(ids2.ravel().astype(np.int32))

    def to_dense(v):
        b = v[flat_ids].reshape(gk, gj, BK, BJ, BI)
        return b.transpose(0, 2, 1, 3, 4).reshape(gk * BK, gj * BJ, BI)

    def to_store(dn, like):
        b = dn.reshape(gk, BK, gj, BJ, BI).transpose(0, 2, 1, 3, 4)
        return jnp.zeros_like(like).at[flat_ids].set(
            b.reshape(gk * gj, BK, BJ, BI))

    pads = {}
    for sd in sdefs:
        lo, hi = sd.radius()
        pads[sd.output.name] = tuple((lo[a], hi[a]) for a in range(nd))

    def oracle(*views):
        vs = {n: to_dense(v) for n, v in zip(fieldnames, views)}
        for _ in range(F):
            outs = [dense_apply(
                sd, {n: jnp.pad(vs[n], pads[sd.output.name],
                                mode="wrap") for n in sd.inputs},
                params) for sd in sdefs]
            vs.update(zip(fields, outs))   # Jacobi: all read pre-level
        return tuple(vs[f] for f in fields)

    written = np.zeros(dec.nbricks, np.bool_)
    written[np.unique(ids2)] = True
    mask = jnp.asarray(written.reshape((dec.nbricks,)
                                       + (1,) * len(bdims)))

    @jax.custom_vjp
    def step(*views):
        return fwd_fn(*views)

    def step_fwd(*views):
        return fwd_fn(*views), views

    def step_bwd(views, ct):
        cts = ct if isinstance(ct, tuple) else (ct,)
        # zero the undefined (unwritten) output rows before the vjp
        cts = tuple(jnp.where(mask, c, jnp.zeros((), c.dtype))
                    for c in cts)

        def ofn(*v):
            outs = oracle(*v)
            return tuple(to_store(o, views[fieldnames.index(f)])
                         for o, f in zip(outs, fields))

        _, vjp = jax.vjp(ofn, *views)
        return vjp(cts)

    step.defvjp(step_fwd, step_bwd)
    step.forward = fwd_fn
    step.fields = tuple(fieldnames)
    return step


def _check_periodic_table_nd(grid: np.ndarray, ranges, axes=None):
    """n-outer-axis torus check (4-D pencil tables): every ghost ring
    cell must alias the wrapped owned brick along every checked axis
    (``axes`` restricts the check — exchanged axes carry REAL ghost
    bricks and are exempt)."""
    ok = True
    for ax, (a0, a1) in enumerate(ranges):
        if axes is not None and ax not in axes:
            continue
        G = grid.shape[ax]
        p = a1 - a0
        sl = [slice(None)] * grid.ndim

        def at(r):
            s = list(sl)
            s[ax] = r
            return grid[tuple(s)]

        for r in range(a0):
            ok &= bool(np.array_equal(at(r), at(r + p)))
        for r in range(G - a1):
            ok &= bool(np.array_equal(at(a1 + r), at(a0 + r)))
    if not ok:
        raise ValueError(
            "the differentiable sweep needs a fully periodic grid "
            "table (BrickDecomp.periodic_grid over all axes)")


def differentiable_pencil_sweep_4d(stencil, grid: np.ndarray,
                                   bdims: Sequence[int], nbricks: int,
                                   params: dict | None = None,
                                   mask_ghost: bool = True,
                                   exchanged_axes: Sequence[int] = (),
                                   forward_fn=None,
                                   **kw):
    """4-D twin of :func:`differentiable_pencil_sweep`.  Same contract:
    linear single-input stencil, exact adjoint sweep as the pullback,
    undefined output rows masked to zero.  ``exchanged_axes`` (numpy
    order: 0 = w, 1 = k, 2 = j) marks axes whose ghost ring is filled
    by a real exchange — the pullback runs the adjoint over the FULL
    range there and the exchange's own transpose routes the ghost
    cotangent home; non-exchanged axes must be table-periodic and
    compute owned cells only.  ``fuse`` composes exactly on the torus
    (rejected with exchanged axes — clamped fused levels are not
    exactly transposed across a real ghost ring)."""
    import jax
    import jax.numpy as jnp

    from .sweep import pencil_sweep

    sdefs = stencil if isinstance(stencil, (list, tuple)) else [stencil]
    if len(sdefs) != 1:
        raise ValueError("differentiable_pencil_sweep_4d takes one "
                         "output")
    if sdefs[0].dims != 4:
        raise ValueError("use differentiable_pencil_sweep for 3-D")
    grid = np.asarray(grid)
    g3 = grid[:, :, :, 0] if grid.ndim == 4 else grid
    if grid.ndim == 4 and grid.shape[3] != 1:
        raise ValueError("pencil layout only (one brick per (w, k, j))")
    GW, GK, GJ = g3.shape
    exchanged_axes = tuple(exchanged_axes)
    if not set(exchanged_axes) <= {0, 1, 2}:
        raise ValueError("exchanged_axes are numpy-order w/k/j axes "
                         "(0, 1 and/or 2); i is always lane-periodic")
    if exchanged_axes and int(kw.get("fuse") or 1) > 1:
        raise ValueError("exchanged_axes with fuse > 1 would compute "
                         "wrong gradients (clamped fused adjoint "
                         "levels); exchange every iteration at fuse=1")
    ranges = (tuple(kw.get("w_range") or (1, GW - 1)),
              tuple(kw.get("k_range") or (1, GK - 1)),
              tuple(kw.get("j_range") or (1, GJ - 1)))
    for ax, (a0, a1) in enumerate(ranges):
        G = g3.shape[ax]
        if ax not in exchanged_axes and (a0 < 1 or a1 > G - 1):
            raise ValueError(
                f"axis {ax}: range {(a0, a1)} includes the periodic "
                f"ghost ring (grid extent {G}); compute owned cells "
                f"only (1, {G - 1})")
    _check_periodic_table_nd(
        g3, ranges, axes=tuple(a for a in (0, 1, 2)
                               if a not in exchanged_axes))

    fwd_fn = forward_fn or pencil_sweep(
        sdefs[0], grid, bdims, nbricks, params, **kw)
    # pullback ranges: full span on exchanged axes (ghost cotangent is
    # real data the exchange transpose routes home)
    bkw = dict(kw)
    branges = tuple((0, g3.shape[a]) if a in exchanged_axes
                    else ranges[a] for a in range(3))
    bkw["w_range"], bkw["k_range"], bkw["j_range"] = branges
    adj_fn = pencil_sweep(adjoint_stencil(sdefs[0]), grid,
                                    bdims, nbricks, params, **bkw)

    written = np.zeros(nbricks, np.bool_)
    written[np.unique(g3[branges[0][0]:branges[0][1],
                         branges[1][0]:branges[1][1],
                         branges[2][0]:branges[2][1]])] = True
    mask = jnp.asarray(written.reshape((nbricks,) + (1,) * len(bdims)))

    @jax.custom_vjp
    def step(d):
        return fwd_fn(d)

    def step_fwd(d):
        return fwd_fn(d), None

    def step_bwd(_res, ct):
        xb = adj_fn(ct)
        return ((jnp.where(mask, xb, jnp.zeros((), xb.dtype))
                 if mask_ghost else xb),)

    step.defvjp(step_fwd, step_bwd)
    step.forward = fwd_fn
    step.adjoint = adj_fn
    return step


def differentiable_poly_sweep_4d(stencil, grid: np.ndarray,
                                 bdims: Sequence[int], nbricks: int,
                                 params: dict | None = None,
                                 wrt: Sequence[str] | None = None,
                                 mask_ghost: bool = True,
                                 exchanged_axes: Sequence[int] = (),
                                 forward_fn=None,
                                 **kw):
    """4-D twin of :func:`differentiable_poly_sweep`: exact
    sweep-forward / sweep-backward for POLYNOMIAL 4-D stencils
    (variable coefficients and polynomial nonlinearities) on the 4-D
    multi-input pencil emitter (per-field rolling windows with their
    own w-halo slices).  The pullback of each requested input field is
    one more multi-input 4-D sweep from
    :func:`polynomial_adjoint_stencils`; the only residuals are the
    forward's own input views (O(1) activations — no dense twin).

    ``exchanged_axes`` (numpy order: 0 = w, 1 = k, 2 = j) as in
    :func:`differentiable_pencil_sweep_4d`, with the multi-input
    caveats of the 3-D poly sweep: adjoint residual reads span up to
    2x the forward radius, so ``2 * radius <= min(BW, BK, BJ)``; and
    static aux-field ghost gradients route home through an in-graph
    idempotent aux exchange (its transpose is the ghost-to-owner
    fold — Problem.differentiable_step does this).  ``fuse=F``
    composes on periodic tables for SINGLE-INPUT stencils (the 4-D
    emitter's fusion surface): fused forward, pullback recomputed as F
    unfused exact steps (:func:`_fuse_by_recompute`)."""
    import jax
    import jax.numpy as jnp

    from .sweep import pencil_sweep

    for bad in ("evolve", "batch", "i_ghost", "inplace"):
        if kw.get(bad):
            raise ValueError(f"differentiable_poly_sweep_4d does not "
                             f"support {bad}=...")
    sdefs = stencil if isinstance(stencil, (list, tuple)) else [stencil]
    if len(sdefs) != 1:
        raise ValueError("differentiable_poly_sweep_4d takes one "
                         "output")
    sdef = sdefs[0]
    if sdef.dims != 4:
        raise ValueError("use differentiable_poly_sweep for 3-D")
    F = int(kw.get("fuse") or 1)
    if F > 1:
        if tuple(exchanged_axes):
            raise ValueError(
                "exchanged_axes with fuse > 1 would compute wrong "
                "gradients (clamped fused levels); exchange every "
                "iteration at fuse=1")
        kw1 = {k: v for k, v in kw.items()
               if k != "fuse"}
        fused_fwd = forward_fn or pencil_sweep(
            sdef, grid, bdims, nbricks, params, **kw)
        return _fuse_by_recompute(
            lambda: differentiable_poly_sweep_4d(
                sdef, grid, bdims, nbricks, params, wrt=wrt,
                mask_ghost=mask_ghost, **kw1),
            fused_fwd, F,
            getattr(fused_fwd, "evolve", None)
            or tuple(getattr(fused_fwd, "fields",
                             tuple(sdef.inputs)))[:1])
    grid = np.asarray(grid)
    g3 = grid[:, :, :, 0] if grid.ndim == 4 else grid
    if grid.ndim == 4 and grid.shape[3] != 1:
        raise ValueError("pencil layout only (one brick per (w, k, j))")
    GW, GK, GJ = g3.shape
    ranges = (tuple(kw.get("w_range") or (1, GW - 1)),
              tuple(kw.get("k_range") or (1, GK - 1)),
              tuple(kw.get("j_range") or (1, GJ - 1)))
    exchanged_axes = tuple(exchanged_axes)
    if not set(exchanged_axes) <= {0, 1, 2}:
        raise ValueError("exchanged_axes are numpy-order w/k/j axes "
                         "(0, 1 and/or 2); i is always lane-periodic")
    rad = _outer_radius((sdef,))
    BW, BK, BJ = int(bdims[0]), int(bdims[1]), int(bdims[2])
    if exchanged_axes and 2 * rad > min(BW, BK, BJ):
        # adjoint coefficient factors read residuals at shifted-by-two
        # offsets; beyond-table clamps are only provably harmless when
        # one ghost brick row covers 2x the radius (same derivation as
        # the 3-D poly sweep)
        raise ValueError(
            f"exchanged-axes poly adjoint needs 2*radius <= "
            f"min(BW, BK, BJ) (got radius {rad}, brick {bdims})")
    for ax, (a0, a1) in enumerate(ranges):
        G = g3.shape[ax]
        if ax not in exchanged_axes and (a0 < 1 or a1 > G - 1):
            raise ValueError(
                f"axis {ax}: range {(a0, a1)} includes the periodic "
                f"ghost ring (grid extent {G}); compute owned cells "
                f"only (1, {G - 1})")
    _check_periodic_table_nd(
        g3, ranges, axes=tuple(a for a in (0, 1, 2)
                               if a not in exchanged_axes))

    adjoints, ct = polynomial_adjoint_stencils(sdef, wrt=wrt)

    fwd_fn = forward_fn or pencil_sweep(
        sdef, grid, bdims, nbricks, params, **kw)
    fieldnames = tuple(getattr(fwd_fn, "fields", tuple(sdef.inputs)))
    bkw = dict(kw)
    branges = tuple((0, g3.shape[a]) if a in exchanged_axes
                    else ranges[a] for a in range(3))
    bkw["w_range"], bkw["k_range"], bkw["j_range"] = branges
    adj_fns = {}
    for f, asd in adjoints.items():
        adj_fns[f] = pencil_sweep(asd, grid, bdims, nbricks,
                                            params, **bkw)

    def _written(rg):
        w = np.zeros(nbricks, np.bool_)
        w[np.unique(g3[rg[0][0]:rg[0][1], rg[1][0]:rg[1][1],
                       rg[2][0]:rg[2][1]])] = True
        return jnp.asarray(w.reshape((nbricks,) + (1,) * len(bdims)))

    ct_mask = _written(ranges)
    out_mask = _written(branges)

    def _call_fwd(views):
        return (fwd_fn(*views) if len(fieldnames) > 1
                else fwd_fn(views[0]))

    @jax.custom_vjp
    def step(*views):
        return _call_fwd(views)

    def step_fwd(*views):
        return _call_fwd(views), views

    def step_bwd(views, cotan):
        cotan = jnp.where(ct_mask, cotan, jnp.zeros((), cotan.dtype))
        byname = dict(zip(fieldnames, views))
        byname[ct] = cotan
        grads = []
        for f in fieldnames:
            afn = adj_fns.get(f)
            if afn is None:
                grads.append(jnp.zeros_like(byname[f]))
                continue
            order = getattr(afn, "fields", (ct,))
            g = (afn(*(byname[n] for n in order))
                 if len(order) > 1 else afn(byname[order[0]]))
            if mask_ghost:
                g = jnp.where(out_mask, g, jnp.zeros((), g.dtype))
            grads.append(g)
        return tuple(grads)

    step.defvjp(step_fwd, step_bwd)
    step.forward = fwd_fn
    step.adjoints = adj_fns
    step.fields = fieldnames
    step.ct_name = ct
    return step


def differentiable_poly_system_sweep_4d(stencil, grid: np.ndarray,
                                        bdims: Sequence[int],
                                        nbricks: int,
                                        fields: Sequence[str],
                                        params: dict | None = None,
                                        wrt: Sequence[str] | None = None,
                                        mask_ghost: bool = True,
                                        exchanged_axes:
                                        Sequence[int] = (),
                                        forward_fns=None,
                                        **kw):
    """4-D twin of :func:`differentiable_poly_system_sweep`: exact
    pullback for coupled POLYNOMIAL 4-D stencil systems.

    Forward: one multi-input 4-D pencil kernel PER OUTPUT (the 4-D
    emitter is single-output; Jacobi semantics are identical — every
    output reads the pre-step fields).  Backward: one multi-input 4-D
    sweep per requested input field from
    :func:`polynomial_system_adjoints` (reads the output cotangent
    grids plus the original inputs; O(1) activations).

    ``fields``: the evolving input grid each STENCIL output replaces,
    in output order.  ``forward_fns``: prebuilt per-output
    :func:`pencil_sweep` kernels with the SAME config (e.g.
    a Problem plan's).  ``exchanged_axes``/``wrt``/masking as in
    :func:`differentiable_poly_sweep_4d`."""
    import jax
    import jax.numpy as jnp

    from .sweep import pencil_sweep

    for bad in ("evolve", "batch", "i_ghost", "inplace"):
        if kw.get(bad):
            raise ValueError(f"differentiable_poly_system_sweep_4d "
                             f"does not support {bad}=...")
    if int(kw.get("fuse") or 1) > 1:
        raise ValueError("differentiable_poly_system_sweep_4d is "
                         "fuse=1 only (the 4-D emitter fuses "
                         "single-input single-output sweeps only, so "
                         "no fused system forward exists to wrap)")
    sdefs = list(stencil) if isinstance(stencil, (list, tuple)) \
        else [stencil]
    if any(s.dims != 4 for s in sdefs):
        raise ValueError("use differentiable_poly_system_sweep for "
                         "3-D")
    fields = tuple(fields)
    if len(fields) != len(sdefs):
        raise ValueError("one evolving field per STENCIL output")
    grid = np.asarray(grid)
    g3 = grid[:, :, :, 0] if grid.ndim == 4 else grid
    if grid.ndim == 4 and grid.shape[3] != 1:
        raise ValueError("pencil layout only (one brick per (w, k, j))")
    GW, GK, GJ = g3.shape
    ranges = (tuple(kw.get("w_range") or (1, GW - 1)),
              tuple(kw.get("k_range") or (1, GK - 1)),
              tuple(kw.get("j_range") or (1, GJ - 1)))
    exchanged_axes = tuple(exchanged_axes)
    if not set(exchanged_axes) <= {0, 1, 2}:
        raise ValueError("exchanged_axes are numpy-order w/k/j axes "
                         "(0, 1 and/or 2); i is always lane-periodic")
    rad = _outer_radius(sdefs)
    BW, BK, BJ = int(bdims[0]), int(bdims[1]), int(bdims[2])
    if exchanged_axes and 2 * rad > min(BW, BK, BJ):
        raise ValueError(
            f"exchanged-axes system adjoint needs 2*radius <= "
            f"min(BW, BK, BJ) (got radius {rad}, brick {bdims})")
    for ax, (a0, a1) in enumerate(ranges):
        G = g3.shape[ax]
        if ax not in exchanged_axes and (a0 < 1 or a1 > G - 1):
            raise ValueError(
                f"axis {ax}: range {(a0, a1)} includes the periodic "
                f"ghost ring (grid extent {G}); compute owned cells "
                f"only (1, {G - 1})")
    _check_periodic_table_nd(
        g3, ranges, axes=tuple(a for a in (0, 1, 2)
                               if a not in exchanged_axes))

    adjoints, ct_names = polynomial_system_adjoints(sdefs, wrt=wrt)

    # union input order across the system (first-seen), the step's
    # calling convention — per-output kernels pick their own subset
    fieldnames: list = []
    for s in sdefs:
        for n in s.inputs:
            if n not in fieldnames:
                fieldnames.append(n)
    fieldnames = tuple(fieldnames)
    fwd_fns = list(forward_fns) if forward_fns is not None else [
        pencil_sweep(s, grid, bdims, nbricks, params, **kw)
        for s in sdefs]
    if len(fwd_fns) != len(sdefs):
        raise ValueError("one forward kernel per STENCIL output")
    fwd_orders = [tuple(getattr(f_, "fields", tuple(s.inputs)))
                  for f_, s in zip(fwd_fns, sdefs)]
    bkw = dict(kw)
    branges = tuple((0, g3.shape[a]) if a in exchanged_axes
                    else ranges[a] for a in range(3))
    bkw["w_range"], bkw["k_range"], bkw["j_range"] = branges
    adj_fns = {}
    for f, asd in adjoints.items():
        afn = pencil_sweep(asd, grid, bdims, nbricks,
                                     params, **bkw)
        if not hasattr(afn, "fields"):   # single-input adjoint
            afn.fields = tuple(asd.inputs)
        adj_fns[f] = afn

    def _written(rg):
        w = np.zeros(nbricks, np.bool_)
        w[np.unique(g3[rg[0][0]:rg[0][1], rg[1][0]:rg[1][1],
                       rg[2][0]:rg[2][1]])] = True
        return jnp.asarray(w.reshape((nbricks,) + (1,) * len(bdims)))

    ct_mask = _written(ranges)
    out_mask = _written(branges)

    def _call_fwd(views):
        byname = dict(zip(fieldnames, views))
        outs = []
        for f_, order in zip(fwd_fns, fwd_orders):
            outs.append(f_(*(byname[n] for n in order))
                        if len(order) > 1 else f_(byname[order[0]]))
        return tuple(outs)

    @jax.custom_vjp
    def step(*views):
        return _call_fwd(views)

    def step_fwd(*views):
        return _call_fwd(views), views

    def step_bwd(views, cotans):
        byname = dict(zip(fieldnames, views))
        for ct, c in zip(ct_names, cotans):
            byname[ct] = jnp.where(ct_mask, c, jnp.zeros((), c.dtype))
        grads = []
        for f in fieldnames:
            afn = adj_fns.get(f)
            if afn is None:
                grads.append(jnp.zeros_like(byname[f]))
                continue
            order = afn.fields
            g = (afn(*(byname[n] for n in order))
                 if len(order) > 1 else afn(byname[order[0]]))
            if mask_ghost:
                g = jnp.where(out_mask, g, jnp.zeros((), g.dtype))
            grads.append(g)
        return tuple(grads)

    step.defvjp(step_fwd, step_bwd)
    step.forward = fwd_fns
    step.adjoints = adj_fns
    step.fields = fieldnames
    step.evolve = fields
    step.ct_names = ct_names
    return step


def differentiable_pencil_sweep_2d(stencil, grid: np.ndarray,
                                   bdims: Sequence[int], nbricks: int,
                                   params: dict | None = None,
                                   mask_ghost: bool = True,
                                   exchanged_axes: Sequence[int] = (),
                                   forward_fn=None,
                                   **kw):
    """2-D twin of :func:`differentiable_pencil_sweep` (linear
    single-input stencils on the 2-D row-pencil emitter).  Same
    contract: the pullback is the adjoint stencil as a second 2-D
    sweep; ``exchanged_axes=(0,)`` marks a real y exchange, whose
    transpose routes the ghost-row cotangent the full-range adjoint
    scatters back to the senders (x is always lane-periodic)."""
    import jax
    import jax.numpy as jnp

    from .sweep import pencil_sweep

    sdefs = stencil if isinstance(stencil, (list, tuple)) else [stencil]
    if len(sdefs) != 1:
        raise ValueError("differentiable_pencil_sweep_2d takes one "
                         "output")
    if sdefs[0].dims != 2:
        raise ValueError("use differentiable_pencil_sweep for 3-D")
    grid = np.asarray(grid)
    g1 = grid[:, 0] if grid.ndim == 2 else grid
    if grid.ndim == 2 and grid.shape[1] != 1:
        raise ValueError("2-D pencil layout only (one brick per y row)")
    GY = g1.shape[0]
    y_range = tuple(kw.pop("y_range", None) or (1, GY - 1))
    exchanged_axes = tuple(exchanged_axes)
    if not set(exchanged_axes) <= {0}:
        raise ValueError("the only exchangeable 2-D axis is y (0); "
                         "x is always lane-periodic")
    if exchanged_axes and int(kw.get("fuse") or 1) > 1:
        # same contract as the 3-D form: the fused trapezoid's window
        # rows clamp at the table edge, which is not exactly transposed
        # across a real ghost ring (fuse composes exactly on a torus)
        raise ValueError("exchanged_axes with fuse > 1 would compute "
                         "wrong gradients (clamped window rows); "
                         "exchange every iteration at fuse=1")
    if 0 not in exchanged_axes:
        if y_range[0] < 1 or y_range[1] > GY - 1:
            raise ValueError(
                f"y range {y_range} includes the periodic ghost ring "
                f"(grid extent {GY}); table-periodic axes must compute "
                f"owned cells only (1, {GY - 1})")
        _check_periodic_table_nd(g1, (y_range,))

    fwd_fn = forward_fn or pencil_sweep(
        sdefs[0], grid, bdims, nbricks, params, y_range=y_range, **kw)
    # pullback range: full span when y is exchanged (ghost cotangent is
    # real data the exchange transpose routes home), owned span on a
    # table-periodic y (ring rows alias owned bricks)
    byr = (0, GY) if 0 in exchanged_axes else y_range
    adj_fn = pencil_sweep(
        adjoint_stencil(sdefs[0]), grid, bdims, nbricks, params,
        y_range=byr, **kw)

    written = np.zeros(nbricks, np.bool_)
    written[np.unique(g1[byr[0]:byr[1]])] = True
    mask = jnp.asarray(written.reshape((nbricks,) + (1,) * len(bdims)))

    @jax.custom_vjp
    def step(d):
        return fwd_fn(d)

    def step_fwd(d):
        return fwd_fn(d), None

    def step_bwd(_res, ct):
        xb = adj_fn(ct)
        return ((jnp.where(mask, xb, jnp.zeros((), xb.dtype))
                 if mask_ghost else xb),)

    step.defvjp(step_fwd, step_bwd)
    step.forward = fwd_fn
    step.adjoint = adj_fn
    return step


def differentiable_poly_sweep_2d(stencil, grid: np.ndarray,
                                 bdims: Sequence[int], nbricks: int,
                                 params: dict | None = None,
                                 wrt: Sequence[str] | None = None,
                                 mask_ghost: bool = True,
                                 exchanged_axes: Sequence[int] = (),
                                 forward_fn=None,
                                 **kw):
    """2-D twin of :func:`differentiable_poly_sweep`: exact sweep
    forward/backward for POLYNOMIAL 2-D stencils (variable-coefficient
    and polynomial-nonlinear) on the row-pencil emitter.  Each
    requested input's pullback is another multi-input 2-D sweep built
    from :func:`polynomial_adjoint_stencils`; residuals are the
    forward's own input views (O(1) activation memory).  Same
    exchanged-axes contract as the 3-D form (y only; adjoint residual
    reads at up to 2x the forward radius must fit one ghost brick
    row).  ``fuse=F`` composes on periodic tables for SINGLE-INPUT
    stencils (the 2-D trapezoid's fusion surface): fused forward,
    pullback recomputed as F unfused exact steps
    (:func:`_fuse_by_recompute`)."""
    import jax
    import jax.numpy as jnp

    from .sweep import pencil_sweep

    sdefs = stencil if isinstance(stencil, (list, tuple)) else [stencil]
    if len(sdefs) != 1:
        raise ValueError("differentiable_poly_sweep_2d takes one "
                         "output")
    sdef = sdefs[0]
    if sdef.dims != 2:
        raise ValueError("use differentiable_poly_sweep for 3-D")
    F = int(kw.get("fuse") or 1)
    if F > 1:
        if tuple(exchanged_axes):
            raise ValueError(
                "exchanged_axes with fuse > 1 would compute wrong "
                "gradients (clamped fused levels); exchange every "
                "iteration at fuse=1")
        kw1 = {k: v for k, v in kw.items() if k != "fuse"}
        fused_fwd = forward_fn or pencil_sweep(
            sdef, grid, bdims, nbricks, params, **kw)
        return _fuse_by_recompute(
            lambda: differentiable_poly_sweep_2d(
                sdef, grid, bdims, nbricks, params, wrt=wrt,
                mask_ghost=mask_ghost, **kw1),
            fused_fwd, F,
            getattr(fused_fwd, "evolve", None)
            or tuple(getattr(fused_fwd, "fields",
                             tuple(sdef.inputs)))[:1])
    grid = np.asarray(grid)
    g1 = grid[:, 0] if grid.ndim == 2 else grid
    if grid.ndim == 2 and grid.shape[1] != 1:
        raise ValueError("2-D pencil layout only (one brick per y row)")
    GY = g1.shape[0]
    y_range = tuple(kw.pop("y_range", None) or (1, GY - 1))
    exchanged_axes = tuple(exchanged_axes)
    if not set(exchanged_axes) <= {0}:
        raise ValueError("the only exchangeable 2-D axis is y (0); "
                         "x is always lane-periodic")
    rad = _outer_radius((sdef,))
    if exchanged_axes and 2 * rad > int(bdims[0]):
        raise ValueError(
            f"exchanged-y poly adjoint needs 2*radius <= BY "
            f"(got radius {rad}, brick {tuple(bdims)})")
    if 0 not in exchanged_axes:
        if y_range[0] < 1 or y_range[1] > GY - 1:
            raise ValueError(
                f"y range {y_range} includes the periodic ghost ring "
                f"(grid extent {GY}); table-periodic axes must compute "
                f"owned cells only (1, {GY - 1})")
        _check_periodic_table_nd(g1, (y_range,))

    adjoints, ct = polynomial_adjoint_stencils(sdef, wrt=wrt)

    fwd_fn = forward_fn or pencil_sweep(
        sdef, grid, bdims, nbricks, params, y_range=y_range, **kw)
    fieldnames = tuple(getattr(fwd_fn, "fields", tuple(sdef.inputs)))
    byr = (0, GY) if 0 in exchanged_axes else y_range
    adj_fns = {f: pencil_sweep(asd, grid, bdims, nbricks,
                                         params, y_range=byr, **kw)
               for f, asd in adjoints.items()}

    def _written(yr):
        w = np.zeros(nbricks, np.bool_)
        w[np.unique(g1[yr[0]:yr[1]])] = True
        return jnp.asarray(w.reshape((nbricks,) + (1,) * len(bdims)))

    ct_mask = _written(y_range)
    out_mask = _written(byr)

    def _call_fwd(views):
        return (fwd_fn(*views) if len(fieldnames) > 1
                else fwd_fn(views[0]))

    @jax.custom_vjp
    def step(*views):
        return _call_fwd(views)

    def step_fwd(*views):
        return _call_fwd(views), views

    def step_bwd(views, cotan):
        cotan = jnp.where(ct_mask, cotan, jnp.zeros((), cotan.dtype))
        byname = dict(zip(fieldnames, views))
        byname[ct] = cotan
        grads = []
        for f in fieldnames:
            afn = adj_fns.get(f)
            if afn is None:
                grads.append(jnp.zeros_like(byname[f]))
                continue
            order = getattr(afn, "fields", (ct,))
            g = (afn(*(byname[n] for n in order))
                 if len(order) > 1 else afn(byname[order[0]]))
            if mask_ghost:
                g = jnp.where(out_mask, g, jnp.zeros((), g.dtype))
            grads.append(g)
        return tuple(grads)

    step.defvjp(step_fwd, step_bwd)
    step.forward = fwd_fn
    step.adjoints = adj_fns
    step.fields = fieldnames
    step.ct_name = ct
    return step


def differentiable_poly_system_sweep_2d(stencil, grid: np.ndarray,
                                        bdims: Sequence[int],
                                        nbricks: int,
                                        fields: Sequence[str],
                                        params: dict | None = None,
                                        wrt: Sequence[str] | None = None,
                                        mask_ghost: bool = True,
                                        exchanged_axes:
                                        Sequence[int] = (),
                                        forward_fn=None,
                                        **kw):
    """2-D twin of :func:`differentiable_poly_system_sweep`: exact
    pullback for coupled POLYNOMIAL 2-D systems.  One multi-output
    row-pencil forward per step; one multi-input adjoint 2-D sweep per
    requested input field (reads the output cotangent grids plus the
    original inputs; O(1) activation memory).  Same exchanged-y
    contract as the single-output 2-D form."""
    import jax
    import jax.numpy as jnp

    from .sweep import pencil_sweep

    if int(kw.get("fuse") or 1) > 1:
        raise ValueError("differentiable_poly_system_sweep_2d is "
                         "fuse=1 only (the 2-D trapezoid fuses "
                         "single-input single-output sweeps only, so "
                         "no fused system forward exists to wrap)")
    sdefs = list(stencil) if isinstance(stencil, (list, tuple)) \
        else [stencil]
    fields = tuple(fields)
    if len(fields) != len(sdefs):
        raise ValueError("one evolving field per STENCIL output")
    grid = np.asarray(grid)
    g1 = grid[:, 0] if grid.ndim == 2 else grid
    if grid.ndim == 2 and grid.shape[1] != 1:
        raise ValueError("2-D pencil layout only (one brick per y row)")
    GY = g1.shape[0]
    y_range = tuple(kw.pop("y_range", None) or (1, GY - 1))
    exchanged_axes = tuple(exchanged_axes)
    if not set(exchanged_axes) <= {0}:
        raise ValueError("the only exchangeable 2-D axis is y (0); "
                         "x is always lane-periodic")
    rad = _outer_radius(sdefs)
    if exchanged_axes and 2 * rad > int(bdims[0]):
        raise ValueError(
            f"exchanged-y system adjoint needs 2*radius <= BY "
            f"(got radius {rad}, brick {tuple(bdims)})")
    if 0 not in exchanged_axes:
        if y_range[0] < 1 or y_range[1] > GY - 1:
            raise ValueError(
                f"y range {y_range} includes the periodic ghost ring "
                f"(grid extent {GY}); table-periodic axes must compute "
                f"owned cells only (1, {GY - 1})")
        _check_periodic_table_nd(g1, (y_range,))

    adjoints, ct_names = polynomial_system_adjoints(sdefs, wrt=wrt)

    fwd_fn = forward_fn or pencil_sweep(
        sdefs, grid, bdims, nbricks, params, y_range=y_range, **kw)
    allin: list = []
    for sd in sdefs:
        for n in sd.inputs:
            if n not in allin:
                allin.append(n)
    fieldnames = tuple(getattr(fwd_fn, "fields", tuple(allin)))
    byr = (0, GY) if 0 in exchanged_axes else y_range
    adj_fns = {}
    for f, asd in adjoints.items():
        afn = pencil_sweep(asd, grid, bdims, nbricks, params,
                                     y_range=byr, **kw)
        if not hasattr(afn, "fields"):
            afn.fields = tuple(asd.inputs)
        adj_fns[f] = afn

    def _written(yr):
        w = np.zeros(nbricks, np.bool_)
        w[np.unique(g1[yr[0]:yr[1]])] = True
        return jnp.asarray(w.reshape((nbricks,) + (1,) * len(bdims)))

    ct_mask = _written(y_range)
    out_mask = _written(byr)

    @jax.custom_vjp
    def step(*views):
        return fwd_fn(*views)

    def step_fwd(*views):
        return fwd_fn(*views), views

    def step_bwd(views, cotans):
        byname = dict(zip(fieldnames, views))
        for ct, c in zip(ct_names, cotans):
            byname[ct] = jnp.where(ct_mask, c, jnp.zeros((), c.dtype))
        grads = []
        for f in fieldnames:
            afn = adj_fns.get(f)
            if afn is None:
                grads.append(jnp.zeros_like(byname[f]))
                continue
            order = afn.fields
            g = (afn(*(byname[n] for n in order))
                 if len(order) > 1 else afn(byname[order[0]]))
            if mask_ghost:
                g = jnp.where(out_mask, g, jnp.zeros((), g.dtype))
            grads.append(g)
        return tuple(grads)

    step.defvjp(step_fwd, step_bwd)
    step.forward = fwd_fn
    step.adjoints = adj_fns
    step.fields = fieldnames
    step.evolve = fields
    step.ct_names = ct_names
    return step
