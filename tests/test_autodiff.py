"""Differentiable pencil sweeps (codegen.autodiff).

The adjoint stencil is algebraically the transpose (inner-product
identity on a periodic dense domain, numpy only), and jax.grad through
the pencil sweep (custom_vjp) matches jax.grad through the
differentiable dense twin, including chained steps and temporal fusion.
"""

import numpy as np
import pytest

from brickjax.codegen import (adjoint_stencil, dense_apply,
                                  linear_decomposition)
from brickjax.st import ConstRef, Grid, Index, load_stencil_module
from brickjax.stencils import DEFAULT_PARAMS, stencil_by_name


def _asym_stencil():
    """Deliberately asymmetric taps — symmetric stencils cannot catch
    offset-negation sign bugs (their adjoint equals themselves)."""
    i, j, k = Index(0), Index(1), Index(2)
    g, o = Grid("in", 3), Grid("out", 3)
    o(i, j, k).assign(
        ConstRef("a") * g(i + 1, j, k) + ConstRef("b") * g(i, j - 1, k)
        + ConstRef("c") * g(i, j, k + 2) - ConstRef("a") * g(i - 2, j, k)
        + g(i, j, k))
    return load_stencil_module({"STENCIL": [o]})[0]


_ASYM_PARAMS = {"a": 0.7, "b": -0.3, "c": 1.9}


def _dense_periodic(sdef, x, params):
    lo, hi = sdef.radius()
    pad = tuple((lo[a], hi[a]) for a in range(x.ndim))
    return dense_apply(sdef, {next(iter(sdef.inputs)):
                              np.pad(x, pad, mode="wrap")}, params,
                       xp=np)


def _canon(sdef, params):
    """Canonical {np_offsets: resolved coeff} for tap-set comparison."""
    acc = {}
    for _k, cexpr, taps in linear_decomposition(sdef.rhs):
        c = (params[cexpr.name] if hasattr(cexpr, "name")
             else float(cexpr.val))
        for sign, _g, offs in taps:
            o = tuple(reversed(offs))
            acc[o] = acc.get(o, 0.0) + (c if sign > 0 else -c)
    return acc


@pytest.mark.parametrize("case", ["asym", "mpi7pt", "mpi13pt"])
def test_adjoint_inner_product(case):
    # <S x, y> == <x, S^T y> on the periodic torus
    if case == "asym":
        sd, params = _asym_stencil(), _ASYM_PARAMS
    else:
        sd, params = stencil_by_name(case)[0], dict(DEFAULT_PARAMS)
    adj = adjoint_stencil(sd)
    rng = np.random.default_rng(3)
    x = rng.random((8, 8, 8)).astype(np.float64)
    y = rng.random((8, 8, 8)).astype(np.float64)
    lhs = float(np.sum(_dense_periodic(sd, x, params) * y))
    rhs = float(np.sum(x * _dense_periodic(adj, y, params)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


def test_adjoint_involution():
    sd = _asym_stencil()
    twice = adjoint_stencil(adjoint_stencil(sd))
    a, b = _canon(sd, _ASYM_PARAMS), _canon(twice, _ASYM_PARAMS)
    assert set(a) == set(b)
    for o in a:
        np.testing.assert_allclose(a[o], b[o], rtol=1e-12)


def test_adjoint_rejects_nonlinear():
    sd = stencil_by_name("cond")[0]
    with pytest.raises(ValueError, match="linear"):
        adjoint_stencil(sd)


# ------------------------------------------------- gradients vs dense


@pytest.fixture(scope="module")
def _grad_setup():
    import jax
    import jax.numpy as jnp

    from brickjax.codegen.autodiff import differentiable_pencil_sweep
    from brickjax.comm import BrickDecomp, skinlist_by_name
    from brickjax.core import to_bricks

    N = 16
    BD = (4, 4, N)
    dec = BrickDecomp(dims=(N, N, N), ghost_depth=(BD[0], BD[1], 0),
                      bdims=BD).initialize(skinlist_by_name("good", 3))
    tgrid = dec.periodic_grid((0, 1, 2))
    sd, params = _asym_stencil(), _ASYM_PARAMS

    def stage(a):
        idx = [np.arange(-g, N + g) % N for g in (BD[0], BD[1], 0)]
        dat = np.zeros((dec.nbricks, int(np.prod(BD))), np.float32)
        to_bricks(a[np.ix_(*idx)], dec.grid, BD, dat=dat)
        return dat.reshape((dec.nbricks,) + BD)

    rng = np.random.default_rng(0)
    x = rng.random((N, N, N), np.float32)
    w = rng.random((N, N, N), np.float32)
    xb = jnp.asarray(stage(x))
    wb = stage(w)
    wb[dec.sep_pos[1]:] = 0.0   # weigh OWNED rows only (ghost rows of
    wb[0] = 0.0                 # a sweep output are undefined)
    wb = jnp.asarray(wb)

    def make(fuse=1):
        return differentiable_pencil_sweep(
            sd, tgrid, BD, dec.nbricks, params,
            fuse=fuse)

    return dict(N=N, BD=BD, dec=dec, sd=sd, params=params, x=x, w=w,
                xb=xb, wb=wb, make=make, jax=jax, jnp=jnp)


def _unstage(dec, BD, g):
    from brickjax.core import from_bricks

    N = BD[2]
    full = from_bricks(np.asarray(g).reshape(dec.nbricks, -1), dec.grid,
                       BD)
    return full[BD[0]:BD[0] + N, BD[1]:BD[1] + N, :]


@pytest.mark.parametrize("steps", [1, 2])
def test_grad_matches_dense_twin(_grad_setup, steps):
    s = _grad_setup
    jax, jnp = s["jax"], s["jnp"]
    step = s["make"]()

    def loss_pencil(d):
        for _ in range(steps):
            d = step(d)
        return jnp.sum(d * s["wb"])

    gb = jax.grad(loss_pencil)(s["xb"])

    def loss_dense(xd):
        d = xd
        lo, hi = s["sd"].radius()
        for _ in range(steps):
            pad = tuple((lo[a], hi[a]) for a in range(3))
            d = dense_apply(s["sd"],
                            {"in": jnp.pad(d, pad, mode="wrap")},
                            s["params"])
        return jnp.sum(d * jnp.asarray(s["w"]))

    gd = jax.grad(loss_dense)(jnp.asarray(s["x"]))
    got = _unstage(s["dec"], s["BD"], gb)
    np.testing.assert_allclose(got, np.asarray(gd), rtol=2e-5,
                               atol=2e-5)
    # masked rows carry exact zeros, not stale data
    assert float(np.abs(np.asarray(gb)[0]).max()) == 0.0
    assert float(np.abs(np.asarray(gb)[s["dec"].sep_pos[1]:]).max()) \
        == 0.0


def test_grad_fused_equals_composed(_grad_setup):
    s = _grad_setup
    jax, jnp = s["jax"], s["jnp"]
    f2, f1 = s["make"](fuse=2), s["make"]()

    g2 = jax.grad(lambda d: jnp.sum(f2(d) * s["wb"]))(s["xb"])
    g1 = jax.grad(lambda d: jnp.sum(f1(f1(d)) * s["wb"]))(s["xb"])
    np.testing.assert_allclose(
        _unstage(s["dec"], s["BD"], g2),
        _unstage(s["dec"], s["BD"], g1), rtol=2e-5, atol=2e-5)


def test_grad_distributed_exchange_sweep():
    """jax.grad through the full distributed step — exchange_shift
    (AD-transparent ppermutes under shard_map) composed with the
    custom-VJP pencil sweep (exchanged_axes mode: the pullback's ghost
    cotangent rides the exchange's own transpose back to the senders).
    Two steps on a (2, 2, 1) mesh vs the global dense periodic twin."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from brickjax.codegen.autodiff import differentiable_pencil_sweep
    from brickjax.comm import BrickDecomp, skinlist_by_name
    from brickjax.comm.exchange import exchange_shift
    from brickjax.comm.mesh import make_domain_mesh, shard_map
    from brickjax.core import from_bricks, to_bricks

    mesh_shape = (2, 2, 1)
    dims = (16, 16, 32)            # per-device owned elements
    BD = (4, 4, dims[2])
    gz = (BD[0], BD[1], 0)
    sd, params = _asym_stencil(), _ASYM_PARAMS
    dec = BrickDecomp(dims=dims, ghost_depth=gz, bdims=BD).initialize(
        skinlist_by_name("good", 3))
    nb = dec.nbricks
    kgrid = dec.periodic_grid((2,))   # i periodic by table; k, j exchanged
    mesh = make_domain_mesh(mesh_shape)
    names = mesh.axis_names
    P_ = P(tuple(names))

    dstep = differentiable_pencil_sweep(
        sd, kgrid, BD, nb, params, exchanged_axes=(0, 1))

    def step2(d):
        for _ in range(2):
            d = exchange_shift(d, dec, names, mesh_shape,
                               table_axes=(2,))
            d = dstep(d)
        return d

    fwd = jax.jit(shard_map(step2, mesh, P_, P_))

    gshape = tuple(m * d for m, d in zip(mesh_shape, dims))
    rng = np.random.default_rng(7)
    x = rng.random(gshape, np.float32)
    w = rng.random(gshape, np.float32)

    def stage(g, zero_nonowned):
        ndev = int(np.prod(mesh_shape))
        stacked = np.zeros((ndev * nb,) + BD, np.float32)
        for r, c in enumerate(np.ndindex(*mesh_shape)):
            idx = [(np.arange(c[a] * dims[a] - gz[a],
                              c[a] * dims[a] + dims[a] + gz[a])
                    % gshape[a]) for a in range(3)]
            dat = np.zeros((nb, int(np.prod(BD))), np.float32)
            to_bricks(g[np.ix_(*idx)], dec.grid, BD, dat=dat)
            if zero_nonowned:
                dat[dec.sep_pos[1]:] = 0.0
                dat[0] = 0.0
            stacked[r * nb:(r + 1) * nb] = dat.reshape((-1,) + BD)
        return stacked

    sharding = NamedSharding(mesh, P_)
    xb = jax.device_put(jnp.asarray(stage(x, False)), sharding)
    wb = jax.device_put(jnp.asarray(stage(w, True)), sharding)

    # forward equivalence first (2 exact periodic global steps)
    got_y = np.asarray(fwd(xb))
    yd = jnp.asarray(x)
    lo, hi = sd.radius()
    pad = tuple((lo[a], hi[a]) for a in range(3))

    def dense_step(d):
        return dense_apply(sd, {"in": jnp.pad(d, pad, mode="wrap")},
                           params)

    yd2 = np.asarray(dense_step(dense_step(yd)))
    for r, c in enumerate(np.ndindex(*mesh_shape)):
        own = from_bricks(got_y[r * nb:(r + 1) * nb].reshape(nb, -1),
                          dec.interior_grid(), BD)
        sl = tuple(slice(c[a] * dims[a], (c[a] + 1) * dims[a])
                   for a in range(3))
        np.testing.assert_allclose(own, yd2[sl], rtol=2e-5, atol=2e-5)

    # gradient equivalence
    gb = jax.grad(lambda d: jnp.sum(fwd(d) * wb))(xb)
    gd = np.asarray(jax.grad(
        lambda d: jnp.sum(dense_step(dense_step(d))
                          * jnp.asarray(w)))(jnp.asarray(x)))
    gbn = np.asarray(gb)
    for r, c in enumerate(np.ndindex(*mesh_shape)):
        own = from_bricks(gbn[r * nb:(r + 1) * nb].reshape(nb, -1),
                          dec.interior_grid(), BD)
        sl = tuple(slice(c[a] * dims[a], (c[a] + 1) * dims[a])
                   for a in range(3))
        np.testing.assert_allclose(own, gd[sl], rtol=2e-5, atol=2e-5)
        # the exchange overwrites ghost storage, so its transpose
        # zeroes the ghost cotangent: grads wrt initial ghost rows = 0
        blk = gbn[r * nb:(r + 1) * nb]
        assert float(np.abs(blk[dec.sep_pos[1]:]).max()) == 0.0


@pytest.mark.parametrize("mesh", [(1, 1, 1), (2, 1, 1)])
def test_problem_differentiable_step(mesh):
    """Problem.differentiable_step: jax.grad through the user-facing
    API (single-device chained sweeps and a distributed mesh) matches
    the dense global twin."""
    import jax
    import jax.numpy as jnp

    from brickjax.api import Problem

    dims = (16, 16, 32)
    sd, params = _asym_stencil(), _ASYM_PARAMS
    st_iter = 2 if mesh == (1, 1, 1) else 1
    p = Problem(dims=dims, mesh=mesh, stencil=sd, params=params,
                bdims=(4, 4, dims[2]), backend="pencil",
                st_iter=st_iter)
    fn = p.differentiable_step()
    wmask = p.owned_mask()

    gshape = tuple(m * d for m, d in zip(mesh, dims))
    rng = np.random.default_rng(11)
    x = rng.random(gshape, np.float32)
    w = rng.random(gshape, np.float32)
    p.init(array=x)
    xb = p._dats[0]
    wp = Problem(dims=dims, mesh=mesh, stencil=sd, params=params,
                 bdims=(4, 4, dims[2]), backend="pencil",
                 st_iter=st_iter)
    wp.init(array=w)
    wb = jnp.where(wmask, wp._dats[0], 0.0)

    gb = jax.grad(lambda d: jnp.sum(fn(d) * wb))(xb)

    lo, hi = sd.radius()
    pad = tuple((lo[a], hi[a]) for a in range(3))

    def loss_dense(d):
        for _ in range(st_iter):
            d = dense_apply(sd, {"in": jnp.pad(d, pad, mode="wrap")},
                            params)
        return jnp.sum(d * jnp.asarray(w))

    gd = np.asarray(jax.grad(loss_dense)(jnp.asarray(x)))

    from brickjax.core import from_bricks

    nb = p.dec.nbricks
    gbn = np.asarray(gb)
    for r, c in enumerate(np.ndindex(*mesh)):
        own = from_bricks(gbn[r * nb:(r + 1) * nb].reshape(nb, -1),
                          p.dec.interior_grid(), p.bdims)
        sl = tuple(slice(c[a] * dims[a], (c[a] + 1) * dims[a])
                   for a in range(3))
        np.testing.assert_allclose(own, gd[sl], rtol=2e-5, atol=2e-5)


def test_exchanged_axes_rejects_fuse():
    """Regression (review finding): distributed + fuse>1 would compute
    WRONG gradients — the fused adjoint's clamped intermediate levels
    inject cotangent into outer ghost elements where the exact
    transpose is zero, and the exchange transpose routes that garbage
    into the neighbors' owned gradients.  Must be rejected at build."""
    from brickjax.codegen.autodiff import differentiable_pencil_sweep
    from brickjax.comm import BrickDecomp, skinlist_by_name

    BD = (4, 4, 16)
    dec = BrickDecomp(dims=(16, 16, 16), ghost_depth=(4, 4, 0),
                      bdims=BD).initialize(skinlist_by_name("good", 3))
    kg = dec.periodic_grid((1, 2))
    with pytest.raises(ValueError, match="fuse"):
        differentiable_pencil_sweep(
            _asym_stencil(), kg, BD, dec.nbricks, _ASYM_PARAMS,
            exchanged_axes=(0,), fuse=2)
    # and a non-periodic table on a NON-exchanged axis is rejected too
    with pytest.raises(ValueError, match="periodic"):
        differentiable_pencil_sweep(
            _asym_stencil(), dec.periodic_grid((2,)), BD, dec.nbricks,
            _ASYM_PARAMS, exchanged_axes=(0,))


def test_problem_differentiable_step_rejects_deep_ghost():
    from brickjax.api import Problem

    p = Problem(dims=(16, 16, 32), mesh=(2, 1, 1),
                stencil=_asym_stencil(), params=_ASYM_PARAMS,
                bdims=(4, 4, 32), backend="pencil", st_iter=2)
    with pytest.raises(ValueError, match="st_iter=1"):
        p.differentiable_step()


def _varcoeff_stencil():
    """Flux-form variable-coefficient diffusion slice (asymmetric
    subset so adjoint sign bugs can't cancel)."""
    i, j, k = Index(0), Index(1), Index(2)
    u, c, o = Grid("u", 3), Grid("c", 3), Grid("out", 3)
    flux = None
    for args in ([i + 1, j, k], [i, j - 1, k], [i, j, k + 1]):
        f = (c(i, j, k) + c(*args)) * (u(*args) - u(i, j, k))
        flux = f if flux is None else flux + f
    o(i, j, k).assign(u(i, j, k) + ConstRef("dt") * flux)
    return load_stencil_module({"STENCIL": [o]})[0]


_VC_PARAMS = {"dt": 0.05}


def _dense_multi(sdef, named, params):
    import jax.numpy as jnp

    lo, hi = sdef.radius()
    pad = tuple((lo[a], hi[a]) for a in range(3))
    return dense_apply(sdef, {n: jnp.pad(v, pad, mode="wrap")
                              for n, v in named.items()}, params)


@pytest.mark.parametrize("which", ["u", "c"])
def test_poly_adjoint_matches_dense_ad(which):
    """polynomial_adjoint_stencils: the adjoint stencil evaluated on
    the dense periodic twin equals jax.grad through the dense forward
    — for the evolving field AND the variable coefficient."""
    import jax
    import jax.numpy as jnp

    from brickjax.codegen.autodiff import polynomial_adjoint_stencils

    sd = _varcoeff_stencil()
    adjs, ct = polynomial_adjoint_stencils(sd)
    assert set(adjs) == {"u", "c"}
    rng = np.random.default_rng(5)
    u0 = jnp.asarray(rng.random((8, 8, 8), np.float32))
    c0 = jnp.asarray(1.0 + rng.random((8, 8, 8), np.float32))
    w = jnp.asarray(rng.random((8, 8, 8), np.float32))

    got = _dense_multi(adjs[which], {ct: w, "u": u0, "c": c0},
                       _VC_PARAMS)

    def loss(v):
        named = {"u": u0, "c": c0}
        named[which] = v
        return jnp.sum(_dense_multi(sd, named, _VC_PARAMS) * w)

    want = jax.grad(loss)(u0 if which == "u" else c0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_poly_adjoint_nonlinear_product_rule():
    """Occurrence-wise product rule: d(u_i * u_{i+1}) — the adjoint of
    a polynomial NONLINEAR stencil is exact given the forward input."""
    import jax
    import jax.numpy as jnp

    from brickjax.codegen.autodiff import polynomial_adjoint_stencils

    i, j, k = Index(0), Index(1), Index(2)
    u, o = Grid("u", 3), Grid("out", 3)
    o(i, j, k).assign(u(i, j, k) * u(i + 1, j, k)
                      - 0.5 * u(i, j - 1, k) * u(i, j, k)
                      + 2.0 * u(i, j, k + 1))
    sd = load_stencil_module({"STENCIL": [o]})[0]
    adjs, ct = polynomial_adjoint_stencils(sd)
    rng = np.random.default_rng(6)
    u0 = jnp.asarray(rng.random((8, 8, 8), np.float32))
    w = jnp.asarray(rng.random((8, 8, 8), np.float32))
    got = _dense_multi(adjs["u"], {ct: w, "u": u0}, {})
    want = jax.grad(lambda v: jnp.sum(_dense_multi(sd, {"u": v}, {})
                                      * w))(u0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_poly_expansion_rejects_unknown_function():
    """If/max now differentiate exactly (round 5); only opaque
    functions with no registered derivative rule are rejected."""
    from brickjax.codegen.autodiff import polynomial_adjoint_stencils
    from brickjax.st import Func

    i, j, k = Index(0), Index(1), Index(2)
    g, o = Grid("u", 3), Grid("out", 3)
    o(i, j, k).assign(Func("erf", 1)(g(i, j, k)))
    sd = load_stencil_module({"STENCIL": [o]})[0]
    with pytest.raises(ValueError, match="polynomial expansion"):
        polynomial_adjoint_stencils(sd)


def test_poly_sweep_grads_match_dense(interpret=True):
    """differentiable_poly_sweep: jax.grad through the sweep forward
    runs adjoint PENCIL sweeps (no dense twin) — grads wrt u and c
    match dense AD on the periodic table."""
    import jax
    import jax.numpy as jnp

    from brickjax.codegen.autodiff import differentiable_poly_sweep
    from brickjax.comm import BrickDecomp, skinlist_by_name
    from brickjax.core import to_bricks

    N = 16
    BD = (4, 4, N)
    dec = BrickDecomp(dims=(N, N, N), ghost_depth=(4, 4, 0),
                      bdims=BD).initialize(skinlist_by_name("good", 3))
    sd = _varcoeff_stencil()
    step = differentiable_poly_sweep(
        sd, dec.periodic_grid((0, 1, 2)), BD, dec.nbricks, _VC_PARAMS)

    def stage(a):
        idx = [np.arange(-g, N + g) % N for g in (4, 4, 0)]
        dat = np.zeros((dec.nbricks, int(np.prod(BD))), np.float32)
        to_bricks(a[np.ix_(*idx)], dec.grid, BD, dat=dat)
        return jnp.asarray(dat.reshape((dec.nbricks,) + BD))

    rng = np.random.default_rng(8)
    u0 = rng.random((N, N, N), np.float32)
    c0 = 1.0 + 0.5 * rng.random((N, N, N), np.float32)
    w = rng.random((N, N, N), np.float32)
    wb = np.array(stage(w))
    wb[dec.sep_pos[1]:] = 0.0
    wb[0] = 0.0
    wb = jnp.asarray(wb)
    byname = {"u": stage(u0), "c": stage(c0)}

    def loss(uv):
        named = dict(zip(("u", "c"), uv))
        return jnp.sum(step(*(named[n] for n in step.fields)) * wb)

    gu, gc = jax.grad(loss)((byname["u"], byname["c"]))

    def dense_loss(uv):
        return jnp.sum(_dense_multi(sd, dict(zip(("u", "c"), uv)),
                                    _VC_PARAMS) * jnp.asarray(w))

    du, dc = jax.grad(dense_loss)((jnp.asarray(u0), jnp.asarray(c0)))
    np.testing.assert_allclose(_unstage(dec, BD, gu), np.asarray(du),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_unstage(dec, BD, gc), np.asarray(dc),
                               rtol=2e-5, atol=2e-5)


def test_problem_poly_diff_step_distributed_aux_grads():
    """Problem.differentiable_step on a variable-coefficient stencil
    over an 8-device (2, 4, 1) mesh: exact adjoint sweeps, ghost
    cotangent riding the exchange transpose, and AUX-field gradients
    routed home through the in-graph aux exchange — vs global dense AD."""
    import jax
    import jax.numpy as jnp

    from brickjax.api import Problem
    from brickjax.core import from_bricks

    mesh = (2, 4, 1)
    dims = (8, 8, 32)              # per-device owned elements
    sd = _varcoeff_stencil()
    p = Problem(dims=dims, mesh=mesh, stencil=sd, field="u",
                params=_VC_PARAMS, bdims=(4, 4, dims[2]),
                backend="pencil", st_iter=1)
    fn = p.differentiable_step()
    wmask = p.owned_mask()

    gshape = tuple(m * d for m, d in zip(mesh, dims))
    rng = np.random.default_rng(12)
    u0 = rng.random(gshape, np.float32)
    c0 = 1.0 + 0.5 * rng.random(gshape, np.float32)
    w = rng.random(gshape, np.float32)
    p.init(array=u0, aux={"c": c0})
    wp = Problem(dims=dims, mesh=mesh, stencil=sd, field="u",
                 params=_VC_PARAMS, bdims=(4, 4, dims[2]),
                 backend="pencil", st_iter=1)
    wp.init(array=w, aux={"c": c0})
    wb = jnp.where(wmask, wp._dats[0], 0.0)

    gu, gc = jax.grad(lambda uc: jnp.sum(fn(uc[0], uc[1]) * wb))(
        (p._dats[0], p._aux[0]))

    def dense_loss(uc):
        return jnp.sum(_dense_multi(sd, {"u": uc[0], "c": uc[1]},
                                    _VC_PARAMS) * jnp.asarray(w))

    du, dc = jax.grad(dense_loss)((jnp.asarray(u0), jnp.asarray(c0)))
    nb = p.dec.nbricks
    for got, want in ((gu, np.asarray(du)), (gc, np.asarray(dc))):
        gn = np.asarray(got)
        for r, cpos in enumerate(np.ndindex(*mesh)):
            own = from_bricks(gn[r * nb:(r + 1) * nb].reshape(nb, -1),
                              p.dec.interior_grid(), p.bdims)
            sl = tuple(slice(cpos[a] * dims[a], (cpos[a] + 1) * dims[a])
                       for a in range(3))
            np.testing.assert_allclose(own, want[sl], rtol=2e-5,
                                       atol=2e-5)


def _gray_scott_defs():
    i, j, k = Index(0), Index(1), Index(2)
    u, v = Grid("u", 3), Grid("v", 3)
    ou, ov = Grid("ou", 3), Grid("ov", 3)

    def lap(g):
        return (g(i + 1, j, k) + g(i - 1, j, k) + g(i, j + 1, k)
                + g(i, j - 1, k) + g(i, j, k + 1) + g(i, j, k - 1)
                - 6.0 * g(i, j, k))

    uvv = u(i, j, k) * v(i, j, k) * v(i, j, k)
    ou(i, j, k).assign(u(i, j, k) + 0.8 * (0.16 * lap(u) - uvv
                                           + 0.035 * (1.0 - u(i, j, k))))
    ov(i, j, k).assign(v(i, j, k) + 0.8 * (0.08 * lap(v) + uvv
                                           - 0.1 * v(i, j, k)))
    return load_stencil_module({"STENCIL": [ou, ov]})


def test_oracle_vjp_nonlinear_system():
    """oracle_vjp_sweep: sweep forward + dense-oracle pullback on the
    NONLINEAR Gray-Scott system — jax.grad wrt both fields matches
    jax.grad through the pure dense twin."""
    import jax
    import jax.numpy as jnp

    from brickjax.codegen.autodiff import oracle_vjp_sweep
    from brickjax.comm import BrickDecomp, skinlist_by_name
    from brickjax.core import to_bricks

    N = 16
    BD = (4, 4, N)
    dec = BrickDecomp(dims=(N, N, N), ghost_depth=(4, 4, 0),
                      bdims=BD).initialize(skinlist_by_name("good", 3))
    sds = _gray_scott_defs()
    step = oracle_vjp_sweep(sds, dec, BD, {}, fields=("u", "v"))

    def stage(a):
        idx = [np.arange(-g, N + g) % N for g in (4, 4, 0)]
        dat = np.zeros((dec.nbricks, int(np.prod(BD))), np.float32)
        to_bricks(a[np.ix_(*idx)], dec.grid, BD, dat=dat)
        return jnp.asarray(dat.reshape((dec.nbricks,) + BD))

    rng = np.random.default_rng(2)
    u0 = rng.random((N, N, N), np.float32)
    v0 = rng.random((N, N, N), np.float32)
    w = rng.random((N, N, N), np.float32)
    wb = np.array(stage(w))
    wb[dec.sep_pos[1]:] = 0.0
    wb[0] = 0.0
    wb = jnp.asarray(wb)

    ub, vb = stage(u0), stage(v0)
    ins = {n: (ub if n == "u" else vb) for n in step.fields}

    def loss(uv):
        u_, v_ = step(*(uv[0] if n == "u" else uv[1]
                        for n in step.fields))
        return jnp.sum(u_ * wb) + 0.5 * jnp.sum(v_ * wb)

    gu, gv = jax.grad(loss)((ub, vb))

    lo, hi = sds[0].radius()
    pad = tuple((lo[a], hi[a]) for a in range(3))

    def dense_loss(uv):
        cur = {"u": uv[0], "v": uv[1]}
        outs = [dense_apply(sd, {n: jnp.pad(cur[n], pad, mode="wrap")
                                 for n in sd.inputs}, {})
                for sd in sds]
        return (jnp.sum(outs[0] * jnp.asarray(w))
                + 0.5 * jnp.sum(outs[1] * jnp.asarray(w)))

    du, dv = jax.grad(dense_loss)((jnp.asarray(u0), jnp.asarray(v0)))
    dec_ = dec
    for got, want in ((gu, du), (gv, dv)):
        own = _unstage(dec_, BD, got)
        np.testing.assert_allclose(own, np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


def test_oracle_vjp_aux_coefficient_grad():
    """Gradients wrt a STATIC aux coefficient field (the inverse
    problem: estimate c(x) from observations) through the pencil
    forward."""
    import jax
    import jax.numpy as jnp

    from brickjax.codegen.autodiff import oracle_vjp_sweep
    from brickjax.comm import BrickDecomp, skinlist_by_name
    from brickjax.core import to_bricks

    i, j, k = Index(0), Index(1), Index(2)
    u, c, o = Grid("u", 3), Grid("c", 3), Grid("out", 3)
    flux = None
    for args in ([i + 1, j, k], [i, j - 1, k], [i, j, k + 1]):
        f = (c(i, j, k) + c(*args)) * (u(*args) - u(i, j, k))
        flux = f if flux is None else flux + f
    o(i, j, k).assign(u(i, j, k) + 0.05 * flux)
    sd = load_stencil_module({"STENCIL": [o]})[0]

    N = 16
    BD = (4, 4, N)
    dec = BrickDecomp(dims=(N, N, N), ghost_depth=(4, 4, 0),
                      bdims=BD).initialize(skinlist_by_name("good", 3))
    step = oracle_vjp_sweep(sd, dec, BD, {}, fields=("u",))

    def stage(a):
        idx = [np.arange(-g, N + g) % N for g in (4, 4, 0)]
        dat = np.zeros((dec.nbricks, int(np.prod(BD))), np.float32)
        to_bricks(a[np.ix_(*idx)], dec.grid, BD, dat=dat)
        return jnp.asarray(dat.reshape((dec.nbricks,) + BD))

    rng = np.random.default_rng(4)
    u0 = rng.random((N, N, N), np.float32)
    c0 = 1.0 + 0.5 * rng.random((N, N, N), np.float32)
    w = rng.random((N, N, N), np.float32)
    wb = np.array(stage(w))
    wb[dec.sep_pos[1]:] = 0.0
    wb[0] = 0.0
    wb = jnp.asarray(wb)
    named = {"u": stage(u0), "c": stage(c0)}

    def loss(uv):
        byname = dict(zip(("u", "c"), uv))
        out = step(*(byname[n] for n in step.fields))
        return jnp.sum(out * wb)

    gu, gc = jax.grad(loss)((named["u"], named["c"]))

    lo, hi = sd.radius()
    pad = tuple((lo[a], hi[a]) for a in range(3))

    def dense_loss(uv):
        out = dense_apply(sd, {"u": jnp.pad(uv[0], pad, mode="wrap"),
                               "c": jnp.pad(uv[1], pad, mode="wrap")},
                          {})
        return jnp.sum(out * jnp.asarray(w))

    du, dc = jax.grad(dense_loss)((jnp.asarray(u0), jnp.asarray(c0)))
    np.testing.assert_allclose(_unstage(dec, BD, gu), np.asarray(du),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_unstage(dec, BD, gc), np.asarray(dc),
                               rtol=2e-5, atol=2e-5)


def test_rejects_ghost_inclusive_range_on_periodic_axis():
    """Regression (review finding): a deep-ghost range like (0, GK) on
    a table-periodic axis writes each skin brick twice through the
    ring alias (last-write-wins corruption) and made the periodicity
    check vacuous — must be rejected at build."""
    from brickjax.codegen.autodiff import differentiable_pencil_sweep
    from brickjax.comm import BrickDecomp, skinlist_by_name

    BD = (4, 4, 16)
    dec = BrickDecomp(dims=(16, 16, 16), ghost_depth=(4, 4, 0),
                      bdims=BD).initialize(skinlist_by_name("good", 3))
    tg = dec.periodic_grid((0, 1, 2))
    GK = tg.shape[0]
    with pytest.raises(ValueError, match="ghost ring"):
        differentiable_pencil_sweep(
            _asym_stencil(), tg, BD, dec.nbricks, _ASYM_PARAMS,
            k_range=(0, GK))


def test_decomp_owned_mask():
    from brickjax.comm import BrickDecomp, skinlist_by_name

    dec = BrickDecomp(dims=(16, 16, 16), ghost_depth=(4, 4, 0),
                      bdims=(4, 4, 16)).initialize(
                          skinlist_by_name("good", 3))
    m = dec.owned_mask()
    assert not m[0]                       # garbage brick
    assert m.sum() == dec.interior_grid().size
    assert bool(np.all(m[1:dec.sep_pos[1]]))   # align=1: contiguous
    assert not m[dec.sep_pos[1]:].any()


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_adjoint_inner_product(seed):
    """Randomized adjoint property: <S x, y> == <x, S^T y> for seeded
    random linear stencils (asymmetric radii, repeated taps, degenerate
    coefficients) on the periodic dense torus — numpy only."""
    from tests.test_fuzz_stencils import _random_stencil

    rng = np.random.default_rng(7000 + seed)
    sd = _random_stencil(rng)
    adj = adjoint_stencil(sd)
    x = rng.random((8, 8, 8)).astype(np.float64)
    y = rng.random((8, 8, 8)).astype(np.float64)
    lhs = float(np.sum(_dense_periodic(sd, x, {}) * y))
    rhs = float(np.sum(x * _dense_periodic(adj, y, {})))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12, atol=1e-12)


def test_grad_4d_matches_dense_twin():
    """4-D differentiable sweep: jax.grad through the 4-D pencil
    kernel (asymmetric taps, fuse=1 and fuse=2) vs the dense twin."""
    import jax
    import jax.numpy as jnp

    from brickjax.codegen.autodiff import (
        differentiable_pencil_sweep_4d)
    from brickjax.comm import BrickDecomp, skinlist_by_name
    from brickjax.core import from_bricks, to_bricks

    i, j, k, w = Index(0), Index(1), Index(2), Index(3)
    g, o = Grid("in", 4), Grid("out", 4)
    o(i, j, k, w).assign(
        1.0 * g(i, j, k, w) + 0.6 * g(i + 1, j, k, w)
        - 0.3 * g(i, j - 1, k, w) + 0.2 * g(i, j, k + 1, w)
        + 0.9 * g(i, j, k, w - 1))
    sd = load_stencil_module({"STENCIL": [o]})[0]

    dims = (4, 8, 8, 16)        # (w, k, j, i)
    BD = (2, 4, 4, 16)
    gz = (2, 4, 4, 0)
    dec = BrickDecomp(dims=dims, ghost_depth=gz, bdims=BD).initialize(
        skinlist_by_name("good", 4))
    tg = dec.periodic_grid((0, 1, 2, 3))

    def stage(a):
        idx = [np.arange(-z, dims[ax] + z) % dims[ax]
               for ax, z in enumerate(gz)]
        dat = np.zeros((dec.nbricks, int(np.prod(BD))), np.float32)
        to_bricks(a[np.ix_(*idx)], dec.grid, BD, dat=dat)
        return jnp.asarray(dat.reshape((dec.nbricks,) + BD))

    rng = np.random.default_rng(6)
    x = rng.random(dims, np.float32)
    wgt = rng.random(dims, np.float32)
    wb = np.array(stage(wgt))
    wb[~dec.owned_mask()] = 0.0
    wb = jnp.asarray(wb)
    xb = stage(x)

    lo, hi = sd.radius()
    pad = tuple((lo[a], hi[a]) for a in range(4))

    def dense_steps(d, n):
        for _ in range(n):
            d = dense_apply(sd, {"in": jnp.pad(d, pad, mode="wrap")},
                            {})
        return d

    def unstage(b):
        full = from_bricks(np.asarray(b).reshape(dec.nbricks, -1),
                           dec.grid, BD)
        return full[tuple(slice(z, z + dims[a])
                          for a, z in enumerate(gz))]

    for fuse, nsteps in ((1, 1), (2, 2)):
        step = differentiable_pencil_sweep_4d(
            sd, tg, BD, dec.nbricks, {}, fuse=fuse)
        gb = jax.grad(lambda d: jnp.sum(step(d) * wb))(xb)
        gd = jax.grad(lambda d: jnp.sum(
            dense_steps(d, nsteps) * jnp.asarray(wgt)))(jnp.asarray(x))
        np.testing.assert_allclose(unstage(gb), np.asarray(gd),
                                   rtol=2e-5, atol=2e-5)


def test_problem_differentiable_step_system_and_aux():
    """Problem.differentiable_step oracle mode: gradients for a
    nonlinear two-field system AND for a static aux coefficient field
    through the user-facing API, vs pure dense AD."""
    import jax
    import jax.numpy as jnp

    from brickjax.api import Problem

    # --- nonlinear system (Gray-Scott shape) --------------------------
    sds = _gray_scott_defs()
    dims = (16, 16, 32)
    p = Problem(dims=dims, stencil=sds, field=("u", "v"),
                bdims=(4, 4, dims[2]), backend="pencil", params={})
    fn = p.differentiable_step()
    rng = np.random.default_rng(9)
    u0 = rng.random(dims, np.float32)
    v0 = rng.random(dims, np.float32)
    w = rng.random(dims, np.float32)
    p.init(array={"u": u0, "v": v0})
    wmask = p.owned_mask()
    wp = Problem(dims=dims, stencil=sds, field=("u", "v"),
                 bdims=(4, 4, dims[2]), backend="pencil", params={})
    wp.init(array={"u": w, "v": w})
    wb = jnp.where(wmask, wp._dats[0], 0.0)

    gu, gv = jax.grad(
        lambda uv: jnp.sum(fn(*uv)[0] * wb))((p._dats[0], p._dats[1]))

    lo, hi = sds[0].radius()
    pad = tuple((lo[a], hi[a]) for a in range(3))

    def dense_loss(uv):
        cur = {"u": uv[0], "v": uv[1]}
        out = dense_apply(sds[0], {n: jnp.pad(cur[n], pad, mode="wrap")
                                   for n in sds[0].inputs}, {})
        return jnp.sum(out * jnp.asarray(w))

    from brickjax.core import from_bricks

    def unst(dec, BD, b):
        full = from_bricks(np.asarray(b).reshape(dec.nbricks, -1),
                           dec.grid, BD)
        return full[BD[0]:BD[0] + dims[0], BD[1]:BD[1] + dims[1], :]

    du, dv = jax.grad(dense_loss)((jnp.asarray(u0), jnp.asarray(v0)))
    np.testing.assert_allclose(unst(p.dec, p.bdims, gu),
                               np.asarray(du), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(unst(p.dec, p.bdims, gv),
                               np.asarray(dv), rtol=2e-5, atol=2e-5)

    # --- aux coefficient gradients ------------------------------------
    i, j, k = Index(0), Index(1), Index(2)
    u, c, o = Grid("u", 3), Grid("c", 3), Grid("out", 3)
    o(i, j, k).assign(u(i, j, k)
                      + 0.1 * (c(i, j, k) + c(i + 1, j, k))
                      * (u(i + 1, j, k) - u(i, j, k)))
    sd = load_stencil_module({"STENCIL": [o]})[0]
    q = Problem(dims=dims, stencil=sd, field="u",
                bdims=(4, 4, dims[2]), backend="pencil", params={})
    qf = q.differentiable_step()
    c0 = 1.0 + rng.random(dims, np.float32)
    q.init(array=u0, aux={"c": c0})
    qmask = q.owned_mask()
    names = list(q.fields) + list(q.aux_names)
    args = dict(zip(names, list(q._dats) + list(q._aux)))

    gc = jax.grad(lambda cb: jnp.sum(jnp.where(
        qmask, qf(args["u"], cb), 0.0) * wb))(args["c"])

    def dense_loss_c(cd):
        lo2, hi2 = sd.radius()
        pad2 = tuple((lo2[a], hi2[a]) for a in range(3))
        out = dense_apply(sd, {"u": jnp.pad(jnp.asarray(u0), pad2,
                                            mode="wrap"),
                               "c": jnp.pad(cd, pad2, mode="wrap")},
                          {})
        return jnp.sum(out * jnp.asarray(w))

    dc = jax.grad(dense_loss_c)(jnp.asarray(c0))
    np.testing.assert_allclose(unst(q.dec, q.bdims, gc),
                               np.asarray(dc), rtol=2e-5, atol=2e-5)


# ------------------------------------------------- polynomial SYSTEMS


def test_system_adjoint_matches_dense_ad():
    """polynomial_system_adjoints: each input field's pullback stencil,
    evaluated on the dense periodic twin with INDEPENDENT output
    cotangents, equals jax.grad through the dense coupled forward."""
    import jax
    import jax.numpy as jnp

    from brickjax.codegen.autodiff import polynomial_system_adjoints

    sds = _gray_scott_defs()
    adjs, cts = polynomial_system_adjoints(sds)
    assert set(adjs) == {"u", "v"} and cts == ("ou_ct", "ov_ct")
    rng = np.random.default_rng(17)
    u0 = jnp.asarray(rng.random((8, 8, 8), np.float32))
    v0 = jnp.asarray(rng.random((8, 8, 8), np.float32))
    wu = jnp.asarray(rng.random((8, 8, 8), np.float32))
    wv = jnp.asarray(rng.random((8, 8, 8), np.float32))

    def loss(uv):
        named = {"u": uv[0], "v": uv[1]}
        ou = _dense_multi(sds[0], {n: named[n] for n in sds[0].inputs},
                          {})
        ov = _dense_multi(sds[1], {n: named[n] for n in sds[1].inputs},
                          {})
        return jnp.sum(ou * wu) + jnp.sum(ov * wv)

    du, dv = jax.grad(loss)((u0, v0))
    byname = {"ou_ct": wu, "ov_ct": wv, "u": u0, "v": v0}
    for f, want in (("u", du), ("v", dv)):
        got = _dense_multi(adjs[f],
                           {n: byname[n] for n in adjs[f].inputs}, {})
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)


def test_system_adjoint_single_output_consistency():
    """A one-entry system's adjoints equal the single-output builder's
    (same stencils, same cotangent naming contract)."""
    from brickjax.codegen.autodiff import (
        polynomial_adjoint_stencils, polynomial_system_adjoints)

    sd = _varcoeff_stencil()
    a1, ct1 = polynomial_adjoint_stencils(sd)
    a2, cts = polynomial_system_adjoints([sd])
    assert (ct1,) == cts and set(a1) == set(a2)
    for f in a1:
        assert _canon_poly(a1[f]) == _canon_poly(a2[f])


def _canon_poly(sdef):
    """Canonical monomial multiset for stencil comparison."""
    from brickjax.codegen.autodiff import _expand_monomials

    out = []
    for s, c, refs in _expand_monomials(sdef.rhs):
        out.append((s, repr(c), tuple(sorted(refs))))
    return sorted(out, key=repr)


def test_poly_system_sweep_grads_match_dense():
    """differentiable_poly_system_sweep: jax.grad through the ONE
    multi-output sweep forward runs adjoint PENCIL sweeps (no dense
    twin) — grads wrt both coupled fields match dense AD on the
    periodic table."""
    import jax
    import jax.numpy as jnp

    from brickjax.codegen.autodiff import (
        differentiable_poly_system_sweep)
    from brickjax.comm import BrickDecomp, skinlist_by_name
    from brickjax.core import to_bricks

    N = 16
    BD = (4, 4, N)
    dec = BrickDecomp(dims=(N, N, N), ghost_depth=(4, 4, 0),
                      bdims=BD).initialize(skinlist_by_name("good", 3))
    sds = _gray_scott_defs()
    step = differentiable_poly_system_sweep(
        sds, dec.periodic_grid((0, 1, 2)), BD, dec.nbricks,
        ("u", "v"), {})
    assert step.ct_names == ("ou_ct", "ov_ct")

    def stage(a):
        idx = [np.arange(-g, N + g) % N for g in (4, 4, 0)]
        dat = np.zeros((dec.nbricks, int(np.prod(BD))), np.float32)
        to_bricks(a[np.ix_(*idx)], dec.grid, BD, dat=dat)
        return jnp.asarray(dat.reshape((dec.nbricks,) + BD))

    rng = np.random.default_rng(21)
    u0 = rng.random((N, N, N), np.float32)
    v0 = rng.random((N, N, N), np.float32)
    wu = rng.random((N, N, N), np.float32)
    wv = rng.random((N, N, N), np.float32)

    def stage_mask(a):
        b = np.array(stage(a))
        b[dec.sep_pos[1]:] = 0.0
        b[0] = 0.0
        return jnp.asarray(b)

    wub, wvb = stage_mask(wu), stage_mask(wv)
    byname = {"u": stage(u0), "v": stage(v0)}

    def loss(uv):
        named = dict(zip(("u", "v"), uv))
        ou, ov = step(*(named[n] for n in step.fields))
        return jnp.sum(ou * wub) + jnp.sum(ov * wvb)

    gu, gv = jax.grad(loss)((byname["u"], byname["v"]))

    def dense_loss(uv):
        named = dict(zip(("u", "v"), uv))
        ou = _dense_multi(sds[0], named, {})
        ov = _dense_multi(sds[1], named, {})
        return (jnp.sum(ou * jnp.asarray(wu))
                + jnp.sum(ov * jnp.asarray(wv)))

    du, dv = jax.grad(dense_loss)((jnp.asarray(u0), jnp.asarray(v0)))
    np.testing.assert_allclose(_unstage(dec, BD, gu), np.asarray(du),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_unstage(dec, BD, gv), np.asarray(dv),
                               rtol=2e-5, atol=2e-5)


def test_problem_poly_system_diff_step_distributed():
    """Problem.differentiable_step on the coupled Gray-Scott SYSTEM
    over an 8-device (2, 4, 1) mesh — previously oracle-only and
    single-device; now the exact adjoint-system pullback, ghost
    cotangents riding the exchange transposes — vs global dense AD."""
    import jax
    import jax.numpy as jnp

    from brickjax.api import Problem
    from brickjax.core import from_bricks

    mesh = (2, 4, 1)
    dims = (8, 8, 32)              # per-device owned elements
    sds = _gray_scott_defs()
    p = Problem(dims=dims, mesh=mesh, stencil=sds, field=("u", "v"),
                params={}, bdims=(4, 4, dims[2]), backend="pencil",
                st_iter=1)
    fn = p.differentiable_step()
    wmask = p.owned_mask()

    gshape = tuple(m * d for m, d in zip(mesh, dims))
    rng = np.random.default_rng(23)
    u0 = rng.random(gshape, np.float32)
    v0 = rng.random(gshape, np.float32)
    w = rng.random(gshape, np.float32)
    p.init(array={"u": u0, "v": v0})
    wp = Problem(dims=dims, mesh=mesh, stencil=sds, field=("u", "v"),
                 params={}, bdims=(4, 4, dims[2]), backend="pencil",
                 st_iter=1)
    wp.init(array={"u": w, "v": w})
    wb = jnp.where(wmask, wp._dats[0], 0.0)

    gu, gv = jax.grad(
        lambda uv: jnp.sum(fn(*uv)[0] * wb))((p._dats[0], p._dats[1]))

    def dense_loss(uv):
        named = {"u": uv[0], "v": uv[1]}
        ou = _dense_multi(sds[0], named, {})
        return jnp.sum(ou * jnp.asarray(w))

    du, dv = jax.grad(dense_loss)((jnp.asarray(u0), jnp.asarray(v0)))
    nb = p.dec.nbricks
    for got, want in ((gu, np.asarray(du)), (gv, np.asarray(dv))):
        gn = np.asarray(got)
        for r, cpos in enumerate(np.ndindex(*mesh)):
            own = from_bricks(gn[r * nb:(r + 1) * nb].reshape(nb, -1),
                              p.dec.interior_grid(), p.bdims)
            sl = tuple(slice(cpos[a] * dims[a], (cpos[a] + 1) * dims[a])
                       for a in range(3))
            np.testing.assert_allclose(own, want[sl], rtol=2e-5,
                                       atol=2e-5)


# ------------------------------------------------ differentiable rollout


@pytest.mark.parametrize("seg", [None, 1, 3])
def test_differentiable_rollout_matches_composed(seg):
    """differentiable_rollout(n): forward equals n composed
    differentiable steps and the gradient matches jax.grad through the
    composed chain — remat segments change memory, not values."""
    import jax
    import jax.numpy as jnp

    from brickjax.api import Problem

    dims = (16, 16, 32)
    p = Problem(dims=dims, stencil="mpi7pt", bdims=(4, 4, dims[2]),
                backend="pencil", st_iter=1)
    step = p.differentiable_step()
    roll = p.differentiable_rollout(3, checkpoint_every=seg)
    rng = np.random.default_rng(31)
    p.init(array=rng.random(dims, np.float32))
    x0 = p._dats[0]
    wb = jnp.where(p.owned_mask(), 1.0, 0.0)

    def composed(d):
        for _ in range(3):
            d = step(d)
        return d

    np.testing.assert_allclose(np.asarray(roll(x0)),
                               np.asarray(composed(x0)), rtol=1e-6,
                               atol=1e-6)
    g_roll = jax.grad(lambda d: jnp.sum(roll(d) * wb))(x0)
    g_comp = jax.grad(lambda d: jnp.sum(composed(d) * wb))(x0)
    np.testing.assert_allclose(np.asarray(g_roll),
                               np.asarray(g_comp), rtol=2e-5,
                               atol=2e-5)


def test_differentiable_rollout_distributed_system():
    """differentiable_rollout on the distributed coupled SYSTEM:
    4 steps / 2-step remat segments over a (2, 2, 1) mesh — gradient
    wrt both fields matches 4 dense AD steps globally."""
    import jax
    import jax.numpy as jnp

    from brickjax.api import Problem
    from brickjax.core import from_bricks

    mesh = (2, 2, 1)
    dims = (8, 8, 32)
    sds = _gray_scott_defs()
    p = Problem(dims=dims, mesh=mesh, stencil=sds, field=("u", "v"),
                params={}, bdims=(4, 4, dims[2]), backend="pencil",
                st_iter=1)
    roll = p.differentiable_rollout(4, checkpoint_every=2)
    gshape = tuple(m * d for m, d in zip(mesh, dims))
    rng = np.random.default_rng(37)
    u0 = rng.random(gshape, np.float32)
    v0 = rng.random(gshape, np.float32)
    w = rng.random(gshape, np.float32)
    p.init(array={"u": u0, "v": v0})
    wp = Problem(dims=dims, mesh=mesh, stencil=sds, field=("u", "v"),
                 params={}, bdims=(4, 4, dims[2]), backend="pencil",
                 st_iter=1)
    wp.init(array={"u": w, "v": w})
    wb = jnp.where(p.owned_mask(), wp._dats[0], 0.0)

    gu, gv = jax.grad(
        lambda uv: jnp.sum(roll(*uv)[0] * wb))((p._dats[0],
                                                p._dats[1]))

    def dense_loss(uv):
        named = {"u": uv[0], "v": uv[1]}
        for _ in range(4):
            ou = _dense_multi(sds[0], named, {})
            ov = _dense_multi(sds[1], named, {})
            named = {"u": ou, "v": ov}
        return jnp.sum(named["u"] * jnp.asarray(w))

    du, dv = jax.grad(dense_loss)((jnp.asarray(u0), jnp.asarray(v0)))
    nb = p.dec.nbricks
    for got, want in ((gu, np.asarray(du)), (gv, np.asarray(dv))):
        gn = np.asarray(got)
        for r, cpos in enumerate(np.ndindex(*mesh)):
            own = from_bricks(gn[r * nb:(r + 1) * nb].reshape(nb, -1),
                              p.dec.interior_grid(), p.bdims)
            sl = tuple(slice(cpos[a] * dims[a], (cpos[a] + 1) * dims[a])
                       for a in range(3))
            np.testing.assert_allclose(own, want[sl], rtol=1e-4,
                                       atol=1e-4)


def test_differentiable_rollout_validates_args():
    from brickjax.api import Problem

    p = Problem(dims=(16, 16, 32), stencil="mpi7pt",
                bdims=(4, 4, 32), backend="pencil", st_iter=1)
    with pytest.raises(ValueError, match="n >= 1"):
        p.differentiable_rollout(0)
    with pytest.raises(ValueError, match="checkpoint_every"):
        p.differentiable_rollout(3, checkpoint_every=4)


# ---------------------------------------------------------------------------
# exact If/max adjoints (round 5): the symbolic differentiator replaces the
# dense oracle — cond's pullback is a multi-input pencil stencil whose gates
# recompute from the residual input views (ref: stencils/cond.py)
# ---------------------------------------------------------------------------

_COND_PARAMS = {"coeff": [0.1, 0.2, 0.05, 0.15, 0.12, 0.08, 0.3]}


def test_piecewise_adjoint_matches_dense_ad():
    """cond (max + If): the symbolic-diff adjoint stencil, evaluated
    densely on the torus, equals jax.grad of the dense forward."""
    import jax
    import jax.numpy as jnp

    from brickjax.codegen.autodiff import polynomial_adjoint_stencils

    sd = stencil_by_name("cond")[0]
    adjs, ct = polynomial_adjoint_stencils(sd)
    assert set(adjs) == {"bIn"}
    # the gates read the ORIGINAL input, so the adjoint is multi-input
    assert set(adjs["bIn"].inputs) == {ct, "bIn"}

    rng = np.random.default_rng(3)
    N = 12
    # shift away from 0 so the max(x, 0) gate has both branches active
    # and no ties
    u0 = rng.random((N, N, N), np.float32) - 0.45
    w = rng.random((N, N, N), np.float32)

    def dense_loss(v):
        return jnp.sum(_dense_multi(sd, {"bIn": v}, _COND_PARAMS)
                       * jnp.asarray(w))

    want = jax.grad(dense_loss)(jnp.asarray(u0))
    got = _dense_multi(adjs["bIn"], {ct: jnp.asarray(w),
                                     "bIn": jnp.asarray(u0)},
                       _COND_PARAMS)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_piecewise_adjoint_abs_sqrt_exp():
    """Smooth opaque calls + If: d sqrt, d exp, d abs, and grid-valued
    divisors (quotient rule) all differentiate exactly."""
    import jax
    import jax.numpy as jnp

    from brickjax.codegen.autodiff import polynomial_adjoint_stencils
    from brickjax.st import Func, If

    i, j, k = Index(0), Index(1), Index(2)
    g, o = Grid("u", 3), Grid("out", 3)
    sqrt, ex, ab = Func("sqrt", 1), Func("exp", 1), Func("abs", 1)
    o(i, j, k).assign(
        sqrt(g(i, j, k) + 2.0) + ConstRef("a") * ex(-g(i + 1, j, k))
        + ab(g(i, j - 1, k)) + g(i, j, k + 1) / (g(i, j, k) + 3.0))
    sd = load_stencil_module({"STENCIL": [o]})[0]
    adjs, ct = polynomial_adjoint_stencils(sd)
    params = {"a": 0.6}

    rng = np.random.default_rng(5)
    N = 10
    u0 = rng.random((N, N, N), np.float32) - 0.4
    w = rng.random((N, N, N), np.float32)

    def dense_loss(v):
        return jnp.sum(_dense_multi(sd, {"u": v}, params)
                       * jnp.asarray(w))

    want = jax.grad(dense_loss)(jnp.asarray(u0))
    got = _dense_multi(adjs["u"], {ct: jnp.asarray(w),
                                   "u": jnp.asarray(u0)}, params)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_cond_pencil_grads_match_dense():
    """differentiable_poly_sweep on cond (If/max): jax.grad through the
    sweep forward + adjoint pencil sweep matches dense AD."""
    import jax
    import jax.numpy as jnp

    from brickjax.codegen.autodiff import differentiable_poly_sweep
    from brickjax.comm import BrickDecomp, skinlist_by_name
    from brickjax.core import to_bricks

    N = 16
    BD = (4, 4, N)
    dec = BrickDecomp(dims=(N, N, N), ghost_depth=(4, 4, 0),
                      bdims=BD).initialize(skinlist_by_name("good", 3))
    sd = stencil_by_name("cond")[0]
    step = differentiable_poly_sweep(
        sd, dec.periodic_grid((0, 1, 2)), BD, dec.nbricks,
        _COND_PARAMS)
    assert step.fields == ("bIn",)

    def stage(a):
        idx = [np.arange(-g, N + g) % N for g in (4, 4, 0)]
        dat = np.zeros((dec.nbricks, int(np.prod(BD))), np.float32)
        to_bricks(a[np.ix_(*idx)], dec.grid, BD, dat=dat)
        return jnp.asarray(dat.reshape((dec.nbricks,) + BD))

    rng = np.random.default_rng(11)
    u0 = rng.random((N, N, N), np.float32) - 0.45
    w = rng.random((N, N, N), np.float32)
    wb = np.array(stage(w))
    wb[dec.sep_pos[1]:] = 0.0
    wb[0] = 0.0
    wb = jnp.asarray(wb)

    gu = jax.grad(lambda v: jnp.sum(step(v) * wb))(stage(u0))

    want = jax.grad(lambda v: jnp.sum(
        _dense_multi(sd, {"bIn": v}, _COND_PARAMS)
        * jnp.asarray(w)))(jnp.asarray(u0))
    np.testing.assert_allclose(_unstage(dec, BD, gu), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_problem_cond_differentiable_step():
    """Problem.differentiable_step on cond now takes the EXACT pullback
    (no oracle): gradient matches dense AD through one step."""
    import jax
    import jax.numpy as jnp

    from brickjax.api import Problem
    from brickjax.core import from_bricks

    N = 16
    dims = (N, N, N)

    def make():
        return Problem(dims=dims, stencil="cond", bdims=(4, 4, N),
                       backend="pencil", st_iter=1,
                       params=_COND_PARAMS)

    p = make()
    fn = p.differentiable_step()
    rng = np.random.default_rng(13)
    u0 = rng.random(dims, np.float32) - 0.45
    w = rng.random(dims, np.float32)
    p.init(array=u0)
    xb = p._dats[0]
    wp = make()
    wp.init(array=w)
    wb = jnp.where(p.owned_mask(), wp._dats[0], 0.0)

    gb = jax.grad(lambda d: jnp.sum(fn(d) * wb))(xb)

    want = np.asarray(jax.grad(lambda v: jnp.sum(
        _dense_multi(stencil_by_name("cond")[0], {"bIn": v},
                     _COND_PARAMS) * jnp.asarray(w)))(jnp.asarray(u0)))
    own = from_bricks(np.asarray(gb).reshape(p.dec.nbricks, -1),
                      p.dec.interior_grid(), p.bdims)
    np.testing.assert_allclose(own, want, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# fused differentiable poly/system steps (round 5): the fused sweep forward
# keeps its 1/F HBM traffic; the pullback recomputes F unfused exact steps
# (_fuse_by_recompute) — grads must match the composed unfused chain exactly
# ---------------------------------------------------------------------------


def _stage_cube(dec, BD, N, a):
    import jax.numpy as jnp

    from brickjax.core import to_bricks

    idx = [np.arange(-g, N + g) % N for g in (4, 4, 0)]
    dat = np.zeros((dec.nbricks, int(np.prod(BD))), np.float32)
    to_bricks(a[np.ix_(*idx)], dec.grid, BD, dat=dat)
    return jnp.asarray(dat.reshape((dec.nbricks,) + BD))


def test_fused_poly_sweep_grads_match_composed():
    """differentiable_poly_sweep(fuse=2) on a var-coeff stencil: the
    fused forward and its recompute pullback are BIT-EXACT to two
    composed unfused differentiable steps."""
    import jax
    import jax.numpy as jnp

    from brickjax.codegen.autodiff import differentiable_poly_sweep
    from brickjax.comm import BrickDecomp, skinlist_by_name

    N = 16
    BD = (4, 4, N)
    dec = BrickDecomp(dims=(N, N, N), ghost_depth=(4, 4, 0),
                      bdims=BD).initialize(skinlist_by_name("good", 3))
    tg = dec.periodic_grid((0, 1, 2))
    sd = _varcoeff_stencil()
    f1 = differentiable_poly_sweep(sd, tg, BD, dec.nbricks, _VC_PARAMS)
    f2 = differentiable_poly_sweep(sd, tg, BD, dec.nbricks, _VC_PARAMS, fuse=2)

    rng = np.random.default_rng(7)
    u0 = _stage_cube(dec, BD, N, rng.random((N, N, N), np.float32))
    c0 = _stage_cube(dec, BD, N,
                     1.0 + 0.3 * rng.random((N, N, N), np.float32))
    w = np.array(_stage_cube(dec, BD, N,
                             rng.random((N, N, N), np.float32)))
    w[dec.sep_pos[1]:] = 0.0
    w[0] = 0.0
    w = jnp.asarray(w)

    own = np.unique(np.asarray(tg)[1:-1, 1:-1, 0])
    o1, o2 = f1(f1(u0, c0), c0), f2(u0, c0)
    assert float(jnp.max(jnp.abs(o1[own] - o2[own]))) == 0.0

    g1 = jax.grad(lambda uv: jnp.sum(f1(f1(uv[0], uv[1]), uv[1])
                                     * w))((u0, c0))
    g2 = jax.grad(lambda uv: jnp.sum(f2(uv[0], uv[1]) * w))((u0, c0))
    for a, b in zip(g1, g2):
        assert float(jnp.max(jnp.abs(a - b))) == 0.0


def test_fused_system_sweep_grads_match_composed():
    """differentiable_poly_system_sweep(fuse=2) on a coupled system:
    fused forward + recompute pullback vs two composed unfused steps."""
    import jax
    import jax.numpy as jnp

    from brickjax.codegen.autodiff import (
        differentiable_poly_system_sweep)
    from brickjax.comm import BrickDecomp, skinlist_by_name

    i, j, k = Index(0), Index(1), Index(2)
    u, v = Grid("u", 3), Grid("v", 3)
    ou, ov = Grid("ou", 3), Grid("ov", 3)
    lap_u = (u(i + 1, j, k) + u(i - 1, j, k) + u(i, j + 1, k)
             + u(i, j - 1, k) + u(i, j, k + 1) + u(i, j, k - 1)
             - 6.0 * u(i, j, k))
    ou(i, j, k).assign(u(i, j, k) + ConstRef("a") * lap_u
                       - ConstRef("b") * u(i, j, k) * v(i, j, k))
    ov(i, j, k).assign(v(i, j, k)
                       + ConstRef("b") * u(i, j, k) * v(i, j, k))
    sds = load_stencil_module({"STENCIL": [ou, ov]})
    params = {"a": 0.08, "b": 0.05}

    N = 16
    BD = (4, 4, N)
    dec = BrickDecomp(dims=(N, N, N), ghost_depth=(4, 4, 0),
                      bdims=BD).initialize(skinlist_by_name("good", 3))
    tg = dec.periodic_grid((0, 1, 2))
    f1 = differentiable_poly_system_sweep(
        sds, tg, BD, dec.nbricks, ("u", "v"), params)
    f2 = differentiable_poly_system_sweep(
        sds, tg, BD, dec.nbricks, ("u", "v"), params,
        fuse=2)

    rng = np.random.default_rng(9)
    u0 = _stage_cube(dec, BD, N,
                     0.5 * rng.random((N, N, N), np.float32))
    v0 = _stage_cube(dec, BD, N,
                     0.5 * rng.random((N, N, N), np.float32))
    w = np.array(_stage_cube(dec, BD, N,
                             rng.random((N, N, N), np.float32)))
    w[dec.sep_pos[1]:] = 0.0
    w[0] = 0.0
    w = jnp.asarray(w)

    def two_unfused(uv):
        a, b = f1(*uv)
        return f1(a, b)

    def loss1(uv):
        a, b = two_unfused(uv)
        return jnp.sum(a * w) + jnp.sum(b * w)

    def loss2(uv):
        a, b = f2(*uv)
        return jnp.sum(a * w) + jnp.sum(b * w)

    own = np.unique(np.asarray(tg)[1:-1, 1:-1, 0])
    (a1, b1), (a2, b2) = two_unfused((u0, v0)), f2(u0, v0)
    assert float(jnp.max(jnp.abs(a1[own] - a2[own]))) == 0.0
    assert float(jnp.max(jnp.abs(b1[own] - b2[own]))) == 0.0

    g1 = jax.grad(loss1)((u0, v0))
    g2 = jax.grad(loss2)((u0, v0))
    for a, b in zip(g1, g2):
        assert float(jnp.max(jnp.abs(a - b))) == 0.0


def test_problem_fused_differentiable_step_cond():
    """Problem.differentiable_step on cond with st_iter=2 fused
    (generic path): the FUSED differentiable step's gradient matches
    dense AD through two composed steps."""
    import jax
    import jax.numpy as jnp

    from brickjax.api import Problem
    from brickjax.core import from_bricks

    N = 16
    dims = (N, N, N)

    def make():
        return Problem(dims=dims, stencil="cond", bdims=(4, 4, N),
                       backend="pencil", st_iter=2,
                       params=_COND_PARAMS, schedule=dict(fuse=2))

    p = make()
    assert p.fuse == 2
    fn = p.differentiable_step()
    rng = np.random.default_rng(17)
    u0 = rng.random(dims, np.float32) - 0.45
    w = rng.random(dims, np.float32)
    p.init(array=u0)
    xb = p._dats[0]
    wp = make()
    wp.init(array=w)
    wb = jnp.where(p.owned_mask(), wp._dats[0], 0.0)

    gb = jax.grad(lambda d: jnp.sum(fn(d) * wb))(xb)

    def dense2(v):
        for _ in range(2):
            v = _dense_multi(stencil_by_name("cond")[0], {"bIn": v},
                             _COND_PARAMS)
        return jnp.sum(v * jnp.asarray(w))

    want = np.asarray(jax.grad(dense2)(jnp.asarray(u0)))
    own = from_bricks(np.asarray(gb).reshape(p.dec.nbricks, -1),
                      p.dec.interior_grid(), p.bdims)
    np.testing.assert_allclose(own, want, rtol=2e-5, atol=2e-5)


def test_problem_cond_diff_step_distributed():
    """DISTRIBUTED cond (If/max): the piecewise exact pullback runs on
    a (2, 2, 1) mesh — gate masks recompute from exchanged residual
    views, ghost cotangent rides the exchange transpose — vs global
    dense AD.  (Round 4 rejected this case outright; round 5's
    symbolic differentiator serves it on the same poly path.)"""
    import jax
    import jax.numpy as jnp

    from brickjax.api import Problem
    from brickjax.core import from_bricks

    mesh = (2, 2, 1)
    dims = (8, 8, 32)
    sd = stencil_by_name("cond")[0]

    def make():
        return Problem(dims=dims, mesh=mesh, stencil="cond",
                       params=_COND_PARAMS, bdims=(4, 4, dims[2]),
                       backend="pencil", st_iter=1)

    p = make()
    fn = p.differentiable_step()
    wmask = p.owned_mask()

    gshape = tuple(m * d for m, d in zip(mesh, dims))
    rng = np.random.default_rng(23)
    u0 = rng.random(gshape, np.float32) - 0.45
    w = rng.random(gshape, np.float32)
    p.init(array=u0)
    wp = make()
    wp.init(array=w)
    wb = jnp.where(wmask, wp._dats[0], 0.0)

    gu = jax.grad(lambda d: jnp.sum(fn(d) * wb))(p._dats[0])

    want = np.asarray(jax.grad(lambda v: jnp.sum(
        _dense_multi(sd, {"bIn": v}, _COND_PARAMS)
        * jnp.asarray(w)))(jnp.asarray(u0)))
    nb = p.dec.nbricks
    gn = np.asarray(gu)
    for r, cpos in enumerate(np.ndindex(*mesh)):
        own = from_bricks(gn[r * nb:(r + 1) * nb].reshape(nb, -1),
                          p.dec.interior_grid(), p.bdims)
        sl = tuple(slice(cpos[a] * dims[a], (cpos[a] + 1) * dims[a])
                   for a in range(3))
        np.testing.assert_allclose(own, want[sl], rtol=2e-5,
                                   atol=2e-5)
