"""Generic-path (nonlinear) scheduling: memoized evaluation, additive
coefficient grouping and fused-generic correctness — the analog of the
reference's Reduction grouping + live-buffer scheduling for arbitrary
stencils (ref: codegen/st/codegen/base.py:108-239, dag_opt.py:159-290).
"""

import numpy as np

import jax.numpy as jnp

from brickjax.codegen import dense_apply
from brickjax.codegen.ir import additive_groups
from brickjax.st import ConstRef, Func, Grid, Index, If
from brickjax.st.loader import load_stencil_module
from brickjax.stencils import DEFAULT_PARAMS, stencil_by_name


def _sym_nonlinear():
    """Symmetric-coefficient nonlinear stencil: Σ c_g * max(tap, 0)
    with REPEATED coefficients — the grouping target."""
    i, j, k = Index(0), Index(1), Index(2)
    g, o = Grid("in", 3), Grid("out", 3)
    mx = Func("max", 2)
    zero = ConstRef("0.0")
    a, b = ConstRef("a"), ConstRef("b")
    expr = a * mx(g(i, j, k), zero)
    for d in range(3):
        for s in (1, -1):
            args = [i, j, k]
            args[d] = args[d] + s
            expr = expr + b * mx(g(*args), zero)
    o(i, j, k).assign(expr)
    return load_stencil_module({"STENCIL": [o]})[0]


def test_additive_groups_merges_symmetric_coeffs():
    sd = _sym_nonlinear()
    g = additive_groups(sd.rhs)
    assert g is not None
    sizes = sorted(len(ts) for _c, ts in g)
    assert sizes == [1, 6]        # a x 1, b x 6


def test_additive_groups_none_for_singletons():
    assert additive_groups(stencil_by_name("cond")[0].rhs) is None


def test_grouped_generic_run_matches_plain_eval():
    """dense_apply (which routes through _run's grouped generic path)
    equals a direct numpy evaluation of the same stencil."""
    sd = _sym_nonlinear()
    prm = {"a": 0.7, "b": -0.3}
    rng = np.random.default_rng(13)
    x = rng.standard_normal((10, 10, 10)).astype(np.float64)
    got = dense_apply(sd, {"in": np.pad(x, 1, mode="wrap")}, prm, xp=np)
    xp_ = np.pad(x, 1, mode="wrap")
    want = prm["a"] * np.maximum(xp_[1:-1, 1:-1, 1:-1], 0.0)
    for ax in range(3):
        for s in (1, -1):
            sl = [slice(1, -1)] * 3
            sl[ax] = slice(1 + s, xp_.shape[ax] - 1 + s)
            want = want + prm["b"] * np.maximum(xp_[tuple(sl)], 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_problem_autofuses_nonlinear():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from brickjax.api import Problem

    p = Problem(dims=(16, 16, 32), stencil="cond", bdims=(4, 4, 32),
                backend="pencil", st_iter=4, schedule=dict(fuse=4))
    assert p.fuse == 4
    assert p.describe()["fuse"] == 4


def test_fused_generic_cond_matches_composed():
    """Fused generic (If/max) sweep == two composed sweeps, bit-exact
    (the correctness basis of fusing nonlinear stencils)."""
    from brickjax.codegen.sweep import pencil_sweep
    from brickjax.comm import BrickDecomp, skin3d_good

    params = dict(DEFAULT_PARAMS)
    params["coeff"] = [0.03 * (c + 1) for c in range(27)]
    bd = (4, 4, 16)
    dec = BrickDecomp(dims=(16, 16, 16), ghost_depth=(4, 4, 0),
                      bdims=bd).initialize(skin3d_good)
    tg = dec.periodic_grid((0, 1, 2))
    sd = stencil_by_name("cond")[0]
    f2 = pencil_sweep(sd, tg, bd, dec.nbricks, params, fuse=2)
    f1 = pencil_sweep(sd, tg, bd, dec.nbricks, params)
    dat = np.random.default_rng(3).standard_normal(
        (dec.nbricks,) + bd).astype(np.float32)
    a = np.asarray(f2(jnp.asarray(dat)))
    b = np.asarray(f1(f1(jnp.asarray(dat))))
    w = np.unique(np.asarray(tg)[1:-1, 1:-1])
    np.testing.assert_array_equal(a[w], b[w])
