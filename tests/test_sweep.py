"""The XLA pencil sweep (codegen.sweep) against the dense periodic
twin: the stencil corpus at fuse 1 and 2, plus the sweep's range,
batch, in-place and system semantics."""

import numpy as np
import pytest

import jax.numpy as jnp

from brickjax.codegen import dense_apply
from brickjax.codegen.sweep import pencil_sweep
from brickjax.comm import BrickDecomp, skin3d_good
from brickjax.core import compare_arrays, from_bricks, random_array
from brickjax.core import to_bricks
from brickjax.stencils import bench_params, stencil_by_name

PARAMS = bench_params()
CORPUS3D = ["s7pt", "s27pt", "cond", "mpi7pt", "mpi13pt", "mpi25pt",
            "mpi125pt"]


def _dense_steps(sd, g, n):
    lo, hi = sd.radius()
    for _ in range(n):
        gp = np.pad(g, list(zip(lo, hi)), mode="wrap")
        g = dense_apply(sd, {next(iter(sd.inputs)): gp}, PARAMS, xp=np)
    return g


def _periodic(dims, bd, seed):
    dec = BrickDecomp(dims=dims, ghost_depth=bd[:-1] + (0,),
                      bdims=bd).initialize(skin3d_good)
    g = random_array(dims, np.float32, seed)
    ext = np.pad(g, [(b, b) for b in bd[:-1]] + [(0, 0)], mode="wrap")
    dat = np.zeros((dec.nbricks, int(np.prod(bd))), np.float32)
    to_bricks(ext, dec.grid, bd, dat=dat)
    return dec, g, jnp.asarray(dat.reshape((-1,) + bd))


@pytest.mark.parametrize("fuse", [1, 2])
@pytest.mark.parametrize("name", CORPUS3D)
def test_corpus_matches_dense(name, fuse):
    """Every corpus stencil, one window of ``fuse`` levels on a
    table-periodic grid, equals ``fuse`` dense periodic steps."""
    sd = stencil_by_name(name)[0]
    rad = max(max(sd.radius()[0]), max(sd.radius()[1]))
    b = 8 if fuse * rad <= 8 else 16
    bd = (b, b, 32)
    dec, g, view = _periodic((2 * b, 2 * b, 32), bd, 3)
    fn = pencil_sweep(sd, dec.periodic_grid((0, 1, 2)), bd, dec.nbricks,
                      PARAMS, fuse=fuse)
    got = from_bricks(np.asarray(fn(view)).reshape(dec.nbricks, -1),
                      dec.interior_grid(), bd)
    assert compare_arrays(got, _dense_steps(sd, g, fuse), 1e-4)


def test_batch_equals_per_subdomain_sweeps():
    """batch=2 sweeps two stacked subdomains through one table, each as
    if swept alone."""
    sd = stencil_by_name("s7pt")[0]
    bd = (4, 4, 16)
    dec, _g, v0 = _periodic((8, 8, 16), bd, 5)
    _dec, _g, v1 = _periodic((8, 8, 16), bd, 6)
    tg = dec.periodic_grid((0, 1, 2))
    nb = dec.nbricks
    one = pencil_sweep(sd, tg, bd, nb, PARAMS)
    two = pencil_sweep(sd, tg, bd, 2 * nb, PARAMS, batch=2,
                       batch_stride=nb)
    out = np.asarray(two(jnp.concatenate([v0, v1])))
    w = np.unique(tg[1:-1, 1:-1])
    np.testing.assert_array_equal(out[w], np.asarray(one(v0))[w])
    np.testing.assert_array_equal(out[nb + w], np.asarray(one(v1))[w])
    with pytest.raises(ValueError, match="batch_stride"):
        pencil_sweep(sd, tg, bd, nb, PARAMS, batch=2)


def test_inplace_partial_sweeps_compose():
    """Two in-place half-range sweeps into one output equal the
    full-range sweep; bricks outside a range keep ``out_prev``."""
    sd = stencil_by_name("mpi13pt")[0]
    bd = (4, 4, 16)
    dec, _g, view = _periodic((16, 8, 16), bd, 7)
    tg = dec.periodic_grid((0, 1, 2))
    GK = tg.shape[0]
    nb = dec.nbricks
    full = np.asarray(pencil_sweep(sd, tg, bd, nb, PARAMS)(view))
    mid = GK // 2
    lo = pencil_sweep(sd, tg, bd, nb, PARAMS, k_range=(1, mid),
                      inplace=True)
    hi = pencil_sweep(sd, tg, bd, nb, PARAMS, k_range=(mid, GK - 1),
                      inplace=True)
    prev = jnp.zeros_like(view)
    out = np.asarray(hi(view, lo(view, prev)))
    w = np.unique(tg[1:-1, 1:-1])
    np.testing.assert_array_equal(out[w], full[w])
    untouched = np.setdiff1d(np.arange(nb), w)
    assert not out[untouched].any()


def test_system_jacobi_reads_pre_step_fields():
    """A two-output system updates both fields from the PRE-step state
    (Jacobi), equal to the dense twin of each output."""
    from brickjax.st import ConstRef, Grid, Index
    from brickjax.st.loader import load_stencil_module

    u, v, ou, ov = (Grid(n, 3) for n in ("u", "v", "ou", "ov"))
    i, j, k = Index(0), Index(1), Index(2)
    ou(i, j, k).assign(u(i, j, k) + ConstRef("c") * v(i, j + 1, k))
    ov(i, j, k).assign(v(i, j, k) - ConstRef("c") * u(i - 1, j, k - 1))
    sds = load_stencil_module({"STENCIL": [ou, ov]})
    prm = {"c": 0.3}
    bd = (4, 4, 16)
    dec, gu, vu = _periodic((8, 8, 16), bd, 8)
    _d, gv, vv = _periodic((8, 8, 16), bd, 9)
    fn = pencil_sweep(sds, dec.periodic_grid((0, 1, 2)), bd, dec.nbricks,
                      prm, evolve=("u", "v"))
    assert fn.fields == ("u", "v") and fn.evolve == ("u", "v")
    outs = fn(vu, vv)
    for sd, o in zip(sds, outs):
        pad = list(zip(*sd.radius()))
        want = dense_apply(sd, {"u": np.pad(gu, pad, mode="wrap"),
                                "v": np.pad(gv, pad, mode="wrap")}, prm,
                           xp=np)
        got = from_bricks(np.asarray(o).reshape(dec.nbricks, -1),
                          dec.interior_grid(), bd)
        assert compare_arrays(got, want, 1e-5)


def test_argument_guards():
    sd = stencil_by_name("s7pt")[0]
    bd = (4, 4, 16)
    dec, _g, _v = _periodic((8, 8, 16), bd, 1)
    tg = dec.periodic_grid((0, 1, 2))
    with pytest.raises(TypeError, match="w_range"):
        pencil_sweep(sd, tg, bd, dec.nbricks, PARAMS, w_range=(1, 2))
    with pytest.raises(ValueError, match="i-bricked"):
        pencil_sweep(sd, tg, bd, dec.nbricks, PARAMS, i_range=(0, 2))
    with pytest.raises(ValueError, match="outside grid"):
        pencil_sweep(sd, tg, bd, dec.nbricks, PARAMS, k_range=(0, 99))
    with pytest.raises(ValueError, match="k-radius"):
        pencil_sweep(sd, tg, bd, dec.nbricks, PARAMS, fuse=5)
