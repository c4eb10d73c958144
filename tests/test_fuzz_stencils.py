"""Randomized stencil fuzz: the pencil emitter vs the dense twin.

The corpus stencils are all symmetric stars/boxes; the factorization
(fold_linear: k-profiles -> j-shifts -> lane rolls, with W/V sharing by
structural equality) has branches only asymmetric or degenerate
stencils reach — asymmetric radii, repeated taps, zero/negative and
coincidentally-equal coefficients, single-axis stencils.  This fuzz
generates seeded random linear stencils across those shapes and checks
the pencil kernel against the dense twin (the reference's
array-vs-brick self-validation idea, stencils/3axis.cpp:78-86, applied
property-style).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from brickjax.codegen import dense_apply
from brickjax.codegen.sweep import pencil_sweep
from brickjax.core import (
    compare_arrays,
    from_bricks,
    init_grid,
    random_array,
    to_bricks,
)
from brickjax.st import FloatLiteral, Grid, Index
from brickjax.st.loader import load_stencil_module

BD = (4, 8, 16)
G = (5, 5, 1)


def _random_stencil(rng):
    """Random linear stencil with asymmetric per-axis radii <= (2,2,2)
    (brick-fitting), possibly repeated taps and degenerate coeffs."""
    inp, out = Grid("in", 3), Grid("out", 3)
    i, j, k = Index(0), Index(1), Index(2)
    ntap = int(rng.integers(1, 12))
    lo = [int(rng.integers(0, 3)) for _ in range(3)]   # numpy order k,j,i
    hi = [int(rng.integers(0, 3)) for _ in range(3)]
    calc = None
    for _ in range(ntap):
        dk = int(rng.integers(-lo[0], hi[0] + 1))
        dj = int(rng.integers(-lo[1], hi[1] + 1))
        di = int(rng.integers(-lo[2], hi[2] + 1))
        c = float(rng.choice(
            [0.0, 1.0, -1.0, 0.5, round(float(rng.normal()), 3)]))
        t = FloatLiteral(c) * inp(i + di, j + dj, k + dk)
        calc = t if calc is None else calc + t
    out(i, j, k).assign(calc)
    return load_stencil_module({"STENCIL": [out]})[0]


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_pencil_matches_dense(seed):
    rng = np.random.default_rng(1000 + seed)
    sd = _random_stencil(rng)
    grid, info = init_grid(G)
    KI, JI = G[0] - 2, G[1] - 2
    core = random_array((KI * BD[0], JI * BD[1], BD[2]), np.float32,
                        seed)
    ext = np.pad(core, ((BD[0], BD[0]), (BD[1], BD[1]), (0, 0)),
                 mode="wrap")
    view = jnp.asarray(to_bricks(ext, grid, BD).reshape((-1,) + BD))
    fn = pencil_sweep(sd, grid, BD, info.nbricks, {})
    out = np.asarray(fn(view))
    lo, hi = sd.radius()
    corep = np.pad(core, [(l, h) for l, h in zip(lo, hi)], mode="wrap")
    want = dense_apply(sd, {"in": corep}, {}, xp=np)
    got = from_bricks(out, grid[1:-1, 1:-1], BD)
    assert compare_arrays(got, want, 1e-4), f"seed {seed}"


# --- 4-D fuzz: the 4-D pencil emitter incl. temporal fusion ----------

BD4 = (2, 4, 4, 16)
G4 = (4, 4, 4, 1)


def _random_stencil_4d(rng):
    """Random linear 4-D stencil, per-axis radii <= (1, 2, 2, 2) in
    numpy order (w, k, j, i) — w capped by BD4[0] and the F=2 fused
    contamination bound."""
    inp, out = Grid("in", 4), Grid("out", 4)
    i, j, k, w = Index(0), Index(1), Index(2), Index(3)
    ntap = int(rng.integers(1, 10))
    lo = [int(rng.integers(0, 2))] + [int(rng.integers(0, 3))
                                      for _ in range(3)]
    hi = [int(rng.integers(0, 2))] + [int(rng.integers(0, 3))
                                      for _ in range(3)]
    calc = None
    for _ in range(ntap):
        dw = int(rng.integers(-lo[0], hi[0] + 1))
        dk = int(rng.integers(-lo[1], hi[1] + 1))
        dj = int(rng.integers(-lo[2], hi[2] + 1))
        di = int(rng.integers(-lo[3], hi[3] + 1))
        c = float(rng.choice(
            [0.0, 1.0, -1.0, 0.5, round(float(rng.normal()), 3)]))
        t = FloatLiteral(c) * inp(i + di, j + dj, k + dk, w + dw)
        calc = t if calc is None else calc + t
    out(i, j, k, w).assign(calc)
    return load_stencil_module({"STENCIL": [out]})[0]


def _dense_steps_4d(sd, g, n):
    lo, hi = sd.radius()
    w = g
    for _ in range(n):
        wp = np.pad(w, [(l, h) for l, h in zip(lo, hi)], mode="wrap")
        w = dense_apply(sd, {"in": wp}, {}, xp=np)
    return w


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_pencil_4d_matches_dense(seed):
    """Random 4-D stencil: F=1 always, plus F=2 when the fused
    contamination bounds admit it (guards the w/j ring extensions)."""
    from brickjax.codegen.sweep import pencil_sweep

    rng = np.random.default_rng(4000 + seed)
    sd = _random_stencil_4d(rng)
    grid, info = init_grid(G4)
    core = random_array(
        tuple((g - 2) * b for g, b in zip(G4[:3], BD4[:3])) + (BD4[3],),
        np.float32, seed)
    ext = np.pad(core, [(b, b) for b in BD4[:3]] + [(0, 0)],
                 mode="wrap")
    view = jnp.asarray(to_bricks(ext, grid, BD4).reshape((-1,) + BD4))
    lo, hi = sd.radius()
    fuses = [1]
    if all(2 * l <= b and 2 * h <= b
           for l, h, b in zip(lo[:3], hi[:3], BD4[:3])):
        fuses.append(2)
    for F in fuses:
        fn = pencil_sweep(sd, grid, BD4, info.nbricks, {}, fuse=F)
        got = from_bricks(np.asarray(fn(view)),
                          grid[1:-1, 1:-1, 1:-1], BD4)
        want = _dense_steps_4d(sd, core, F)
        assert compare_arrays(got, want, 1e-4), f"seed {seed} F={F}"
