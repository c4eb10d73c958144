"""Geometric multigrid on the fast path: solve the periodic Poisson
problem -lap(u) = f with V(2,2)-cycles whose smoother and residual are
pencil sweeps (multi-input stencils: u evolving, f static).

Weighted-Jacobi smoothing and the residual are where the FLOPs are —
both run as brick sweeps; restriction (2^3 cell average)
and prolongation (trilinear) are cheap dense transfers between
levels.
The demo asserts the textbook result: V-cycles beat plain Jacobi by
orders of magnitude at EQUAL fine-level smoothing work.

    python examples/multigrid_poisson.py   # runs on whatever jax sees
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))   # repo root, for uninstalled checkouts

from brickjax.codegen.sweep import pencil_sweep
from brickjax.comm import BrickDecomp, skinlist_by_name
from brickjax.core import from_bricks, to_bricks
from brickjax.st import ConstRef, Grid, Index, load_stencil_module

i, j, k = Index(0), Index(1), Index(2)


def _defs():
    """smooth: u' = (1-w) u + (w/6)(sum_nb u + f)   (weighted Jacobi)
    resid:  r = f + sum_nb u - 6 u                 (f - A u)"""
    u, f = Grid("u", 3), Grid("f", 3)
    su, rr = Grid("su", 3), Grid("rr", 3)
    nb_taps = [(i + 1, j, k), (i - 1, j, k), (i, j + 1, k),
               (i, j - 1, k), (i, j, k + 1), (i, j, k - 1)]
    w6 = ConstRef("w6")          # w/6
    sm = ConstRef("wc") * u(i, j, k) + w6 * f(i, j, k)
    rs = f(i, j, k) + (-6.0) * u(i, j, k)
    for t in nb_taps:
        sm = sm + w6 * u(*t)
        rs = rs + 1.0 * u(*t)
    su(i, j, k).assign(sm)
    rr(i, j, k).assign(rs)
    return load_stencil_module({"STENCIL": [su]})[0], \
        load_stencil_module({"STENCIL": [rr]})[0]


class Level:
    """One grid level: brick decomp + smoother/residual sweeps +
    dense<->brick staging (all axes table-periodic).  Levels too coarse
    for a ghost brick ring (n < 8) run the DENSE twin instead — they
    are tiny and the FLOPs live on the fine levels anyway."""

    def __init__(self, n, smooth_sd, resid_sd, params):
        self.n = n
        self.params = params
        self.sds = {"smooth": smooth_sd, "resid": resid_sd}
        self.dense = n < 8
        if self.dense:
            self.smooth, self.resid = "smooth", "resid"
            return
        self.BD = (8, 8, n) if n >= 128 else (4, 4, n)
        self.dec = BrickDecomp(
            dims=(n, n, n), ghost_depth=(self.BD[0], self.BD[1], 0),
            bdims=self.BD).initialize(skinlist_by_name("good", 3))
        tg = self.dec.periodic_grid((0, 1, 2))
        self.smooth = pencil_sweep(
            smooth_sd, tg, self.BD, self.dec.nbricks, params,
            evolve=("u",))
        self.resid = pencil_sweep(
            resid_sd, tg, self.BD, self.dec.nbricks, params,
            evolve=("u",))

    def stage(self, a):
        import jax.numpy as jnp

        z = (self.BD[0], self.BD[1], 0)
        idx = [np.arange(-g, self.n + g) % self.n for g in z]
        dat = np.zeros((self.dec.nbricks, int(np.prod(self.BD))),
                       np.float32)
        to_bricks(np.ascontiguousarray(a[np.ix_(*idx)]), self.dec.grid,
                  self.BD, dat=dat)
        return jnp.asarray(dat.reshape((self.dec.nbricks,) + self.BD))

    def unstage(self, b):
        full = from_bricks(
            np.asarray(b).reshape(self.dec.nbricks, -1), self.dec.grid,
            self.BD)
        g0, g1 = self.BD[0], self.BD[1]
        return full[g0:g0 + self.n, g1:g1 + self.n, :]

    def apply(self, kern, u, f, times=1):
        if getattr(self, "dense", False):
            import jax.numpy as jnp

            from brickjax.codegen import dense_apply

            sd = self.sds[kern]
            uu = jnp.asarray(u)
            for _ in range(times):
                uu = dense_apply(
                    sd, {"u": jnp.pad(uu, 1, mode="wrap"),
                         "f": jnp.pad(jnp.asarray(f), 1, mode="wrap")},
                    self.params)
            return np.asarray(uu)
        staged = {"u": self.stage(u), "f": self.stage(f)}
        for _ in range(times):
            # views go in kern.fields order (not necessarily (u, f))
            staged["u"] = kern(*(staged[n] for n in kern.fields))
        return self.unstage(staged["u"])


def restrict(a):
    """2^3 cell average."""
    n = a.shape[0] // 2
    return a.reshape(n, 2, n, 2, n, 2).mean(axis=(1, 3, 5))


def prolong(a):
    """Trilinear, periodic, cell-centered: fine centers sit 1/4 cell
    off the coarse center, so each axis interleaves (3/4, 1/4) blends
    with the wrap neighbor."""
    for ax in range(3):
        lo = 0.75 * a + 0.25 * np.roll(a, 1, ax)     # even fine cell
        hi = 0.75 * a + 0.25 * np.roll(a, -1, ax)    # odd fine cell
        a = np.stack([lo, hi], axis=ax + 1)
        a = a.reshape(a.shape[:ax] + (-1,) + a.shape[ax + 2:])
    return a


def main():
    smooth_sd, resid_sd = _defs()
    w = 2.0 / 3.0
    params = {"w6": w / 6.0, "wc": 1.0 - w}

    n = int(os.environ.get("BRICK_EXAMPLE_N", "128"))
    levels = []
    m = n
    while m >= 8:
        levels.append(Level(m, smooth_sd, resid_sd, params))
        m //= 2

    rng = np.random.default_rng(0)
    f = rng.random((n, n, n), np.float32)
    f -= f.mean()                     # periodic solvability
    nu = 2                            # pre/post smoothing sweeps

    def vcycle(lvl, u, fl):
        L = levels[lvl]
        u = L.apply(L.smooth, u, fl, times=nu)
        if lvl + 1 < len(levels):
            r = L.apply(L.resid, u, fl)
            # every level reuses the UNIT-h stencil, so the coarse
            # equation A e = r picks up the (2h/h)^2 scaling here
            rc = 4.0 * restrict(r)
            ec = vcycle(lvl + 1, np.zeros_like(rc), rc)
            u = u + prolong(ec).astype(np.float32)
        else:
            u = L.apply(L.smooth, u, fl, times=20)
        return L.apply(L.smooth, u, fl, times=nu)

    def rnorm(u):
        L = levels[0]
        return float(np.abs(L.apply(L.resid, u, f)).max())

    u_mg = np.zeros((n, n, n), np.float32)
    r0 = rnorm(u_mg)
    cycles = int(os.environ.get("BRICK_EXAMPLE_STEPS", "6"))
    for c in range(cycles):
        u_mg = vcycle(0, u_mg, f)
        print(f"V-cycle {c + 1}: residual {rnorm(u_mg):.3e}")
    r_mg = rnorm(u_mg)

    # plain weighted Jacobi at EQUAL fine-level smoothing work
    u_j = np.zeros((n, n, n), np.float32)
    L0 = levels[0]
    u_j = L0.apply(L0.smooth, u_j, f, times=cycles * 3 * nu)
    r_j = rnorm(u_j)
    print(f"after {cycles} V(2,2)-cycles: residual {r_mg:.3e}  vs  "
          f"plain Jacobi (same fine sweeps): {r_j:.3e}  "
          f"(start {r0:.3e})")
    assert r_mg < 0.05 * r_j and r_mg < 1e-2 * r0
    print("OK")


if __name__ == "__main__":
    main()
