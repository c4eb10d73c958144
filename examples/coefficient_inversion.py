"""Inverse problem through the fast path (beyond the reference):
recover a spatially varying diffusion coefficient c(x) from observed
states, with the pencil sweep as the forward model.

``codegen.differentiable_poly_sweep`` registers the EXACT pullback for
variable-coefficient stencils — one adjoint PENCIL sweep per field,
sweep forward AND backward, O(1) activation memory — so plain
gradient descent fits c(x) with both directions at stencil speed
(round 4; the dense-twin oracle now serves only systems and If/max):

    y_obs = M(u0; c_true)   (flux-form variable-coefficient diffusion)
    minimize ||M(u0; c) - y_obs||^2 over the field c

    python examples/coefficient_inversion.py  # runs on whatever jax sees
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))   # repo root, for uninstalled checkouts

from brickjax.codegen import differentiable_poly_sweep
from brickjax.comm import BrickDecomp, skinlist_by_name
from brickjax.core import to_bricks
from brickjax.st import Grid, Index, load_stencil_module

i, j, k = Index(0), Index(1), Index(2)
u, c, o = Grid("u", 3), Grid("c", 3), Grid("out", 3)
flux = None
for args in ([i + 1, j, k], [i - 1, j, k], [i, j + 1, k],
             [i, j - 1, k], [i, j, k + 1], [i, j, k - 1]):
    f = (c(i, j, k) + c(*args)) * (u(*args) - u(i, j, k))
    flux = f if flux is None else flux + f
o(i, j, k).assign(u(i, j, k) + 0.04 * flux)
STENCIL = [o]


def main():
    import jax
    import jax.numpy as jnp

    sdef = load_stencil_module({"STENCIL": STENCIL})[0]

    # BRICK_EXAMPLE_N shrinks test runs
    n = int(os.environ.get("BRICK_EXAMPLE_N", "128"))
    BD = (8, 8, n) if n % 128 == 0 else (4, 4, n)
    dec = BrickDecomp(dims=(n, n, n), ghost_depth=(BD[0], BD[1], 0),
                      bdims=BD).initialize(skinlist_by_name("good", 3))
    step = differentiable_poly_sweep(
        sdef, dec.periodic_grid((0, 1, 2)), BD, dec.nbricks, {})

    def stage(a):
        idx = [np.arange(-z, n + z) % n for z in (BD[0], BD[1], 0)]
        dat = np.zeros((dec.nbricks, int(np.prod(BD))), np.float32)
        to_bricks(a[np.ix_(*idx)], dec.grid, BD, dat=dat)
        return jnp.asarray(dat.reshape((dec.nbricks,) + BD))

    rng = np.random.default_rng(0)
    x = np.linspace(0, 2 * np.pi, n, endpoint=False, dtype=np.float32)
    c_true = (1.0 + 0.4 * np.sin(x)[:, None, None]
              * np.cos(x)[None, :, None]
              * np.ones((n, n, n), np.float32)).astype(np.float32)
    # several observation experiments (distinct initial states) make
    # the coefficient identifiable
    u0s = [stage(rng.random((n, n, n), np.float32)) for _ in range(3)]
    cb_true = stage(c_true)
    wmask = jnp.asarray(dec.owned_mask().reshape((-1,) + (1,) * 3))

    args_of = {nme: idx for idx, nme in enumerate(step.fields)}

    def fwd(ub, cb):
        vs = [None, None]
        vs[args_of["u"]] = ub
        vs[args_of["c"]] = cb
        return step(*vs)

    y_obs = [fwd(u0, cb_true) for u0 in u0s]

    @jax.jit
    def loss_and_grad(cb):
        def f(cb_):
            tot = 0.0
            for u0, yo in zip(u0s, y_obs):
                r = jnp.where(wmask, fwd(u0, cb_) - yo, 0.0)
                tot = tot + 0.5 * jnp.sum(r * r)
            return tot
        return jax.value_and_grad(f)(cb)

    cb = stage(np.ones((n, n, n), np.float32))   # flat initial guess
    lr = 4.0
    steps = int(os.environ.get("BRICK_EXAMPLE_STEPS", "60"))
    l0 = None
    for it in range(steps):
        loss, grad = loss_and_grad(cb)
        cb = cb - lr * grad
        if l0 is None:
            l0 = float(loss)
        if it % max(1, steps // 5) == 0:
            err = float(jnp.max(jnp.abs(
                jnp.where(wmask, cb - cb_true, 0.0))))
            print(f"iter {it:3d}  loss {float(loss):.6f}  "
                  f"max|c-c_true| {err:.4f}")
    lN = float(loss_and_grad(cb)[0])
    err = float(jnp.max(jnp.abs(jnp.where(wmask, cb - cb_true, 0.0))))
    print(f"loss {l0:.4f} -> {lN:.6f}; max coefficient error {err:.4f}")
    assert lN < 0.02 * l0
    print("OK")


if __name__ == "__main__":
    main()
