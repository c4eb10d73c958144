"""Differentiable stencils (beyond the reference): recover an initial
condition by gradient descent THROUGH the pencil sweep.

The pencil sweep is a linear operator ``y = A x``; ``codegen.autodiff``
registers its exact reverse-mode rule (the adjoint stencil — same
coefficients, negated offsets — run as a second pencil sweep at
identical cost).  Here: observe ``y_obs = A^2 x_true``, start from
zero, and minimize ``||A^2 x - y_obs||^2`` with plain gradient descent
— the classic adjoint-method data assimilation loop, each iteration
two forward sweeps + two adjoint sweeps at stencil speed.

    python examples/adjoint_assimilation.py   # runs on whatever jax sees
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))   # repo root, for uninstalled checkouts

from brickjax.codegen.autodiff import differentiable_pencil_sweep
from brickjax.comm import BrickDecomp, skinlist_by_name
from brickjax.core import to_bricks
from brickjax.st import ConstRef, Grid, Index, load_stencil_module

i, j, k = Index(0), Index(1), Index(2)
g, o = Grid("in", 3), Grid("out", 3)
# an asymmetric advection-diffusion-flavored linear stencil: the
# adjoint differs from the forward, so this exercises the real
# transpose (a symmetric stencil would hide offset-sign bugs)
d, u = ConstRef("d"), ConstRef("u")
_expr = 0.55 * g(i, j, k)
for _t in (g(i + 1, j, k), g(i - 1, j, k), g(i, j + 1, k),
           g(i, j - 1, k), g(i, j, k + 1), g(i, j, k - 1)):
    _expr = _expr + d * _t   # one coeff per tap: the IR's linear form
o(i, j, k).assign(_expr + u * g(i + 1, j, k) - u * g(i, j, k - 1))
STENCIL = [o]


def main():
    import jax
    import jax.numpy as jnp

    sdef = load_stencil_module({"STENCIL": STENCIL})[0]
    params = {"d": 0.07, "u": 0.11}

    # BRICK_EXAMPLE_N shrinks test runs
    n = int(os.environ.get("BRICK_EXAMPLE_N", "128"))
    BD = (8, 8, n) if n % 128 == 0 else (4, 4, n)
    dec = BrickDecomp(dims=(n, n, n), ghost_depth=(BD[0], BD[1], 0),
                      bdims=BD).initialize(skinlist_by_name("good", 3))
    step = differentiable_pencil_sweep(
        sdef, dec.periodic_grid((0, 1, 2)), BD, dec.nbricks, params)

    def stage(a):
        idx = [np.arange(-z, n + z) % n for z in (BD[0], BD[1], 0)]
        dat = np.zeros((dec.nbricks, int(np.prod(BD))), np.float32)
        to_bricks(a[np.ix_(*idx)], dec.grid, BD, dat=dat)
        return jnp.asarray(dat.reshape((dec.nbricks,) + BD))

    rng = np.random.default_rng(0)
    x_true = stage(rng.random((n, n, n), np.float32))
    wmask = jnp.asarray(dec.owned_mask().reshape((-1,) + (1,) * 3))

    def fwd2(x):
        return step(step(x))

    y_obs = fwd2(x_true)

    @jax.jit
    def loss_and_grad(x):
        def f(x_):
            r = jnp.where(wmask, fwd2(x_) - y_obs, 0.0)
            return 0.5 * jnp.sum(r * r)
        return jax.value_and_grad(f)(x)

    x = jnp.zeros_like(x_true)
    lr = 0.35
    steps = int(os.environ.get("BRICK_EXAMPLE_STEPS", "40"))
    l0 = None
    for it in range(steps):
        loss, grad = loss_and_grad(x)
        x = x - lr * grad
        if l0 is None:
            l0 = float(loss)
        if it % max(1, steps // 5) == 0:
            print(f"iter {it:3d}  loss {float(loss):.6f}")
    lN = float(loss_and_grad(x)[0])
    print(f"loss: {l0:.4f} -> {lN:.6f} "
          f"({lN / l0:.2e} of start) in {steps} adjoint iterations")
    assert lN < 0.01 * l0
    print("OK")


if __name__ == "__main__":
    main()
