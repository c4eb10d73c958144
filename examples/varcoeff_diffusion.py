"""Variable-coefficient diffusion: a stencil reading TWO grids — the
evolving field u and a static spatially-varying coefficient c — on the
pencil fast path via the Problem API (multi-input support; ref: the
codegen's per-grid prologues, codegen/st/codegen/backend/base.py:93-123).

    u' = u + dt * div(c grad u)   (flux form, 7-point)

    python examples/varcoeff_diffusion.py     # runs on whatever jax sees
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))   # repo root, for uninstalled checkouts

from brickjax.api import Problem
from brickjax.st import ConstRef, Grid, Index, load_stencil_module

# -- define the two-grid stencil ---------------------------------------
i, j, k = Index(0), Index(1), Index(2)
u = Grid("u", 3)
c = Grid("c", 3)
out = Grid("out", 3)
dt = ConstRef("dt")

# face-centered flux: flux_+ = (c0 + c+)/2 * (u+ - u0), summed over axes
flux = None
for args_p in ([i + 1, j, k], [i, j + 1, k], [i, j, k + 1]):
    f = (c(i, j, k) + c(*args_p)) * (u(*args_p) - u(i, j, k))
    flux = f if flux is None else flux + f
for args_m in ([i - 1, j, k], [i, j - 1, k], [i, j, k - 1]):
    f = (c(i, j, k) + c(*args_m)) * (u(*args_m) - u(i, j, k))
    flux = flux + f
out(i, j, k).assign(u(i, j, k) + dt * flux)
STENCIL = [out]


def main():
    sdef = load_stencil_module({"STENCIL": STENCIL})[0]
    params = {"dt": 0.05}

    # BRICK_EXAMPLE_N shrinks test runs
    n = int(os.environ.get("BRICK_EXAMPLE_N", "128"))
    rng = np.random.default_rng(0)
    u0 = rng.random((n, n, n), dtype=np.float32)
    # smooth, positive coefficient field
    x = np.linspace(0, 2 * np.pi, n, endpoint=False, dtype=np.float32)
    cf = (1.2 + np.sin(x)[:, None, None] * np.cos(x)[None, :, None]
          * 0.5).astype(np.float32) * np.ones((n, n, n), np.float32)

    p = Problem(dims=(n, n, n), stencil=sdef, field="u", params=params,
                bdims=(8, 8, n), backend="pencil")
    p.init(array=u0, aux={"c": cf}).step(3)
    got = p.result()

    # numpy twin
    w = u0
    for _ in range(3):
        up = np.pad(w, 1, mode="wrap")
        cp = np.pad(cf, 1, mode="wrap")
        acc = np.zeros_like(w)
        ctr = (slice(1, -1),) * 3
        for ax in range(3):
            for s in (1, -1):
                sl = [slice(1, -1)] * 3
                sl[ax] = slice(1 + s, None if s > 0 else -2)
                sl = tuple(sl)
                acc += (cp[ctr] + cp[sl]) * (up[sl] - up[ctr])
        w = w + params["dt"] * acc
    err = np.abs(got - w).max()
    print(f"max |err| vs numpy after 3 steps: {err:.2e}")
    assert err < 1e-3

    # --- exact gradients wrt u AND the coefficient field c -----------
    # (the inverse problem).  differentiable_step builds the
    # POLYNOMIAL adjoint pullback: sweep forward + one adjoint pencil
    # sweep per field, O(1) activation memory (codegen.autodiff.
    # differentiable_poly_sweep — round-4 exact mode; the dense oracle
    # now serves only systems and If/max stencils).
    import jax
    import jax.numpy as jnp

    fn = p.differentiable_step()
    wmask = p.owned_mask()

    def dense_step(ud, cd):
        up = jnp.pad(ud, 1, mode="wrap")
        cp = jnp.pad(cd, 1, mode="wrap")
        acc = jnp.zeros_like(ud)
        ctr = (slice(1, -1),) * 3
        for ax in range(3):
            for s in (1, -1):
                sl = [slice(1, -1)] * 3
                sl[ax] = slice(1 + s, None if s > 0 else -2)
                sl = tuple(sl)
                acc += (cp[ctr] + cp[sl]) * (up[sl] - up[ctr])
        return ud + params["dt"] * acc

    # compare on the dense twin (forward state after the 3 steps above)
    ud = jnp.asarray(p.result())
    du, dc = jax.grad(lambda uc: jnp.sum(
        dense_step(uc[0], uc[1]) ** 2))((ud, jnp.asarray(cf)))

    from brickjax.core import from_bricks

    def unstage(b):
        full = from_bricks(np.asarray(b).reshape(p.dec.nbricks, -1),
                           p.dec.grid, p.bdims)
        return full[p.bdims[0]:p.bdims[0] + n,
                    p.bdims[1]:p.bdims[1] + n, :]

    # fn differentiates ONE step from the problem's current state
    gu, gc = jax.grad(lambda uc: jnp.sum(
        jnp.where(wmask, fn(uc[0], uc[1]), 0.0) ** 2))(
        (p._dats[0], p._aux[0]))
    eg = max(np.abs(unstage(gu) - np.asarray(du)).max(),
             np.abs(unstage(gc) - np.asarray(dc)).max())
    print(f"max |grad err| (u and c) vs dense AD: {eg:.2e}")
    assert eg < 1e-3
    print("OK")


if __name__ == "__main__":
    main()
