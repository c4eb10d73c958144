"""Gray-Scott reaction-diffusion: a coupled TWO-FIELD stencil system
through the Problem API (the reference's multi-output ``STENCIL =
[out_u, out_v]`` contract, codegen/vecscatter:165-168).

    u' = u + dt * (Du lap(u) - u v^2 + F (1 - u))
    v' = v + dt * (Dv lap(v) + u v^2 - (F + K) v)

Both fields exchange every step; both updates read both PRE-step
fields (Jacobi).  The nonlinear u*v*v terms are grid x grid products —
the generic-evaluator path of the multi-input pencil kernel.

    python examples/gray_scott.py      # runs on whatever jax sees
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))   # repo root, for uninstalled checkouts

from brickjax.api import Problem
from brickjax.st import ConstRef, Grid, Index, load_stencil_module

i, j, k = Index(0), Index(1), Index(2)
u, v = Grid("u", 3), Grid("v", 3)
ou, ov = Grid("ou", 3), Grid("ov", 3)
dt, Du, Dv = ConstRef("dt"), ConstRef("Du"), ConstRef("Dv")
F, K = ConstRef("F"), ConstRef("K")


def lap(g):
    return (g(i + 1, j, k) + g(i - 1, j, k) + g(i, j + 1, k)
            + g(i, j - 1, k) + g(i, j, k + 1) + g(i, j, k - 1)
            - 6.0 * g(i, j, k))


uvv = u(i, j, k) * v(i, j, k) * v(i, j, k)
ou(i, j, k).assign(u(i, j, k)
                   + dt * (Du * lap(u) - uvv + F * (1.0 - u(i, j, k))))
ov(i, j, k).assign(v(i, j, k)
                   + dt * (Dv * lap(v) + uvv - (F + K) * v(i, j, k)))
STENCIL = [ou, ov]


def main():
    sdefs = load_stencil_module({"STENCIL": STENCIL})
    params = {"dt": 0.8, "Du": 0.16, "Dv": 0.08, "F": 0.035,
              "K": 0.065}

    # BRICK_EXAMPLE_N shrinks test runs
    n = int(os.environ.get("BRICK_EXAMPLE_N", "128"))
    rng = np.random.default_rng(0)
    u0 = np.ones((n, n, n), np.float32)
    v0 = np.zeros((n, n, n), np.float32)
    # seed a perturbed blob in the middle
    c, h = n // 2, min(6, n // 4)
    s = slice(c - h, c + h)
    u0[s, s, s] = 0.5
    v0[s, s, s] = 0.25
    v0 += 0.01 * rng.random((n, n, n), dtype=np.float32)

    p = Problem(dims=(n, n, n), stencil=sdefs, field=("u", "v"),
                params=params, bdims=(8, 8, n), backend="pencil")
    steps = int(os.environ.get("BRICK_EXAMPLE_STEPS", "50"))
    p.init(array={"u": u0, "v": v0})
    p.step(steps)
    out = p.result()

    # numpy twin for a short re-run (3 steps from the same start)
    q = Problem(dims=(n, n, n), stencil=sdefs, field=("u", "v"),
                params=params, bdims=(8, 8, n), backend="pencil")
    q.init(array={"u": u0, "v": v0}).step(3)
    got = q.result()

    wu, wv = u0, v0
    for _ in range(3):
        pu = np.pad(wu, 1, mode="wrap")
        pv = np.pad(wv, 1, mode="wrap")

        def lp(g):
            return (g[2:, 1:-1, 1:-1] + g[:-2, 1:-1, 1:-1]
                    + g[1:-1, 2:, 1:-1] + g[1:-1, :-2, 1:-1]
                    + g[1:-1, 1:-1, 2:] + g[1:-1, 1:-1, :-2]
                    - 6.0 * g[1:-1, 1:-1, 1:-1])

        uvv_ = wu * wv * wv
        nu = wu + params["dt"] * (params["Du"] * lp(pu) - uvv_
                                  + params["F"] * (1.0 - wu))
        nv = wv + params["dt"] * (params["Dv"] * lp(pv) + uvv_
                                  - (params["F"] + params["K"]) * wv)
        wu, wv = nu, nv
    err = max(np.abs(got["u"] - wu).max(), np.abs(got["v"] - wv).max())
    print(f"max |err| vs numpy after 3 steps: {err:.2e}")
    assert err < 1e-4
    print(f"{steps} steps: u in [{out['u'].min():.3f}, {out['u'].max():.3f}],"
          f" v in [{out['v'].min():.3f}, {out['v'].max():.3f}]")
    print("OK")


if __name__ == "__main__":
    main()
