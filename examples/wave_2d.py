"""2-D wave equation as a coupled stencil SYSTEM on the 2-D fast path,
with source inversion through the EXACT adjoint-system pullback.

2-D is a first-class Problem rank (codegen/sweep: whole-row pencil
bricks, x-taps roll within the row — the dimension generality the
reference gets from templates, include/brick.h:96-127).
This example drives the full 2-D surface:

1. wave dynamics as a two-field symplectic system STENCIL = [p', v']
   (pressure p and velocity v; periodic domain);
2. Problem(stencil=[...], field=("p", "v")) — one multi-output kernel
   per step, auto-selected 2-D pencil backend;
3. source inversion: recover an initial condition from a late-time
   snapshot with jax.grad through Problem.differentiable_step (the
   exact adjoint-system pullback — sweep forward AND backward).

    python examples/wave_2d.py          # BRICK_EXAMPLE_N=32 by default
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))   # repo root, for uninstalled checkouts

import jax
import jax.numpy as jnp

from brickjax.api import Problem
from brickjax.codegen import dense_apply
from brickjax.st import Grid, Index, load_stencil_module

N = int(os.environ.get("BRICK_EXAMPLE_N", "32"))
W = N
STEPS = int(os.environ.get("BRICK_EXAMPLE_STEPS", "3"))
C2 = 0.2          # (c * dt / dx)^2, stable leapfrog

# -- the system: p'' = c^2 lap(p) in symplectic (p, v) form ----------
# v' = v + C2 lap(p);  p' = p + v' = p + v + C2 lap(p)  (Jacobi: both
# outputs read the PRE-step fields, which is exactly this update)
i, j = Index(0), Index(1)
p, v = Grid("p", 2), Grid("v", 2)
op, ov = Grid("op", 2), Grid("ov", 2)


def lap(g):
    return (g(i + 1, j) + g(i - 1, j) + g(i, j + 1) + g(i, j - 1)
            - 4.0 * g(i, j))


op(i, j).assign(p(i, j) + v(i, j) + C2 * lap(p))
ov(i, j).assign(v(i, j) + C2 * lap(p))
SDS = load_stencil_module({"STENCIL": [op, ov]})

rng = np.random.default_rng(0)
x0 = np.zeros((N, W), np.float32)
x0[N // 4, N // 4] = 1.0                 # point source
x0[5 * N // 8, W // 2] = -0.7

prob = Problem(dims=(N, W), stencil=SDS, field=("p", "v"),
               bdims=(8, W))
assert prob.backend == "pencil", prob.backend
prob.init(array={"p": x0, "v": np.zeros_like(x0)})
prob.step(STEPS)
got = prob.result()

# numpy twin
named = {"p": x0, "v": np.zeros_like(x0)}
for _ in range(STEPS):
    new = {}
    for oname, s_ in (("p", SDS[0]), ("v", SDS[1])):
        lo, hi = s_.radius()
        pad = [(l, h) for l, h in zip(lo, hi)]
        padded = {n: np.pad(a, pad, mode="wrap")
                  for n, a in named.items()}
        new[oname] = dense_apply(s_, padded, {}, xp=np)
    named = new
err = max(np.max(np.abs(got[n] - named[n])) for n in ("p", "v"))
print(f"wave_2d: {STEPS} steps on the 2-D pencil system path, "
      f"max |err| vs numpy twin = {err:.2e}")
assert err < 1e-4, err

# -- source inversion: one gradient step through the exact adjoint ----
step = prob.differentiable_step()
target = jnp.asarray(prob._dats[0])     # late-time p snapshot (bricked)
mask = prob.owned_mask()

prob2 = Problem(dims=(N, W), stencil=SDS, field=("p", "v"),
                bdims=(8, W))
prob2.init(array={"p": np.zeros_like(x0),
                  "v": np.zeros_like(x0)})
z = prob2._dats[0]


def loss(p0):
    st = (p0, jnp.zeros_like(p0))
    for _ in range(STEPS):
        st = step(*st)
    r = jnp.where(mask, st[0] - target, 0.0)
    return jnp.sum(r * r)


val, grad = jax.value_and_grad(loss)(z)
# the gradient at zero must point toward the true source: a descent
# step must reduce the loss
val2 = loss(z - 0.25 * grad)
print(f"wave_2d: inversion loss {float(val):.4f} -> "
      f"{float(val2):.4f} after one adjoint descent step")
assert float(val2) < float(val), (val, val2)
print("wave_2d: OK")
