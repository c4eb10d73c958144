"""External-user example (ref: examples/external/7pt.py + its driver):
define your own stencil with the eDSL, run it through the high-level
Problem API, and check it against numpy.

    python examples/laplace7pt.py            # runs on whatever jax sees
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))   # repo root, for uninstalled checkouts

from brickjax.api import Problem
from brickjax.st import ConstRef, Grid, Index, load_stencil_module

# -- define a stencil exactly like a reference stencil module ----------
i, j, k = Index(0), Index(1), Index(2)
inp = Grid("in", 3)
out = Grid("out", 3)
alpha, beta = ConstRef("alpha"), ConstRef("beta")
out(i, j, k).assign(
    alpha * inp(i, j, k)
    + beta * (inp(i + 1, j, k) + inp(i - 1, j, k)
              + inp(i, j + 1, k) + inp(i, j - 1, k)
              + inp(i, j, k + 1) + inp(i, j, k - 1)))
STENCIL = [out]


def main():
    sdef = load_stencil_module({"STENCIL": STENCIL})[0]
    params = {"alpha": 0.4, "beta": 0.1}

    # BRICK_EXAMPLE_N shrinks test runs
    n = int(os.environ.get("BRICK_EXAMPLE_N", "128"))
    rng = np.random.default_rng(0)
    field = rng.random((n, n, n), dtype=np.float32)

    p = Problem(dims=(n, n, n), stencil=sdef, params=params,
                bdims=(8, 8, n), backend="pencil")
    p.init(array=field).step(1)
    got = p.result()

    fp = np.pad(field, 1, mode="wrap")
    want = (params["alpha"] * fp[1:-1, 1:-1, 1:-1]
            + params["beta"] * (fp[1:-1, 1:-1, 2:] + fp[1:-1, 1:-1, :-2]
                                + fp[1:-1, 2:, 1:-1] + fp[1:-1, :-2, 1:-1]
                                + fp[2:, 1:-1, 1:-1] + fp[:-2, 1:-1, 1:-1]))
    err = np.abs(got - want).max()
    print(f"max |err| vs numpy: {err:.2e}")
    assert err < 1e-4
    print("OK")


if __name__ == "__main__":
    main()
