"""Dimension generality beyond 4-D: the layout core, decomp, exchange
and jnp oracle are rank-generic like the reference's templates
(ref: include/brick.h:96-127) — a 5-D distributed Problem runs
end-to-end and matches the dense periodic twin exactly.
"""

import numpy as np

from brickjax.api import Problem
from brickjax.codegen import dense_apply
from brickjax.st import Grid, Index
from brickjax.st.loader import load_stencil_module


def _sd5():
    idx = [Index(a) for a in range(5)]
    g, o = Grid("in", 5), Grid("out", 5)
    a1 = list(idx)
    a1[4] = idx[4] + 1      # outermost numpy axis (eDSL dim 4)
    a2 = list(idx)
    a2[0] = idx[0] - 1      # innermost
    a3 = list(idx)
    a3[2] = idx[2] + 1
    o(*idx).assign(0.5 * g(*idx) + 0.25 * g(*a1) + 0.25 * g(*a2)
                   - 0.1 * g(*a3))
    return load_stencil_module({"STENCIL": [o]})[0]


def test_problem_5d_distributed_matches_dense():
    sd = _sd5()
    p = Problem(dims=(4, 4, 4, 4, 8), stencil=sd, bdims=(2, 2, 2, 2, 4),
                backend="jnp", mesh=(2, 1, 2, 1, 1))
    x = np.random.default_rng(0).random((8, 4, 8, 4, 8), np.float32)
    p.init(array=x).step(2)
    lo, hi = sd.radius()
    want = x
    for _ in range(2):
        wp = np.pad(want, [(l, h) for l, h in zip(lo, hi)], mode="wrap")
        want = dense_apply(sd, {"in": wp}, {}, xp=np)
    np.testing.assert_allclose(np.asarray(p.result()), want, rtol=0,
                               atol=2e-6)
