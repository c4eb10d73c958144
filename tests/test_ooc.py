"""Out-of-core streaming sweep vs the in-core dense twin."""

import numpy as np
import pytest

from brickjax.codegen import dense_apply
from brickjax.core import compare_arrays, random_array
from brickjax.ooc import ooc_sweep
from brickjax.stencils import bench_params, stencil_by_name

PARAMS = bench_params()


def _dense_steps(sd, g, n):
    lo, hi = sd.radius()
    for _ in range(n):
        gp = np.pad(g, list(zip(lo, hi)), mode="wrap")
        g = dense_apply(sd, {next(iter(sd.inputs)): gp}, PARAMS, xp=np)
    return g


@pytest.mark.parametrize("name,slab_rows,iters", [
    ("s7pt", 6, 2),       # 3 slabs, radius 1, two passes
    ("mpi13pt", 5, 1),    # radius 2: slab overlap deeper than 1
    ("s7pt", 16, 1),      # single slab degenerate case
])
def test_ooc_matches_dense(name, slab_rows, iters):
    sd = stencil_by_name(name)[0]
    g = random_array((16, 16, 256), np.float32, 7)
    stats = {}
    got = ooc_sweep(g, sd, PARAMS, iters=iters, slab_rows=slab_rows,
                    stats=stats)
    want = _dense_steps(sd, g, iters)
    assert compare_arrays(got, want, 1e-5)
    assert stats["slabs"] == -(-16 // slab_rows)
    # input must be untouched (streaming works on a copy)
    np.testing.assert_array_equal(
        g, random_array((16, 16, 256), np.float32, 7))


def test_ooc_slab_bytes_budget():
    """slab_bytes bounds the derived slab height (many small slabs)."""
    sd = stencil_by_name("s7pt")[0]
    g = random_array((16, 16, 256), np.float32, 8)
    stats = {}
    row = (16 + 16) * (256 + 2 * 63) * 4   # padded row bytes, roughly
    got = ooc_sweep(g, sd, PARAMS, slab_bytes=8 * row, stats=stats)
    assert stats["slabs"] >= 4
    assert compare_arrays(got, _dense_steps(sd, g, 1), 1e-5)
