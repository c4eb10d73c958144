"""Two-level mesh: nodes x cards (the reference's arbitrary MPI_Cart
topologies, ref: weak/args.cpp:105-108, brick-mpi.h:730-753).

On the 8-virtual-CPU-device harness a "node" is just another device
group — what these tests prove is the TOPOLOGY plumbing: the composite
(slice, card) ppermute axis, node-major placement, staging, and plan
reporting all agree with the plain single-level mesh and the dense
twin.
"""

import numpy as np
import pytest

from brickjax.api import Problem
from brickjax.codegen import dense_apply
from brickjax.core import compare_arrays, random_array
from brickjax.stencils import stencil_by_name


def _dense_steps(g, name, n, params):
    sd = stencil_by_name(name)[0]
    lo, hi = sd.radius()
    w = g
    for _ in range(n):
        wp = np.pad(w, [(l, h) for l, h in zip(lo, hi)], mode="wrap")
        w = dense_apply(sd, {next(iter(sd.inputs)): wp}, params, xp=np)
    return w


def test_multislice_jnp_matches_dense():
    # 2 nodes x (1, 2, 2) cards = 8 devices; domain axis 0 spans
    # (slice, z) as one composite ppermute line
    g = random_array((16, 16, 32), np.float32, 21)
    p = Problem(dims=(8, 8, 16), stencil="mpi7pt", mesh=(1, 2, 2),
                slices=2, bdims=(4, 4, 8), backend="jnp")
    p.init(array=g).step(2)
    want = _dense_steps(g, "mpi7pt", 2, p.params)
    assert compare_arrays(p.result(), want, 1e-4)


def test_multislice_matches_single_level():
    """slices=2, mesh=(2,2,1) computes EXACTLY what the plain
    eff-shaped mesh=(4,2,1) computes (same devices, same placement)."""
    g = random_array((32, 16, 32), np.float32, 22)
    a = Problem(dims=(8, 8, 32), stencil="mpi13pt", mesh=(2, 2, 1),
                slices=2, bdims=(4, 4, 16), backend="jnp", st_iter=1)
    b = Problem(dims=(8, 8, 32), stencil="mpi13pt", mesh=(4, 2, 1),
                bdims=(4, 4, 16), backend="jnp", st_iter=1)
    a.init(array=g).step(2)
    b.init(array=g).step(2)
    np.testing.assert_array_equal(a.result(), b.result())


def test_multislice_pencil_matches_dense():
    g = random_array((32, 16, 32), np.float32, 23)
    p = Problem(dims=(8, 8, 32), stencil="mpi7pt", mesh=(2, 2, 1),
                slices=2, bdims=(4, 4, 32), backend="pencil")
    p.init(array=g).step(2)
    want = _dense_steps(g, "mpi7pt", 2, p.params)
    assert compare_arrays(p.result(), want, 1e-4)


def test_multislice_describe_and_guards():
    p = Problem(dims=(8, 8, 16), stencil="mpi7pt", mesh=(2, 2, 1),
                slices=2, bdims=(4, 4, 8), backend="jnp")
    d = p.describe()
    assert d["slices"] == 2
    assert d["eff_mesh"] == [4, 2, 1]
    assert "node x card" in d["exchange_axes"][0]
    assert "2 nodes x 2 cards" in d["exchange_axes"][0]
    # a two-level mesh larger than the device count raises
    with pytest.raises(ValueError, match="needs 16 devices"):
        Problem(dims=(8, 8, 32), stencil="mpi7pt", mesh=(2, 2, 2),
                slices=2, bdims=(4, 4, 8), backend="jnp")


def test_multislice_checkpoint_guard(tmp_path):
    g = random_array((16, 16, 32), np.float32, 25)
    p = Problem(dims=(8, 8, 16), stencil="mpi7pt", mesh=(1, 2, 2),
                slices=2, bdims=(4, 4, 8), backend="jnp")
    p.init(array=g)
    path = str(tmp_path / "ck")
    p.save(path)
    q = Problem(dims=(8, 8, 16), stencil="mpi7pt", mesh=(1, 2, 2),
                slices=2, bdims=(4, 4, 8), backend="jnp")
    q.load(path)
    assert compare_arrays(q.result(), p.result(), 1e-6)
    bad = Problem(dims=(8, 8, 16), stencil="mpi7pt", mesh=(1, 2, 2),
                  bdims=(4, 4, 8), backend="jnp")
    with pytest.raises(ValueError, match="slices"):
        bad.load(path)
