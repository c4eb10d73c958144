"""Shared bench machinery (brickjax.bench.roofline).

bench.py prints its JSON line through these helpers, so the cheap
invariants get fast-tier coverage: pytree-aware barrier/chain
semantics, in-jit repetition and the copy roofline's arithmetic.
"""

import jax
import jax.numpy as jnp

from brickjax.bench.roofline import barrier, chain, make_copy, rep


def test_chain_pytree_carry_and_count():
    # chain() = 1 warm-up + `it` timed dependent calls, pytree carries
    # work (the coupled-system benches time (u, v) tuples)
    calls = []

    @jax.jit
    def step(uv):
        u, v = uv
        return u + 1.0, v + 2.0

    def counted(uv):
        calls.append(1)
        return step(uv)

    x = (jnp.zeros((2, 2)), jnp.zeros((2, 2)))
    dt, (u, v) = chain(counted, x, 3)
    assert dt > 0 and len(calls) == 4
    assert float(u[0, 0]) == 4.0 and float(v[0, 0]) == 8.0


def test_rep_composes_iterations():
    f = rep(lambda d: d * 2.0, 3)
    out = f(jnp.ones((2,)))
    assert float(out[0]) == 8.0
    barrier(out)  # smoke: scalar readback on an array leaf


def test_make_copy_moves_every_element():
    # an even count of negations returns the input exactly: the copy
    # really reads and writes every element, and the barrier keeps the
    # chain from folding neg(neg(x)) into nothing
    x = jnp.arange(12.0).reshape(3, 4)
    f = rep(make_copy(), 2)
    assert bool(jnp.array_equal(f(x), x))
    assert bool(jnp.array_equal(rep(make_copy(), 3)(x), -x))
    hlo = f.lower(x).compile().as_text()
    assert "negate" in hlo
