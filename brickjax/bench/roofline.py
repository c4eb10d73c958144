"""Shared measurement machinery for ``bench.py``.

- :func:`barrier` — wait for a (pytree) result;
- :func:`chain` — dependent-call timing loop ending in that barrier;
- :func:`rep` — R iterations INSIDE one jit call, so per-dispatch host
  cost stays out of both sides of a ratio;
- :func:`make_copy` — the copy roofline: one read and one write of the
  storage per call, with an optimization barrier so that XLA cannot
  merge the copies of a :func:`rep` chain into fewer passes.
"""

from __future__ import annotations

import time


def barrier(out):
    """Block until every leaf of ``out`` is computed."""
    import jax

    jax.block_until_ready(out)


def chain(fn, x, it):
    """(avg seconds, last output) for a dependent chain ending in a
    barrier; donation-safe (never reuses a consumed buffer)."""
    out = fn(x)
    barrier(out)
    t0 = time.perf_counter()
    for _ in range(it):
        out = fn(out)
    barrier(out)
    return (time.perf_counter() - t0) / it, out


def rep(fn, r):
    """jit of ``r`` dependent iterations of ``fn`` in ONE dispatch."""
    import jax

    def g(d):
        for _ in range(r):
            d = fn(d)
        return d

    return jax.jit(g)


def make_copy():
    """``fn(view) -> view'``: a full read and write of the storage
    (2 x itemsize bytes per element).  The negation is a real
    elementwise pass; the barrier keeps a chain of them from being
    simplified or fused into one."""
    from jax import lax

    def copy(d):
        return lax.optimization_barrier(-d)

    return copy
