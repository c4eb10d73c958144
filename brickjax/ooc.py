"""Out-of-core stencils: domains larger than device memory.

The reference is bounded by device memory (its mmap storage aliases
views, it does not stream); the classic extension is out-of-core
temporal streaming (cf. arXiv:1709.02125, "Beyond 16GB: Out-of-Core
Stencil Computations" — PAPERS.md).  The domain lives in HOST RAM, and
each sweep streams overlapping k-slabs through the device —

    host slab [s0-lo_k, s1+hi_k)  --H2D-->  wrap-pad j/i, dense stencil
        --D2H-->  host out rows [s0, s1)

with the next slab's host-to-device transfer dispatched before the
previous output is read back, so jax's async dispatch overlaps transfer
with compute.  Global boundaries are periodic (the drivers'
convention): k wraps through the slab indexing, j/i wrap on the device.

This is deliberately the DENSE-array path (the ``tile(...)`` twin):
out-of-core domains are transfer-bound, so the brick layout's on-device
advantages are irrelevant and the array form avoids a layout transform
per slab.
"""

from __future__ import annotations

import numpy as np


def _slab_plan(K: int, slab_rows: int):
    """Half-open owned k-ranges covering [0, K)."""
    plan = []
    s0 = 0
    while s0 < K:
        s1 = min(s0 + slab_rows, K)
        plan.append((s0, s1))
        s0 = s1
    return plan


def ooc_sweep(arr: np.ndarray, stencil, params: dict | None = None,
              iters: int = 1, slab_bytes: int = 2 * 2 ** 30,
              slab_rows: int | None = None,
              stats: dict | None = None):
    """Apply ``iters`` periodic stencil sweeps to a host-resident 3-D
    array by streaming k-slabs through the device; returns the new host
    array (the input is not modified).

    ``slab_bytes`` bounds the per-slab device footprint (in+out, both
    resident during the overlap window); ``slab_rows`` overrides the
    derived slab height.  ``stats`` (optional dict) receives
    ``{"slabs", "h2d_bytes", "d2h_bytes", "wall_s"}`` per call.
    """
    import time

    import jax
    import jax.numpy as jnp

    from .codegen.jnp_backend import _as_ir, dense_apply

    ir = _as_ir(stencil)
    if ir.dims != 3:
        raise NotImplementedError("out-of-core path is 3-D")
    if len(ir.sdef.inputs) != 1:
        raise NotImplementedError("out-of-core path reads one grid")
    gname = next(iter(ir.sdef.inputs))
    arr = np.asarray(arr)
    K, J, I = arr.shape
    lo, hi = ir.radius()
    row_bytes = J * I * arr.dtype.itemsize
    if slab_rows is None:
        slab_rows = max(1, int(slab_bytes // (3 * row_bytes))
                        - lo[0] - hi[0])
    slab_rows = min(slab_rows, K)
    plan = _slab_plan(K, slab_rows)

    @jax.jit
    def slab_fn(slab):
        pad = ((0, 0), (lo[1], hi[1]), (lo[2], hi[2]))
        return dense_apply(ir, {gname: jnp.pad(slab, pad, mode="wrap")},
                           params)

    def host_slab(src, s0, s1):
        """Host k rows [s0-lo_k, s1+hi_k) with global wrap."""
        return src[np.arange(s0 - lo[0], s1 + hi[0]) % K]

    t0 = time.perf_counter()
    h2d = d2h = 0
    cur = arr
    for _ in range(int(iters)):
        out = np.empty_like(cur)
        # software pipeline: slab s+1's H2D dispatches before slab s's
        # result readback blocks, so transfer overlaps compute
        dev = jax.device_put(jnp.asarray(host_slab(cur, *plan[0])))
        for s, (s0, s1) in enumerate(plan):
            o = slab_fn(dev)
            h2d += dev.nbytes
            if s + 1 < len(plan):
                dev = jax.device_put(
                    jnp.asarray(host_slab(cur, *plan[s + 1])))
            res = np.asarray(o)
            d2h += res.nbytes
            out[s0:s1] = res
        cur = out
    if stats is not None:
        stats.update(slabs=len(plan), h2d_bytes=h2d, d2h_bytes=d2h,
                     wall_s=time.perf_counter() - t0)
    return cur
