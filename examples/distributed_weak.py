"""Distributed example: domain decomposition over a device mesh with
deep-ghost iteration amortization and the SHIFT exchange —
the reference's weak-scaling flow (weak/main.cpp) through the
high-level Problem API.

Runs on whatever devices jax sees; with fewer than 4 devices it
re-executes itself on 4 virtual CPU devices (the reference's single-box
``mpirun -np N`` trick):

    python examples/distributed_weak.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))   # repo root, for uninstalled checkouts


def main():
    import jax

    if len(jax.devices()) < 4:
        print(f"{len(jax.devices())} device(s) visible - re-running on "
              f"4 virtual CPU devices")
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        flags = [f for f in env.get("XLA_FLAGS", "").split()
                 if "host_platform_device_count" not in f]
        env["XLA_FLAGS"] = " ".join(
            flags + ["--xla_force_host_platform_device_count=4"])
        os.execve(sys.executable,
                  [sys.executable, os.path.abspath(__file__), "--inner"],
                  env)

    from brickjax.api import Problem
    from brickjax.codegen import dense_apply
    from brickjax.stencils import stencil_by_name

    mesh = (2, 2, 1)          # devices per domain axis (k, j; i local)
    # per-device owned elements; BRICK_EXAMPLE_DIMS shrinks test runs
    dims = tuple(int(x) for x in os.environ.get(
        "BRICK_EXAMPLE_DIMS", "32,32,128").split(","))
    st_iter = 4               # iterations per ghost exchange (deep-ghost)

    rng = np.random.default_rng(1)
    gshape = tuple(m * d for m, d in zip(mesh, dims))
    field = rng.random(gshape, dtype=np.float32)

    p = Problem(dims=dims, mesh=mesh, stencil="mpi7pt",
                bdims=(8, 8, dims[2]), backend="pencil",
                st_iter=st_iter)
    p.init(array=field).step(1)       # one step = exchange + 4 sweeps
    got = p.result()

    # dense periodic twin
    sd = stencil_by_name("mpi7pt")[0]
    w = field
    for _ in range(st_iter):
        wp = np.pad(w, 1, mode="wrap")
        w = dense_apply(sd, {"in": wp}, p.params, xp=np)
    err = float(np.abs(got - w).max())
    print(f"mesh {mesh}  domain {gshape}  ST_ITER {st_iter}  "
          f"SHIFT exchange")
    print(f"max |err| vs dense periodic twin: {err:.2e}")
    assert err < 1e-4
    print("OK")


if __name__ == "__main__":
    if "--inner" in sys.argv:
        import jax

        jax.config.update("jax_platforms", "cpu")
    main()
