"""Single-device driver: copy / 7pt / 27pt / cond with array-twin
validation (ref: single/cpu.cpp:10-25, stencils/3axis.cpp).

Per stencil it reports, like the reference's Arr/Bri/Trans lines:
  arr   — dense jnp stencil (the tiled-array twin)
  bri   — jnp brick executor (hand-accessor analog)
  gen   — window sweep over the brick grid table (codegen analog)
"""

from __future__ import annotations

import argparse

import numpy as np


def run(n: int = 256, bdim=(8, 8, 128), stencils=("s7pt", "s27pt", "cond"),
        tot_time: float = 2.0, pencil: bool = True):
    import jax
    import jax.numpy as jnp

    from ..bench.timing import time_func
    from ..codegen import brick_apply, dense_apply
    from ..codegen.sweep import pencil_sweep
    from ..core import (compare_arrays, from_bricks, init_grid,
                        random_array, to_bricks)
    from ..stencils import bench_params, stencil_by_name

    params = bench_params()

    use_pencil = pencil and n % bdim[0] == 0 and n % bdim[1] == 0
    if use_pencil:
        bdim = (bdim[0], bdim[1], n)
        gdims = (n // bdim[0] + 2, n // bdim[1] + 2, 1)
    else:
        gdims = tuple(n // b + 2 for b in bdim)
    grid, info = init_grid(gdims)

    core = random_array((n, n, n), np.float32, seed=1)
    ext = np.pad(core, [(b, b) for b in
                        (bdim[0], bdim[1], 0 if use_pencil else bdim[2])],
                 mode="wrap")
    dat = to_bricks(ext, grid, bdim)
    view = jnp.asarray(dat.reshape((-1,) + bdim))
    adj = jnp.asarray(info.adj)
    elems = n ** 3
    results = {}

    for name in stencils:
        sd = stencil_by_name(name)[0]
        gname = next(iter(sd.inputs))
        lo, hi = sd.radius()

        corep = np.pad(core, [(l, h) for l, h in zip(lo, hi)],
                       mode="wrap")
        want = dense_apply(sd, {gname: corep}, params, xp=np)

        # stream results as each backend finishes: first-compile of the
        # big oracle graphs is slow and a silent driver looks hung
        print(name, flush=True)
        arr_in = jnp.asarray(corep)
        arr_fn = jax.jit(lambda a, sd=sd, gn=gname:
                         dense_apply(sd, {gn: a}, params))
        t_arr = time_func(arr_fn, arr_in, tot_time=tot_time)
        print(f"  arr: {t_arr:.6f}s  {elems / t_arr / 1e9:7.2f} "
              f"GStencil/s", flush=True)

        bri_fn = jax.jit(lambda v, sd=sd, gn=gname:
                         brick_apply(sd, {gn: v}, adj, params))
        t_bri = time_func(bri_fn, view, tot_time=tot_time)
        print(f"  bri: {t_bri:.6f}s  {elems / t_bri / 1e9:7.2f} "
              f"GStencil/s", flush=True)
        got = from_bricks(np.asarray(bri_fn(view)), grid[1:-1, 1:-1, 1:-1]
                          if not use_pencil else grid[1:-1, 1:-1], bdim)
        if use_pencil:
            # brick executor is not periodic in i; trim the i edge
            r = max(lo[2], hi[2])
            ok_bri = compare_arrays(got[:, :, r:n - r],
                                    want[:, :, r:n - r], 1e-4)
        else:
            ok_bri = compare_arrays(got, want, 1e-4)

        gen_fn = jax.jit(pencil_sweep(
            sd, grid, bdim, info.nbricks, params,
            i_ghost=0 if use_pencil else 1))
        t_gen = time_func(gen_fn, view, tot_time=tot_time)
        print(f"  gen: {t_gen:.6f}s  {elems / t_gen / 1e9:7.2f} "
              f"GStencil/s", flush=True)
        gotg = from_bricks(np.asarray(gen_fn(view)),
                           grid[1:-1, 1:-1] if use_pencil
                           else grid[1:-1, 1:-1, 1:-1], bdim)
        ok_gen = compare_arrays(gotg, want, 1e-4)

        if not (ok_bri and ok_gen):
            raise RuntimeError(f"result mismatch! {name} "
                               f"bri={ok_bri} gen={ok_gen}")
        results[name] = dict(arr=t_arr, bri=t_bri, gen=t_gen)
    return results


def copy_bench(n: int = 256, bdim=(8, 8, 128), tot_time: float = 2.0):
    """Layout copy benchmark (ref: stencils/copy.cpp): dense<->brick
    transforms and brick-to-brick copy, in GB/s."""
    import jax
    import jax.numpy as jnp

    from ..bench.timing import time_func
    from ..core import init_grid

    gdims = tuple(n // b for b in bdim)
    grid, info = init_grid(gdims)
    gridj = jnp.asarray(grid)
    dense = jax.random.uniform(jax.random.PRNGKey(0), (n, n, n),
                               jnp.float32)
    nb = info.nbricks
    bel = int(np.prod(bdim))

    from ..core.setup import to_bricks as tb, from_bricks as fb

    to_b = jax.jit(lambda a: tb(a, grid, bdim))
    dat = to_b(dense)
    from_b = jax.jit(lambda d: fb(d, grid, bdim))
    cp = jax.jit(lambda d: d * 1.0)

    gb = n ** 3 * 4 * 2 / 1e9
    for name, fn, x in (("toBrick", to_b, dense),
                        ("fromBrick", from_b, dat),
                        ("brickCopy", cp, dat)):
        t = time_func(fn, x, tot_time=tot_time, chain=False)
        print(f"  {name}: {t:.6f}s  {gb / t:7.1f} GB/s")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-n", type=int, default=256, help="domain edge")
    p.add_argument("-b", "--bdim", default="8,8,128")
    p.add_argument("--stencils", default="s7pt,s27pt,cond")
    p.add_argument("--tot-time", type=float, default=2.0)
    p.add_argument("--no-pencil", action="store_true")
    p.add_argument("--copy", action="store_true",
                   help="layout copy benchmark instead of stencils")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU platform")
    a = p.parse_args(argv)
    import jax

    from ..utils.compile_cache import enable_compile_cache

    if a.cpu:
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()
    if a.copy:
        print("copy")
        copy_bench(a.n, tuple(int(x) for x in a.bdim.split(",")),
                   a.tot_time)
        return
    run(a.n, tuple(int(x) for x in a.bdim.split(",")),
        tuple(a.stencils.split(",")), a.tot_time, pencil=not a.no_pencil)


if __name__ == "__main__":
    main()
