"""Strong-scaling driver: fixed global domain over a growing mesh via
the two-level decomposition (ref: strong/main.cpp:73-482,
strong/args.cpp:16-26; CLI -d global domain, -s subdomain, -I
iterations, -v validate).

Backends: "pencil" (window sweeps — subdomains keep the full global
i extent so i stays table-periodic via rolls and only k/j exchange;
the batched sweep runs all local subdomains at once) or "jnp"
(halo-extend executor, any subdomain shape).  "auto" picks pencil.
"""

from __future__ import annotations

import argparse

import numpy as np


def run(dom=(64, 64, 64), sdom=(32, 32, 32), bdim=(4, 4, 8),
        stencil="mpi7pt", st_iter=1, mesh_shape=(2, 1, 1), iters=25,
        validate=False, backend="auto", fuse=1):
    """One strong-scaling configuration.  Returns ``{"step": seconds
    per step, "input": the global array, "result": the global array
    after one step}``; ``result`` is gathered only with ``validate``,
    which also checks it against the dense twin."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..bench.timing import mpi_statistics, time_mpi
    from ..codegen import brick_apply, dense_apply
    from ..comm import skin3d_good
    from ..comm.mesh import make_domain_mesh, shard_map
    from ..comm.strong import StrongDecomp, exchange_strong_shift
    from ..core import compare_arrays, from_bricks, random_array, to_bricks
    from ..stencils import DEFAULT_PARAMS, stencil_by_name

    sd = stencil_by_name(stencil)[0]
    gname = next(iter(sd.inputs))
    lo, hi = sd.radius()
    rad = max(max(lo), max(hi))
    if backend == "auto":
        backend = "pencil"
    cubic = backend == "pencil" and (sdom[2] != dom[2]
                                     or mesh_shape[2] != 1)
    if backend == "pencil" and not cubic:
        bdim = (bdim[0], bdim[1], sdom[2])
        gz = (bdim[0], bdim[1], 0)
        if st_iter * rad > min(bdim[0], bdim[1]):
            raise ValueError("st_iter x radius exceeds ghost depth")
    else:
        gz = tuple(bdim)
        if cubic and st_iter * rad > min(bdim):
            # deep-ghost bound: every iteration contaminates the ghost
            # shell radius elements deeper on ALL axes (incl. i)
            raise ValueError("st_iter x radius exceeds ghost depth")
    plan = StrongDecomp(dom=dom, sdom=sdom, mesh_shape=mesh_shape,
                        bdims=bdim, ghost_depth=gz).initialize(skin3d_good)
    sdec = plan.sdec
    adj = jnp.asarray(sdec.info.adj)
    mesh = make_domain_mesh(mesh_shape)
    names = mesh.axis_names
    P_ = P(*names)
    nlead = len(mesh_shape)

    g = random_array(dom, np.float32, seed=4)
    nloc = plan.nsub_local
    nb = sdec.nbricks
    stacked = np.zeros(mesh_shape + (nloc, nb) + tuple(bdim), np.float32)
    for c in np.ndindex(*mesh_shape):
        for row in range(nloc):
            lc = plan.sub_order[row]
            base = tuple(c[a] * plan.local_block[a] + lc[a]
                         for a in range(3))
            idx = [(np.arange(base[a] * sdom[a] - gz[a],
                              base[a] * sdom[a] + sdom[a] + gz[a])
                    % dom[a]) for a in range(3)]
            dat = np.zeros((nb, int(np.prod(bdim))), np.float32)
            to_bricks(g[np.ix_(*idx)], sdec.grid, bdim, dat=dat)
            dat[sdec.sep_pos[1]:] = 0
            stacked[c + (row,)] = dat.reshape((nb,) + tuple(bdim))

    sweep_skip = sweep_ghost = None
    if backend == "pencil":
        from ..codegen.sweep import pencil_sweep

        if st_iter % fuse:
            raise ValueError("st_iter must be a multiple of fuse")
        if cubic:
            # the reference's canonical strong config: CUBIC subdomains
            # (512^3 -> 128^3, strong/args.cpp:32) — the i-bricked
            # unified sweep assembles each row's i-ghost halo; deep-
            # ghost ST_ITER runs ghost-inclusive sweeps on ALL axes
            # (i_range (0, GI)) between exchanges
            GKs, GJs, GIs = sdec.grid.shape
            sweep_skip = pencil_sweep(
                sd, sdec.grid, bdim, nloc * nb, DEFAULT_PARAMS,
                batch=nloc, batch_stride=nb, i_ghost=1,
                k_range=(1, GKs - 1), j_range=(1, GJs - 1), fuse=fuse)
            if st_iter > fuse:
                sweep_ghost = pencil_sweep(
                    sd, sdec.grid, bdim, nloc * nb, DEFAULT_PARAMS,
                    batch=nloc, batch_stride=nb, i_ghost=1,
                    k_range=(0, GKs), j_range=(0, GJs),
                    i_range=(0, GIs), fuse=fuse)
        else:
            kgrid = sdec.periodic_grid((2,))
            GKs, GJs = kgrid.shape[0], kgrid.shape[1]
            sweep_skip = pencil_sweep(
                sd, kgrid, bdim, nloc * nb, DEFAULT_PARAMS,
                batch=nloc, batch_stride=nb, fuse=fuse)
            if st_iter > fuse:
                sweep_ghost = pencil_sweep(
                    sd, kgrid, bdim, nloc * nb, DEFAULT_PARAMS,
                    k_range=(0, GKs), j_range=(0, GJs),
                    batch=nloc, batch_stride=nb, fuse=fuse)

    def step(batch):
        x = batch[(0,) * nlead]
        x = exchange_strong_shift(x, plan, names)
        if sweep_skip is not None:
            flat = x.reshape((nloc * nb,) + tuple(bdim))
            nsweeps = st_iter // fuse
            for it in range(nsweeps):
                last = it == nsweeps - 1
                flat = (sweep_skip if (last or sweep_ghost is None)
                        else sweep_ghost)(flat)
            x = flat.reshape(x.shape)
        else:
            for it in range(st_iter):
                out = jax.vmap(lambda v: brick_apply(
                    sd, {gname: v}, adj, DEFAULT_PARAMS))(x)
                x = out
        return x[(None,) * nlead]

    sharded = jax.device_put(jnp.asarray(stacked),
                             NamedSharding(mesh, P_))
    step_j = jax.jit(shard_map(step, mesh, P_, P_), donate_argnums=0)

    res = {"input": g, "result": None}
    if validate:
        out = np.asarray(step_j(jnp.copy(sharded)))
        full = np.zeros(dom, np.float32)
        # pad by the stencil's own radius so the dense twin lines up for
        # every corpus stencil (radius-2/4 star, 5^3 cube), not just r=1
        b = g
        for _ in range(st_iter):
            gp = np.pad(b, list(zip(lo, hi)), mode="wrap")
            b = dense_apply(sd, {gname: gp}, DEFAULT_PARAMS, xp=np)
        want_g = b
        for c in np.ndindex(*mesh_shape):
            for row in range(nloc):
                lc = plan.sub_order[row]
                base = tuple(c[a] * plan.local_block[a] + lc[a]
                             for a in range(3))
                sl = tuple(slice(base[a] * sdom[a],
                                 (base[a] + 1) * sdom[a])
                           for a in range(3))
                got = from_bricks(
                    out[c + (row,)].reshape(nb, -1),
                    sdec.interior_grid(), bdim)
                full[sl] = got
                if not compare_arrays(got, want_g[sl], 1e-4):
                    raise RuntimeError(f"mismatch at {c} sub {row}")
        print("validated against global dense twin: OK")
        res["result"] = full

    avg, samples = time_mpi(step_j, jnp.copy(sharded), iters=iters)
    elems = int(np.prod(dom)) * st_iter
    print(f"dom {dom} sdom {sdom} mesh {mesh_shape} "
          f"subs/device {nloc} stencil {stencil} backend {backend}")
    print(f"perf {elems / avg / 1e9:8.3f} GStencil/s "
          f"({avg * 1e3:.3f} ms/step)")
    st = mpi_statistics(samples)
    print(f"  step min {st['min']*1e3:7.3f} avg {st['avg']*1e3:7.3f} "
          f"max {st['max']*1e3:7.3f} sigma {st['sigma']*1e3:7.3f} ms")
    res["step"] = avg
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-d", "--dom", default="64,64,64")
    p.add_argument("-s", "--sdom", default="32,32,32")
    p.add_argument("-b", "--bdim", default="4,4,8")
    p.add_argument("--stencil", default="mpi7pt")
    p.add_argument("-I", "--st-iter", type=int, default=1)
    p.add_argument("--mesh", default="2,1,1")
    p.add_argument("--iters", type=int, default=25)
    p.add_argument("-v", "--validate", action="store_true")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "jnp", "pencil"])
    p.add_argument("--fuse", type=int, default=1,
                   help="stencil levels fused per sweep window "
                        "(pencil backend)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU platform (with XLA_FLAGS="
                        "--xla_force_host_platform_device_count=N for "
                        "an N-device mesh)")
    a = p.parse_args(argv)
    import jax

    from ..utils.compile_cache import enable_compile_cache

    if a.cpu:
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()
    run(tuple(int(x) for x in a.dom.split(",")),
        tuple(int(x) for x in a.sdom.split(",")),
        tuple(int(x) for x in a.bdim.split(",")),
        a.stencil, a.st_iter,
        tuple(int(x) for x in a.mesh.split(",")),
        a.iters, a.validate, a.backend, a.fuse)


if __name__ == "__main__":
    main()
