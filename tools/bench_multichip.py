#!/usr/bin/env python
"""One-command multi-device exchange measurement.

Measures, on whatever device mesh it finds (the GPUs when present;
``--cpu N`` re-execs onto N virtual CPU host devices — the reference's
single-box ``mpirun -np N`` CI trick):

- the HONEST distributed step (SHIFT ghost exchange + ST_ITER sweeps,
  one jit), per-iteration;
- the same step with the exchange removed -> **exchange share**
  (the <10%-overlap gate of BASELINE.md:33 is judged on this number);
- the exchange alone (calltime+waittime analog — the collectives have
  no pack phase, the layout is pack-free by construction).

Emits one JSON object with the reference's phase taxonomy
(packtime/calltime/waittime/movetime/calctime, min/avg/max/sigma —
ref: include/brick-mpi.h:23,758-793; weak/main.cpp:229-251) and the
derived GStencil/s.  Protocol: MPI_ITER=25 dependent-chained
iterations after warm-up (ref: stencils/fake.h:393-404).

    python tools/bench_multichip.py                 # real mesh
    python tools/bench_multichip.py --cpu 8         # CI dryrun
    python tools/bench_multichip.py --mesh 4,2,1 --domain 64,64,512
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cpu", type=int, metavar="N", default=0,
                    help="run on N virtual CPU host devices (CI mode)")
    ap.add_argument("--mesh", default=None,
                    help="mesh shape mz,my,mx (default: all devices "
                         "along the outermost axis)")
    ap.add_argument("--slices", type=int, default=1,
                    help="two-level topology: nodes x card mesh, node "
                         "axis composed with domain axis 0")
    ap.add_argument("--domain", default=None,
                    help="PER-DEVICE owned elements kz,ky,kx (default "
                         "512,512,512 on GPUs — the repo's weak-scaling "
                         "size per card / 16,16,32 on CPU)")
    ap.add_argument("--stencil", default="s7pt")
    ap.add_argument("--st-iter", type=int, default=8)
    ap.add_argument("--iters", type=int, default=25)
    ap.add_argument("--json", dest="as_json", action="store_true")
    args = ap.parse_args(argv)

    if args.cpu and os.environ.get("BRICK_MC_REEXEC") != "1":
        # host device count must be fixed before jax initializes, so
        # re-exec with it set
        env = dict(os.environ)
        env["BRICK_MC_REEXEC"] = "1"
        env["JAX_PLATFORMS"] = "cpu"
        flags = env.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            env["XLA_FLAGS"] = (flags + " --xla_force_host_platform_"
                                f"device_count={args.cpu}").strip()
        return subprocess.call([sys.executable, os.path.abspath(
            __file__)] + [a for a in (argv or sys.argv[1:])], env=env)

    sys.path.insert(0, __file__.rsplit("/", 2)[0])

    import jax

    from brickjax.utils.compile_cache import enable_compile_cache

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()

    import numpy as np
    import jax.numpy as jnp

    from brickjax.bench.timing import (PhaseTimers, mpi_statistics,
                                           time_mpi)
    from brickjax.codegen.sweep import pencil_sweep
    from brickjax.comm import BrickDecomp, skinlist_by_name
    from brickjax.comm.exchange import exchange_shift
    from brickjax.comm.mesh import make_domain_mesh, shard_map
    from brickjax.stencils import bench_params, stencil_by_name

    ndev = len(jax.devices())
    on_gpu = jax.default_backend() == "gpu"
    if args.mesh:
        mesh_shape = tuple(int(x) for x in args.mesh.split(","))
    else:
        mesh_shape = (ndev, 1, 1)
    slices = max(1, int(args.slices))
    eff_shape = (slices * mesh_shape[0],) + mesh_shape[1:]
    n = int(np.prod(eff_shape))
    if n > ndev:
        print(f"ERROR: {slices} nodes x mesh {mesh_shape} needs {n} "
              f"devices, have {ndev}", file=sys.stderr)
        return 2
    if args.domain:
        dims = tuple(int(x) for x in args.domain.split(","))
    else:
        dims = (512, 512, 512) if on_gpu else (16, 16, 32)
    BD = (8, 8, dims[2]) if on_gpu else (4, 4, dims[2])
    params = bench_params()
    sd = stencil_by_name(args.stencil)[0]
    ST = args.st_iter

    dec = BrickDecomp(dims=dims, ghost_depth=(BD[0], BD[1], 0),
                      bdims=BD).initialize(skinlist_by_name("good", 3))
    nb = dec.nbricks
    GK, GJ = dec.grid.shape[0], dec.grid.shape[1]
    table_axes = tuple(a for a in range(3) if eff_shape[a] == 1)
    kgrid = dec.periodic_grid(table_axes)
    if slices > 1:
        from brickjax.comm.mesh import make_multislice_mesh

        mesh, xnames, _eff = make_multislice_mesh(slices, mesh_shape)
    else:
        mesh = make_domain_mesh(mesh_shape)
        xnames = mesh.axis_names
    names = mesh.axis_names
    from jax.sharding import NamedSharding, PartitionSpec as P
    P_ = P(tuple(names))

    def rng(skip):
        return dict(k_range=((1, GK - 1) if 0 in table_axes
                             else (skip, GK - skip)),
                    j_range=((1, GJ - 1) if 1 in table_axes
                             else (skip, GJ - skip)))

    k_skip = pencil_sweep(sd, kgrid, BD, nb, params, **rng(1))
    k_ghost = pencil_sweep(sd, kgrid, BD, nb, params, **rng(0))

    def honest(d):
        d = exchange_shift(d, dec, xnames, eff_shape,
                           table_axes=table_axes)
        for _ in range(ST - 1):
            d = k_ghost(d)
        return k_skip(d)

    def noex(d):
        for _ in range(ST - 1):
            d = k_ghost(d)
        return k_skip(d)

    def exch_only(d):
        return exchange_shift(d, dec, xnames, eff_shape,
                              table_axes=table_axes)

    def wrap(f):
        return jax.jit(shard_map(f, mesh, P_, P_), donate_argnums=0)

    sharding = NamedSharding(mesh, P_)
    rng_ = np.random.default_rng(0)

    def fresh():
        return jax.device_put(jnp.asarray(rng_.standard_normal(
            (n * nb,) + BD).astype(np.float32)), sharding)

    legs = {
        "honest": (wrap(honest), ST),
        "noex": (wrap(noex), ST),
        "exchange": (wrap(exch_only), 1),
    }

    res_legs = {}
    samples = {}
    for name, (fn, per) in legs.items():
        avg, samp = time_mpi(fn, fresh(), iters=args.iters)
        res_legs[name] = avg / per
        samples[name] = [s / per for s in samp]

    t = PhaseTimers()
    # pack-free layout and no host staging: pack/move are structurally
    # zero
    t.calltime = res_legs["exchange"]
    t.calctime = res_legs["noex"]
    t.waittime = max(0.0, res_legs["honest"] - res_legs["noex"]
                     - res_legs["exchange"])
    t.samples["calltime"] = samples["exchange"]
    t.samples["calctime"] = samples["noex"]

    elems = n * int(np.prod(dims))
    honest_it = res_legs["honest"]
    share = max(0.0, (honest_it - res_legs["noex"]) / honest_it)
    out = {
        "devices": n, "mesh": list(mesh_shape), "slices": slices,
        "backend": jax.default_backend(),
        "domain_per_device": list(dims), "brick": list(BD),
        "stencil": args.stencil, "st_iter": ST, "iters": args.iters,
        "per_iter_ms": round(honest_it * 1e3, 3),
        "gstencil_s": round(elems / honest_it / 1e9, 3),
        "exchange_share": round(share, 4),
        "exchange_ms": round(res_legs["exchange"] * 1e3, 3),
        "noex_ms": round(res_legs["noex"] * 1e3, 3),
        "phases": t.report(),
        "honest_spread": mpi_statistics(samples["honest"]),
        "gate": {"target_exchange_share": 0.10,
                 "met": bool(share < 0.10),
                 "note": ("CPU dryrun: shares are not device "
                          "evidence" if not on_gpu else
                          "real-mesh measurement")},
    }
    print(json.dumps(out) if args.as_json else json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
