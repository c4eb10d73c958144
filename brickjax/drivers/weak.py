"""Weak-scaling driver: ghost exchange + iterated stencil over a device
mesh, validated against the array-exchange twin
(ref: weak/main.cpp:38-306, weak/args.cpp:16-28).

CLI mirrors the reference: -d per-device domain, -s stencil, -I
iterations between exchanges (ST_ITER), --mesh devices per axis.
Reports the reference's metrics: perf GStencil/s, exchange GB/s,
phase statistics (calc/call+wait as 'comm') across steps
(ref: weak/main.cpp:229-251, brick-mpi.h:768-793).
"""

from __future__ import annotations

import argparse

import numpy as np


def run(dims=(64, 64, 64), bdim=(8, 8, 128), stencil="mpi7pt",
        st_iter=8, mesh_shape=(1, 1, 1), iters=25, validate=True,
        overlap=False, backend="jnp", profile_dir=None,
        exchange="shift", table_periodic=True, skin="good",
        f64_validate=False, fuse=1):
    """backend="jnp" (halo-extend executor) or "pencil" (window sweeps:
    bricks become whole-i pencils, ghost only in the outer axes, and the
    exchange moves pencil bricks over the mesh).

    ``table_periodic=False`` disables the zero-copy table wrap on
    1-device axes so they exchange real ghost bricks via in-place
    self-copies — the honest distributed configuration on any device
    count (how the reference's np=1 torus run exercises all 26 exchange
    directions)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..bench.timing import mpi_statistics, time_mpi
    from ..codegen import brick_apply, dense_apply
    from ..comm import BrickDecomp, skinlist_by_name
    from ..comm.exchange import exchange_put, exchange_shift
    from ..comm.mesh import make_domain_mesh, shard_map
    from ..core import (compare_arrays, from_bricks, random_array,
                        to_bricks)
    from ..stencils import DEFAULT_PARAMS, stencil_by_name

    sd = stencil_by_name(stencil)[0]
    gname = next(iter(sd.inputs))
    nd = len(dims)
    lo_r, hi_r = sd.radius()
    rad = max(max(lo_r), max(hi_r))
    if backend == "pencil":
        if nd not in (3, 4) or mesh_shape[-1] != 1:
            raise ValueError("pencil backend: 3-D or 4-D, innermost "
                             "axis undistributed")
        bdim = tuple(bdim[:nd - 1]) + (dims[-1],)
        gz = tuple(bdim[:nd - 1]) + (0,)
        # deep-ghost ST_ITER bound (ref: weak/main.cpp:203-212): every
        # iteration contaminates the ghost ring radius elements deeper;
        # st_iter sweeps between exchanges stay exact in the owned
        # region iff st_iter*radius fits in the ghost depth.  Axes that
        # are table-periodic (1 device) are exact every iteration.
        if ((any(m > 1 for m in mesh_shape) or not table_periodic)
                and st_iter * rad > min(bdim[:nd - 1])):
            raise ValueError(
                f"st_iter {st_iter} x radius {rad} exceeds ghost depth "
                f"{min(bdim[:nd - 1])}")
    else:
        gz = tuple(bdim)
    dec = BrickDecomp(dims=dims, ghost_depth=gz, bdims=bdim).initialize(
        skinlist_by_name(skin, nd))
    # layout-quality report (ref: the good/normal/bad comparison of
    # src/brick-mpi.cpp:54-136): each contiguous ghost run is one PUT
    # message; the good ordering minimizes the count
    print(f"skin ordering '{skin}': {len(dec.ghost)} ghost runs "
          f"(PUT messages), {len(dec.sections)} sections")
    adj = jnp.asarray(dec.info.adj)
    mesh = make_domain_mesh(mesh_shape)
    names = mesh.axis_names
    P_ = P(tuple(names))  # devices stack along the brick axis

    # per-device data: global periodic domain split over the mesh.
    # Devices stack along the BRICK axis (device block = its [nbricks,
    # step] storage) so shard_map hands each device its storage with no
    # reshapes.
    gshape = tuple(m * d for m, d in zip(mesh_shape, dims))
    g = random_array(gshape, np.float32, seed=3)
    ndev = int(np.prod(mesh_shape))
    stacked = np.zeros((ndev * dec.nbricks,) + tuple(bdim), np.float32)
    blocks = {}
    for r, c in enumerate(np.ndindex(*mesh_shape)):
        idx = [(np.arange(c[a] * dims[a] - gz[a],
                          c[a] * dims[a] + dims[a] + gz[a]) % gshape[a])
               for a in range(nd)]
        blocks[c] = g[np.ix_(*idx)]
        dat = np.zeros((dec.nbricks, int(np.prod(bdim))), np.float32)
        to_bricks(blocks[c], dec.grid, bdim, dat=dat)
        dat[dec.sep_pos[1]:] = 0
        stacked[r * dec.nbricks:(r + 1) * dec.nbricks] = dat.reshape(
            (-1,) + tuple(bdim))

    def do_exchange(d, table_axes=()):
        if exchange == "put":
            return exchange_put(d, dec, names, mesh_shape,
                                table_axes=table_axes)
        return exchange_shift(d, dec, names, mesh_shape,
                              table_axes=table_axes)

    # Iterations between exchanges compute into the ghost region too so
    # validity shrinks from the outer ghost edge (gz deep) instead of the
    # owned boundary; only the LAST iteration skips the ghost ring — the
    # reference's skip parameter (weak/main.cpp:203-212).
    owned_rows = jnp.asarray(np.arange(1, dec.sep_pos[1], dtype=np.int32))

    def one_iter(d, last):
        view = d.reshape((-1,) + tuple(bdim))
        if last:
            out = brick_apply(sd, {gname: view}, adj, DEFAULT_PARAMS,
                              rows=owned_rows)
            return view.at[owned_rows].set(out).reshape(d.shape)
        out = brick_apply(sd, {gname: view}, adj, DEFAULT_PARAMS)
        return out.reshape(d.shape)

    # interior/boundary split (sep_pos): inner bricks never read ghost,
    # so their compute is data-independent of the exchange and XLA can
    # overlap the ppermutes with it (ref: interior-first scheduling idea
    # of weak/main.cu:251-291)
    inner_rows = jnp.asarray(
        np.arange(1, dec.sep_pos[0], dtype=np.int32))
    ring_rows = jnp.asarray(
        np.arange(dec.sep_pos[0], dec.nbricks, dtype=np.int32))

    pencil_fn = pencil_ghost_fn = None
    if backend == "pencil":
        from ..codegen.sweep import pencil_sweep
        from ..stencils import bench_params

        params = bench_params()
        # undistributed axes: periodicity via table indirection, no data
        # movement (zero-copy links); exchange only distributed axes.
        # The i axis never exchanges — pencil rolls are periodic in i.
        table_axes = tuple(
            a for a in range(nd)
            if mesh_shape[a] == 1 and (table_periodic or a == nd - 1))
        kgrid = dec.periodic_grid(table_axes)

        def _ranges(skip):
            # table axes compute owned rows only (their ghost cells
            # redirect to owned bricks — writing them would double-write)
            return {f"{'wkj'[a + 4 - nd]}_range":
                    (1, kgrid.shape[a] - 1) if a in table_axes
                    else (skip, kgrid.shape[a] - skip)
                    for a in range(nd - 1)}

        if fuse > 1:
            # temporal fusion: fuse levels per sweep window; a step is
            # st_iter/fuse fused sweeps (all ghost-inclusive except the
            # last, whose OUTPUT gets skip semantics)
            if st_iter % fuse:
                raise ValueError("st_iter must be a multiple of fuse")
            if overlap:
                raise ValueError("--overlap with fuse>1 not supported")
        pencil_fn = pencil_sweep(sd, kgrid, bdim, dec.nbricks, params,
                                 **_ranges(1), fuse=fuse)
        if st_iter > fuse and len(table_axes) < nd:
            # non-last iterations compute the distributed-axis ghost
            # ring too (deep-ghost mode, ref: weak/main.cpp:203-212)
            pencil_ghost_fn = pencil_sweep(sd, kgrid, bdim, dec.nbricks,
                                           params, **_ranges(0),
                                           fuse=fuse)

        pencil_inner_fn = pencil_ring_fns = None
        if overlap and len(table_axes) < nd and nd == 3:
            # interior/ring split of the first post-exchange sweep
            # (the sep_pos interior-first idea, brick-mpi.h:196;
            # weak/main.cu:251-291): the inner sweep reads no ghost
            # bricks, so XLA can run the ppermutes concurrently; ring
            # sweeps then write their bricks in place (aliased output)
            GK_, GJ_ = kgrid.shape[0], kgrid.shape[1]
            s0 = 0 if st_iter > 1 else 1
            kin = (1, GK_ - 1) if 0 in table_axes else (2, GK_ - 2)
            jin = (1, GJ_ - 1) if 1 in table_axes else (2, GJ_ - 2)
            kfull = (1, GK_ - 1) if 0 in table_axes else (s0, GK_ - s0)
            jfull = (1, GJ_ - 1) if 1 in table_axes else (s0, GJ_ - s0)
            if kin[1] <= kin[0] or jin[1] <= jin[0]:
                raise ValueError(
                    "--overlap needs an interior: per-device grid too "
                    "thin (every owned brick row touches the ghost)")
            pencil_inner_fn = pencil_sweep(
                sd, kgrid, bdim, dec.nbricks, params,
                k_range=kin, j_range=jin)
            parts = []
            if 0 not in table_axes:
                parts.append(((kfull[0], kin[0]), jfull))
                parts.append(((kin[1], kfull[1]), jfull))
            if 1 not in table_axes:
                parts.append((kin, (jfull[0], jin[0])))
                parts.append((kin, (jin[1], jfull[1])))
            pencil_ring_fns = [pencil_sweep(
                sd, kgrid, bdim, dec.nbricks, params,
                k_range=kr, j_range=jr, inplace=True)
                for kr, jr in parts]

    def step(d):
        if pencil_fn is not None:
            it0 = 0
            if pencil_inner_fn is not None:
                # ghost-independent interior first: its compute and the
                # exchange's ppermutes have no data dependence
                inner = pencil_inner_fn(d)
                d = do_exchange(d, table_axes=table_axes)
                out = inner
                for rf in pencil_ring_fns:
                    out = rf(d, out)
                d = out
                it0 = 1
            elif len(table_axes) < nd:
                d = do_exchange(d, table_axes=table_axes)
            nsweeps = st_iter // fuse
            for it in range(it0, nsweeps):
                last = it == nsweeps - 1
                d = pencil_fn(d) if (last or pencil_ghost_fn is None) \
                    else pencil_ghost_fn(d)
            return d
        if overlap:
            view = d.reshape((-1,) + tuple(bdim))
            out_inner = brick_apply(sd, {gname: view}, adj,
                                    DEFAULT_PARAMS, rows=inner_rows)
            d = do_exchange(d)
            view = d.reshape((-1,) + tuple(bdim))
            out_ring = brick_apply(sd, {gname: view}, adj,
                                   DEFAULT_PARAMS, rows=ring_rows)
            view = view.at[inner_rows].set(out_inner)
            view = view.at[ring_rows].set(out_ring)
            d = view.reshape(d.shape)
            for it in range(1, st_iter):
                d = one_iter(d, last=(it == st_iter - 1))
        else:
            d = do_exchange(d)
            for it in range(st_iter):
                d = one_iter(d, last=(it == st_iter - 1))
        return d

    def step_noex(d):
        """The step without its exchange — the exchange cost is
        measured DIFFERENTIALLY (step - step_noex): timing the exchange
        standalone pays a full per-dispatch overhead and overstates its
        share."""
        if pencil_fn is not None:
            nsweeps = st_iter // fuse
            for it in range(nsweeps):
                last = it == nsweeps - 1
                d = pencil_fn(d) if (last or pencil_ghost_fn is None) \
                    else pencil_ghost_fn(d)
            return d
        for it in range(st_iter):
            d = one_iter(d, last=(it == st_iter - 1))
        return d

    sharded = jax.device_put(jnp.asarray(stacked),
                             NamedSharding(mesh, P_))
    # the step rewrites its storage: donate it so updates happen in
    # place.  A single device needs no SPMD wrapper.
    moves_data = not (pencil_fn is not None and len(table_axes) == nd)
    don = dict(donate_argnums=0)
    if ndev > 1:
        step_j = jax.jit(shard_map(step, mesh, P_, P_), **don)
        noex_j = jax.jit(shard_map(step_noex, mesh, P_, P_), **don)
    else:
        step_j = jax.jit(step, **don)
        noex_j = jax.jit(step_noex, **don)

    if validate:
        out = np.asarray(step_j(jnp.copy(sharded)))
        lo, hi = sd.radius()
        ok = True
        for r, (c, blk) in enumerate(blocks.items()):
            b = blk
            for _ in range(st_iter):
                nxt = dense_apply(sd, {gname: b}, DEFAULT_PARAMS, xp=np)
                b2 = np.zeros_like(b)
                b2[tuple(slice(l, s - h) for l, s, h in
                         zip(lo, b.shape, hi))] = nxt
                b = b2
            own = tuple(slice(gz[a], gz[a] + dims[a]) for a in range(nd))
            got = from_bricks(
                out[r * dec.nbricks:(r + 1) * dec.nbricks].reshape(
                    dec.nbricks, -1), dec.interior_grid(), bdim)
            # valid only where st_iter halo sweeps stay inside the block
            m = [st_iter * max(l, h) - gz[a]
                 for a, (l, h) in enumerate(zip(lo, hi))]
            m = [max(x, 0) for x in m]
            sl = tuple(slice(m[a], dims[a] - m[a]) for a in range(nd))
            ok &= compare_arrays(got[sl], b[own][sl], 1e-4)
        if not ok:
            raise RuntimeError("validation mismatch vs array twin")
        print("validated against array twin: OK")

    if f64_validate:
        # honor the reference's 1e-6 brickcompare contract
        # (include/cmpconst.h:9) where it is actually defined: double
        # precision.  The brick layout + executor semantics run in
        # numpy float64 against the float64 dense twin.
        from ..core.compare import BRICK_TOLERANCE

        blk64 = next(iter(blocks.values())).astype(np.float64)
        dat64 = np.zeros((dec.nbricks, int(np.prod(bdim))), np.float64)
        to_bricks(blk64, dec.grid, bdim, dat=dat64)
        view64 = dat64.reshape((-1,) + tuple(bdim))
        b = blk64
        lo, hi = sd.radius()
        for _ in range(st_iter):
            out64 = brick_apply(sd, {gname: view64},
                                np.asarray(dec.info.adj),
                                DEFAULT_PARAMS, xp=np)
            view64 = out64
            nxt = dense_apply(sd, {gname: b}, DEFAULT_PARAMS, xp=np)
            b2 = np.zeros_like(b)
            b2[tuple(slice(l, s - h) for l, s, h in
                     zip(lo, b.shape, hi))] = nxt
            b = b2
        own = tuple(slice(gz[a], gz[a] + dims[a]) for a in range(nd))
        got64 = from_bricks(view64.reshape(dec.nbricks, -1),
                            dec.interior_grid(), bdim)
        m = [max(st_iter * max(l, h) - gz[a], 0)
             for a, (l, h) in enumerate(zip(lo, hi))]
        sl = tuple(slice(m[a], dims[a] - m[a]) for a in range(nd))
        if not compare_arrays(got64[sl], b[own][sl], BRICK_TOLERANCE):
            raise RuntimeError("float64 validation mismatch at 1e-6")
        print(f"validated in float64 at {BRICK_TOLERANCE:g}: OK")

    if profile_dir:
        # jax.profiler trace of a few steps (the tracing-subsystem analog
        # of the reference's omp_get_wtime phase accumulators +
        # nvprof-style runs)
        with jax.profiler.trace(profile_dir):
            out = step_j(jnp.copy(sharded))
            out = step_j(out)
            out.block_until_ready()
        print(f"profiler trace written to {profile_dir}")

    avg, samples = time_mpi(step_j, jnp.copy(sharded), iters=iters)
    if not moves_data:
        # all axes are table-periodic: there IS no exchange
        avg_x, samples_x = 0.0, [0.0]
    else:
        # marginal exchange cost: step minus the same step without its
        # exchange (standalone timing pays per-dispatch overhead)
        avg_nx, samples_x = time_mpi(noex_j, jnp.copy(sharded),
                                     iters=iters)
        avg_x = max(avg - avg_nx, 0.0)

    n_dev = int(np.prod(mesh_shape))
    elems = int(np.prod(gshape)) * st_iter
    ghost_elems = dec.nbricks - dec.sep_pos[1]
    ghost_bytes = ghost_elems * int(np.prod(bdim)) * 4 * n_dev
    print(f"domain {gshape} mesh {mesh_shape} stencil {stencil} "
          f"ST_ITER {st_iter}")
    print(f"perf  {elems / avg / 1e9:8.3f} GStencil/s "
          f"({avg * 1e3:.3f} ms/step)")
    if moves_data:
        print(f"exchange (marginal) {avg_x * 1e3:.3f} ms, "
              f"ghost {ghost_bytes / 1e6:.1f} MB"
              + (f", {2 * ghost_bytes / avg_x / 1e9:.1f} GB/s"
                 if avg_x > 1e-9 else ""))
        print(f"exchange share of step: {avg_x / avg * 100:.1f}%")
    else:
        print("exchange: none (all axes periodic through the table)")
    # five-phase taxonomy (ref: brick-mpi.h:23): pack/move are zero by
    # construction (pack-free exchange, no host staging); call+wait is
    # the exchange, calc the remainder
    phases = {"packtime": 0.0, "calltime+waittime": avg_x,
              "movetime": 0.0, "calctime": max(avg - avg_x, 0.0)}
    print("  phases: " + "  ".join(f"{k} {v*1e3:.3f}ms"
                                   for k, v in phases.items()))
    for nm, s in (("step", samples), ("step-noex", samples_x)):
        st = mpi_statistics(s)
        print(f"  {nm:9s} min {st['min']*1e3:7.3f} avg {st['avg']*1e3:7.3f} "
              f"max {st['max']*1e3:7.3f} sigma {st['sigma']*1e3:7.3f} ms")
    if n_dev > 1:
        # cross-device spread (ref: mpi_statistics across ranks,
        # brick-mpi.h:758-793): same shard-local program timed on each
        # device separately — the slow-rank detector
        from ..bench.timing import device_statistics

        local = jnp.asarray(stacked[:dec.nbricks])
        shard_fn = jax.jit(
            lambda d: brick_apply(sd, {gname: d.reshape((-1,)
                                  + tuple(bdim))}, adj, DEFAULT_PARAMS
                                  ).reshape(d.shape))
        dstat, _per = device_statistics(
            shard_fn, lambda dev: jax.device_put(local, dev),
            devices=mesh.devices.ravel(), iters=min(iters, 5))
        print(f"  devices   min {dstat['min']*1e3:7.3f} "
              f"avg {dstat['avg']*1e3:7.3f} max {dstat['max']*1e3:7.3f} "
              f"sigma {dstat['sigma']*1e3:7.3f} ms (per-device "
              f"shard-local step)")
    return {"step": avg, "exchange": avg_x, "phases": phases}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-d", "--dims", default="64,64,64",
                   help="per-device domain")
    p.add_argument("-b", "--bdim", default="8,8,8")
    p.add_argument("-s", "--stencil", default="mpi7pt")
    p.add_argument("-I", "--st-iter", type=int, default=8)
    p.add_argument("--mesh", default="1,1,1")
    p.add_argument("--iters", type=int, default=25)
    p.add_argument("--no-validate", action="store_true")
    p.add_argument("--overlap", action="store_true",
                   help="interior/boundary split to overlap exchange")
    p.add_argument("--backend", default="jnp", choices=["jnp", "pencil"])
    p.add_argument("--profile", dest="profile_dir", default=None,
                   help="write a jax.profiler trace to this directory")
    p.add_argument("--exchange", default="shift",
                   choices=["shift", "put"],
                   help="SHIFT multi-stage (6 msgs) or PUT (26 msgs)")
    p.add_argument("--no-table-periodic", action="store_true",
                   help="exchange real ghost bricks even on 1-device "
                        "axes (honest distributed config)")
    p.add_argument("--skin", default="good",
                   choices=["good", "normal", "bad", "lex"],
                   help="skin ordering (layout-quality comparison, "
                        "ref: src/brick-mpi.cpp:54-136)")
    p.add_argument("--f64-validate", action="store_true",
                   help="also validate the layout+executor semantics "
                        "in numpy float64 at the 1e-6 brickcompare "
                        "tolerance")
    p.add_argument("--fuse", type=int, default=1,
                   help="stencil levels fused per sweep window "
                        "(pencil backend; must divide st_iter)")
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
    run(tuple(int(x) for x in a.dims.split(",")),
        tuple(int(x) for x in a.bdim.split(",")),
        a.stencil, a.st_iter,
        tuple(int(x) for x in a.mesh.split(",")),
        a.iters, validate=not a.no_validate, overlap=a.overlap,
        backend=a.backend, profile_dir=a.profile_dir,
        exchange=a.exchange, table_periodic=not a.no_table_periodic,
        skin=a.skin, f64_validate=a.f64_validate, fuse=a.fuse)


if __name__ == "__main__":
    main()
