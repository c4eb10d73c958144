#!/usr/bin/env python
"""Headline benchmark: 512^3 7pt star stencil on bricks, one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
``vs_baseline`` is achieved GStencil/s over the speed-of-light GStencil/s
implied by a copy roofline measured in the same run (2 x 4 B moved per
element) — the BASELINE.md target ("512^3 7pt at >= 90% of the
memory-bandwidth roofline").

Every item is timed in interleaved rounds and the minimum per item is
kept (noise only adds time); ratios are of adjacently measured minima.
The headline is the distributed configuration: ghost bricks + SHIFT
exchange + deep-ghost ST_ITER=8 (7 ghost-inclusive sweeps + 1 owned
sweep per exchange, ref: weak/main.cpp:203-212), per iteration.

Needs a GPU: it exits non-zero, printing no result, where JAX finds
none.
"""

import json
import subprocess
import sys


def _card() -> str:
    """``name, power limit`` as nvidia-smi reports them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else ""


def main():
    import jax

    if jax.devices()[0].platform != "gpu":
        print(f"bench.py needs a GPU; JAX found "
              f"{jax.devices()[0].platform}", file=sys.stderr)
        return 1

    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from brickjax.bench.roofline import chain, make_copy
    from brickjax.bench.roofline import rep as _rep
    from brickjax.codegen.autodiff import differentiable_pencil_sweep
    from brickjax.codegen.sweep import pencil_sweep
    from brickjax.comm import BrickDecomp, skinlist_by_name
    from brickjax.comm.exchange import exchange_shift
    from brickjax.comm.mesh import make_domain_mesh, shard_map
    from brickjax.comm.strong import StrongDecomp, exchange_strong_shift
    from brickjax.core import init_grid
    from brickjax.st import ConstRef, Grid, Index
    from brickjax.st.loader import load_stencil_module
    from brickjax.stencils import bench_params, stencil_by_name
    from brickjax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    N = 512
    BD = (8, 8, N)       # pencil bricks: one brick spans the i extent
    iters = 3            # outer chained jit calls per round
    R = 8                # sweeps inside one jit call
    rounds = 3
    ST_ITER = 8

    dec = BrickDecomp(dims=(N, N, N), ghost_depth=(BD[0], BD[1], 0),
                      bdims=BD).initialize(skinlist_by_name("good", 3))
    params = bench_params()
    nb = dec.nbricks
    GK, GJ = dec.grid.shape[0], dec.grid.shape[1]
    s7 = stencil_by_name("s7pt")[0]

    def rep(f, r=R):
        return _rep(f, r)

    # single-device periodicity through the grid table (zero-copy
    # links): ghost cells redirect to wrapped owned bricks
    tgrid = dec.periodic_grid((0, 1, 2))
    k7 = rep(pencil_sweep(s7, tgrid, BD, nb, params))
    k125 = rep(pencil_sweep(stencil_by_name("mpi125pt")[0], tgrid, BD,
                            nb, params))
    k7bf = rep(pencil_sweep(s7, tgrid, BD, nb, params,
                            dtype=jnp.bfloat16))

    # TRAINING step: forward + exact pullback of the linear step, one
    # window level (f1) or four (f4) per call
    dk_f4 = differentiable_pencil_sweep(s7, tgrid, BD, nb, params,
                                        fuse=4)
    dk_f1 = differentiable_pencil_sweep(s7, tgrid, BD, nb, params)
    TR = R // 2

    def train_of(kern):
        def one(d):
            out, vjp = jax.vjp(kern, d)
            return vjp(out)[0]
        return rep(one, TR)

    train_f4, train_f1 = train_of(dk_f4), train_of(dk_f1)

    # THE HEADLINE: real ghost bricks + SHIFT exchange + deep-ghost
    # ST_ITER=8; i stays periodic within the pencil bricks
    def honest_of(dtype):
        skip = pencil_sweep(s7, dec.grid, BD, nb, params, dtype=dtype)
        ghost = pencil_sweep(s7, dec.grid, BD, nb, params, dtype=dtype,
                             k_range=(0, GK), j_range=(0, GJ))

        def sweeps(d):
            for _ in range(ST_ITER - 1):
                d = ghost(d)
            return skip(d)

        def step(d):
            return sweeps(exchange_shift(d, dec, ("x", "y", "z"),
                                         (1, 1, 1), table_axes=(2,)))

        return (jax.jit(step, donate_argnums=0),
                jax.jit(sweeps, donate_argnums=0))

    honest, noex = honest_of(jnp.float32)
    honest_bf16, _ = honest_of(jnp.bfloat16)

    # strong scaling: the reference's canonical 512^3 -> 128^3-class
    # subdomains (strong/args.cpp:32) in pencil form (128, 128, 512) x
    # 16 on one card: batched sweeps over the subdomain stack + the
    # staged SHIFT exchange
    SDOM = (N // 4, N // 4, N)
    splan = StrongDecomp(dom=(N, N, N), sdom=SDOM, mesh_shape=(1, 1, 1),
                         bdims=BD, ghost_depth=(BD[0], BD[1], 0)
                         ).initialize(skinlist_by_name("good", 3))
    snb, nloc = splan.sdec.nbricks, splan.nsub_local
    skg = splan.sdec.periodic_grid((2,))
    s_skip = pencil_sweep(s7, skg, BD, nloc * snb, params, batch=nloc,
                          batch_stride=snb)
    s_ghost = pencil_sweep(s7, skg, BD, nloc * snb, params, batch=nloc,
                           batch_stride=snb, k_range=(0, skg.shape[0]),
                           j_range=(0, skg.shape[1]))
    smesh = make_domain_mesh((1, 1, 1))
    sP = P(*smesh.axis_names)

    def strong_step(b):
        x = exchange_strong_shift(b[0, 0, 0], splan, smesh.axis_names)
        flat = x.reshape((nloc * snb,) + BD)
        for _ in range(ST_ITER - 1):
            flat = s_ghost(flat)
        return s_skip(flat).reshape(x.shape)[None, None, None]

    strong = jax.jit(shard_map(strong_step, smesh, sP, sP),
                     donate_argnums=0)

    # 2-D 9pt box on whole-row pencils at 16384^2 (1 GiB storage)
    N2 = 16384
    BD2 = (8, N2)
    i2, j2 = Index(0), Index(1)
    g2, o2 = Grid("in", 2), Grid("out", 2)
    o2(i2, j2).assign(
        ConstRef("0.4") * g2(i2, j2)
        + ConstRef("0.1") * (g2(i2 + 1, j2) + g2(i2 - 1, j2)
                             + g2(i2, j2 + 1) + g2(i2, j2 - 1))
        + ConstRef("0.02") * (g2(i2 + 1, j2 + 1) + g2(i2 - 1, j2 + 1)
                              + g2(i2 + 1, j2 - 1) + g2(i2 - 1, j2 - 1)))
    sd2 = load_stencil_module({"STENCIL": [o2]})[0]
    grid2, info2 = init_grid((N2 // BD2[0] + 2, 1))
    t2d = grid2[:, 0].copy()
    t2d[0], t2d[-1] = t2d[-2], t2d[1]     # periodic y table
    nb2 = info2.nbricks
    k2d = rep(pencil_sweep(sd2, t2d, BD2, nb2, {}))

    copy = rep(make_copy())

    def fresh(seed, shape=(nb,) + BD, dtype=jnp.float32):
        return jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                  jnp.float32).astype(dtype)

    # per nominal iteration: R for rep-items, ST_ITER for whole steps
    items = {"copy": (copy, R, fresh(0)),
             "copy_bf16": (copy, R, fresh(1, dtype=jnp.bfloat16)),
             "7pt": (k7, R, fresh(2)),
             "125pt": (k125, R, fresh(3)),
             "7pt_bf16": (k7bf, R, fresh(4, dtype=jnp.bfloat16)),
             "honest": (honest, ST_ITER, fresh(5)),
             "noex": (noex, ST_ITER, fresh(6)),
             "honest_bf16": (honest_bf16, ST_ITER,
                             fresh(7, dtype=jnp.bfloat16)),
             "strong": (strong, ST_ITER, jax.device_put(
                 fresh(8, (1, 1, 1, nloc, snb) + BD),
                 NamedSharding(smesh, sP))),
             "2d_9pt": (k2d, R, fresh(9, (nb2,) + BD2)),
             "copy_2d": (copy, R, fresh(10, (nb2,) + BD2)),
             "train_f4": (train_f4, 4 * TR, fresh(11)),
             "train_f1": (train_f1, TR, fresh(12))}
    times = {k: [] for k in items}
    bufs = {k: v[2] for k, v in items.items()}
    for _ in range(rounds):
        for k, (fn, per, _b) in items.items():
            dt, bufs[k] = chain(fn, bufs[k], iters)
            times[k].append(dt / per)
    best = {k: min(v) for k, v in times.items()}
    spread = {k: (max(v) - min(v)) / min(v) for k, v in times.items()}

    elems = N ** 3
    sol_bw = 2 * elems * 4 / best["copy"]
    sol_gst = sol_bw / (2 * 4) / 1e9
    honest_iter = best["honest"]
    exch_delta = honest_iter - best["noex"]
    gst = elems / honest_iter / 1e9
    dev = jax.devices()[0]

    def ms(k):
        return best[k] * 1e3

    print(json.dumps({
        "metric": "7pt_512cubed_brick_stencil",
        "value": gst,
        "unit": "GStencil/s",
        "vs_baseline": gst / sol_gst,
        "details": {
            "config": (f"ghost bricks + SHIFT exchange, ST_ITER="
                       f"{ST_ITER}, per-iteration"),
            "per_iter_ms": ms("honest"),
            "exchange_share": max(0.0, exch_delta / honest_iter),
            "exchange_delta_ms": exch_delta * 1e3,
            "domain": N,
            "brick": list(BD),
            "sol_gstencil_s": sol_gst,
            "sol_copy_gb_s": sol_bw / 1e9,
            "spread": spread,
            "rounds": rounds,
            "plain_sweep": {"sweep_ms": ms("7pt"),
                            "vs_sol": best["copy"] / best["7pt"]},
            "125pt_step_ms": ms("125pt"),
            "125pt_vs_sol": best["copy"] / best["125pt"],
            "bf16_sweep_ms": ms("7pt_bf16"),
            "bf16_honest": {
                "per_iter_ms": ms("honest_bf16"),
                "vs_bf16_sol": best["copy_bf16"] / best["honest_bf16"]},
            "strong": {
                "config": (f"{N}^3 -> {N // 4}x{N // 4}x{N} x 16 on one "
                           f"card, SHIFT exchange, ST_ITER={ST_ITER}"),
                "per_iter_ms": ms("strong"),
                "vs_sol": best["copy"] / best["strong"]},
            "pencil_2d": {
                "config": f"{N2}^2 9pt box, brick {BD2}",
                "per_iter_ms": ms("2d_9pt"),
                "vs_2d_sol": best["copy_2d"] / best["2d_9pt"]},
            "training": {
                "config": ("7pt fwd+exact-VJP per stencil step; f4 = "
                           "one fwd + adjoint sweep of 4 levels"),
                "f4_per_iter_ms": ms("train_f4"),
                "f1_per_iter_ms": ms("train_f1")},
            "backend": dev.platform,
            "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "card": _card(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
