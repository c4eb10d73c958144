#!/usr/bin/env python
"""Proof that the main path runs on an NVIDIA GPU, at real sizes.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --cards 4   # the weak-scaling step on 4 cards

Each phase drives the system through the entry points a user calls
(``Problem`` init/rollout/differentiable_step/exported_step, the strong
driver, ``ooc_sweep``) with seeded random data, and compares the result
with the plain reference: ``dense_apply`` on the same periodic data in
float64 on the card (``jax.grad`` of that dense twin for gradients).
Every phase prints one line — name, shape, ms per stencil iteration,
max abs-or-rel error and its tolerance — and a failed phase fails the
script.  The last line is one JSON object naming the device.

It refuses to run (non-zero exit, no result) where JAX finds no GPU.
One process drives the card(s): a JAX process reserves most of a
card's memory, so the script starts no other process that opens one.
"""

from __future__ import annotations

import argparse
import json
import os
import runpy
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# f32 state: the abs-or-rel tolerance of core/compare.py
F32_TOL = 5e-5
# bf16 storage: every sweep rounds the state to 8 significant bits, so
# the error can grow by one bf16 ulp (2^-8 relative) per sweep
BF16_ULP = 2.0 ** -8

# full sizes (one card / four cards); rehearsals pass smaller ones
FULL = dict(n3=512, n_small=256, n2=16384, d4=(16, 64, 128, 512),
            ooc=1024, sdom=128)


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return r.stdout.strip() or r.stderr.strip()


def _timed(fn, reps=2):
    """min wall seconds of ``fn()`` (which blocks on its result)."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def dense_ref(sdefs, fields, state, aux, iters, params):
    """``iters`` periodic Jacobi steps of the dense twin, float64, on
    the default device."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from brickjax.codegen import dense_apply

    with jax.enable_x64(True):
        pads = [tuple(zip(*sd.radius())) for sd in sdefs]

        def steps(st, aux64):
            def step(_, st):
                vals = dict(aux64, **dict(zip(fields, st)))
                return tuple(
                    dense_apply(sd, {n: jnp.pad(vals[n], pad, mode="wrap")
                                     for n in sd.inputs}, params)
                    for sd, pad in zip(sdefs, pads))
            return lax.fori_loop(0, iters, step, st)

        st = tuple(jnp.asarray(np.asarray(state[f], np.float64))
                   for f in fields)
        aux64 = {n: jnp.asarray(a, jnp.float64) for n, a in aux.items()}
        out = jax.jit(steps)(st, aux64)
        return [np.asarray(o) for o in out]


def err(got, want) -> float:
    from brickjax.core.compare import max_mismatch

    return max_mismatch(np.asarray(got, np.float64), want)


def problem_phase(p, state, aux, rolls, tol_per_sweep=None):
    """init -> rollout(rolls) checked against the f64 twin, then the
    same rollout timed.  Returns (ms per stencil iteration, err, tol)."""
    import jax

    p.init(array=state if p.nfld > 1 else state[p.gname], aux=aux)
    start = {f: (p.result(f) if p.nfld > 1 else p.result())
             for f in p.fields}
    p.rollout(rolls)
    got = [p.result(f) if p.nfld > 1 else p.result() for f in p.fields]
    iters = rolls * p.st_iter
    want = dense_ref(p.sdefs, p.fields, start,
                     {n: aux[n] for n in p.aux_names}, iters, p.params)
    e = max(err(g, w) for g, w in zip(got, want))
    tol = F32_TOL if tol_per_sweep is None else tol_per_sweep * iters
    sec = _timed(lambda: jax.block_until_ready(p.rollout(rolls)._dats))
    return sec / iters * 1e3, e, tol


def _rng(seed):
    return np.random.default_rng(seed)


def _field(shape, seed):
    return _rng(seed).random(shape, dtype=np.float32)


def phase_problem(stencil, dims, st_iter, rolls, seed, **kw):
    from brickjax.api import Problem

    def run():
        p = Problem(dims=dims, stencil=stencil, st_iter=st_iter, **kw)
        ms, e, tol = problem_phase(p, {p.gname: _field(dims, seed)}, {},
                                   rolls,
                                   BF16_ULP if "dtype" in kw else None)
        return dims, ms, e, tol, p.describe()
    return run


def phase_varcoeff(n):
    from brickjax.api import Problem
    from brickjax.st import load_stencil_module

    def run():
        ex = runpy.run_path(os.path.join(ROOT, "examples",
                                         "varcoeff_diffusion.py"))
        sd = load_stencil_module({"STENCIL": ex["STENCIL"]})[0]
        dims = (n, n, n)
        p = Problem(dims=dims, stencil=sd, field="u",
                    params={"dt": 0.05})
        c = 1.0 + _field(dims, 12)
        ms, e, tol = problem_phase(p, {"u": _field(dims, 11)}, {"c": c}, 8)
        return dims, ms, e, tol, p.describe()
    return run


def phase_gray_scott(n):
    from brickjax.api import Problem
    from brickjax.st import load_stencil_module

    def run():
        ex = runpy.run_path(os.path.join(ROOT, "examples", "gray_scott.py"))
        sds = load_stencil_module({"STENCIL": ex["STENCIL"]})
        dims = (n, n, n)
        p = Problem(dims=dims, stencil=sds, field=("u", "v"),
                    params={"dt": 0.8, "Du": 0.16, "Dv": 0.08,
                            "F": 0.035, "K": 0.065})
        st = {"u": 1.0 - 0.5 * _field(dims, 13),
              "v": 0.25 * _field(dims, 14)}
        ms, e, tol = problem_phase(p, st, {}, 8)
        return dims, ms, e, tol, p.describe()
    return run


def phase_2d(n):
    from brickjax.api import Problem
    from brickjax.st import ConstRef, Grid, Index
    from brickjax.st.loader import load_stencil_module

    def run():
        i, j = Index(0), Index(1)
        g, o = Grid("in", 2), Grid("out", 2)
        o(i, j).assign(
            ConstRef("0.4") * g(i, j)
            + ConstRef("0.1") * (g(i + 1, j) + g(i - 1, j)
                                 + g(i, j + 1) + g(i, j - 1))
            + ConstRef("0.02") * (g(i + 1, j + 1) + g(i - 1, j + 1)
                                  + g(i + 1, j - 1) + g(i - 1, j - 1)))
        sd = load_stencil_module({"STENCIL": [o]})[0]
        p = Problem(dims=(n, n), stencil=sd, params={})
        ms, e, tol = problem_phase(p, {"in": _field((n, n), 15)}, {}, 8)
        return (n, n), ms, e, tol, p.describe()
    return run


def phase_grad(kind, n):
    """Exact pullback of one differentiable step vs jax.grad of the
    float64 dense twin."""
    import jax
    import jax.numpy as jnp

    from brickjax.api import Problem
    from brickjax.codegen import dense_apply
    from brickjax.core import from_bricks
    from brickjax.st import load_stencil_module

    def run():
        dims = (n, n, n)
        aux = {}
        if kind == "linear":
            kw = dict(stencil="s7pt")
        elif kind == "polynomial":
            ex = runpy.run_path(os.path.join(ROOT, "examples",
                                             "varcoeff_diffusion.py"))
            kw = dict(stencil=load_stencil_module(
                {"STENCIL": ex["STENCIL"]})[0], field="u",
                params={"dt": 0.05})
            aux = {"c": 1.0 + _field(dims, 22)}
        else:
            kw = dict(stencil="cond")
        p = Problem(dims=dims, **kw)
        pw = Problem(dims=dims, **kw)
        x, w = _field(dims, 20) - 0.45, _field(dims, 21)
        # max(x, 0) has no unique derivative at x == 0 (jax.grad splits
        # the tie); keep the data off the kink
        x[x == 0] = 0.25
        p.init(array=x, aux=aux)
        pw.init(array=w, aux=aux)
        fn = p.differentiable_step()
        wb = jnp.where(p.owned_mask(), pw._dats[0], 0.0)
        args = (p._dats[0],) + tuple(p._aux)
        grad = jax.jit(jax.grad(lambda a, wt: jnp.sum(fn(*a) * wt)))
        got = jax.block_until_ready(grad(args, wb))
        sec = _timed(lambda: jax.block_until_ready(grad(args, wb)))
        sd = p.sdef
        pad = tuple(zip(*sd.radius()))
        with jax.enable_x64(True):
            names = [p.gname] + list(p.aux_names)
            vals = [x] + [aux[a] for a in p.aux_names]

            def loss(a):
                ins = {nm: jnp.pad(v, pad, mode="wrap")
                       for nm, v in zip(names, a)}
                return jnp.sum(dense_apply(sd, ins, p.params)
                               * jnp.asarray(w, jnp.float64))

            want = jax.grad(loss)(tuple(jnp.asarray(v, jnp.float64)
                                        for v in vals))
            want = [np.asarray(v) for v in want]
        nb = p.dec.nbricks
        e = max(err(from_bricks(np.asarray(g, np.float32).reshape(nb, -1),
                                p.dec.interior_grid(), p.bdims), wv)
                for g, wv in zip(got, want))
        return dims, sec * 1e3, e, F32_TOL, p.describe()
    return run


def phase_strong(n, sdom):
    from brickjax.drivers import strong
    from brickjax.stencils import DEFAULT_PARAMS, stencil_by_name

    def run():
        st_iter = 8
        res = strong.run(dom=(n, n, n), sdom=(sdom, sdom, n),
                         bdim=(8, 8, 8), stencil="mpi7pt", st_iter=st_iter,
                         mesh_shape=(1, 1, 1), iters=5, validate=True,
                         backend="pencil")
        sd = stencil_by_name("mpi7pt")[0]
        want = dense_ref([sd], [next(iter(sd.inputs))],
                         {next(iter(sd.inputs)): res["input"]}, {},
                         st_iter, DEFAULT_PARAMS)[0]
        return ((n, n, n), res["step"] / st_iter * 1e3,
                err(res["result"], want), F32_TOL,
                {"subdomains": (n // sdom) ** 2})
    return run


def phase_export(n):
    """The exported step (``Problem.exported_step``) run on the card.
    Serializing it needs the ``flatbuffers`` package, which the card's
    machine lacks; the byte round trip is a CPU test."""
    import jax

    from brickjax.api import Problem

    def run():
        dims = (n, n, n)
        p = Problem(dims=dims, stencil="s7pt", st_iter=8)
        p.init(array=_field(dims, 30))
        start = p.result()
        call = p.exported_step(steps=1).call
        out = jax.block_until_ready(call(*p._dats))
        sec = _timed(lambda: jax.block_until_ready(call(*p._dats)))
        want = dense_ref(p.sdefs, p.fields, {p.gname: start}, {}, 8,
                         p.params)[0]
        return (dims, sec / 8 * 1e3, err(p._gather(out), want), F32_TOL,
                {})
    return run


def phase_ooc(n):
    import jax
    import jax.numpy as jnp

    from brickjax.codegen import dense_apply
    from brickjax.ooc import ooc_sweep
    from brickjax.stencils import bench_params, stencil_by_name

    def run():
        sd = stencil_by_name("s7pt")[0]
        params = bench_params()
        arr = _field((n, n, n), 40)
        stats = {}
        got = ooc_sweep(arr, sd, params, iters=1, stats=stats)
        lo, hi = sd.radius()
        e = 0.0
        chunk = max(n // 8, 1)
        with jax.enable_x64(True):
            f = jax.jit(lambda a: dense_apply(
                sd, {"bIn": jnp.pad(a, ((0, 0), (lo[1], hi[1]),
                                        (lo[2], hi[2])), mode="wrap")},
                params))
            for k0 in range(0, n, chunk):
                rows = np.arange(k0 - lo[0], k0 + chunk + hi[0]) % n
                want = np.asarray(f(jnp.asarray(arr[rows], jnp.float64)))
                e = max(e, err(got[k0:k0 + chunk], want))
        return ((n, n, n), stats["wall_s"] * 1e3, e, F32_TOL,
                {"slabs": stats["slabs"]})
    return run


def phase_weak4(mesh, n):
    """Weak scaling over ``mesh`` cards: n^3 per card, st_iter=8,
    against the dense twin of the whole domain on one card."""
    import jax

    from brickjax.api import Problem

    def run():
        p = Problem(dims=(n, n, n), stencil="s7pt", mesh=mesh, st_iter=8)
        gshape = tuple(m * n for m in mesh)
        ms, e, tol = problem_phase(p, {p.gname: _field(gshape, 50)}, {}, 1)
        shard = p.dec.nbricks * int(np.prod(p.bdims)) * 4
        held = {s.device: s.data.nbytes
                for s in p._dats[0].addressable_shards}
        if (set(held) != set(p.mesh.devices.flat)
                or min(held.values()) != shard):
            raise RuntimeError(f"state is not one shard per card: {held}")
        info = p.describe()
        info["bytes_in_use_per_device"] = [
            (d.memory_stats() or {}).get("bytes_in_use")
            for d in p.mesh.devices.flat]
        return gshape, ms, e, tol, info
    return run


def phases(cards: int, sz: dict):
    n, ns = sz["n3"], sz["n_small"]
    if cards == 4:
        return [("weak_s7pt_4x1x1", phase_weak4((4, 1, 1), n)),
                ("weak_s7pt_2x2x1", phase_weak4((2, 2, 1), n))]
    import jax.numpy as jnp

    return [
        ("s7pt_st8", phase_problem("s7pt", (n, n, n), 8, 2, 1)),
        ("s7pt_st8_jnp", phase_problem("s7pt", (n, n, n), 8, 2, 1,
                                       backend="jnp")),
        ("mpi125pt_st4", phase_problem("mpi125pt", (n, n, n), 4, 2, 2)),
        ("cond_st8", phase_problem("cond", (n, n, n), 8, 2, 3)),
        ("varcoeff_aux", phase_varcoeff(n)),
        ("gray_scott_system", phase_gray_scott(ns)),
        ("box9pt_2d", phase_2d(sz["n2"])),
        ("mpi9pt_4d", phase_problem("mpi9pt", sz["d4"], 2, 4, 4)),
        ("s7pt_st8_bf16", phase_problem("s7pt", (n, n, n), 8, 1, 5,
                                        dtype=jnp.bfloat16)),
        ("grad_linear", phase_grad("linear", ns)),
        ("grad_polynomial", phase_grad("polynomial", ns)),
        ("grad_piecewise", phase_grad("piecewise", ns)),
        ("strong_16sub", phase_strong(n, sz["sdom"])),
        ("export_roundtrip", phase_export(n)),
        ("ooc_sweep", phase_ooc(sz["ooc"])),
    ]


def run(cards: int, sz: dict) -> bool:
    """Run every phase; print one line each.  True when all passed."""
    ok = True
    for name, fn in phases(cards, sz):
        t0 = time.perf_counter()
        try:
            shape, ms, e, tol, info = fn()
        except Exception:
            traceback.print_exc()
            print(f"phase {name} FAILED", flush=True)
            ok = False
            continue
        good = bool(e <= tol)
        ok &= good
        plan = {k: info[k] for k in ("backend", "kernel", "fuse")
                if k in info}
        plan.update({k: v for k, v in info.items()
                     if k in ("subdomains", "slabs",
                              "bytes_in_use_per_device")})
        print(f"phase {name} shape={tuple(shape)} ms_per_iter={ms:.4f} "
              f"max_err={e:.3e} tol={tol:.1e} "
              f"{'ok' if good else 'FAILED'} {json.dumps(plan)} "
              f"wall_s={time.perf_counter() - t0:.1f}", flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: only the weak-scaling step on four cards "
                         "and the reference it is compared with")
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    try:
        from brickjax.utils.compile_cache import enable_compile_cache
    except ImportError as e:
        print(f"chip_smoke.py runs from a checkout of the repo: {e}",
              file=sys.stderr)
        return 2
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found "
              f"{devs[0].platform}", file=sys.stderr)
        return 1
    if len(devs) < a.cards:
        print(f"--cards {a.cards} needs {a.cards} GPUs, JAX found "
              f"{len(devs)}", file=sys.stderr)
        return 1
    enable_compile_cache()
    print(card_line())
    print(f"jax {jax.__version__}, {len(devs)} x {devs[0].device_kind}",
          flush=True)
    if not run(a.cards, FULL):
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
