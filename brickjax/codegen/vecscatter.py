"""vecscatter CLI analog (ref: codegen/vecscatter:15-187).

The reference CLI rewrites ``#pragma vecscatter`` sites in C++ source at
build time.  Here sweeps are built at trace time, so the CLI's role
becomes inspection + ahead-of-time checking: load a stencil module
(reference ``STENCIL = [out]`` contract), print the analyzed IR (taps,
radius, coefficient groups — the Reduction-grouping analog), and
optionally smoke-build the sweep for a given layout.

    python -m brickjax.codegen.vecscatter stencils/mpi125pt.py
    python -m brickjax.codegen.vecscatter s7pt --build \
        --bdim 8,8,128 --grid 10,10,3
"""

from __future__ import annotations

import argparse
import json
import sys


def describe(name_or_path: str, params: dict | None = None,
             adjoint: bool = False) -> list[dict]:
    from ..st import load_stencil_module
    from .ir import StencilIR

    if name_or_path.endswith(".py"):
        sdefs = load_stencil_module(name_or_path)
    else:
        from ..stencils import stencil_by_name
        sdefs = stencil_by_name(name_or_path)
    if adjoint:
        from .autodiff import (adjoint_stencil,
                               polynomial_system_adjoints)
        from .ir import linear_decomposition as _lin

        if len(sdefs) > 1:
            # coupled SYSTEM: each field's pullback sums product-rule
            # terms over ALL outputs (reads every output's cotangent
            # grid) — per-output adjoints would be wrong
            adjs, _cts = polynomial_system_adjoints(sdefs)
            sdefs = list(adjs.values())
        elif (len(sdefs[0].inputs) == 1
              and _lin(sdefs[0].rhs) is not None):
            sdefs = [adjoint_stencil(sdefs[0])]
        else:
            # variable-coefficient / polynomial stencils: one
            # pullback stencil per input field (reads the
            # cotangent grid + the original inputs)
            adjs, _ct = polynomial_system_adjoints(sdefs)
            sdefs = list(adjs.values())
    out = []
    for sd in sdefs:
        ir = StencilIR.from_def(sd)
        lo, hi = ir.radius()
        desc = {
            "output": sd.output.name,
            "inputs": sorted(sd.inputs),
            "dims": sd.dims,
            "taps": len(sd.tap_offsets_np()),
            "radius_lo": list(lo),
            "radius_hi": list(hi),
            "flops_per_element": ir.flops_per_element(),
            "linear": ir.linear is not None,
        }
        if ir.linear is not None:
            desc["coeff_groups"] = [
                {"coeff": key[1], "taps": len(taps)}
                for key, _c, taps in ir.linear]
            try:
                from ..stencils import bench_params
                from .evaluate import resolve_const_from_params
                from .ir import fold_linear

                resolve = resolve_const_from_params(bench_params(params))
                fields = ({n: i for i, n in enumerate(sd.inputs)}
                          if len(sd.inputs) > 1 else None)
                lin = fold_linear(ir, resolve, fields=fields)
            except KeyError:    # unresolved custom ConstRefs: pass
                lin = None      # their values via --params to see this
            if lin is not None:
                wdefs, vmap, jneed = lin
                desc["fold"] = {
                    "k_profiles_W": len(wdefs),
                    "j_stages_V": len(set(vmap.values())),
                    "i_shifts": sum(1 for di in vmap if di),
                    "j_halo": list(jneed),
                }
        out.append(desc)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("stencil", help="corpus name or path to a .py module")
    p.add_argument("--build", action="store_true",
                   help="smoke-build the sweep")
    p.add_argument("--bdim", default="8,8,128")
    p.add_argument("--grid", default="6,6,6",
                   help="brick-grid dims incl ghost ring")
    p.add_argument("--json", action="store_true")
    p.add_argument("--params", metavar="JSON",
                   help="extra ConstRef values as a JSON object, merged "
                        "over DEFAULT_PARAMS (external stencil modules "
                        "use their own constant names)")
    p.add_argument("--export", metavar="PATH",
                   help="serialize the jitted kernel AOT via jax.export "
                        "(the VSTARGET build-artifact analog, "
                        "cmake/VecScatter.cmake:8-31); reload with "
                        "jax.export.deserialize")
    p.add_argument("--backend", default="brick",
                   choices=["brick", "pencil"],
                   help="layout to build/export: i-bricked or "
                        "full-i pencil bricks")
    p.add_argument("--adjoint", action="store_true",
                   help="analyze/build the TRANSPOSE stencil instead "
                        "(negated offsets, same coefficients — the "
                        "reverse-mode rule of codegen.autodiff); linear "
                        "single-input stencils only")
    a = p.parse_args(argv)

    user_params = json.loads(a.params) if a.params else None
    descs = describe(a.stencil, user_params, adjoint=a.adjoint)
    if a.json:
        print(json.dumps(descs, indent=2))
    else:
        for d in descs:
            print(f"{d['output']} <- {','.join(d['inputs'])}  "
                  f"{d['dims']}-D, {d['taps']} taps, "
                  f"radius {d['radius_lo']}/{d['radius_hi']}, "
                  f"{d['flops_per_element']} flop/elem"
                  + ("" if not d.get("coeff_groups") else
                     f", {len(d['coeff_groups'])} coeff groups"))
            if "fold" in d:
                f = d["fold"]
                print(f"  factorization: {f['k_profiles_W']} k-profiles "
                      f"(W) -> {f['j_stages_V']} j-stages (V, halo "
                      f"{f['j_halo']}) -> {f['i_shifts']} i-shifts")

    if a.build or a.export:
        from ..core import init_grid
        from ..stencils import bench_params
        from ..st import load_stencil_module

        bdim = tuple(int(x) for x in a.bdim.split(","))
        gdims = tuple(int(x) for x in a.grid.split(","))
        grid, info = init_grid(gdims)
        params = bench_params(user_params)
        if a.stencil.endswith(".py"):
            sd = load_stencil_module(a.stencil)[0]
        else:
            from ..stencils import stencil_by_name
            sd = stencil_by_name(a.stencil)[0]
        if a.adjoint:
            from .autodiff import adjoint_stencil

            sd = adjoint_stencil(sd)
        from .sweep import pencil_sweep

        if a.backend == "pencil":
            grid = grid[..., :1]
            fn = pencil_sweep(sd, grid, bdim, info.nbricks, params)
        else:
            fn = pencil_sweep(sd, grid, bdim, info.nbricks, params,
                              i_ghost=1)
        print(f"built sweep for grid {gdims}, bricks {bdim}"
              + (f", fields {fn.fields}" if hasattr(fn, "fields")
                 else ""))
        if a.export:
            import jax
            import jax.numpy as jnp

            spec = jax.ShapeDtypeStruct((info.nbricks,) + bdim,
                                        jnp.float32)
            specs = [spec] * max(1, len(sd.inputs))  # one per field
            exported = jax.export.export(jax.jit(fn))(*specs)
            blob = exported.serialize()
            with open(a.export, "wb") as f:
                f.write(blob)
            print(f"exported {len(blob)} bytes to {a.export} "
                  f"(platforms {exported.platforms}); reload with "
                  f"jax.export.deserialize(...).call(dat)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
