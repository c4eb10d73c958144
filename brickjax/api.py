"""High-level API: declare a stencil problem, step it, read it back.

The reference's user flow is manual (BrickDecomp + storage + exchange
views + generated kernels, cf. weak/main.cpp:38-306); :class:`Problem`
packages the same pieces behind one object:

    from brickjax.api import Problem

    p = Problem(dims=(512, 512, 512), stencil="mpi7pt")   # one chip
    p.init(seed=0)                # or p.init(array=my_numpy_array)
    p.step(5)                     # 5 x (ghost exchange + stencil), jitted
    out = p.result()              # dense numpy array (owned region)

    p = Problem(dims=(64, 64, 512), mesh=(2, 2, 1), stencil="mpi13pt",
                backend="jnp")    # 4 devices, domain decomposition

Backends: "pencil" (window sweeps over full-row pencil bricks;
2-D/3-D/4-D, innermost axis undistributed) or "jnp" (halo-extend
executor over any brick fold; any rank).  Both are plain XLA.  Data
lives sharded on the mesh between calls; steps donate storage so
exchanges and sweeps update in place.
"""

from __future__ import annotations

import numpy as np


class Problem:
    def __init__(self, dims, stencil="mpi7pt", params=None,
                 bdims=None, ghost=None, mesh=(1, 1, 1),
                 backend="auto", dtype=np.float32, st_iter=1,
                 field=None, slices=1, schedule=None):
        """Multi-input stencils (variable-coefficient fields): ``field``
        names the EVOLVING input grid (default: the stencil's first
        input); every other input is a STATIC auxiliary field whose
        global array is passed to :meth:`init` via ``aux=``.  Aux ghost
        regions are filled once at init (periodic wrap) and never go
        stale, so deep-ghost ``st_iter`` composes unchanged.

        Stencil SYSTEMS (the reference's multi-output ``STENCIL =
        [out1, out2, ...]`` contract, codegen/vecscatter:165-168): pass
        a list of StencilDefs and ``field=(name1, name2, ...)`` naming
        the input grid each output replaces.  Every step exchanges all
        evolving fields, then computes every output from the PRE-step
        fields (Jacobi update); :meth:`init` takes ``array={name:
        global_array}`` and :meth:`result` returns a dict.

        ``backend``: "auto" (the one selection point,
        :meth:`_choose_backend`), "pencil" or "jnp".

        ``schedule``: optional dict of tuning knobs (pencil backend) —
        the runtime analog of the reference codegen CLI's ``--unroll``
        (codegen/vecscatter:22-36); :meth:`describe` reports the
        choice.  Keys:

        - ``fuse``: stencil levels per sweep window (must divide
          ``st_iter`` and fit the ghost halo, fuse*radius within the
          brick); default 1.  Results equal ``fuse`` composed sweeps.
        """
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        from .comm import BrickDecomp, skinlist_by_name
        from .comm.exchange import exchange_shift
        from .comm.mesh import make_domain_mesh, shard_map
        from .stencils import bench_params, stencil_by_name
        from .st.loader import StencilDef

        self.dims = tuple(int(d) for d in dims)     # per-device, owned
        nd = len(self.dims)
        mesh = tuple(int(m) for m in mesh)
        if nd != 3 and mesh == (1, 1, 1):
            mesh = (1,) * nd    # the single-device default adapts to rank
        if len(mesh) != nd:
            raise ValueError(f"mesh needs one entry per domain axis "
                             f"({nd}), got {len(mesh)}")
        self.mesh_shape = mesh
        # two-level topology: ``slices`` nodes stacked along the
        # OUTERMOST domain axis, each running the card mesh ``mesh``
        # (the reference's arbitrary MPI_Cart topologies,
        # weak/args.cpp:105-108).  eff_mesh is the per-domain-axis
        # effective device count every exchange/staging computation
        # uses; the node axis composes into axis 0's ppermute name.
        self.slices = int(slices)
        if self.slices < 1:
            raise ValueError("slices must be >= 1")
        self.eff_mesh = ((self.slices * self.mesh_shape[0],)
                         + self.mesh_shape[1:])
        self.schedule = dict(schedule or {})
        bad = set(self.schedule) - {"fuse"}
        if bad:
            raise ValueError(f"unknown schedule keys {sorted(bad)}; "
                             f"valid: ['fuse']")
        if isinstance(stencil, str):
            sdefs = [stencil_by_name(stencil)[0]]
        elif isinstance(stencil, StencilDef):
            sdefs = [stencil]
        elif isinstance(stencil, (list, tuple)):
            sdefs = list(stencil)
            if not sdefs or not all(isinstance(s, StencilDef)
                                    for s in sdefs):
                raise ValueError("a stencil system is a non-empty list "
                                 "of StencilDefs")
        else:
            raise TypeError(f"stencil: name, StencilDef or list, got "
                            f"{type(stencil)}")
        self.sdefs = sdefs
        self.sdef = sdefs[0]
        nfld = len(sdefs)
        self.nfld = nfld
        if field is None:
            if nfld > 1:
                raise ValueError("stencil systems need field=(name, "
                                 "...) naming each output's evolving "
                                 "input grid, in STENCIL order")
            fields = (next(iter(sdefs[0].inputs)),)
        else:
            fields = ((field,) if isinstance(field, str)
                      else tuple(field))
        if len(fields) != nfld:
            raise ValueError(f"{nfld} stencil output(s) need "
                             f"{nfld} field name(s), got {len(fields)}")
        if len(set(fields)) != nfld:
            raise ValueError("field names must be distinct")
        allinputs: dict = {}
        for s in sdefs:
            allinputs.update(s.inputs)
        for f_ in fields:
            if f_ not in allinputs:
                raise ValueError(f"field {f_!r} is not a stencil "
                                 f"input ({sorted(allinputs)})")
        for idx, (f_, s) in enumerate(zip(fields, sdefs)):
            # field[idx] is what output idx REPLACES; a stencil whose
            # own inputs don't include it is almost certainly a
            # misordered field= tuple (a silently-wrong system)
            if f_ not in s.inputs:
                raise ValueError(
                    f"field[{idx}] = {f_!r} is not an input of stencil "
                    f"output {idx} ({s.output.name} reads "
                    f"{list(s.inputs)}); field= must follow STENCIL "
                    f"order")
        self.fields = fields
        self.gname = fields[0]
        self.aux_names = [n for n in allinputs if n not in fields]
        self.params = bench_params(params)

        backend = self._choose_backend(backend, bdims)
        self.backend = backend
        if self.schedule and backend != "pencil":
            raise ValueError(f"schedule= tunes the pencil backend; "
                             f"backend is {backend!r}")
        if bdims is None:
            if backend == "pencil":
                bdims = ((8, self.dims[1]) if nd == 2
                         else (8, 8, self.dims[2]) if nd == 3
                         else (2, 8, 8, self.dims[3]))
            else:
                bdims = tuple(min(8, d) for d in self.dims[:-1]) + (
                    min(128, self.dims[-1]),)
        self.bdims = tuple(int(b) for b in bdims)
        if ghost is None:
            ghost = (self.bdims[:-1] + (0,) if backend == "pencil"
                     else self.bdims)
        self.ghost = tuple(int(g) for g in ghost)
        self.dec = BrickDecomp(dims=self.dims, ghost_depth=self.ghost,
                               bdims=self.bdims).initialize(
            skinlist_by_name("good", nd))
        if self.slices > 1:
            from .comm.mesh import make_multislice_mesh

            self.mesh, self._xnames, _eff = make_multislice_mesh(
                self.slices, self.mesh_shape)
            assert _eff == self.eff_mesh
        else:
            self.mesh = make_domain_mesh(self.mesh_shape)
            self._xnames = self.mesh.axis_names
        # devices stack along the brick axis: shard_map hands each
        # device its [nbricks, step] storage with no reshapes
        self._P = P(tuple(self.mesh.axis_names))
        self._sharding = NamedSharding(self.mesh, self._P)
        self.dtype = dtype

        self.st_iter = int(st_iter)
        rad = max(max(max(lo_r), max(hi_r))
                  for lo_r, hi_r in (s.radius() for s in sdefs))
        dec, msh, bd = self.dec, self.eff_mesh, self.bdims
        if backend == "pencil":
            from .codegen.sweep import RANGE_NAMES, pencil_sweep

            # zero-copy periodicity on undistributed axes via the table
            table_axes = tuple(a for a in range(nd) if msh[a] == 1)
            distributed = len(table_axes) < nd
            gmin = min(bd[:-1])
            if distributed and self.st_iter * rad > gmin:
                raise ValueError(
                    f"st_iter {self.st_iter} x radius {rad} exceeds "
                    f"ghost depth {gmin}")
            kgrid = dec.periodic_grid(table_axes)
            rnames = RANGE_NAMES[nd]

            def _rng(skip):
                # owned cells on table-periodic axes; ``skip`` ghost
                # bricks trimmed on exchanged ones
                return {rnames[a]: ((1, kgrid.shape[a] - 1)
                                    if a in table_axes
                                    else (skip, kgrid.shape[a] - skip))
                        for a in range(nd - 1)}

            fuse = int(self.schedule.get("fuse", 1))
            if (fuse < 1 or self.st_iter % fuse
                    or any(fuse * rad > b for b in bd[:-1])):
                raise ValueError(
                    f"schedule fuse={fuse} must divide the sweep "
                    f"budget ({self.st_iter}) and fit the halo "
                    f"(fuse*radius within the brick/ghost depth)")
            self.fuse = fuse
            skw = dict(fuse=fuse, dtype=jnp.dtype(self.dtype))
            if nfld > 1:
                skw["evolve"] = self.fields
            sd_or_sys = sdefs if nfld > 1 else self.sdef
            kern = pencil_sweep(sd_or_sys, kgrid, bd, dec.nbricks,
                                self.params, **_rng(1), **skw)
            # differentiable_step reuses this as its forward when the
            # configs match
            self._plan_kern0 = kern
            kern_ghost = None
            if self.st_iter > fuse and distributed:
                # deep-ghost ST_ITER: one exchange amortizes over
                # st_iter sweeps, ghost-inclusive until the last
                # (ref: weak/main.cpp:203-212)
                kern_ghost = pencil_sweep(sd_or_sys, kgrid, bd,
                                          dec.nbricks, self.params,
                                          **_rng(0), **skw)

            def one(*sv):
                states = list(sv[:nfld])
                if distributed:
                    states = [exchange_shift(s_, dec, self._xnames, msh,
                                             table_axes=table_axes)
                              for s_ in states]
                nsweeps = self.st_iter // fuse
                for it in range(nsweeps):
                    k = (kern if (it == nsweeps - 1 or kern_ghost is None)
                         else kern_ghost)
                    vs = dict(zip(self.aux_names, sv[nfld:]))
                    vs.update(zip(self.fields, states))
                    outs = (k(*(vs[n] for n in k.fields))
                            if hasattr(k, "fields") else k(states[0]))
                    states = list(outs) if nfld > 1 else [outs]
                return states[0] if nfld == 1 else tuple(states)

            self._exec_plan = {
                "backend": "pencil", "kernel": "xla", "fuse": fuse,
                "exchange": "shift" if distributed else "table",
                "table_axes": list(table_axes),
            }
        else:
            from .codegen import brick_apply

            # the jnp path exchanges real finite-depth ghost bricks on
            # EVERY device count (no table periodicity), so the
            # deep-ghost validity bound applies even at mesh=(1,1,1)
            if (self.st_iter > 1
                    and self.st_iter * rad > min(
                        (g for g in self.ghost if g), default=0)):
                raise ValueError("st_iter x radius exceeds ghost depth")
            self.fuse = 1
            adj = jnp.asarray(dec.info.adj)
            owned = jnp.asarray(
                np.arange(1, dec.sep_pos[1], dtype=np.int32))

            def one(*sv):
                states = [exchange_shift(s_, dec, self._xnames, msh)
                          for s_ in sv[:nfld]]
                shp = states[0].shape
                views = [s_.reshape((-1,) + bd) for s_ in states]
                avs = {n: a.reshape((-1,) + bd)
                       for n, a in zip(self.aux_names, sv[nfld:])}
                for it in range(self.st_iter):
                    vs = dict(avs)
                    vs.update(zip(self.fields, views))

                    def ins(s_):
                        # only the grids this stencil reads: brick_apply
                        # halo-extends every view it is handed
                        return {n: vs[n] for n in s_.inputs}

                    if it == self.st_iter - 1:   # last: owned only
                        outs = [brick_apply(s_, ins(s_), adj,
                                            self.params, rows=owned)
                                for s_ in sdefs]
                        views = [v.at[owned].set(o)
                                 for v, o in zip(views, outs)]
                    else:  # ghost-inclusive (deep-ghost semantics)
                        views = [brick_apply(s_, ins(s_), adj,
                                             self.params)
                                 for s_ in sdefs]
                if nfld == 1:
                    return views[0].reshape(shp)
                return tuple(v.reshape(shp) for v in views)

            self._exec_plan = {"backend": "jnp", "kernel": "xla",
                               "fuse": 1, "exchange": "shift"}

        # every step rewrites its state: donate it so exchanges and
        # sweeps update the buffers in place
        don = dict(donate_argnums=tuple(range(nfld)))
        nin = nfld + len(self.aux_names)
        out_specs = self._P if nfld == 1 else (self._P,) * nfld
        if int(np.prod(self.eff_mesh)) > 1:
            self._step = jax.jit(shard_map(one, self.mesh,
                                           (self._P,) * nin, out_specs),
                                 **don)
        else:  # single device: no SPMD wrapper
            self._step = jax.jit(one, **don)
        # rollout() fuses n steps into ONE dispatch (fori_loop inside
        # the SPMD region)
        self._one = one
        self._one_wrap = (don, nin, out_specs)
        self._rollouts = {}
        self._dats = None
        self._aux = ()

    def _choose_backend(self, backend, bdims) -> str:
        """The one place the implementation is chosen.  ``auto`` takes
        the pencil sweep wherever its layout applies — rank 2-4, the
        innermost axis undistributed, and (outside 3-D) bricks that
        span the whole row — and the jnp executor elsewhere."""
        nd = len(self.dims)
        if backend == "auto":
            row_ok = (nd == 3 or bdims is None
                      or int(bdims[-1]) == self.dims[-1])
            backend = ("pencil" if nd in (2, 3, 4)
                       and self.mesh_shape[-1] == 1 and row_ok
                       else "jnp")
        if backend not in ("pencil", "jnp"):
            raise ValueError(f"backend is 'auto', 'pencil' or 'jnp', "
                             f"got {backend!r}")
        if backend == "pencil" and self.mesh_shape[-1] != 1:
            # with ghost_depth[i]=0 the innermost roll would wrap
            # per-device, silently computing per-device-periodic results
            raise ValueError(
                "pencil backend needs the innermost axis undistributed "
                "(mesh[-1] == 1); use backend='jnp' instead")
        if backend == "pencil" and nd not in (2, 3, 4):
            raise ValueError("pencil backend is 2-D/3-D/4-D; use "
                             "backend='jnp' for other ranks")
        return backend

    # ------------------------------------------------------------------
    def differentiable_step(self):
        """A step function registered for JAX reverse-mode AD
        (beyond the reference; codegen.autodiff).

        Returns ``fn(state) -> state`` over the stacked sharded storage
        (same layout as the internal step): the pullback runs the
        ADJOINT stencil as a second pencil sweep, and on distributed
        axes the ghost cotangent rides the SHIFT exchange's own
        transpose back to the senders.  Use with :meth:`owned_mask` to
        write losses over owned rows (ghost rows of a sweep output
        are undefined; their gradient is exactly zero).

        Linear single-field problems get the exact adjoint-sweep
        pullback — ``fn(state) -> state``; on a distributed mesh the
        step must be ONE UNFUSED sweep per exchange (``st_iter == 1``,
        ghost-inclusive/fused windows clamp, which is not exactly
        transposed across a real ghost ring).  Single-output
        POLYNOMIAL problems — variable-coefficient multi-input and
        polynomial nonlinearities — get exact adjoint PENCIL sweeps
        too (one per input field, O(1) activations; signature
        ``fn(field, *aux) -> field``, distributed meshes included:
        aux-field ghost gradients ride an in-graph aux exchange's
        transpose home).  Coupled POLYNOMIAL systems get the exact
        adjoint-SYSTEM pullback (one multi-output sweep forward, one
        adjoint pencil sweep per input field, distributed included;
        signature ``fn(*fields, *aux) -> fields``).  PIECEWISE
        nonlinearities (If/max/abs — e.g. cond) differentiate exactly
        on the same pullback: the symbolic differentiator emits gate
        masks that recompute from the residual input views, so no
        dense oracle is ever built (only opaque functions with no
        registered derivative rule raise).  2-D problems get the
        linear adjoint twin on the
        row-pencil emitter (distributed y included).  Pencil backend,
        shift exchange; the built step is cached on the Problem."""
        import jax

        from .codegen.autodiff import differentiable_pencil_sweep
        from .codegen.ir import linear_decomposition
        from .comm.exchange import exchange_shift
        from .comm.mesh import shard_map

        if getattr(self, "_diff_step", None) is not None:
            return self._diff_step
        if self._exec_plan["backend"] != "pencil":
            raise ValueError("differentiable_step needs the pencil "
                             "backend")
        nd = len(self.dims)
        if nd == 4:
            # 4-D: linear single-input gets the exact adjoint twin;
            # multi-input/polynomial gets the exact poly pullback on
            # the 4-D multi-input emitter (one adjoint sweep per input
            # field).  On distributed meshes the ghost cotangent rides
            # the shift exchange's transpose home like the 3-D case
            # (one unfused sweep per exchange); aux-field ghost
            # gradients route home through an idempotent in-graph aux
            # exchange.
            from .codegen.autodiff import (
                differentiable_pencil_sweep_4d,
                differentiable_poly_sweep_4d,
                differentiable_poly_system_sweep_4d)
            import jax.numpy as jnp

            msh4 = self.eff_mesh
            t4 = tuple(a for a in range(4) if msh4[a] == 1)
            dist4 = len(t4) < 4
            if dist4 and self.st_iter != 1:
                raise ValueError(
                    f"differentiable distributed step needs st_iter=1 "
                    f"(one unfused sweep per exchange), got st_iter="
                    f"{self.st_iter}, fuse={self.fuse}")
            names4 = self._xnames
            x4 = tuple(a for a in (0, 1, 2) if a not in t4)
            if self.nfld != 1:
                # coupled 4-D SYSTEMS: exact adjoint-system pullback
                # (per-output multi-input forwards; one adjoint sweep
                # per input field reading every output cotangent)
                try:
                    kern4s = differentiable_poly_system_sweep_4d(
                        self.sdefs, self.dec.periodic_grid(t4),
                        self.bdims, self.dec.nbricks, self.fields,
                        self.params, exchanged_axes=x4,
                        dtype=jnp.dtype(self.dtype))
                except ValueError as e:
                    if "polynomial expansion" not in str(e):
                        raise
                    raise ValueError(
                        "4-D system differentiable_step: opaque "
                        f"function with no derivative rule ({e})"
                        ) from e
                allnames4s = list(self.fields) + list(self.aux_names)

                def one4s(*sv):
                    vals = dict(zip(allnames4s, sv))
                    if dist4:
                        vals = {n: exchange_shift(v, self.dec,
                                                  names4, msh4,
                                                  table_axes=t4)
                                for n, v in vals.items()}
                        return kern4s(*(vals[n]
                                        for n in kern4s.fields))
                    for _ in range(self.st_iter):
                        outs = kern4s(*(vals[n]
                                        for n in kern4s.fields))
                        vals.update(zip(self.fields, outs))
                    return tuple(vals[f] for f in self.fields)

                return self._finalize_diff_step(one4s, len(allnames4s),
                                                self.nfld)
            if self.aux_names or linear_decomposition(
                    self.sdef.rhs) is None:
                fuse4 = 1 if dist4 else self.fuse
                fkw4 = dict(fuse=fuse4)
                try:
                    kern4 = differentiable_poly_sweep_4d(
                        self.sdef, self.dec.periodic_grid(t4),
                        self.bdims, self.dec.nbricks, self.params,
                        exchanged_axes=x4,
                        dtype=jnp.dtype(self.dtype),
                        forward_fn=(self._plan_kern0
                                    if self.fuse == fuse4 else None),
                        **fkw4)
                except ValueError as e:
                    if "polynomial expansion" not in str(e):
                        raise
                    raise ValueError(
                        "4-D multi-input differentiable_step: opaque "
                        f"function with no derivative rule ({e})"
                        ) from e
                allnames4 = [self.gname] + list(self.aux_names)

                def one4p(*sv):
                    vals = dict(zip(allnames4, sv))
                    if dist4:
                        # aux exchanges are idempotent in-graph copies
                        # whose transpose folds ghost gradients home
                        vals = {n: exchange_shift(v, self.dec, names4,
                                                  msh4, table_axes=t4)
                                for n, v in vals.items()}
                        return kern4(*(vals[n] for n in kern4.fields))
                    for _ in range(self.st_iter // fuse4):
                        out = kern4(*(vals[n] for n in kern4.fields))
                        vals[self.gname] = out
                    return vals[self.gname]

                return self._finalize_diff_step(one4p, len(allnames4),
                                                1)
            fuse = 1 if dist4 else self.fuse
            fkw = dict(fuse=fuse)
            kern = differentiable_pencil_sweep_4d(
                self.sdef, self.dec.periodic_grid(t4),
                self.bdims, self.dec.nbricks, self.params,
                exchanged_axes=x4,
                dtype=jnp.dtype(self.dtype), **fkw)

            def one4(d):
                if dist4:
                    d = exchange_shift(d, self.dec, names4, msh4,
                                       table_axes=t4)
                    return kern(d)
                for _ in range(self.st_iter // fuse):
                    d = kern(d)
                return d

            return self._finalize_diff_step(one4, 1, 1)
        if nd == 2:
            # 2-D on the row-pencil emitter: linear single-input gets
            # the exact adjoint twin; multi-input/polynomial gets the
            # exact poly pullback (one adjoint sweep per input field).
            # The y ghost cotangent rides the shift exchange's
            # transpose home like the 3-D case (x is lane-periodic).
            from .codegen.autodiff import (
                differentiable_pencil_sweep_2d,
                differentiable_poly_sweep_2d,
                differentiable_poly_system_sweep_2d,
                linear_taps)
            import jax.numpy as jnp

            msh2 = self.eff_mesh
            t2 = tuple(a for a in range(2) if msh2[a] == 1)
            dist2 = len(t2) < 2
            if dist2 and self.st_iter != 1:
                raise ValueError(
                    f"differentiable distributed step needs st_iter=1 "
                    f"(one sweep per exchange), got st_iter="
                    f"{self.st_iter}")
            names2 = self._xnames
            xargs = () if 0 in t2 else (0,)
            if self.nfld != 1:
                # coupled 2-D SYSTEMS: exact adjoint-system pullback
                try:
                    kern2s = differentiable_poly_system_sweep_2d(
                        self.sdefs, self.dec.periodic_grid(t2),
                        self.bdims, self.dec.nbricks, self.fields,
                        self.params, exchanged_axes=xargs,
                        dtype=jnp.dtype(self.dtype),
                        forward_fn=(self._plan_kern0
                                     if self.fuse == 1 else None))
                except ValueError as e:
                    if "polynomial expansion" not in str(e):
                        raise
                    raise ValueError(
                        "2-D system differentiable_step: opaque "
                        f"function with no derivative rule; "
                        f"differentiate via backend='jnp' ({e})"
                        ) from e
                allnames2s = list(self.fields) + list(self.aux_names)
                nfld2 = self.nfld

                def one2s(*sv):
                    vals = dict(zip(allnames2s, sv))
                    if dist2:
                        vals = {n: exchange_shift(v, self.dec, names2,
                                                  msh2, table_axes=t2)
                                for n, v in vals.items()}
                        return kern2s(*(vals[n]
                                        for n in kern2s.fields))
                    for _ in range(self.st_iter):
                        outs = kern2s(*(vals[n]
                                        for n in kern2s.fields))
                        vals.update(zip(self.fields, outs))
                    return tuple(vals[f] for f in self.fields)

                return self._finalize_diff_step(one2s, len(allnames2s),
                                                nfld2)
            if not self.aux_names and linear_taps(self.sdef) is not None:
                # fuse composes exactly on the torus ((A^F)^T = (A^T)^F
                # as the F-fused adjoint trapezoid); distributed needs
                # one unfused sweep per exchange like 3-D
                fuse2 = 1 if dist2 else self.fuse
                kern2 = differentiable_pencil_sweep_2d(
                    self.sdef, self.dec.periodic_grid(t2), self.bdims,
                    self.dec.nbricks, self.params,
                    exchanged_axes=xargs, dtype=jnp.dtype(self.dtype),
                    forward_fn=(self._plan_kern0
                                if fuse2 == self.fuse else None),
                    **(dict(fuse=fuse2) if fuse2 > 1 else {}))

                def one2(d):
                    if dist2:
                        d = exchange_shift(d, self.dec, names2, msh2,
                                           table_axes=t2)
                        return kern2(d)
                    for _ in range(self.st_iter // fuse2):
                        d = kern2(d)
                    return d

                return self._finalize_diff_step(one2, 1, 1)
            fuse2p = 1 if dist2 else self.fuse
            try:
                kern2 = differentiable_poly_sweep_2d(
                    self.sdef, self.dec.periodic_grid(t2), self.bdims,
                    self.dec.nbricks, self.params,
                    exchanged_axes=xargs, dtype=jnp.dtype(self.dtype),
                    forward_fn=(self._plan_kern0
                                if self.fuse == fuse2p else None),
                    **(dict(fuse=fuse2p) if fuse2p > 1 else {}))
            except ValueError as e:
                if "polynomial expansion" not in str(e):
                    raise
                raise ValueError(
                    "2-D differentiable_step: opaque function with "
                    f"no derivative rule; differentiate via "
                    f"backend='jnp' ({e})") from e
            allnames2 = [self.gname] + list(self.aux_names)

            def one2p(*sv):
                vals = dict(zip(allnames2, sv))
                if dist2:
                    # aux exchanges are idempotent in-graph copies
                    # whose transpose folds ghost gradients home
                    vals = {n: exchange_shift(v, self.dec, names2,
                                              msh2, table_axes=t2)
                            for n, v in vals.items()}
                    return kern2(*(vals[n] for n in kern2.fields))
                for _ in range(self.st_iter // fuse2p):
                    out = kern2(*(vals[n] for n in kern2.fields))
                    vals[self.gname] = out
                return vals[self.gname]

            return self._finalize_diff_step(one2p, len(allnames2), 1)
        if nd != 3:
            raise ValueError("differentiable_step is 2-D/3-D/4-D "
                             "pencil")
        msh = self.eff_mesh
        table_axes = tuple(a for a in range(3) if msh[a] == 1)
        distributed = len(table_axes) < 3
        if self.nfld != 1:
            # coupled SYSTEMS: the exact adjoint-system pullback
            # (sweep fwd+bwd, distributed included).  Piecewise
            # outputs (If/max/abs) differentiate exactly too — the
            # symbolic differentiator emits gate masks that recompute
            # from the residual input views (codegen.autodiff.
            # _diff_tap); only opaque functions with no registered
            # derivative rule raise.  Signature fn(*fields, *aux) ->
            # fields, so grads flow wrt aux too.
            return self._build_poly_system_diff_step(distributed,
                                                     table_axes)
        if self.aux_names or linear_decomposition(self.sdef.rhs) is None:
            # single output, multi-input (variable-coefficient),
            # polynomial or PIECEWISE (If/max — e.g. cond) nonlinear:
            # exact adjoint-stencil pullback via the multi-input pencil
            # path (one sweep per input field, O(1) activations)
            return self._build_poly_diff_step(distributed, table_axes)
        if distributed and self.st_iter != 1:
            # one UNFUSED sweep per exchange: deep-ghost chains and the
            # fused adjoint's clamped intermediate levels are not
            # exactly transposed across a real ghost ring
            raise ValueError(
                f"differentiable distributed step needs st_iter=1 "
                f"(one unfused sweep per exchange), got st_iter="
                f"{self.st_iter}, fuse={self.fuse}")
        import jax.numpy as jnp

        fuse = 1 if distributed else self.fuse
        fkw = dict(fuse=fuse)
        kern = differentiable_pencil_sweep(
            self.sdef, self.dec.periodic_grid(table_axes), self.bdims,
            self.dec.nbricks, self.params,
            exchanged_axes=tuple(a for a in (0, 1)
                                 if a not in table_axes),
            dtype=jnp.dtype(self.dtype),
            # the plan's kernel IS this forward when fuse matches
            # (identical stencil/grid/ranges/dtype)
            forward_fn=(self._plan_kern0 if fuse == self.fuse
                        else None), **fkw)
        names = self._xnames

        def one(d):
            if distributed:
                d = exchange_shift(d, self.dec, names, msh,
                                   table_axes=table_axes)
                return kern(d)
            for _ in range(self.st_iter // fuse):
                d = kern(d)
            return d

        return self._finalize_diff_step(one, 1, 1)

    def _build_poly_diff_step(self, distributed, table_axes):
        """Exact polynomial pullback (codegen.autodiff.
        differentiable_poly_sweep): sweep forward + one adjoint pencil
        sweep per input field, O(1) activations.  Signature
        ``fn(field, *aux) -> field``.  Distributed meshes exchange the
        evolving field per step as usual AND route aux-field ghost
        gradients home through an idempotent in-graph aux exchange
        (its transpose is exactly the ghost-to-owner fold)."""
        import jax
        import jax.numpy as jnp

        from .codegen.autodiff import differentiable_poly_sweep
        from .comm.exchange import exchange_shift
        from .comm.mesh import shard_map

        if distributed and self.st_iter != 1:
            raise ValueError(
                f"differentiable distributed step needs st_iter=1 "
                f"(one unfused sweep per exchange), got st_iter="
                f"{self.st_iter}, fuse={self.fuse}")
        msh = self.eff_mesh
        # single-device periodic steps reuse the plan's fuse: the fused
        # forward keeps its 1/F HBM traffic; the pullback recomputes F
        # unfused exact steps (autodiff._fuse_by_recompute)
        fuse = 1 if distributed else self.fuse
        fkw = dict(fuse=fuse)
        kern = differentiable_poly_sweep(
            self.sdef, self.dec.periodic_grid(table_axes), self.bdims,
            self.dec.nbricks, self.params,
            exchanged_axes=tuple(a for a in (0, 1)
                                 if a not in table_axes),
            dtype=jnp.dtype(self.dtype),
            forward_fn=(self._plan_kern0 if self.fuse == fuse
                        else None), **fkw)
        names = self._xnames
        allnames = list(self.fields) + list(self.aux_names)

        def one(*sv):
            vals = dict(zip(allnames, sv))
            if distributed:
                vals = {n: exchange_shift(v, self.dec, names, msh,
                                          table_axes=table_axes)
                        for n, v in vals.items()}
                return kern(*(vals[n] for n in kern.fields))
            for _ in range(self.st_iter // fuse):
                out = kern(*(vals[n] for n in kern.fields))
                vals[self.fields[0]] = out
            return vals[self.fields[0]]

        return self._finalize_diff_step(one, len(allnames), 1)

    def _build_poly_system_diff_step(self, distributed, table_axes):
        """Exact polynomial SYSTEM pullback (codegen.autodiff.
        differentiable_poly_system_sweep): ONE multi-output sweep
        forward per step + one adjoint pencil sweep per input field
        reading the output cotangents, O(1) activations.  Signature
        ``fn(*fields, *aux) -> fields``.  Distributed meshes exchange
        every field per step; aux/field ghost gradients route home
        through the exchanges' own transposes."""
        import jax
        import jax.numpy as jnp

        from .codegen.autodiff import differentiable_poly_system_sweep
        from .comm.exchange import exchange_shift
        from .comm.mesh import shard_map

        if distributed and self.st_iter != 1:
            raise ValueError(
                f"differentiable distributed step needs st_iter=1 "
                f"(one unfused sweep per exchange), got st_iter="
                f"{self.st_iter}, fuse={self.fuse}")
        msh = self.eff_mesh
        # single-device periodic steps reuse the plan's fuse (the 3-D
        # pencil emitter fuses systems via per-output rings); pullback
        # recomputes F unfused exact steps
        fuse = 1 if distributed else self.fuse
        fkw = dict(fuse=fuse)
        kern = differentiable_poly_system_sweep(
            self.sdefs, self.dec.periodic_grid(table_axes), self.bdims,
            self.dec.nbricks, self.fields, self.params,
            exchanged_axes=tuple(a for a in (0, 1)
                                 if a not in table_axes),
            dtype=jnp.dtype(self.dtype),
            forward_fn=(self._plan_kern0 if self.fuse == fuse
                        else None), **fkw)
        names = self._xnames
        allnames = list(self.fields) + list(self.aux_names)
        nfld = self.nfld

        def one(*sv):
            vals = dict(zip(allnames, sv))
            if distributed:
                vals = {n: exchange_shift(v, self.dec, names, msh,
                                          table_axes=table_axes)
                        for n, v in vals.items()}
                return kern(*(vals[n] for n in kern.fields))
            for _ in range(self.st_iter // fuse):
                outs = kern(*(vals[n] for n in kern.fields))
                vals.update(zip(self.fields, outs))
            return tuple(vals[f] for f in self.fields)

        return self._finalize_diff_step(one, len(allnames), nfld)

    def _finalize_diff_step(self, one, nin, nout):
        """Jit (and shard_map on distributed meshes) the built
        differentiable step; keep the unjitted inner ``one`` so
        :meth:`differentiable_rollout` can chain it inside one SPMD
        region."""
        import jax

        from .comm.mesh import shard_map

        self._diff_one = one
        self._diff_nin = nin
        self._diff_nout = nout
        if int(np.prod(self.eff_mesh)) > 1:
            in_specs = self._P if nin == 1 else (self._P,) * nin
            out_specs = self._P if nout == 1 else (self._P,) * nout
            self._diff_step = jax.jit(
                shard_map(one, self.mesh, in_specs, out_specs))
        else:
            self._diff_step = jax.jit(one)
        return self._diff_step

    def differentiable_rollout(self, n: int,
                               checkpoint_every: int | None = None):
        """``n`` differentiable steps as ONE jitted dispatch with
        segment REMATERIALIZATION (beyond the reference): the
        training-loop twin of :meth:`rollout`.

        Naively, reverse-mode through an n-step chain stores every
        step's input views (O(n) fields of activation memory — each
        custom-VJP step's only residuals).  Here the chain runs as
        ``lax.scan`` over segments of ``checkpoint_every`` steps with
        ``jax.checkpoint`` around each segment, so backprop stores one
        state snapshot per segment and recomputes inside — the classic
        O(sqrt(n)) memory / 2x-forward-FLOPs trade, which suits these
        memory-bound sweeps: device memory capacity binds long before
        arithmetic does.  Default
        ``checkpoint_every`` = round(sqrt(n)).

        Returns the cached jitted ``fn(*fields, *aux) -> fields`` (same
        signature family as :meth:`differentiable_step`; exchanges run
        inside the SPMD region on distributed meshes).  Gradients are
        exact for every mode differentiable_step supports — remat
        composes with the custom-VJP adjoint sweeps."""
        import jax
        from jax import lax

        from .comm.mesh import shard_map

        n = int(n)
        if n < 1:
            raise ValueError("differentiable_rollout needs n >= 1")
        seg = (int(checkpoint_every) if checkpoint_every
               else max(1, int(round(n ** 0.5))))
        if seg < 1 or seg > n:
            raise ValueError(f"checkpoint_every must be in [1, {n}]")
        if not hasattr(self, "_diff_rollouts"):
            self._diff_rollouts = {}
        cached = self._diff_rollouts.get((n, seg))
        if cached is not None:
            return cached
        self.differentiable_step()       # builds _diff_one/_diff_nin
        one = self._diff_one
        nfld, nout = self.nfld, self._diff_nout

        def stepf(st, aux):
            out = one(*st, *aux)
            return (out,) if nout == 1 else tuple(out)

        def seg_fn(m):
            @jax.checkpoint
            def body(st, aux):
                for _ in range(m):
                    st = stepf(st, aux)
                return st
            return body

        full, rem = divmod(n, seg)
        segf = seg_fn(seg)
        remf = seg_fn(rem) if rem else None

        def many(*sv):
            st, aux = tuple(sv[:nfld]), tuple(sv[nfld:])
            if full == 1:
                st = segf(st, aux)
            elif full:
                st, _ = lax.scan(lambda s, _: (segf(s, aux), None),
                                 st, None, length=full)
            if remf is not None:
                st = remf(st, aux)
            return st[0] if nout == 1 else st

        nin = self._diff_nin
        if int(np.prod(self.eff_mesh)) > 1:
            in_specs = self._P if nin == 1 else (self._P,) * nin
            out_specs = self._P if nout == 1 else (self._P,) * nout
            fn = jax.jit(shard_map(many, self.mesh, in_specs,
                                   out_specs))
        else:
            fn = jax.jit(many)
        self._diff_rollouts[(n, seg)] = fn
        return fn

    def owned_mask(self):
        """Broadcastable 0/1 mask over the stacked storage selecting
        each device's OWNED brick rows (loss weights for
        :meth:`differentiable_step`; ghost rows of a sweep output
        are undefined)."""
        import jax
        import jax.numpy as jnp

        ndev = int(np.prod(self.eff_mesh))
        m = np.tile(self.dec.owned_mask(), ndev)
        m = m.reshape((-1,) + (1,) * len(self.bdims))
        return jax.device_put(jnp.asarray(m), self._sharding)

    def describe(self) -> dict:
        """The chosen execution plan (the runtime analog of the
        vecscatter CLI's factorization report): backend, the kernel
        implementation that runs it, temporal-fuse factor, the device
        platform, and the exchange form per domain axis (incl. the
        node x card composition of a two-level mesh)."""
        nd = len(self.dims)
        per_axis = {}
        for a in range(nd):
            if self.eff_mesh[a] == 1:
                per_axis[a] = ("table-periodic"
                               if self._exec_plan.get("backend")
                               == "pencil" else "local ghost copy")
            elif a == 0 and self.slices > 1:
                per_axis[a] = (f"shift ppermute over (node x card): "
                               f"{self.slices} nodes x "
                               f"{self.mesh_shape[0]} cards")
            else:
                per_axis[a] = "shift ppermute"
        return {
            "dims": list(self.dims), "bdims": list(self.bdims),
            "mesh": list(self.mesh_shape), "slices": self.slices,
            "eff_mesh": list(self.eff_mesh),
            "st_iter": self.st_iter,
            "dtype": np.dtype(self.dtype).name,
            "fields": list(self.fields), "aux": list(self.aux_names),
            "exchange_axes": per_axis,
            "platform": self.mesh.devices.flat[0].platform,
            **({"schedule": dict(self.schedule)} if self.schedule
               else {}),
            **self._exec_plan,
        }

    # ------------------------------------------------------------------
    def exported_step(self, steps: int = 1):
        """The jitted step as a ``jax.export.Exported``: it captures the
        mesh, shardings, collectives and sweeps, so a serving process can
        run steps without tracing or this package —
        ``exported.call(*state)`` on a matching device topology.
        Platform-bound: export on the platform that serves.  Requires
        ``init()`` (the live state supplies the arg specs).  ``steps >
        1`` exports the n-step chain (one dispatch — see
        :meth:`rollout`), the natural serving unit.  Beyond the
        reference (its VSTARGET AOT story is compile-time codegen,
        cmake/VecScatter.cmake)."""
        if self._dats is None:
            raise RuntimeError("init() the problem first — export "
                               "takes arg specs from the live state")
        import jax
        import jax.export as jex

        fn = (self._step if int(steps) <= 1
              else self._build_rollout(int(steps)))
        args = list(self._dats) + list(self._aux)
        specs = [jax.ShapeDtypeStruct(a.shape, a.dtype,
                                      sharding=a.sharding)
                 for a in args]
        return jex.export(fn)(*specs)

    def export_step(self, path: "str | None" = None,
                    steps: int = 1) -> bytes:
        """:meth:`exported_step` serialized (``jax.export`` needs the
        ``flatbuffers`` package for this); reload with
        ``jax.export.deserialize(blob).call(*state)``.  Returns the
        bytes; also written to ``path`` if given."""
        blob = self.exported_step(steps).serialize()
        if path is not None:
            with open(path, "wb") as f:
                f.write(blob)
        return blob

    # ------------------------------------------------------------------
    def _stack_global(self, array) -> np.ndarray:
        """Global periodic array -> stacked per-device brick storage
        (ghost filled by wrap, in the step's own [nbricks, *bdims]
        shape)."""
        from .core import to_bricks

        gshape = tuple(m * d for m, d in zip(self.eff_mesh, self.dims))
        array = np.asarray(array, dtype=self.dtype)
        if array.shape != gshape:
            raise ValueError(f"global array must be {gshape}")
        nd = len(self.dims)
        ndev = int(np.prod(self.eff_mesh))
        nb = self.dec.nbricks
        stacked = np.zeros((ndev * nb,) + self.bdims, self.dtype)
        for r, c in enumerate(np.ndindex(*self.eff_mesh)):
            idx = [(np.arange(c[a] * self.dims[a] - self.ghost[a],
                              c[a] * self.dims[a] + self.dims[a]
                              + self.ghost[a]) % gshape[a])
                   for a in range(nd)]
            dat = np.zeros((nb, int(np.prod(self.bdims))), self.dtype)
            to_bricks(array[np.ix_(*idx)], self.dec.grid, self.bdims,
                      dat=dat)
            stacked[r * nb:(r + 1) * nb] = dat.reshape((-1,) + self.bdims)
        return stacked

    @property
    def _dat(self):
        """Back-compat single-field state view."""
        return None if self._dats is None else self._dats[0]

    def init(self, array=None, seed: int = 0, aux=None):
        """Load per-device owned data from global arrays (shape =
        mesh*dims, periodic) or random values.  Single-field problems
        take ``array=<array>``; stencil systems take ``array={field:
        array}`` (missing fields default to seeded random).  ``aux``:
        dict of global arrays for the static auxiliary fields (every
        input not named in ``field``); their ghost is filled here by
        periodic wrap and never needs re-exchanging."""
        import jax
        import jax.numpy as jnp

        from .core import random_array

        gshape = tuple(m * d for m, d in
                       zip(self.eff_mesh, self.dims))
        if self.nfld == 1 and not isinstance(array, dict):
            array = {self.gname: array}
        elif array is not None and not isinstance(array, dict):
            raise TypeError(
                f"a {self.nfld}-field system takes array={{field: "
                f"global_array}} with fields {list(self.fields)}")
        array = dict(array) if array else {}
        extra_f = [n for n in array if n not in self.fields]
        if extra_f:
            raise ValueError(f"unknown state fields {extra_f}; "
                             f"evolving fields are {list(self.fields)}")
        for i, f_ in enumerate(self.fields):
            if array.get(f_) is None:
                array[f_] = random_array(gshape, self.dtype, seed + i)
        aux = dict(aux or {})
        missing = [n for n in self.aux_names if n not in aux]
        if missing:
            raise ValueError(f"init() needs aux arrays for stencil "
                             f"inputs {missing}")
        extra = [n for n in aux if n not in self.aux_names]
        if extra:
            raise ValueError(f"unknown aux fields {extra}; stencil aux "
                             f"inputs are {self.aux_names}")
        # validate and stack everything on the host before the first
        # device_put so a raise leaves the Problem fully uninitialized
        aux_stk = [self._stack_global(aux[n]) for n in self.aux_names]
        dat_stk = [self._stack_global(array[f_]) for f_ in self.fields]
        self._aux = tuple(
            jax.device_put(jnp.asarray(s), self._sharding)
            for s in aux_stk)
        self._dats = tuple(
            jax.device_put(jnp.asarray(s), self._sharding)
            for s in dat_stk)
        return self

    def step(self, n: int = 1):
        if self._dats is None:
            raise RuntimeError("call init() first")
        for _ in range(n):
            out = self._step(*self._dats, *self._aux)
            self._dats = (out,) if self.nfld == 1 else tuple(out)
        return self

    def rollout(self, n: int):
        """Advance ``n`` steps in ONE device dispatch.

        ``step(n)`` issues one jit call per step, and each dispatch
        costs host time between steps.  ``rollout`` runs a ``lax.fori_loop`` of the step INSIDE the
        SPMD region instead (exchanges included), so the chain runs at
        kernel speed regardless of n.  Numerically identical to
        ``step(n)``."""
        n = int(n)
        if n < 1:
            raise ValueError("rollout needs n >= 1")
        if self._dats is None:
            raise RuntimeError("call init() first")
        out = self._build_rollout(n)(*self._dats, *self._aux)
        self._dats = (out,) if self.nfld == 1 else tuple(out)
        return self

    def _build_rollout(self, n: int):
        """Cached jitted n-step chain (one dispatch; see rollout)."""
        import jax
        from jax import lax

        from .comm.mesh import shard_map

        fn = self._rollouts.get(n)
        if fn is not None:
            return fn
        one = self._one
        don, nin, out_specs = self._one_wrap
        nfld = self.nfld

        def many(*sv):
            aux = sv[nfld:]

            def body(_, st):
                out = one(*st, *aux)
                return (out,) if nfld == 1 else tuple(out)

            out = lax.fori_loop(0, n, body, tuple(sv[:nfld]))
            return out[0] if nfld == 1 else tuple(out)

        if int(np.prod(self.eff_mesh)) > 1:
            fn = jax.jit(shard_map(many, self.mesh,
                                   (self._P,) * nin, out_specs), **don)
        else:
            fn = jax.jit(many, **don)
        self._rollouts[n] = fn
        return fn

    def save(self, path: str):
        """Checkpoint the sharded brick state + problem config.

        A capability beyond the reference (it has none — SURVEY §5):
        restart long runs without re-initializing.
        """
        if self._dats is None:
            raise RuntimeError("nothing to save; call init() first")
        np.savez_compressed(
            path,
            dat=np.asarray(self._dats[0]),
            dims=np.asarray(self.dims),
            mesh=np.asarray(self.mesh_shape),
            slices=np.asarray(self.slices),
            bdims=np.asarray(self.bdims),
            ghost=np.asarray(self.ghost),
            **{f"dat_{n}": np.asarray(a)
               for n, a in zip(self.fields[1:], self._dats[1:])},
            **{f"aux_{n}": np.asarray(a)
               for n, a in zip(self.aux_names, self._aux)})
        return self

    def load(self, path: str):
        """Restore a checkpoint saved by :meth:`save` (config must
        match this Problem)."""
        import jax
        import jax.numpy as jnp

        z = np.load(path if path.endswith(".npz") else path + ".npz")
        for name, mine in (("dims", self.dims), ("mesh", self.mesh_shape),
                           ("slices", (self.slices,)),
                           ("bdims", self.bdims), ("ghost", self.ghost)):
            if name == "slices" and name not in z:
                got = (1,)      # pre-multislice checkpoints
            else:
                got = tuple(np.atleast_1d(z[name]))
            if got != tuple(mine):
                raise ValueError(
                    f"checkpoint {name} {got} != {tuple(mine)}")
        keys = ["dat"] + [f"dat_{n}" for n in self.fields[1:]]
        missing = ([k for k in keys[1:] if k not in z]
                   + [n for n in self.aux_names if f"aux_{n}" not in z])
        if missing:
            raise ValueError(f"checkpoint lacks fields {missing}")
        self._dats = tuple(
            jax.device_put(jnp.asarray(z[k]), self._sharding)
            for k in keys)
        self._aux = tuple(
            jax.device_put(jnp.asarray(z[f"aux_{n}"]), self._sharding)
            for n in self.aux_names)
        return self

    def _gather(self, dat) -> np.ndarray:
        from .core import from_bricks

        out = np.asarray(dat)
        nd = len(self.dims)
        nb = self.dec.nbricks
        gshape = tuple(m * d for m, d in zip(self.eff_mesh, self.dims))
        full = np.zeros(gshape, self.dtype)
        for r, c in enumerate(np.ndindex(*self.eff_mesh)):
            own = from_bricks(out[r * nb:(r + 1) * nb].reshape(nb, -1),
                              self.dec.interior_grid(), self.bdims)
            sl = tuple(slice(c[a] * self.dims[a],
                             (c[a] + 1) * self.dims[a])
                       for a in range(nd))
            full[sl] = own
        return full

    def result(self, field: str | None = None):
        """Gather the owned region back to dense global array(s):
        single-field problems return the array; systems return
        ``{field: array}`` (or one array when ``field`` names one)."""
        if self._dats is None:
            raise RuntimeError("no state; call init() first")
        if field is not None:
            if field not in self.fields:
                raise ValueError(f"unknown field {field!r}")
            return self._gather(
                self._dats[self.fields.index(field)])
        if self.nfld == 1:
            return self._gather(self._dats[0])
        return {f_: self._gather(d)
                for f_, d in zip(self.fields, self._dats)}
