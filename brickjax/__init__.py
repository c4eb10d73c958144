"""brickjax — a bricked-stencil computation framework in JAX.

Built from scratch with the capabilities of bricklib (reference:
/root/reference, benSepanski/bricklib):

- ``core``    — brick data layout: flat device-resident brick storage with an
                explicit adjacency table (ref: include/brick.h).
- ``st``      — the stencil-expression eDSL (ref: codegen/st/), same
                ``STENCIL = [output]`` module contract.
- ``codegen`` — stencil lowering + executors: the dense reference, the
                halo-extend brick executor (the "scalar backend"
                analog) and the pencil window sweep, all plain XLA
                (replacing the AVX512/AVX2/SSE/ASIMD/SVE/CUDA/HIP/OpenCL/
                SYCL emitters of ref: codegen/st/codegen/backend/).
- ``comm``    — distributed decomposition & ghost exchange: BrickDecomp
                skin/ghost planner + shard_map/ppermute halo exchange over a
                jax.sharding.Mesh (ref: include/brick-mpi.h).
- ``bench``   — timing harness with the reference's five-phase taxonomy
                (ref: include/brick-mpi.h:23, stencils/stencils.h:40-53).
- ``utils``   — BitSet direction encoding (ref: include/bitset.h), Z-Morton
                ordering (ref: include/zmort.h).
- ``api``     — the high-level ``Problem`` object (single stencils,
                variable-coefficient aux fields, coupled multi-output
                systems, deep-ghost st_iter, checkpointing).
- ``ooc``     — out-of-core streaming sweeps for domains larger than
                device memory (beyond the reference).
"""

__version__ = "0.1.0"
