from .autodiff import (adjoint_stencil, differentiable_pencil_sweep,
                       differentiable_pencil_sweep_2d,
                       differentiable_pencil_sweep_4d,
                       differentiable_poly_sweep,
                       differentiable_poly_sweep_2d,
                       differentiable_poly_sweep_4d,
                       differentiable_poly_system_sweep,
                       differentiable_poly_system_sweep_2d,
                       differentiable_poly_system_sweep_4d,
                       linear_taps, oracle_vjp_sweep,
                       polynomial_adjoint_stencils,
                       polynomial_system_adjoints)
from .evaluate import evaluate, resolve_const_from_params
from .ir import StencilIR, additive_groups, linear_decomposition
from .jnp_backend import dense_apply, brick_apply
from .sweep import pencil_sweep

__all__ = [
    "evaluate",
    "resolve_const_from_params",
    "StencilIR",
    "linear_decomposition",
    "additive_groups",
    "dense_apply",
    "brick_apply",
    "pencil_sweep",
    "adjoint_stencil",
    "linear_taps",
    "differentiable_pencil_sweep",
    "differentiable_pencil_sweep_2d",
    "differentiable_pencil_sweep_4d",
    "differentiable_poly_sweep",
    "differentiable_poly_sweep_2d",
    "differentiable_poly_sweep_4d",
    "differentiable_poly_system_sweep",
    "differentiable_poly_system_sweep_2d",
    "differentiable_poly_system_sweep_4d",
    "polynomial_adjoint_stencils",
    "polynomial_system_adjoints",
    "oracle_vjp_sweep",
]
