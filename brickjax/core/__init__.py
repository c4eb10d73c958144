from .layout import (
    Brick,
    BrickInfo,
    BrickStorage,
    adj_index,
    adj_offsets,
    adjacency_from_grid,
    init_grid,
    STEP_ALIGN,
)
from .setup import to_bricks, from_bricks, halo_extend
from .compare import BRICK_TOLERANCE, compare_arrays, compare_bricks
from .multiarray import random_array, zero_array, uninit_array

__all__ = [
    "Brick",
    "BrickInfo",
    "BrickStorage",
    "adj_index",
    "adj_offsets",
    "adjacency_from_grid",
    "init_grid",
    "STEP_ALIGN",
    "to_bricks",
    "from_bricks",
    "halo_extend",
    "BRICK_TOLERANCE",
    "compare_arrays",
    "compare_bricks",
    "random_array",
    "zero_array",
    "uninit_array",
]
