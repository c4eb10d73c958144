"""fake_stencil layout validation (ref: single/mpi.cpp:16-135 — the
distributed layout tested without any cluster) and the vecscatter CLI
analog."""

import numpy as np

from brickjax.comm import BrickDecomp, skin3d_good
from brickjax.core import compare_arrays, from_bricks, init_grid, random_array, to_bricks
from brickjax.core.fake import fake_stencil
from brickjax.codegen.vecscatter import describe


def test_fake_stencil_dense_vs_decomp_layout():
    """Same data through two layouts (dense init_grid vs BrickDecomp skin
    ordering) must give identical fake_stencil results — layout
    independence, the reference's single-mpi check."""
    BD = (4, 4, 8)
    ext_shape = (24, 24, 32)  # 4x4x2 interior bricks + ghost ring
    arr = random_array(ext_shape, np.float32, 13)

    grid_d, info_d = init_grid((6, 6, 4))
    dat_d = to_bricks(arr, grid_d, BD)
    out_d = fake_stencil(dat_d.reshape((-1,) + BD), info_d.adj)

    dec = BrickDecomp(dims=(16, 16, 16), ghost_depth=(4, 4, 8),
                      bdims=BD).initialize(skin3d_good)
    dat_s = np.zeros((dec.nbricks, 128), np.float32)
    to_bricks(arr, dec.grid, BD, dat=dat_s)
    out_s = fake_stencil(dat_s.reshape((-1,) + BD), dec.info.adj)

    inner_d = grid_d[1:-1, 1:-1, 1:-1]
    inner_s = dec.grid[1:-1, 1:-1, 1:-1]
    a = from_bricks(out_d.reshape(len(dat_d), -1), inner_d, BD)
    b = from_bricks(out_s.reshape(len(dat_s), -1), inner_s, BD)
    assert compare_arrays(a, b, 1e-6)


def test_fake_stencil_center_check():
    import pytest

    grid, info = init_grid((3, 3, 3))
    adj = info.adj.copy()
    adj[5, info.center] = 4  # corrupt
    view = np.zeros((27, 2, 2, 2), np.float32)
    with pytest.raises(RuntimeError):
        fake_stencil(view, adj)


def test_vecscatter_describe():
    d = describe("mpi125pt")[0]
    assert d["taps"] == 125
    assert d["radius_lo"] == [2, 2, 2]
    assert len(d["coeff_groups"]) == 10
    assert describe("cond")[0]["linear"] is False
    d9 = describe("mpi9pt")[0]
    assert d9["dims"] == 4 and d9["taps"] == 9


def test_vecscatter_describe_adjoint():
    # --adjoint analyzes the transpose stencil; an asymmetric radius
    # mirrors (lo <-> hi), a symmetric one is self-adjoint
    import numpy as np

    d = describe("mpi13pt", adjoint=True)[0]
    s = describe("mpi13pt")[0]
    assert d["taps"] == s["taps"] == 13
    assert d["radius_lo"] == s["radius_hi"]
    assert d["output"].endswith("_adj")


def test_vecscatter_describe_adjoint_polynomial():
    # variable-coefficient / polynomial stencils: one pullback
    # stencil per input field (reads the cotangent + the originals)
    import os

    path = os.path.join(os.path.dirname(__file__), os.pardir,
                        "examples", "varcoeff_diffusion.py")
    ds = describe(path, {"dt": 0.05}, adjoint=True)
    outs = {d["output"]: d for d in ds}
    assert set(outs) == {"out_adj_u", "out_adj_c"}
    assert "out_ct" in outs["out_adj_u"]["inputs"]
    assert "u" in outs["out_adj_c"]["inputs"]
