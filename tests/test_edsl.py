"""eDSL structure tests (ref contract: codegen/st/, STENCIL = [output])."""

import pytest

from brickjax.st import ConstRef, Grid, Index, load_stencil_module
from brickjax.st.grid import eval_offset
from brickjax.codegen.ir import linear_decomposition
from brickjax.stencils import stencil_by_name


def test_eval_offset_affine():
    i = Index(0)
    assert eval_offset(i + 1)[2] == 1
    assert eval_offset(i - 3)[2] == -3
    assert eval_offset(2 + i)[2] == 2
    var, coef, off = eval_offset(i)
    assert var is i and coef == 1 and off == 0


def test_gridref_offsets_and_assign():
    i, j, k = Index(0), Index(1), Index(2)
    g = Grid("in", 3)
    out = Grid("out", 3)
    r = g(i + 1, j, k - 2)
    assert r.offsets == [1, 0, -2]
    out(i, j, k).assign(0.5 * g(i, j, k) + r)
    sdefs = load_stencil_module({"STENCIL": [out]})
    assert len(sdefs) == 1
    sd = sdefs[0]
    assert sd.dims == 3
    assert set(sd.inputs) == {"in"}
    # numpy-ordered: eDSL (1, 0, -2) -> (k, j, i) = (-2, 0, 1)
    assert (-2, 0, 1) in sd.tap_offsets_np()
    lo, hi = sd.radius()
    assert lo == (2, 0, 0) and hi == (0, 0, 1)


def test_gridref_rejects_bad_subscripts():
    i, j, k = Index(0), Index(1), Index(2)
    g = Grid("in", 3)
    with pytest.raises(ValueError):
        g(i + j, j, k)  # two indices in one subscript
    with pytest.raises(ValueError):
        g(2 * i, j, k)  # non-unit coefficient
    with pytest.raises(ValueError):
        g(i, j)  # wrong arity
    out = Grid("out", 3)
    with pytest.raises(ValueError):
        out(i + 1, j, k).assign(g(i, j, k))  # shifted output


def test_corpus_shapes():
    expect = {
        "s7pt": (7, 1), "cond": (7, 1), "s27pt": (27, 1),
        "mpi7pt": (7, 1), "mpi13pt": (13, 2), "mpi25pt": (25, 4),
        "mpi125pt": (125, 2),
    }
    for name, (ntaps, rad) in expect.items():
        sd = stencil_by_name(name)[0]
        assert len(sd.tap_offsets_np()) == ntaps, name
        lo, hi = sd.radius()
        assert lo == (rad,) * 3 and hi == (rad,) * 3, name
    sd = stencil_by_name("mpi9pt")[0]
    assert sd.dims == 4
    assert len(sd.tap_offsets_np()) == 9


def test_linear_decomposition_groups():
    sd = stencil_by_name("mpi125pt")[0]
    lin = linear_decomposition(sd.rhs)
    assert lin is not None
    assert len(lin) == 10  # C0..C9 symmetry classes
    counts = sorted(len(taps) for _, _, taps in lin)
    assert counts == sorted([1, 6, 6, 12, 24, 12, 8, 24, 24, 8])
    # cond is not a linear combination
    sd = stencil_by_name("cond")[0]
    assert linear_decomposition(sd.rhs) is None


def test_reference_style_module_loads_via_st_alias():
    """A stencil written against the reference's `from st.expr import ...`
    API loads unchanged (the loader aliases st -> brickjax.st)."""
    import brickjax.st  # triggers nothing; alias happens in loader
    from brickjax.st.loader import _alias_st
    _alias_st()
    src = (
        "from st.expr import Index, ConstRef\n"
        "from st.grid import Grid\n"
        "i = Index(0)\nj = Index(1)\nk = Index(2)\n"
        "inp = Grid('bIn', 3)\nout = Grid('bOut', 3)\n"
        "calc = ConstRef('MPI_ALPHA') * inp(i, j, k) + 0.25 * inp(i+1, j, k)\n"
        "out(i, j, k).assign(calc)\n"
        "STENCIL = [out]\n"
    )
    g = {}
    exec(src, g)
    sdefs = load_stencil_module(g)
    assert sdefs[0].output.name == "bOut"
    assert len(sdefs[0].tap_offsets_np()) == 2
