"""BrickDecomp planner invariants (ref assertions: weak/main.cpp:87-94,
brick-mpi.h layout contract)."""

import numpy as np
import pytest

from brickjax.comm import BrickDecomp, skin3d_good, skin3d_bad, skinlist_by_name
from brickjax.utils.bitset import allneighbors


@pytest.fixture(scope="module")
def dec():
    d = BrickDecomp(dims=(32, 32, 32), ghost_depth=(4, 4, 8),
                    bdims=(4, 4, 8))
    return d.initialize(skin3d_good)


def test_grid_coverage_and_garbage_brick(dec):
    g = dec.grid
    assert g.shape == (10, 10, 6)
    vals = np.sort(g.ravel())
    # every storage index 1..nbricks-1 appears exactly once; 0 is garbage
    assert vals[0] == 1
    assert np.array_equal(vals, np.arange(1, dec.nbricks))
    assert dec.nbricks == 10 * 10 * 6 + 1


def test_sep_pos_ordering(dec):
    s0, s1, s2 = dec.sep_pos
    interior = 6 * 6 * 2  # (gdims - 2gz) product
    assert s0 == 1 + interior
    # skin = owned minus inner interior
    owned = 8 * 8 * 4
    assert s1 - s0 == owned - interior
    assert s2 == dec.nbricks
    # interior grid holds exactly the owned bricks, all below s1
    og = dec.interior_grid()
    assert og.shape == (8, 8, 4)
    assert og.max() < s1 and og.min() >= 1


def test_adjacency_involution_and_center(dec):
    info = dec.info
    assert np.array_equal(info.adj[:, info.center],
                          np.arange(dec.nbricks))
    assert info.check_involution(dec.grid[1:-1, 1:-1, 1:-1])


def test_ghost_skin_mirror(dec):
    assert len(dec.ghost) == len(dec.skin)
    seen = set()
    for g, s in zip(dec.ghost, dec.skin):
        assert g.len == s.len
        assert s.neighbor == ~g.neighbor
        assert (g.skin_st, g.skin_ed) == (s.skin_st, s.skin_ed)
        seen.add(g.neighbor.set)
        # ghost runs live in the ghost segment, skins in the skin segment
        assert g.pos >= dec.sep_pos[1]
        assert dec.sep_pos[0] <= s.pos < dec.sep_pos[1]
    # all 26 neighbors covered
    assert seen == {n.set for n in allneighbors(3) if n}


def test_skin3d_good_single_run_per_neighbor(dec):
    """The 'good' ordering gives few runs — that is its whole point
    (ref: docs; PPoPP'21).  Every neighbor needs >= 1 run; face neighbors
    should be a single run when contiguous in the list."""
    from collections import Counter
    runs = Counter(g.neighbor.set for g in dec.ghost)
    assert max(runs.values()) <= 4  # ±outermost faces split into 4 runs
    total = sum(runs.values())
    bad = BrickDecomp(dims=(32, 32, 32), ghost_depth=(4, 4, 8),
                      bdims=(4, 4, 8)).initialize(skin3d_bad)
    assert sum(1 for _ in bad.ghost) > total  # bad ordering fragments


def test_sections_partition_ghost_segment(dec):
    ghost_secs = [s for s in dec.sections if s.owner]
    assert sum(s.len for s in ghost_secs) == dec.sep_pos[2] - dec.sep_pos[1]
    skin_secs = [s for s in dec.sections if not s.owner]
    assert sum(s.len for s in skin_secs) == dec.sep_pos[1] - dec.sep_pos[0]


def test_stage_sections_corner_forwarding(dec):
    order, stages = dec.stage_sections()
    assert order == [2, 1, 0]
    n_pairs = sum(len(st[s]) for st in stages for s in (+1, -1))
    ghost_secs = [s for s in dec.sections if s.owner]
    assert n_pairs == len(ghost_secs)
    # stage 0 (innermost axis) sources must be pure skin sections
    for sign in (+1, -1):
        for dst, src in stages[0][sign]:
            assert not src.owner
            assert dst.skin_idx == src.skin_idx
    # later stages may forward ghosts received earlier
    fwd = [
        (dst, src)
        for st in stages[1:] for sign in (+1, -1) for dst, src in st[sign]
        if src.owner
    ]
    assert fwd, "corner forwarding must occur"
    # a forwarded source differs from its dst only in the stage axis
    for dst, src in fwd:
        diff = dst.owner ^ src.owner
        assert diff.size() == 1


def test_zero_ghost_axis():
    d = BrickDecomp(dims=(16, 16, 16), ghost_depth=(4, 4, 0),
                    bdims=(4, 4, 8)).initialize(skinlist_by_name("good"))
    # no runs may involve the innermost axis (tag 1)
    for g in d.ghost:
        assert 1 not in g.neighbor and -1 not in g.neighbor
    assert d.grid.shape == (6, 6, 2)


def test_4d_decomp():
    d = BrickDecomp(dims=(8, 8, 8, 16), ghost_depth=(2, 2, 2, 8),
                    bdims=(2, 2, 2, 8)).initialize(skinlist_by_name("lex", 4))
    assert d.info.check_involution(d.grid[1:-1, 1:-1, 1:-1, 1:-1])
    neigh = {g.neighbor.set for g in d.ghost}
    assert len(neigh) == 80  # 3^4 - 1


def test_periodic_grid_wraps(dec):
    """Ghost cells on table axes redirect to wrapped owned cells; owned
    cells are untouched (zero-copy periodicity)."""
    g = dec.periodic_grid((0, 2))
    own = dec.grid[1:-1, 1:-1, 1:-1]
    assert np.array_equal(g[1:-1, 1:-1, 1:-1], own)
    # k ghost rows -> wrapped owned rows (k interior = 8 cells)
    assert np.array_equal(g[0], g[8])
    assert np.array_equal(g[9], g[1])
    # i ghost -> wrapped (i interior = 4 cells)
    assert np.array_equal(g[:, :, 0], g[:, :, 4])
    assert np.array_equal(g[:, :, 5], g[:, :, 1])
    # axis 1 NOT in table_axes: ghost pencils unchanged
    assert np.array_equal(g[1:-1, 0, 1:-1], dec.grid[1:-1, 0, 1:-1])
