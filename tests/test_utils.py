
from brickjax.utils import BitSet, ZMort
from brickjax.utils.bitset import allneighbors
from brickjax.utils.zmort import zmort_ids


def test_bitset_basic():
    s = BitSet([1, -3])
    assert 1 in s and -3 in s and 3 not in s and -1 not in s
    assert s.size() == 2
    assert s.elements() == [1, -3]
    assert BitSet() == BitSet([])
    assert not BitSet()


def test_bitset_algebra():
    a = BitSet([1, 2])
    b = BitSet([2, -3])
    assert (a & b) == BitSet([2])
    assert (a | b) == BitSet([1, 2, -3])
    assert (a ^ b) == BitSet([1, -3])
    assert ~BitSet([1, -3]) == BitSet([-1, 3])
    assert BitSet([2]) <= a
    assert a >= BitSet([1])
    assert not (BitSet([3]) <= a)
    assert a.flip(1) == BitSet([2])
    assert a.flip(-1) == BitSet([1, 2, -1])


def test_bitset_hashable_rank_map_key():
    m = {BitSet([1, -2]).set: 7}
    assert m[BitSet([1, -2]).set] == 7


def test_allneighbors():
    ns = allneighbors(3)
    assert len(ns) == 27
    assert len(set(n.set for n in ns)) == 27
    assert BitSet() in ns
    assert BitSet([1, 2, 3]) in ns
    assert BitSet([-1, -2, -3]) in ns


def test_zmort_roundtrip():
    for coords in [(0, 0, 0), (1, 2, 3), (5, 0, 7), (3, 3, 3), (10, 20, 30)]:
        z = ZMort.encode(coords)
        assert z.coords() == coords
    # classic 2-D morton: (x=1, y=1) -> 3
    assert ZMort.encode((1, 1)).id == 3
    assert ZMort.encode((1, 0)).id == 1
    assert ZMort.encode((0, 1)).id == 2


def test_zmort_set():
    z = ZMort.encode((1, 2, 3))
    z2 = z.set(1, 5)
    assert z2.coords() == (1, 5, 3)


def test_zmort_ids_grid():
    ids = zmort_ids((4, 4))
    # axis ordering: last axis = morton dim 0
    assert ids[0, 0] == 0
    assert ids[0, 1] == 1  # x=1,y=0
    assert ids[1, 0] == 2  # y=1
    assert ids[1, 1] == 3
    # a permutation of 0..15
    assert sorted(ids.ravel().tolist()) == list(range(16))
    # matches scalar encode
    for y in range(4):
        for x in range(4):
            assert ids[y, x] == ZMort.encode((x, y)).id
