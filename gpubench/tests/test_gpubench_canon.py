"""The reference's canonical key: the least DFS code over every traversal
(``harness/canon.py``), against the program's own minimum-DFS-code search
as a second witness, and its invariance under renumbering."""
import numpy as np
import pytest

from harness.canon import is_canonical, min_code
from repro_torch.core.dfscode import min_dfs_code
from repro_torch.core.graphdb import Graph


def random_pattern(rng, n_v, n_extra, n_vl=3, n_el=2):
    """A connected labeled graph: a random tree and ``n_extra`` chords."""
    vl = [int(x) for x in rng.integers(0, n_vl, n_v)]
    edges = {}
    for k in range(1, n_v):
        p = int(rng.integers(0, k))
        edges[(p, k)] = int(rng.integers(0, n_el))
    for _ in range(n_extra):
        u, v = sorted(int(x) for x in rng.choice(n_v, 2, replace=False))
        edges.setdefault((u, v), int(rng.integers(0, n_el)))
    return vl, [(u, v, el) for (u, v), el in edges.items()]


def renumbered(rng, vl, edges):
    perm = rng.permutation(len(vl))
    nvl = [0] * len(vl)
    for old, new in enumerate(perm):
        nvl[int(new)] = vl[old]
    ne = [(int(perm[u]), int(perm[v]), el) for (u, v, el) in edges]
    return nvl, [ne[i] for i in rng.permutation(len(ne))]


@pytest.mark.parametrize("seed", range(6))
def test_min_code_equals_the_programs_and_ignores_numbering(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        n_v = int(rng.integers(2, 7))
        vl, edges = random_pattern(rng, n_v, int(rng.integers(0, 3)))
        code = min_code(vl, edges)
        assert len(code) == len(edges)
        assert is_canonical(code)
        e = np.array([(u, v) for (u, v, _l) in edges], np.int32)
        theirs = min_dfs_code(Graph(np.array(vl, np.int32), e,
                                    np.array([l for *_x, l in edges],
                                             np.int32)))
        assert code == theirs
        assert min_code(*renumbered(rng, vl, edges)) == code


def test_hand_cases():
    # a path a-b-a with labels (1, 0, 1): the least code starts at the
    # lower-labeled middle vertex
    assert min_code([1, 0, 1], [(0, 1, 0), (1, 2, 0)]) == (
        (0, 1, 0, 0, 1), (0, 2, 0, 0, 1))
    # a triangle of one label: tree edge, tree edge, then the back edge
    assert min_code([0, 0, 0], [(0, 1, 0), (1, 2, 0), (0, 2, 0)]) == (
        (0, 1, 0, 0, 0), (1, 2, 0, 0, 0), (2, 0, 0, 0, 0))
    # a star of one label: start at a leaf, since a tree edge from the
    # deeper vertex comes first
    assert min_code([0, 0, 0, 0], [(0, 1, 0), (0, 2, 0), (0, 3, 0)]) == (
        (0, 1, 0, 0, 0), (1, 2, 0, 0, 0), (1, 3, 0, 0, 0))
    assert not is_canonical(((0, 1, 0, 0, 0), (0, 2, 0, 0, 0),
                             (0, 3, 0, 0, 0)))
    # a path of four: from an end, each edge from the deepest vertex
    assert is_canonical(((0, 1, 0, 0, 0), (1, 2, 0, 0, 0),
                         (2, 3, 0, 0, 0)))
    assert not is_canonical(((0, 1, 0, 0, 0), (1, 2, 0, 0, 0),
                             (0, 3, 0, 0, 0)))
