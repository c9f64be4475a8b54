"""The plain reference against the program: the frozen generator makes
the program's databases, and the reference's frequent set equals the
program's CPU fit and its sequential host miner."""
import numpy as np
import pytest

from harness import check, program
from harness.generator import generate, make_db
from harness.reference import abs_minsup, mine
from repro_torch.core.graphdb import pubchem_like_db
from repro_torch.core.host_miner import mine_host


def pubchem_like(n, *, seed):
    return generate("pubchem_like", n, seed)


@pytest.mark.parametrize("n, seed", [(50, 0), (40, 2**31 + 7)])
def test_generator_is_the_programs(n, seed):
    mine_ = pubchem_like(n, seed=seed)
    theirs = pubchem_like_db(n, seed=seed)
    for a, b in zip(mine_, theirs):
        assert np.array_equal(a.vlabels, b.vlabels)
        assert np.array_equal(a.edges, b.edges)
        assert np.array_equal(a.elabels, b.elabels)


def test_make_db_takes_any_seed():
    conf = {"generator": "pubchem_like", "n_graphs": 3, "base_seed": 0}
    a, b = make_db(conf, -5), make_db(conf, (1 << 64) - 5)
    assert all(np.array_equal(x.edges, y.edges) for x, y in zip(a, b))


def test_seeds_shuffle_one_database():
    """Every seed gives the same graphs (the same frequent set), as other
    bytes in another order."""
    conf = {"generator": "pubchem_like", "n_graphs": 200, "base_seed": 0}
    a, b = make_db(conf, 1), make_db(conf, 2)
    assert not all(np.array_equal(x.edges, y.edges) for x, y in zip(a, b))
    base = mine(pubchem_like(200, seed=0), 0.15)
    for db in (a, b):
        assert sorted(g.edges.shape[0] for g in db) == sorted(
            g.edges.shape[0] for g in pubchem_like(200, seed=0))
        got = mine(db, 0.15)
        assert got.levels == base.levels and got.supports == base.supports


@pytest.mark.parametrize("n, minsup, seed", [
    (150, 0.15, 1), (200, 0.1, 5), (120, 0.2, 2**31 + 3), (60, 4, 9)])
def test_reference_equals_host_miner(n, minsup, seed):
    db = pubchem_like(n, seed=seed)
    ref = mine(db, minsup)
    host = mine_host(pubchem_like_db(n, seed=seed), abs_minsup(minsup, n))
    assert ref.levels == [sorted(l) for l in host.levels]
    assert ref.supports == {c: p.support for c, p in host.frequent.items()}


def test_reference_max_size():
    db = pubchem_like(100, seed=4)
    full, cut = mine(db, 0.15), mine(db, 0.15, max_size=2)
    assert cut.levels == full.levels[:2]


@pytest.mark.parametrize("n, parts, minsup, seed", [
    (60, 2, 0.2, 3), (80, 4, 0.15, 4)])
def test_reference_equals_program_cpu_fit(n, parts, minsup, seed):
    db = pubchem_like(n, seed=seed)
    conf = {"n_partitions": parts, "scheme": 2}
    fit = program.fit_once(program.to_graphs(db), conf,
                           {"minsup": minsup, "max_size": None}, "cpu")
    ref = mine(db, minsup)
    numbers = check.compare([fit], ref)
    assert check.is_correct(numbers, 1), numbers
    assert len(ref.levels) >= 3
