"""The port's continuous invariant auditor (DESIGN.md §14), held to the
JAX package's units (``tests/test_auditor.py``), its overhead model
equal to the JAX package's on that file's grid.

Doctored-level tests: hand a consistent level to the auditor and flip
exactly one invariant at a time — support threshold, support range,
downward closure, monotonicity, canonicality — pinning both that the
violation raises :class:`AuditError` and that the clean level appends
a report row.  The overhead model is gated here at the same <5% bound
``benchmarks/check_recovery.py`` enforces in CI.
"""
import numpy as np
import pytest

from repro.core import auditor as jauditor
from repro_torch.core import dfscode
from repro_torch.core.auditor import (Auditor, _is_canonical,
                                      audit_frequent_set,
                                      audit_overhead_model,
                                      describe_audit_word)
from repro_torch.core.candgen import Candidate
from repro_torch.core.graphdb import random_db
from repro_torch.core.host_miner import mine_host
from repro_torch.runtime.errors import AuditError

# a canonical 2-edge code and its 1-edge parent
PARENT = ((0, 1, 0, 0, 0),)
CHILD = ((0, 1, 0, 0, 0), (1, 2, 0, 0, 1))
# same shape, labels permuted so the min DFS code starts elsewhere
NON_CANON = ((0, 1, 1, 0, 0), (1, 2, 0, 0, 0))
NC_PARENT = ((0, 1, 1, 0, 0),)


# ---------------------------------------------------------------------------
# audit word
# ---------------------------------------------------------------------------

def test_describe_audit_word():
    assert describe_audit_word(0) == "clean"
    assert describe_audit_word(1) == "monotonicity"
    assert describe_audit_word(3) == "monotonicity+compaction"
    assert describe_audit_word(15) == \
        "monotonicity+compaction+support-range+survivor-count"


def test_check_wire_zero_is_clean_nonzero_raises():
    a = Auditor(minsup=5)
    a.check_wire(3, 0)                          # no raise, no report row
    assert a.report == []
    with pytest.raises(AuditError) as ei:
        a.check_wire(3, 0x5)
    assert ei.value.level == 3
    assert "monotonicity" in str(ei.value) and "range" in str(ei.value)


# ---------------------------------------------------------------------------
# per-level spot checks (doctored levels)
# ---------------------------------------------------------------------------

def _level(gsup_val=6, code=CHILD, parent_idx=0, parents=(PARENT,),
           parent_sup=8):
    cands = [Candidate(code, parent_idx, None)]
    keep = np.array([0])
    gsup = np.array([gsup_val])
    supports = {p: parent_sup for p in parents}
    return dict(cands=cands, keep=keep, gsup=gsup,
                parents=list(parents), supports=supports)


def test_check_level_clean_appends_report_row():
    a = Auditor(minsup=5, n_graphs=10, samples=4)
    a.check_level(2, **_level())
    assert a.report == [{
        "level": 2,
        "checked": {"verdict": 1, "closure": 1, "canonical": 1},
        "n_survivors": 1, "ok": True}]


def test_check_level_below_minsup_survivor():
    a = Auditor(minsup=5, samples=4)
    with pytest.raises(AuditError, match="< minsup"):
        a.check_level(2, **_level(gsup_val=3))


def test_check_level_support_above_graph_count():
    a = Auditor(minsup=5, n_graphs=10, samples=4)
    with pytest.raises(AuditError, match="graph count"):
        a.check_level(2, **_level(gsup_val=11, parent_sup=12))


def test_check_level_downward_closure_violation():
    # recorded parent is NOT the rightmost-removed prefix
    a = Auditor(minsup=5, samples=4)
    lvl = _level(parents=(((0, 1, 1, 1, 1),),))
    with pytest.raises(AuditError, match="downward closure"):
        a.check_level(2, **lvl)


def test_check_level_parent_index_out_of_range():
    a = Auditor(minsup=5, samples=4)
    with pytest.raises(AuditError, match="downward closure"):
        a.check_level(2, **_level(parent_idx=7))


def test_check_level_monotonicity_violation():
    # child claims more support than its parent — anti-monotone pruning
    # says impossible
    a = Auditor(minsup=5, samples=4)
    with pytest.raises(AuditError, match="monotonicity"):
        a.check_level(2, **_level(gsup_val=9, parent_sup=8))


def test_check_level_non_canonical_survivor():
    assert not dfscode.is_canonical(NON_CANON)   # fixture sanity
    a = Auditor(minsup=5, samples=4)
    lvl = _level(code=NON_CANON, parents=(NC_PARENT,))
    with pytest.raises(AuditError, match="not canonical"):
        a.check_level(2, **lvl)


# ---------------------------------------------------------------------------
# whole-prefix audit (checkpoint cuts)
# ---------------------------------------------------------------------------

def _prefix():
    levels = [[PARENT], [CHILD]]
    supports = {PARENT: 8, CHILD: 6}
    return levels, supports


def test_check_levels_clean_prefix():
    levels, supports = _prefix()
    a = Auditor(minsup=5, n_graphs=10, samples=4)
    a.check_levels(levels, supports, start_level=1)
    assert [r["level"] for r in a.report] == [1, 2]
    assert all(r["ok"] for r in a.report)


def test_check_levels_absent_parent():
    levels, supports = _prefix()
    levels[0] = []                              # orphan the child
    a = Auditor(minsup=5, samples=4)
    with pytest.raises(AuditError, match="downward closure"):
        a.check_levels(levels, supports, start_level=2)


def test_check_levels_support_inversion():
    levels, supports = _prefix()
    supports[CHILD] = 9                         # > parent's 8
    a = Auditor(minsup=5, samples=4)
    with pytest.raises(AuditError, match="monotonicity"):
        a.check_levels(levels, supports, start_level=2)


def test_check_levels_missing_support():
    levels, supports = _prefix()
    del supports[CHILD]
    a = Auditor(minsup=5, samples=4)
    with pytest.raises(AuditError, match="missing a support"):
        a.check_levels(levels, supports, start_level=2)


# ---------------------------------------------------------------------------
# frequent-set gate (partial-result certification)
# ---------------------------------------------------------------------------

def test_audit_frequent_set_passes_host_miner_output():
    db = random_db(10, seed=5, n_vertices=9, n_vlabels=2, n_elabels=1)
    ref = mine_host(db, 5, max_size=4)
    supports = {c: i.support for c, i in ref.frequent.items()}
    report = audit_frequent_set(ref.levels, supports, 5, n_graphs=10)
    assert len(report) == len(ref.levels)
    assert all(r["ok"] for r in report)


def test_audit_frequent_set_rejects_doctored_support():
    db = random_db(10, seed=5, n_vertices=9, n_vlabels=2, n_elabels=1)
    ref = mine_host(db, 5, max_size=3)
    supports = {c: i.support for c, i in ref.frequent.items()}
    child = ref.levels[1][0]
    supports[child] = supports[tuple(child[:-1])] + 1   # invert monotone
    with pytest.raises(AuditError):
        audit_frequent_set(ref.levels, supports, 5)


# ---------------------------------------------------------------------------
# overhead model (the CI gate's bound)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cp,np_,w,packed", [
    (64, 2, 1, False), (256, 4, 2, False), (1024, 8, 4, False),
    (1024, 8, 4, True), (512, 8, 1, True), (4096, 16, 8, False),
])
def test_overhead_model_under_five_percent(cp, np_, w, packed):
    m = audit_overhead_model(cp, np_, w, packed=packed)
    assert m["overhead"] < 0.05, m
    assert m["audit_bytes"] > 0 and m["path_bytes"] > m["audit_bytes"]
    assert m == jauditor.audit_overhead_model(cp, np_, w, packed=packed)
    for kw in (dict(reduce="psum"), dict(sharded=False), dict(parents=3)):
        assert audit_overhead_model(cp, np_, w, packed=packed, **kw) == \
            jauditor.audit_overhead_model(cp, np_, w, packed=packed, **kw)


def test_overhead_model_upload_scales_with_parents_not_candidates():
    few = audit_overhead_model(1024, 8, 4, parents=16)
    many = audit_overhead_model(1024, 8, 4, parents=1024)
    assert few["audit_bytes"] < many["audit_bytes"]
    assert few["parents"] == 16
    # default fanout assumption: cp/4
    assert audit_overhead_model(1024, 8, 4)["parents"] == 256


def test_device_canonicality_waits_for_the_device_loop_slice():
    """The device-loop slice has come: ``device=True`` answers on the
    bounded array machine, as the exact host checker does."""
    for code, want in ((CHILD, True), (NON_CANON, False), (PARENT, True)):
        assert _is_canonical(code) is want
        assert _is_canonical(code, device=True) is want


def test_device_canonicality_matches_host_checker_and_jax():
    """``_is_canonical(device=True)`` over the frequent codes of a seeded
    DB and every rightmost extension of them (canonical or not) agrees
    with the host checker and with the JAX package's device answer; a
    code past the machine's 31 edges is inconclusive (None)."""
    graphs = random_db(10, n_vertices=6, extra_edge_prob=0.4, n_vlabels=3,
                       n_elabels=2, seed=1)
    codes = list(mine_host(graphs, 2, max_size=4).frequent)
    grown = []
    for code in codes:
        n_v = max(max(e[0], e[1]) for e in code) + 1
        for w in dfscode.rightmost_path(code):
            for lab in (0, 1, 2):
                grown.append(code + ((w, n_v, code[0][2], 0, lab),))
    pile = codes + grown
    got = [_is_canonical(c, device=True) for c in pile]
    assert got == [_is_canonical(c) for c in pile]
    assert True in got and False in got
    assert got == [jauditor._is_canonical(c, device=True) for c in pile]
    path = tuple((i, i + 1, 0, 0, 0) for i in range(32))
    assert _is_canonical(path, device=True) is None
