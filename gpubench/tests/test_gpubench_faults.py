"""A run with the timed path broken underneath reads ``correct: false``:
the harness's look for a card is skipped (the program's plain kernels on
the CPU), everything else runs as on the card, at a size a test holds.
One case for each fault a one-card cell can have (the exchange between
cards does not exist there), two faults of the program's canonical
check (which the reference does not share), and the sound run beside
them."""
import math

import pytest
import torch

from harness.runner import MIN_FITS, run_cell
from harness.spec import Cell, load_cell
from repro_torch.core import candgen, dfscode, level_step


def tiny_cell() -> Cell:
    c = load_cell("nci40k.ms15")
    return Cell("tiny", 1, dict(c.config, n_graphs=60, n_partitions=2),
                dict(c.traffic, minsup=0.2, warmup_graphs=20),
                c.end_to_end, c.per_layer)


def store_left_unchanged(monkeypatch):
    """Pass 2 does nothing: each level's child store is handed on as it
    was allocated (no embeddings)."""
    orig = level_step.level_program

    def broken(*args, **kwargs):
        wire, ol, mask = orig(*args, **kwargs)
        return wire, ol.fill_(-1), mask.zero_()
    monkeypatch.setattr(level_step, "level_program", broken)


def half_the_partitions(monkeypatch):
    """Pass 1 sees half of the partitions and takes the mean over them:
    the other half's edges are masked off and the threshold halved."""
    orig = level_step.level_program

    def broken(mesh, c_real, psup, *args, minsup, **kwargs):
        *rest, emask = args
        emask = emask.clone()
        emask[emask.shape[0] // 2:] = False
        return orig(mesh, c_real, psup, *rest, emask,
                    minsup=math.ceil(minsup / 2), **kwargs)
    monkeypatch.setattr(level_step, "level_program", broken)


def one_support_altered(monkeypatch):
    """The shuffle's answer altered where it is made: the global support
    of each level's first frequent candidate is one too high."""
    orig = level_step.reduce_supports

    def broken(*args, **kwargs):
        gsup, verdict = orig(*args, **kwargs)
        gsup = gsup.clone()
        gsup[torch.argmax((verdict[:gsup.shape[0]] != 0).to(torch.int32))] += 1
        return gsup, verdict
    monkeypatch.setattr(level_step, "reduce_supports", broken)


def _plant_canonical(monkeypatch, wrong):
    """The program's canonical check replaced where candgen and the
    auditor's spot checks call it, as one wrong check would be."""
    monkeypatch.setattr(candgen, "is_canonical", wrong)
    monkeypatch.setattr(dfscode, "is_canonical", wrong)


def canonical_accepts_two_edges(monkeypatch):
    """The canonical check lets every two-edge child through: such a
    pattern comes back under each of its DFS codes."""
    orig = dfscode.is_canonical
    _plant_canonical(monkeypatch, lambda code: len(code) == 2 or orig(code))


def canonical_rejects_root_branches(monkeypatch):
    """The canonical check refuses every minimal code whose last edge
    branches from the root: those patterns and their children go
    missing."""
    orig = dfscode.is_canonical
    _plant_canonical(monkeypatch, lambda code: (
        len(code) == 1 or code[-1][0] != 0) and orig(code))


@pytest.mark.parametrize("plant, number", [
    (store_left_unchanged, None), (half_the_partitions, None),
    (one_support_altered, None), (canonical_accepts_two_edges, "extra"),
    (canonical_rejects_root_branches, "missing")])
def test_a_broken_path_reads_incorrect(plant, number, monkeypatch):
    plant(monkeypatch)
    result = run_cell(tiny_cell(), 3, 0.0, False, device="cpu")
    assert result["correct"] is False
    checks = result["checks"]
    assert any(c["value"] > c["limit"] for c in checks.values())
    if number is not None:
        assert checks[number]["value"] > checks[number]["limit"], checks


def test_the_sound_path_reads_correct():
    result = run_cell(tiny_cell(), 3, 0.0, False, device="cpu")
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] == MIN_FITS and result["failed"] == 0
    assert list(result)[-1] == "checks"
