"""The control reads ``correct: false``: the program with its embedding
cap halved and its exactness valve off (``control.CONTROL``), through a
whole run, beside the sound program on the same database.  The size is
one a test holds (100 graphs); on seed 3 the control undercounts a
support there, as it does by tens of patterns at a cell's own size."""
from control import CONTROL, CONTROLS
from harness.runner import run_cell
from harness.spec import Cell, load_cell


def small_cell() -> Cell:
    c = load_cell("nci40k.ms15")
    return Cell("small", 1, dict(c.config, n_graphs=100, n_partitions=2),
                dict(c.traffic, warmup_graphs=20),
                c.end_to_end, c.per_layer)


def test_control_reads_incorrect():
    result = run_cell(small_cell(), 3, 0.0, False, device="cpu",
                      overrides=CONTROLS[CONTROL])
    assert result["correct"] is False
    assert result["checks"]["support"]["value"] >= 1


def test_sound_program_reads_correct_on_the_same_data():
    result = run_cell(small_cell(), 3, 0.0, False, device="cpu")
    assert result["correct"] is True, result["checks"]
