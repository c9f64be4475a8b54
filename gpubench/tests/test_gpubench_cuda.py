"""On the card: a small cell through the whole traced run (the program's
CUDA kernels, the profiler, the B1 events and counts).  Skips without a
card; run it on the chip with ``-m cuda``."""
import pytest
import torch

from harness.runner import run_cell
from harness.spec import Cell, load_cell


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
def test_small_cell_on_the_card(trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = load_cell("nci40k.ms15")
    cell = Cell("small", 1, dict(c.config, n_graphs=2000),
                dict(c.traffic, warmup_graphs=500),
                c.end_to_end, c.per_layer)
    r = run_cell(cell, 2**31 + 1, 0.0, trace, device="cuda")
    assert r["correct"] is True, r["checks"]
    assert r["device"]["platform"] == "gpu"
    m = r["metrics"]
    if trace:
        assert 0 < m["b1_roofline_pct"]["value"] <= 100
        assert 0 <= m["device_idle_pct"]["value"] < 100
        assert r["device"]["busy_s"] > 0
        assert r["breakdown"]["device_ops"]
    else:
        assert m["fit_s"]["value"] > 0 and m["peak_mem_gib"]["value"] > 0
