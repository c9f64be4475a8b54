"""Nothing the benchmark runs loads JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` begins with
``repro``), and the reference loads nothing of the program."""
import subprocess
import sys

from harness.runner import FORBIDDEN, forbidden_modules
from harness.spec import BENCH_DIR, ROOT

_RUN = f"""
import sys
sys.path[:0] = [{str(BENCH_DIR)!r}, {str(ROOT / 'src')!r}]
from harness.spec import Cell, load_cell, load_metric
from harness.runner import run_cell, forbidden_modules
import run, control
c = load_cell("nci40k.ms15")
cell = Cell("tiny", 1, dict(c.config, n_graphs=40, n_partitions=2),
            dict(c.traffic, minsup=0.2, warmup_graphs=20),
            c.end_to_end, c.per_layer)
for trace in (False, True):
    r = run_cell(cell, 1, 0.0, trace, device="cpu")
    assert r["correct"], r
for m in c.end_to_end + c.per_layer:
    load_metric(m)
import repro_torch.kernels.ops, repro_torch.kernels.fused_level
print(sorted({{m.split('.')[0] for m in sys.modules}}))
print(forbidden_modules())
"""


def test_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro" in FORBIDDEN and "jax" in FORBIDDEN
    assert forbidden_modules() == [m for m in FORBIDDEN if m in sys.modules]


def test_a_run_loads_no_jax_and_no_repro():
    out = subprocess.run([sys.executable, "-c", _RUN], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    names, found = out.stdout.strip().splitlines()[-2:]
    assert found == "[]"
    assert "'repro_torch'" in names
    assert not ({"'jax'", "'jaxlib'", "'flax'", "'repro'"}
                & set(names.strip("[]").split(", ")))


def test_reference_loads_nothing_of_the_program():
    code = (f"import sys; sys.path[:0] = [{str(BENCH_DIR)!r}, "
            f"{str(ROOT / 'src')!r}]\n"
            "import harness.reference, harness.canon, harness.generator\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('repro_torch', 'torch', 'repro', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"
