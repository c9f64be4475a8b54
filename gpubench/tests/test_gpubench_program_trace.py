"""The readers of the program's own spans: each on synthetic spans, the
sink set and undone through ``Hooks``, and one traced run on the CPU."""
import pytest

from harness import program_trace
from harness.runner import run_cell
from harness.spec import load_metric
from harness.tracing import Hooks
from repro_torch.runtime import trace
from test_gpubench_faults import tiny_cell

NEW = ["prep_partition_s", "prep_edge_ol_s", "spec_candgen_s",
       "wire_wait_s", "pass2_device_s", "pass2_slot_use_pct", "retry_s"]
S = 10**9


def _span(name, t0, t1, fit, **attrs):
    return (name, int(t0 * S), int(t1 * S), None, fit, attrs)


# two fits: fit 1 admitted the speculation once and retried once, fit 2
# did neither; times in seconds
SPANS = [
    _span("prep.partition.validate", 0, 1, 1),
    _span("prep.partition.filter", 1, 3, 1),
    _span("prep.partition.split", 3, 3.5, 1),
    _span("prep.edge_ol.stack", 4, 4.5, 1),
    _span("prep.edge_ol", 3.5, 5, 1),
    _span("level.spec_candgen", 6, 8, 1),
    _span("level.wait", 8, 8.25, 1, refetches=0),
    _span("level.retry", 8.5, 9, 1, materializations=1, M=32),
    _span("level.pass2", 5.5, 5.6, 1, slots=64, useful=0, device_s=2.0),
    _span("level.pass2", 9.5, 9.6, 1, slots=32, useful=16, device_s=1.0),
    _span("fit", 0, 10, 1),
    _span("prep.partition.validate", 10, 11, 2),
    _span("prep.partition.split", 11, 11.5, 2),
    _span("prep.edge_ol", 12, 13, 2),
    _span("level.wait", 14, 14.75, 2, refetches=1),
    _span("level.pass2", 13.5, 13.6, 2, slots=32, useful=32, device_s=3.0),
    _span("fit", 10, 15, 2),
]


@pytest.mark.parametrize("name, want", [
    ("prep_partition_s", (3.5 + 1.5) / 2),
    ("prep_edge_ol_s", (1.5 + 1.0) / 2),
    ("spec_candgen_s", 2.0 / 2),
    ("wire_wait_s", (0.25 + 0.75) / 2),
    ("pass2_device_s", (2.0 + 1.0 + 3.0) / 2),
    ("pass2_slot_use_pct", 100.0 * 48 / 128),
    ("retry_s", 0.5 / 2)])
def test_reader_on_synthetic_spans(name, want):
    metric = load_metric(name)
    assert metric.read({"hooks": {"program_spans": SPANS}}) == \
        pytest.approx(want)
    # a program without the recorder: nothing to read, and no raise
    assert metric.read({"hooks": {}}) is None


def test_spec_candgen_reads_zero_where_the_gate_refused():
    no_spec = [s for s in SPANS if s[0] != "level.spec_candgen"]
    assert load_metric("spec_candgen_s").read(
        {"hooks": {"program_spans": no_spec}}) == 0.0
    no_device = [s[:5] + ({k: v for k, v in s[5].items()
                           if k != "device_s"},) for s in SPANS]
    assert load_metric("pass2_device_s").read(
        {"hooks": {"program_spans": no_device}}) is None


def test_install_sets_the_sink_once_and_restore_unsets_it():
    hooks = Hooks()
    for name in NEW:
        load_metric(name).install(hooks)
    assert trace.sink is not None
    with trace.span("fit"):
        with trace.span("level.wait"):
            pass
    hooks.restore()
    assert trace.sink is None
    names = [r[0] for r in hooks.data["program_spans"]]
    assert names == ["level.wait", "fit"]
    assert [s[0] for s in hooks.data["spans"]] == names
    assert program_trace.spans({"hooks": hooks.data}) == \
        hooks.data["program_spans"]


def test_a_traced_cpu_run_reports_the_host_span_metrics():
    result = run_cell(tiny_cell(), 3, 0.0, True, device="cpu")
    assert trace.sink is None
    assert result["correct"] is True, result["checks"]
    metrics = result["metrics"]
    for name in NEW:
        if name == "pass2_device_s":
            assert name not in metrics
        else:
            assert metrics[name]["value"] >= 0, name
    assert 0 < metrics["pass2_slot_use_pct"]["value"] <= 100
    assert metrics["prep_partition_s"]["value"] > 0
