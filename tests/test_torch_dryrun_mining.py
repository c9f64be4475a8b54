"""The port's mining dry run (``repro_torch.launch.dryrun_mining``) at W =
4 against ``repro.launch.dryrun_mining.run`` on a 2×2 mesh of 4
simulated devices (its production mesh replaced by that one), at small
shapes, for both reduces: the analytic HBM bytes equal, and the support
round's collectives — kinds, counts, payload and wire bytes — equal to
those ``parse_hlo_cost`` reads in ``repro``'s compiled program.  The
materialization's one collective is the overflow's sum (an int64 in
the port, int32 in ``repro``).  ``repro``'s ``run`` cannot run as it is
(ROADMAP C7): the test hands its ``_materialize_program`` the width
``materialize_ol`` defaults to."""
import pytest

import torch_ranks
from repro_torch.launch import dryrun_mining as tdm
from repro_torch.roofline import hw

SHAPES = dict(parts_per_dev=2, P=8, C=16, G=64, M=8, K=4, T=8, F=8,
              minsup=3)
REDUCES = ["psum", "reduce_scatter"]

JAX_BODY = """
import repro.core.mapreduce as mr
import repro.launch.mesh as jmesh
import repro.roofline.hlo as hlo
from repro.launch.dryrun_mining import run
# ROADMAP C7: repro's run calls _materialize_program(mmesh, M) without
# its out_width, which raises; None is the width materialize_ol defaults
materialize = mr._materialize_program
mr._materialize_program = lambda mmesh, M: materialize(mmesh, M, None)
jmesh.make_production_mesh = lambda multi_pod=False: jmesh.make_mesh(
    (2, 2), ("data", "model"))
parse, seen = hlo.parse_hlo_cost, []
def record(text):
    seen.append(parse(text))
    return seen[-1]
hlo.parse_hlo_cost = record
for reduce in ARGS[1].split(","):
    seen.clear()
    out = run("single", ARGS[0], reduce=reduce, **eval(ARGS[2]))
    RESULT[reduce] = {
        phase: dict(out[phase], payload_bytes=c.collective_payload_bytes)
        for phase, c in zip(("support", "materialize"), seen)}
"""


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("mining")
    _, ref = torch_ranks.run(out, jax=(JAX_BODY, 4),
                             args=(str(out / "jax"), ",".join(REDUCES),
                                   repr(SHAPES)), timeout=300)
    port = {r: tdm.run("single", str(out / "port"), reduce=r, world=4,
                       **SHAPES) for r in REDUCES}
    return port, ref


@pytest.mark.parametrize("reduce", REDUCES)
def test_support_round_collectives_equal_repro(cells, reduce):
    port, ref = cells
    got, want = port[reduce]["support"], ref[reduce]["support"]
    assert got["collectives"] == want["collectives"]
    assert got["payload_bytes"] == want["payload_bytes"]
    assert got["wire_bytes"] == want["wire_bytes"]
    assert set(got["collectives"]) == (
        {"all-reduce"} if reduce == "psum"
        else {"reduce-scatter", "all-gather"})


@pytest.mark.parametrize("reduce", REDUCES)
def test_analytic_bytes_equal_repro(cells, reduce):
    port, ref = cells
    for phase in ("support", "materialize"):
        got, want = port[reduce][phase], ref[reduce][phase]
        assert got["hbm_bytes_analytic"] == want["hbm_bytes_analytic"]
        assert got["t_memory"] == got["hbm_bytes_analytic"] / hw.HBM_BW
    assert port[reduce]["shapes"] == {"NP": 8, "P": 8, "C": 16, "G": 64,
                                      "M": 8, "K": 4, "T": 8, "F": 8}


def test_materialize_sums_the_overflow(cells):
    port, ref = cells
    for reduce in REDUCES:
        got, want = port[reduce]["materialize"], ref[reduce]["materialize"]
        assert got["collectives"] == want["collectives"] == {"all-reduce": 1}
        assert got["payload_bytes"] == 8 and want["payload_bytes"] == 4
        # ranks 0-3 share a node: the wire is charged at NVLink's rate
        assert got["t_collective"] == got["wire_bytes"] / hw.NVLINK_BW
