"""The port's roofline tools (``repro_torch.roofline``) against
``repro.roofline``: ``model_flops`` and ``analytic_bytes`` equal for
every arch × shape on both production meshes, ``_wire_factor`` equal,
the report's tables byte-identical on the same cells; the H100
constants; the per-rank cost counter on the counterparts of
``tests/test_runtime.py``'s HLO-parser cases, on a sharded product of a
fake 16×16 mesh (the local shard's FLOPs, not the global product's),
on a ``redistribute``'s collectives (payload, wire bytes, and the link
rate of each group: NVLink for ranks 0–7, the inter-node rate for ranks
0–15)."""
import json
import os

import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import registry as jreg
from repro.roofline import analysis as janalysis
from repro.roofline import hlo as jhlo
from repro.roofline import report as jreport
from repro_torch.configs import base as tbase
from repro_torch.launch.dryrun import fake_group
from repro_torch.models import registry as treg
from repro_torch.roofline import analysis as tanalysis
from repro_torch.roofline import cost as tcost
from repro_torch.roofline import hw
from repro_torch.roofline import report as treport

MESHES = [(256, 16), (512, 16)]     # (chips, tp) of "single", "multi"


@pytest.mark.parametrize("arch", treg.ARCHS)
def test_model_flops_and_analytic_bytes_equal_repro(arch):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    for name in tbase.SHAPES:
        jshape, tshape = jbase.SHAPES[name], tbase.SHAPES[name]
        assert (tanalysis.model_flops(tcfg, tshape)
                == janalysis.model_flops(jcfg, jshape)), name
        for chips, tp in MESHES:
            micro = max(1, tshape.global_batch // (chips // tp))
            assert (tanalysis.analytic_bytes(tcfg, tshape, chips=chips,
                                             tp=tp, microbatches=micro)
                    == janalysis.analytic_bytes(jcfg, jshape, chips=chips,
                                                tp=tp, microbatches=micro)
                    ), (name, chips)


def test_wire_factor_equals_repro():
    for kind in tcost.COLLECTIVES + ("other",):
        for n in range(0, 20):
            assert tcost._wire_factor(kind, n) == jhlo._wire_factor(kind, n)


def test_h100_constants():
    assert hw.PEAK_FLOPS_BF16 == 989e12 and hw.HBM_BW == 3.35e12
    assert hw.NVLINK_BW == 450e9 and hw.INTER_NODE_BW == 50e9
    assert hw.GPUS_PER_NODE == 8
    assert hw.DTYPE_BYTES[torch.bfloat16] == 2
    assert hw.DTYPE_BYTES[torch.float32] == 4
    assert hw.DTYPE_BYTES[torch.bool] == 1


def test_span_rule():
    assert hw.same_node(range(8)) and hw.link_bw(range(8)) == hw.NVLINK_BW
    assert hw.same_node(range(8, 16))
    assert not hw.same_node(range(16))
    assert hw.link_bw(range(16)) == hw.INTER_NODE_BW
    assert hw.link_bw([0, 16, 32]) == hw.INTER_NODE_BW


def _cells(tmp_path):
    """A dry-run cell from the port, a skipped cell and a mining cell,
    written where ``load_cells`` reads them."""
    from repro_torch.launch.dryrun import cell_path, run_cell
    cfg = treg.get_smoke_config("minicpm_2b")
    shape = tbase.ShapeConfig("decode_32k", 64, 4, "decode")
    cells = [run_cell("minicpm-2b", "decode_32k", "single", str(tmp_path),
                      cfg=cfg, shape=shape, mesh_shape=(2, 2)),
             {"arch": "gemma2-2b", "shape": "long_500k", "mesh": "single",
              "status": "skipped",
              "reason": "pure full-attention arch: 512k-token decode needs "
                        "sub-quadratic attention (documented skip)"}]
    for arch, d in zip(("minicpm-2b", "gemma2-2b"), cells):
        path = cell_path(str(tmp_path), "single", arch, d["shape"])
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(d, f)
    phase = {"flops": 0.0, "hbm_bytes_analytic": 3.0e8, "wire_bytes": 1275.0,
             "collectives": {"reduce-scatter": 1, "all-gather": 1},
             "t_compute": 0.0, "t_memory": 8.9e-5, "t_collective": 2.55e-8,
             "temp_bytes": 10, "argument_bytes": 20, "bottleneck": "memory"}
    with open(tmp_path / "dryrun" / "single"
              / "mirage_mining__reduce_scatter.json", "w") as f:
        json.dump({"kind": "mining", "mesh": "single", "chips": 256,
                   "reduce": "reduce_scatter", "support": phase,
                   "materialize": phase}, f)


def test_report_tables_equal_repro(tmp_path, capsys, monkeypatch):
    _cells(tmp_path)
    out = {}
    for name, mod in (("repro", jreport), ("port", treport)):
        monkeypatch.setattr("sys.argv", ["report", "--results",
                                         str(tmp_path)])
        capsys.readouterr()
        mod.main()
        out[name] = capsys.readouterr().out
    assert out["port"] == out["repro"]
    assert "| minicpm-2b | decode_32k | decode_step | ok |" in out["port"]
    assert "SKIP" in out["port"] and "reduce_scatter" in out["port"]
    cells = treport.load_cells(str(tmp_path), "single")
    for table in ("dryrun_table", "roofline_table", "mining_table"):
        assert getattr(treport, table)(cells) == getattr(jreport, table)(
            cells)


# ---------------------------------------------------------------------------
# the cost counter
# ---------------------------------------------------------------------------

def test_counter_chained_products():
    """``test_hlo_parser_scan_and_collectives``' 7 chained products."""
    x, w = torch.ones(64, 128), torch.ones(128, 128)

    def f():
        y = x
        for _ in range(7):
            y = y @ w
        return y

    _, c = tcost.count_step(f)
    assert c.flops == 7 * 2 * 64 * 128 * 128 and c.n_matmuls == 7
    assert c.collectives == {} and c.collective_seconds == 0.0


def test_counter_relu_chain():
    """``test_hlo_parser_counts_fused_dots``: relu(x @ w1) @ w2."""
    x, w1, w2 = torch.ones(32, 64), torch.ones(64, 96), torch.ones(96, 16)
    _, c = tcost.count_step(lambda: torch.relu(x @ w1) @ w2)
    assert c.flops == 2 * 32 * 64 * 96 + 2 * 32 * 96 * 16
    assert c.n_matmuls == 2
    # the bytes proxy: each op's operands and output, views excluded
    mm1 = (32 * 64 + 64 * 96 + 32 * 96) * 4
    relu = 2 * 32 * 96 * 4
    mm2 = (32 * 96 + 96 * 16 + 32 * 16) * 4
    assert c.bytes_hbm == mm1 + relu + mm2
    assert c.peak_bytes >= 32 * 96 * 4


def _sharded_product(mesh_shape):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    n = int(np.prod(mesh_shape))
    mesh = DeviceMesh("cpu", torch.arange(n).reshape(mesh_shape),
                      mesh_dim_names=("data", "model"))
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        a, b = torch.empty(256, 4096), torch.empty(4096, 4096)
    A = distribute_tensor(a, mesh, [Shard(0), Replicate()],
                          src_data_rank=None)
    B = distribute_tensor(b, mesh, [Replicate(), Shard(1)],
                          src_data_rank=None)
    return mesh, fake, A, B


def test_sharded_product_counts_the_local_shard():
    """A (256, 4096) @ (4096, 4096) product on a fake 16×16 mesh, rows
    over "data" and columns over "model": rank 0 counts its (16, 4096)
    @ (4096, 256) block, not the 8.59e9 FLOPs of the global product (a
    mode that sees the DTensor-level op counts those)."""
    with fake_group(256):
        mesh, fake, A, B = _sharded_product((16, 16))
        C, c = tcost.count_step(lambda: A @ B, fake_mode=fake)
        _, again = tcost.count_step(lambda: A @ B, fake_mode=fake)
    assert tuple(C.to_local().shape) == (16, 256)
    assert c.flops == 2 * 16 * 4096 * 256 == again.flops
    assert c.flops != 2 * 256 * 4096 * 4096
    assert c.n_matmuls == 1 and c.collectives == {}


@pytest.mark.parametrize("mesh_shape,bw", [((16, 16), hw.INTER_NODE_BW),
                                           ((32, 8), hw.NVLINK_BW)])
def test_redistribute_collectives(mesh_shape, bw):
    """A ``redistribute`` to replicated of the product's (16, 256) f32
    block: an all-gather over "model" (rank 0's group: ranks 0–15 on a
    16×16 mesh, across two nodes of 8; ranks 0–7 on a 32×8 mesh, one
    node), then one over "data" (every group spans nodes).  Payload: the
    gathered output; wire: payload × (n - 1) / n; seconds: wire over the
    group's link rate, the c10d route counting the same."""
    from torch.distributed.tensor import Replicate
    from repro_torch.launch.mesh import c10d_collectives
    rows = 256 // mesh_shape[0]
    with fake_group(256):
        mesh, fake, A, B = _sharded_product(mesh_shape)
        C = A @ B
        step = lambda: C.redistribute(mesh, [Replicate(), Replicate()])
        _, c = tcost.count_step(step, fake_mode=fake)
        with c10d_collectives():
            _, r = tcost.count_step(step, fake_mode=fake)
    model = rows * 4096 * 4                  # (rows, 4096) after "model"
    full = 256 * 4096 * 4
    n_m, n_d = mesh_shape[1], mesh_shape[0]
    wire = model * (n_m - 1) / n_m + full * (n_d - 1) / n_d
    for cost in (c, r):
        e = cost.collectives["all-gather"]
        assert e["count"] == 2 and e["payload_bytes"] == model + full
        assert cost.collective_wire_bytes == pytest.approx(wire, rel=1e-12)
        assert cost.collective_seconds == pytest.approx(
            model * (n_m - 1) / n_m / bw
            + full * (n_d - 1) / n_d / hw.INTER_NODE_BW, rel=1e-12)
        assert set(cost.collectives) == {"all-gather"}
