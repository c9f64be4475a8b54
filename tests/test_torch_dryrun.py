"""The port's production dry run (``repro_torch.launch.dryrun``) against
``repro.launch.dryrun``: ``cell_path`` equal for every arch, alias and a
variant; the applicability skips equal; and ``run_cell`` on three smoke
configs (dense, MoE + MLA, hybrid) × train / prefill / decode on a 2×2
fake mesh against ``repro``'s same cells lowered for 4 simulated
devices: rank 0's argument bytes equal ``memory_analysis()``'s
``argument_size_in_bytes`` exactly, and its matmul FLOPs equal
``parse_hlo_cost``'s plus the gap, computed and named:

  * one-hot: the vocab-sharded embedding is a one-hot product in the
    port (ROADMAP §"Deliberate differences", PR 24), 2·b·s·(V/m)·d on
    each rank, forward and (training) its weight gradient, where
    ``repro``'s gather has no dot;
  * Mamba2's C·Bᵀ: one group shared by the heads, computed whole on
    each "model" rank (the port runs the SSD on the rank's heads), where
    XLA splits its state axis over "model"; and decode's conv window
    product, whole on each "model" rank (the port convolves every
    channel there), where XLA splits the channels;
  * MLA's ``w_kr``: the shared rope key's projection whole on each
    "model" rank in decode, where XLA splits its rope axis;
  * training's backward: the MoE's and MLA's (deepseek) and Mamba2's
    (zamba2) products that DTensor and XLA's SPMD partitioner lay out
    differently, pinned at the measured values below.
"""
import concurrent.futures

import pytest

import torch_ranks
from repro.configs import base as jbase
from repro.launch import dryrun as jdryrun
from repro.models import registry as jreg
from repro_torch.configs import base as tbase
from repro_torch.launch import dryrun as tdryrun
from repro_torch.models import registry as treg
from repro_torch.models.ssm import pick_chunk

ARCHS = ["minicpm_2b", "deepseek_v2_lite", "zamba2_2p7b"]
# (name, seq_len, global batch, kind): train in one microbatch (batch 2
# over data 2), prefill long enough for the chunked attention
SHAPES = [("train_4k", 32, 2, "train"), ("prefill_32k", 1024, 4, "prefill"),
          ("decode_32k", 256, 8, "decode")]
DP, TP = 2, 2
# training's backward layouts (see the module's docstring), FLOPs
BACKWARD = {"minicpm_2b": 0, "deepseek_v2_lite": 262144,
            "zamba2_2p7b": -118784}

JAX_BODY = """
import jax.numpy as jnp
from repro.configs.base import ShapeConfig
from repro.launch.mesh import make_mesh
from repro.launch.specs import cache_specs_struct, input_specs, params_specs
from repro.models.registry import build, get_smoke_config
from repro.optim.adamw import AdamWConfig
from repro.roofline.hlo import parse_hlo_cost
from repro.runtime.sharding import (active_mesh, batch_specs, cache_specs,
                                    param_shardings)
from repro.train.train_step import init_train_state, make_train_step
NS, PS = jax.sharding.NamedSharding, jax.sharding.PartitionSpec
def named(mesh, tree):
    return jax.tree_util.tree_map(lambda s: NS(mesh, s), tree,
                                  is_leaf=lambda x: isinstance(x, PS))
mesh = make_mesh((2, 2), ("data", "model"))
for arch in ARGS[0].split(","):
    cfg = get_smoke_config(arch)
    fns = build(cfg)
    p = params_specs(cfg)
    ps = param_shardings(p, mesh)
    for name, S, B, kind in eval(ARGS[1]):
        shape = ShapeConfig(name, S, B, kind)
        b = input_specs(cfg, shape)
        bs = named(mesh, batch_specs(cfg, mesh, b))
        with mesh, active_mesh(mesh):
            if kind == "train":
                step = make_train_step(cfg, AdamWConfig(), fns["loss_fn"],
                                       microbatches=max(1, B // 2))
                o = jax.eval_shape(init_train_state, p)
                osh = {"m": ps, "v": ps, "step": NS(mesh, PS())}
                low = jax.jit(step, in_shardings=(ps, osh, bs),
                              donate_argnums=(0, 1)).lower(p, o, b)
            elif kind == "prefill":
                low = jax.jit(fns["prefill"],
                              in_shardings=(ps, bs)).lower(p, b)
            else:
                c = cache_specs_struct(cfg, shape)
                cs = named(mesh, cache_specs(cfg, mesh, c))
                low = jax.jit(fns["decode"],
                              in_shardings=(ps, cs, bs, None),
                              donate_argnums=(1,)).lower(
                    p, c, b, jax.ShapeDtypeStruct((), jnp.int32))
            comp = low.compile()
        RESULT[arch + ":" + kind] = {
            "args": comp.memory_analysis().argument_size_in_bytes,
            "flops": parse_hlo_cost(comp.as_text()).flops}
"""


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """Both packages' cells: ``repro``'s in a JAX process of 4
    simulated devices, beside the port's (this process as rank 0 of a
    fake group of 4)."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(torch_ranks.run, tmp_path_factory.mktemp("dry"),
                          jax=(JAX_BODY, 4),
                          args=(",".join(ARCHS), repr(SHAPES)), timeout=400)
        port = {}
        for arch in ARCHS:
            cfg = treg.get_smoke_config(arch)
            for name, S, B, kind in SHAPES:
                port[arch + ":" + kind] = tdryrun.run_cell(
                    arch, name, "single", "", cfg=cfg,
                    shape=tbase.ShapeConfig(name, S, B, kind),
                    mesh_shape=(DP, TP))
        return port, ref.result()[1]


def onehot(cfg, B, S):
    """The one-hot embedding's FLOPs on one rank: (B/dp, S, V/m) @ (V/m,
    d), S the step's tokens a row."""
    return 2 * (B // DP) * S * (cfg.vocab // TP) * cfg.d_model


def named_gap(arch, kind, S, B):
    cfg = treg.get_smoke_config(arch)
    tokens = 1 if kind == "decode" else S
    gap = onehot(cfg, B, tokens) * (2 if kind == "train" else 1)
    if kind == "train":
        gap += BACKWARD[arch]
    if cfg.family == "hybrid" and kind == "prefill":
        l, N = pick_chunk(S, cfg.ssm_chunk), cfg.ssm_state
        gap += cfg.n_layers * 2 * (B // DP) * S * l * N * (1 - 1 / TP)
    if cfg.family == "hybrid" and kind == "decode":
        channels = cfg.ssm_expand * cfg.d_model + 2 * cfg.ssm_state
        gap += (cfg.n_layers * 2 * (B // DP) * cfg.d_conv * channels
                * (1 - 1 / TP))
    if cfg.mla and kind == "decode":
        gap += (cfg.n_layers * 2 * (B // DP) * cfg.d_model * cfg.qk_rope_dim
                * (1 - 1 / TP))
    return gap


@pytest.mark.parametrize("kind", [s[3] for s in SHAPES])
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_repro(cells, arch, kind):
    port, ref = cells
    assert port[arch + ":" + kind]["status"] == "ok"
    assert (port[arch + ":" + kind]["argument_bytes"]
            == ref[arch + ":" + kind]["args"])


@pytest.mark.parametrize("shape", SHAPES, ids=[s[3] for s in SHAPES])
@pytest.mark.parametrize("arch", ARCHS)
def test_matmul_flops_equal_repro_plus_named_gap(cells, arch, shape):
    port, ref = cells
    _, S, B, kind = shape
    got, want = port[arch + ":" + kind], ref[arch + ":" + kind]["flops"]
    assert got["flops"] - want == named_gap(arch, kind, S, B), (
        got["flops"], want)
    assert got["n_matmuls"] > 0 and got["t_compute"] > 0
    assert got["temp_bytes"] > 0 and got["collectives"]


def test_cell_path_equals_repro():
    names = list(treg.ARCHS) + list(treg._ALIASES)
    assert treg._ALIASES == jreg._ALIASES
    for arch in names:
        for shape in tbase.SHAPES:
            for mesh in ("single", "multi"):
                for variant in ("", '{"attn_schedule": "tri"}'):
                    assert (tdryrun.cell_path("out", mesh, arch, shape,
                                              variant)
                            == jdryrun.cell_path("out", mesh, arch, shape,
                                                 variant))


def test_skips_equal_repro():
    skipped = 0
    for arch in treg.ARCHS:
        for shape in tbase.SHAPES:
            got = tbase.cell_applicable(treg.get_config(arch),
                                        tbase.SHAPES[shape])
            assert got == jbase.cell_applicable(jreg.get_config(arch),
                                                jbase.SHAPES[shape])
            if not got[0]:
                skipped += 1
                assert (tdryrun.run_cell(arch, shape, "single", "")
                        == jdryrun.run_cell(arch, shape, "single", ""))
    assert skipped == 8         # long_500k on the eight full-attention archs


def test_decode_weights_replicated_and_dump(tmp_path, monkeypatch):
    """``DRYRUN_DECODE_WEIGHTS=replicated``: decode's weights placed by
    their compute specs (each rank holds its whole "model" share: more
    argument bytes, no gather of the weights over "data"), and
    ``DRYRUN_DUMP_OPS`` writes the per-op listing."""
    cfg = treg.get_smoke_config("minicpm_2b")
    shape = tbase.ShapeConfig("decode_32k", 64, 4, "decode")
    run = lambda: tdryrun.run_cell("minicpm_2b", "decode_32k", "single", "",
                                   cfg=cfg, shape=shape, mesh_shape=(2, 2))
    fsdp = run()
    monkeypatch.setenv("DRYRUN_DECODE_WEIGHTS", "replicated")
    monkeypatch.setenv("DRYRUN_DUMP_OPS", str(tmp_path / "ops.txt"))
    rep = run()
    assert rep["argument_bytes"] > fsdp["argument_bytes"]
    assert rep["wire_bytes"] < fsdp["wire_bytes"]
    assert rep["flops"] == fsdp["flops"]
    lines = (tmp_path / "ops.txt").read_text().splitlines()
    assert lines[0].startswith("aten.") and "flops=" in lines[0]


def test_microbatches_env(monkeypatch):
    cfg = treg.get_smoke_config("minicpm_2b")
    shape = tbase.ShapeConfig("train_4k", 16, 4, "train")
    run = lambda: tdryrun.run_cell("minicpm_2b", "train_4k", "single", "",
                                   cfg=cfg, shape=shape, mesh_shape=(2, 2))
    monkeypatch.setenv("DRYRUN_MICROBATCHES", "1")
    one = run()
    monkeypatch.setenv("DRYRUN_MICROBATCHES", "2")
    two = run()
    # the same products over the same tokens, in one or two microbatches
    assert one["flops"] == two["flops"]
    assert one["argument_bytes"] == two["argument_bytes"]
    assert two["temp_bytes"] < one["temp_bytes"]


def test_perf_variants_are_repros():
    from repro.launch import perf_variants as jpv
    from repro_torch.launch import perf_variants as tpv
    assert tpv.VARIANTS == jpv.VARIANTS
