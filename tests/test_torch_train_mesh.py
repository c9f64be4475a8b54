"""FSDP + tensor parallelism over a device mesh in the port
(``train_step(..., mesh=)``, ``runtime.sharding``) on 4 gloo ranks on
the CPU, a 2×2 ("data", "model") mesh, against the port's unsharded
step (which ``tests/test_torch_train_grads.py`` holds against
``jax.value_and_grad``): for each of the ten smoke configs (and deepseek's
at capacity factor 1.0, where pairs are dropped, and minicpm's in two
microbatches, each placed over the data axis), one float32 train
step from the same weights on the same global batch gives the
same loss (1e-5 relative) and the same gradients and updated masters
(1e-4 of max(1, max |x|)), at lr 1e-5 (AdamW's first step moves every
weight by about lr, whatever the gradient's rounding).  Held tighter as
well: each gradient within 1e-4 of its own largest element, and each
master's update within lr / 2 of the unsharded one (both runs start
from the same masters; an update left out or of the wrong sign is lr or
2 lr away).  Inside a unit
the weights a module computes with are placed by ``compute_specs``
(``wq``'s heads on "model", the dp axes gathered); each rank's local
masters take the bytes the storage specs imply.  A 1×1 mesh (bf16,
remat) gives the unsharded run's losses bit for bit (the embedding is
gathered in float32: ROADMAP §C), and ``make_mesh`` refuses a mesh
larger than the group."""
import pytest
from torch.distributed.tensor import Replicate, Shard

import torch_ranks
from repro_torch.models import registry as treg

BODY = """
import dataclasses
import math
import torch
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import registry as treg
from repro_torch.models.attention import Attention
from repro_torch.models.mlp import MLP
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import sharding as tsh
from repro_torch.train.train_step import init_train_state, make_train_step
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
axes = tsh.mesh_axes(mesh)
opt = AdamWConfig(lr=1e-5, schedule="constant", warmup_steps=0)
seen = {}

def spy(cls, attrs):
    forward = cls.forward
    def wrapped(self, *a, **k):
        for n in attrs:
            w = getattr(self, n)
            if not hasattr(w, "placements"):    # the unsharded run
                continue
            seen.setdefault(f"{cls.__name__}.{n}", (
                type(w).__name__, [str(p) for p in w.placements],
                str(w.dtype)))
        return forward(self, *a, **k)
    cls.forward = wrapped

spy(Attention, ("wq", "wk", "wo"))
spy(MLP, ("w_up", "w_down"))

from repro_torch.models.mlp import MoE
dropped = []
slots = MoE.slots

def count_drops(gates, C):
    pos, keep = slots(gates, C)
    if not hasattr(gates, "placements"):        # the unsharded run
        dropped.append(int(((gates > 0) & ~keep).sum()))
    return pos, keep

MoE.slots = staticmethod(count_drops)

def batch_of(cfg, B=4, S=8):
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=g)
    if cfg.family == "vlm":
        return {"embeds": torch.randn(B, S, cfg.d_model, generator=g) * .02,
                "labels": toks[:, 1:], "positions3": torch.arange(S)[
                    None, None].expand(3, B, S).contiguous()}
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family in ("audio", "encdec"):
        batch["frames"] = torch.randn(B, cfg.encoder_frames, cfg.d_model,
                                      generator=g) * .02
    return batch

def rel(a, b):
    return float((a - b).abs().max()) / max(1.0, float(a.abs().max()))

def own(a, b):
    err, scale = float((a - b).abs().max()), float(a.abs().max())
    return err / scale if scale else 0.0 if err == 0 else math.inf

# (smoke config, overrides, microbatches) of each case
CASES = {a: (a, {}, 1) for a in treg.ARCHS}
CASES["deepseek_drops"] = ("deepseek_v2_lite", {"capacity_factor": 1.0}, 1)
CASES["minicpm_microbatches"] = ("minicpm_2b", {}, 2)
for arch, (base, over, microbatches) in CASES.items():
    cfg = dataclasses.replace(treg.get_smoke_config(base), dtype="float32",
                              **over)
    fns = treg.build(cfg, device="cpu", masters=True)
    batch = batch_of(cfg)
    out = {}
    for sharded in (False, True):
        model = fns["init"](torch.Generator().manual_seed(0))
        if sharded:
            tsh.place_model(cfg, model, mesh)
            specs = tsh.param_specs(cfg, model, mesh)
            csp = tsh.compute_specs(cfg, model, mesh)
            named = dict(model.named_parameters())
            RESULT[arch + ":bytes"] = (
                sum(p.to_local().numel() * 4 for p in named.values()),
                sum(p.numel() * 4 // math.prod(
                    axes[a] for e in specs[n] if e is not None
                    for a in ((e,) if isinstance(e, str) else e))
                    for n, p in named.items()))
            RESULT[arch + ":want"] = {
                n.split(".", 2)[-1]: [str(p) for p in tsh.placements(
                    csp[n], mesh)] for n in named
                if n.startswith("layers.0.") or n.startswith("layers.1.")}
            seen.clear()
        step = make_train_step(cfg, opt, fns["loss_fn"],
                               microbatches=microbatches,
                               mesh=mesh if sharded else None)
        model, _, m = step(model, init_train_state(model), batch)
        full = lambda t: t.full_tensor() if sharded else t
        out[sharded] = (float(m["loss"]), float(m["grad_norm"]),
                        {n: full(p.grad).detach() for n, p in
                         model.named_parameters() if p.grad is not None},
                        {n: full(p).detach() for n, p in
                         model.named_parameters()})
        if sharded:
            RESULT[arch + ":seen"] = dict(seen)
    (l0, n0, g0, p0), (l1, n1, g1, p1) = out[False], out[True]
    RESULT[arch + ":dropped"] = sum(dropped)
    dropped.clear()
    RESULT[arch] = {
        "loss": abs(l1 - l0) / abs(l0), "gnorm": abs(n1 - n0) / n0,
        "grads": max(rel(g0[n], g1[n]) for n in g0),
        "grads_missing": sorted(set(g0) ^ set(g1)),
        "grads_own": max(own(g0[n], g1[n]) for n in g0),
        "masters": max(rel(p0[n], p1[n]) for n in p0),
        "masters_lr": max(float((p0[n] - p1[n]).abs().max())
                          for n in p0) / opt.lr}
    print(arch, "rank", RANK, "local master bytes",
          RESULT[arch + ":bytes"], flush=True)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    res, _ = torch_ranks.run(tmp_path_factory.mktemp("mesh"),
                             ranks=(BODY, 4), timeout=400)
    return res


@pytest.mark.parametrize("arch", treg.ARCHS + ["deepseek_drops",
                                               "minicpm_microbatches"])
def test_sharded_step_equals_unsharded(ranks, arch):
    if arch == "deepseek_drops":
        assert ranks[0][arch + ":dropped"] > 0
    for res in ranks:
        r = res[arch]
        assert r["loss"] <= 1e-5, r
        assert r["gnorm"] <= 1e-5, r
        assert r["grads"] <= 1e-4 and not r["grads_missing"], r
        assert r["masters"] <= 1e-4, r
        assert r["grads_own"] <= 1e-4 and r["masters_lr"] <= 0.5, r


@pytest.mark.parametrize("arch", ["minicpm_2b", "qwen2p5_14b",
                                  "deepseek_v2_lite", "whisper_base"])
def test_compute_placements_inside_a_unit(ranks, arch):
    """The weights ``Attention`` and ``MLP`` see inside a unit are
    DTensors at ``compute_specs``' placements: the storage placements
    with the data axis replicated, heads (hidden units) still on
    "model" where the smoke shapes divide."""
    for res in ranks:
        seen, want = res[arch + ":seen"], res[arch + ":want"]
        assert seen, arch
        for key, (kind, placements, dtype) in seen.items():
            cls, attr = key.split(".")
            sub = "attn" if cls == "Attention" else "mlp"
            names = [n for n in want if n.endswith(f"{sub}.{attr}")]
            assert kind == "DTensor" and dtype == "torch.float32", key
            assert placements in [want[n] for n in names], (key, placements)
            assert placements[0] == str(Replicate()), key   # data gathered
    wq = ranks[0][arch + ":seen"].get("Attention.wq")
    if wq is not None:                  # MLA has no wq at smoke size
        assert wq[1] == [str(Replicate()), str(Shard(1))], wq


def test_mla_is_placed_by_its_rules(ranks):
    """deepseek's MLA weights (``w_uk`` heads on "model") at compute."""
    want = ranks[0]["deepseek_v2_lite:want"]
    assert want["attn.w_uk"] == [str(Replicate()), str(Shard(1))]


def test_local_master_bytes_follow_the_specs(ranks):
    for res in ranks:
        for arch in treg.ARCHS:
            got, want = res[arch + ":bytes"]
            assert got == want, (arch, got, want)
    # FSDP + TP: a rank holds well under half of the float32 masters
    assert ranks[0]["minicpm_2b:bytes"][0] < 4 * treg.count_params(
        treg.get_smoke_config("minicpm_2b")) // 2


ONE_BY_ONE = """
import dataclasses
import torch
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import registry as treg
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import TrainLoopConfig, train_loop
cfg = dataclasses.replace(treg.get_smoke_config("minicpm_2b"), n_layers=4,
                          remat="block")
fns = treg.build(cfg, device="cpu", masters=True)
pipe = TokenPipeline(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=0)
opt = AdamWConfig(lr=3e-3, schedule="cosine", warmup_steps=1,
                  total_steps=10)
loop = TrainLoopConfig(steps=4, log_every=1000)
RESULT["plain"] = train_loop(cfg, fns, loop, opt, pipe,
                             device="cpu")["losses"]
RESULT["mesh"] = train_loop(cfg, fns, loop, opt, pipe, mesh=make_mesh(
    (1, 1), ("data", "model"), device="cpu"))["losses"]
try:
    make_mesh((2, 2), ("data", "model"), device="cpu")
    RESULT["raised"] = ""
except RuntimeError as e:
    RESULT["raised"] = str(e)
"""


def test_one_by_one_mesh_is_the_unsharded_run_and_make_mesh_raises(
        tmp_path):
    """bf16 compute and remat on a degenerate 1×1 mesh of one gloo rank:
    the DTensor path gives the unsharded losses exactly; a 2×2 mesh over
    that one rank raises."""
    (res,), _ = torch_ranks.run(tmp_path, ranks=(ONE_BY_ONE, 1),
                                timeout=200)
    assert res["mesh"] == res["plain"]
    assert "needs 4 ranks" in res["raised"]
