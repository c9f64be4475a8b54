"""Serving on a device mesh in the port (``registry.build``'s ``prefill``
and ``decode`` under ``runtime.sharding.active_mesh``, the model placed
by ``place_model``) on 4 gloo ranks on the CPU, a 2×2 ("data", "model")
mesh, against the port's unsharded serve (which the model tests hold
against ``repro``): one smoke config of each family (and granite's, whose
one kv head puts its caches' sequence axis on "model"), float32, prefill of
4 × 8 tokens and greedy decode steps, with the weights placed by their
FSDP specs and by their compute specs (tensor parallel only, replicated
over "data": ``repro``'s ``DRYRUN_DECODE_WEIGHTS=replicated``).  Every
step's logits within 1e-5 of max(1, max |logit|) of the unsharded
ones, the greedy tokens identical, each cache leaf a DTensor whose
local block has the shape ``cache_specs`` gives it, and the attention
caches written in place by decode.  A 1×1 mesh on one rank serves the
unsharded tokens and logits bit for bit (bf16)."""
import pytest

import torch_ranks

# one smoke config of each family, and granite's single kv head: its
# caches' sequence axis is sharded over "model" (context-parallel decode)
ARCHS = ["minicpm_2b", "granite_20b", "qwen2_vl_72b", "deepseek_v2_lite",
         "xlstm_1p3b", "zamba2_2p7b", "whisper_base"]
B, S, STEPS = 4, 8, 4          # caches of 12 positions: 12 % 2 == 0

BODY = """
import dataclasses
import math
import torch
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import registry as treg
from repro_torch.runtime import sharding as tsh
B, S, STEPS = %d, %d, %d
shape = tuple(int(a) for a in ARGS[0].split("x"))
dtype = ARGS[1]
archs = ARGS[2].split(",")
mesh = make_mesh(shape, ("data", "model"), device="cpu")

def batch_of(cfg, tokens, pos):
    b, s = tokens.shape
    g = torch.Generator().manual_seed(7 + pos)
    if cfg.family == "vlm":
        return {"embeds": (torch.randn(b, s, cfg.d_model, generator=g)
                           * .02).to(getattr(torch, cfg.dtype)),
                "positions3": (pos + torch.arange(s))[None, None].expand(
                    3, b, s).contiguous()}
    batch = {"tokens": tokens}
    if cfg.family in ("audio", "encdec") and pos == 0:
        batch["frames"] = (torch.randn(b, cfg.encoder_frames, cfg.d_model,
                                       generator=g) * .02).to(
            getattr(torch, cfg.dtype))
    return batch

def serve(cfg, fns, model, sharded):
    toks = torch.randint(0, cfg.vocab, (B, S),
                         generator=torch.Generator().manual_seed(3))
    full = (lambda t: t.full_tensor()) if sharded else (lambda t: t)
    logits, cache = fns["prefill"](model, batch_of(cfg, toks, 0),
                                   max_len=S + STEPS)
    out, tokens = [full(logits).float()], []
    first = [None if c is None else {k: v for k, v in c.items()}
             for c in cache]
    nxt = out[-1][:, -1].argmax(-1)
    for i in range(STEPS):
        tokens.append(nxt.tolist())
        logits, cache = fns["decode"](model, cache,
                                      batch_of(cfg, nxt[:, None], S + i),
                                      S + i)
        out.append(full(logits).float())
        nxt = out[-1][:, -1].argmax(-1)
    tokens.append(nxt.tolist())
    in_place = all(c is None or all(c[k] is f[k] for k in ("k", "v", "ckv")
                                    if k in c and k in f)
                   for c, f in zip(cache, first))
    return out, tokens, cache, in_place

for arch in archs:
    cfg = dataclasses.replace(treg.get_smoke_config(arch), dtype=dtype)
    fns = treg.build(cfg, device="cpu")
    ref = serve(cfg, fns, fns["init"](torch.Generator().manual_seed(0)),
                False)
    for weights in ("fsdp", "data_replicated"):
        model = fns["init"](torch.Generator().manual_seed(0))
        tsh.place_model(cfg, model, mesh,
                        data_replicated=weights == "data_replicated")
        with tsh.active_mesh(mesh):
            got = serve(cfg, fns, model, True)
        logit_err = max(
            float((a - b).abs().max()) / max(1.0, float(a.abs().max()))
            for a, b in zip(ref[0], got[0]))
        exact = all(torch.equal(a, b) for a, b in zip(ref[0], got[0]))
        axes = tsh.mesh_axes(mesh)
        specs = tsh.cache_specs(cfg, mesh, got[2])
        shapes_ok, placed = True, True
        for c, sp in zip(got[2], specs):
            if c is None:
                continue
            for k, v in c.items():
                placed &= tsh.is_sharded(v)
                want = tuple(
                    n // math.prod(axes[a] for a in ((e,) if isinstance(
                        e, str) else e)) if e is not None else n
                    for n, e in zip(v.shape, sp[k]))
                shapes_ok &= tuple(v.to_local().shape) == want
        first = next(c for c in got[2] if c is not None)
        RESULT[arch + ":" + weights] = {
            "logit_err": logit_err, "exact": exact,
            "tokens": got[1] == ref[1], "shapes": shapes_ok,
            "placed": placed, "in_place": got[3],
            "n_steps": len(got[0]),
            # the sharded tensor axis on each mesh axis, None: replicated
            "placements": [p.dim if p.is_shard() else None
                           for p in next(iter(first.values())).placements]}
""" % (B, S, STEPS)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    res, _ = torch_ranks.run(tmp_path_factory.mktemp("serve"),
                             ranks=(BODY, 4),
                             args=("2x2", "float32", ",".join(ARCHS)),
                             timeout=400)
    return res


@pytest.mark.parametrize("weights", ["fsdp", "data_replicated"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_serve_equals_unsharded(ranks, arch, weights):
    for res in ranks:
        r = res[arch + ":" + weights]
        assert r["n_steps"] == STEPS + 1, r
        assert r["logit_err"] <= 1e-5, r
        assert r["tokens"], r


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_caches_follow_cache_specs(ranks, arch):
    for res in ranks:
        for weights in ("fsdp", "data_replicated"):
            r = res[arch + ":" + weights]
            assert r["placed"] and r["shapes"], r
            assert r["in_place"], r
    if arch == "granite_20b":       # one kv head: the sequence on "model"
        assert ranks[0][arch + ":fsdp"]["placements"] == [0, 1]


def test_one_by_one_mesh_serves_bit_for_bit(tmp_path):
    res, _ = torch_ranks.run(tmp_path, ranks=(BODY, 1),
                             args=("1x1", "bfloat16", "minicpm_2b"),
                             timeout=200)
    for weights in ("fsdp", "data_replicated"):
        r = res[0]["minicpm_2b:" + weights]
        assert r["exact"] and r["tokens"], r
