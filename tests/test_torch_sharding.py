"""The port's sharding tables (``repro_torch.runtime.sharding``) against
the JAX package's (``repro.runtime.sharding``): ``logical_rules``,
``param_specs`` and ``compute_specs`` leaf by leaf for all ten archs at
full width on the (16, 16), (2, 16, 16), (2, 2), (1, 4) and (4, 1)
meshes (shapes on the ``meta`` device and ``jax.eval_shape``: nothing
is allocated), ``batch_specs`` on each family's batch, ``cache_specs``
at decode_32k and long_500k, the rule-coverage assertions of
``tests/test_runtime.py``, the no-mesh behaviour of ``shard_hint`` and
``gather_for_compute``, and, on a 2×2 gloo mesh, every rank's local
shard of every smoke-config leaf against the block that
``NamedSharding(mesh, spec).devices_indices_map`` gives the JAX device
at that rank (compared exactly).  The tables take a mesh stand-in with
``axis_names`` and a ``shape`` mapping, as ``test_runtime`` does.  Also
on the 2×2 gloo mesh, the port's deliberate differences (ROADMAP §C):
DTensor's collectives routed through c10d (``c10d_collectives``, the
answer to torch 2.11's gloo crash on the card) against the functional
ones, the
attention core on each rank's heads and rows against the whole, and
the vocab-sharded embedding's one-hot product against a lookup."""
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import torch_ranks
from repro_torch.launch.specs import layer_caches
from repro_torch.models import registry as treg
from repro_torch.runtime import sharding as tsh

MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (2, 2): ("data", "model"), (1, 4): ("data", "model"),
          (4, 1): ("data", "model")}


class FakeMesh:
    def __init__(self, shape, axes):
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))


FAKES = [FakeMesh(s, a) for s, a in MESHES.items()]


def norm(spec, ndim: int) -> tuple:
    """A spec (``repro``'s PartitionSpec or the port's tuple) as one
    tuple of axis-name tuples (empty for a replicated dim), ``ndim``
    long."""
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(tuple(spec))):
        out.append(() if e is None else (e,) if isinstance(e, str)
                   else tuple(e))
    return tuple(out)


def jax_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.fixture(scope="module")
def jx():
    import jax
    from jax.sharding import PartitionSpec
    from repro.launch import specs as jspecs
    from repro.models import registry as jreg
    from repro.runtime import sharding as jsh
    return jax, PartitionSpec, jspecs, jreg, jsh


def test_logical_rules_equal_jax(jx):
    _, _, _, _, jsh = jx
    for mesh in FAKES:
        got = tsh.logical_rules(mesh)
        want = jsh.logical_rules(mesh)
        assert [r for r, _ in got] == [r for r, _ in want]
        for (r, g), (_, w) in zip(got, want):
            assert norm(g, len(tuple(w))) == norm(w, len(tuple(w))), r


@pytest.mark.parametrize("arch", treg.ARCHS)
def test_param_and_compute_specs_equal_jax(jx, arch):
    """Every parameter of ``arch`` at full width: the port's per-layer
    spec is ``repro``'s stacked spec less its leading (repeat,) entry,
    on each mesh, for storage and for compute."""
    jax, P, jspecs, jreg, jsh = jx
    sds = jspecs.params_specs(jreg.get_config(arch))
    cfg = treg.get_config(arch)
    model = treg.model_class(cfg)(cfg, device="meta", masters=True)
    named = dict(model.named_parameters())
    layout = treg.jax_layout(cfg, named)
    for mesh in FAKES:
        jp = jsh.param_specs(sds, mesh)
        jc = jsh.compute_specs(sds, mesh)
        tp = tsh.param_specs(cfg, model, mesh)
        tc = tsh.compute_specs(cfg, named, mesh)
        assert set(tp) == set(named) == set(tc)
        for name, (path, index) in layout.items():
            leaf = jax_leaf(sds, path)
            nd = leaf.ndim
            want_p = norm(jax_leaf(jp, path), nd)
            want_c = norm(jax_leaf(jc, path), nd)
            if index is not None:
                assert want_p[0] == () and want_c[0] == ()
                want_p, want_c = want_p[1:], want_c[1:]
            ndim = named[name].ndim
            assert norm(tp[name], ndim) == want_p, (arch, mesh.shape, name)
            assert norm(tc[name], ndim) == want_c, (arch, mesh.shape, name)


def family_batch(cfg, B: int, S: int) -> dict:
    """A training batch of the family's keys (numpy, shapes only)."""
    z = lambda *s: np.zeros(s, np.float32)
    batch = {"labels": z(B, S)}
    if cfg.family == "vlm":
        batch.update(embeds=z(B, S, 8), positions3=z(3, B, S))
    else:
        batch["tokens"] = z(B, S)
    if cfg.family in ("audio", "encdec"):
        batch["frames"] = z(B, 12, 8)
    return batch


@pytest.mark.parametrize("arch", treg.ARCHS)
def test_batch_specs_equal_jax(jx, arch):
    *_, jsh = jx
    cfg = treg.get_config(arch)
    for B in (1, 2, 4, 8, 32, 256):
        batch = family_batch(cfg, B, 16)
        for mesh in FAKES:
            want = jsh.batch_specs(cfg, mesh, batch)
            got = tsh.batch_specs(cfg, mesh, batch)
            assert set(got) == set(want)
            for k, v in batch.items():
                assert norm(got[k], v.ndim) == norm(want[k], v.ndim), (
                    arch, B, mesh.shape, k)


@pytest.mark.parametrize("arch", treg.ARCHS)
def test_cache_specs_equal_jax(jx, arch):
    """The port's per-block caches at decode_32k (batch 128) and
    long_500k (batch 1: the sequence takes dp): each leaf's spec is
    ``repro``'s for the stacked leaf of its group, repeat and sub-layer,
    less the leading entry."""
    from repro.configs.base import SHAPES
    from repro_torch.models.transformer import block_specs
    _, _, jspecs, jreg, jsh = jx
    cfg = treg.get_config(arch)
    blocks = block_specs(cfg)
    for sname in ("decode_32k", "long_500k"):
        shape = SHAPES[sname]
        jtree = jspecs.cache_specs_struct(jreg.get_config(arch), shape)
        caches = layer_caches(cfg, shape)
        assert len(caches) == len(blocks)
        for mesh in FAKES:
            want = jsh.cache_specs(cfg, mesh, jtree)
            got = tsh.cache_specs(cfg, mesh, caches)
            for (gi, _r, li, _m, _f), c, g in zip(blocks, caches, got):
                w = want[gi][li]
                if c is None:
                    assert w is None and g is None
                    continue
                assert set(g) == set(w) == set(c)
                for k, leaf in c.items():
                    ws = norm(w[k], leaf.ndim + 1)
                    assert ws[0] == ()
                    assert norm(g[k], leaf.ndim) == ws[1:], (
                        arch, sname, mesh.shape, gi, li, k)


def test_param_specs_cover_rules():
    """``tests/test_runtime.py``'s coverage assertions, on the port."""
    mesh = FakeMesh((16, 16), ("data", "model"))
    for arch in treg.ARCHS:
        cfg = treg.get_config(arch)
        specs = tsh.param_specs(
            cfg, treg.model_class(cfg)(cfg, device="meta", masters=True),
            mesh).values()
        n_model = sum(1 for s in specs if any(
            p is not None and "model" in tsh._entry_axes(p) for p in s))
        n_any = sum(1 for s in specs if any(p is not None for p in s))
        assert n_any >= 5, f"{arch}: too few sharded params"
        assert n_model >= 1, f"{arch}: vocab/ffn must be model-sharded"
        if cfg.n_heads % 16 == 0 and cfg.n_kv % 16 == 0:
            assert n_model >= 3, f"{arch}: divisible heads must TP-shard"


def test_no_mesh_hint_is_identity_and_gather_only_casts():
    assert tsh.current_mesh() is None
    x = torch.randn(4, 8)
    assert tsh.shard_hint(x, "dp", "model") is x
    params = {"w": torch.randn(4, 8), "b": torch.randn(8),
              "i": torch.ones(2, 2, dtype=torch.int32)}
    out = tsh.gather_for_compute(params, cast=torch.bfloat16)
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"], params["w"].to(torch.bfloat16))
    assert out["b"] is params["b"] and out["i"] is params["i"]
    assert tsh.gather_for_compute(params)["w"] is params["w"]


def test_placements_of_specs():
    mesh = FakeMesh((2, 4, 4), ("pod", "data", "model"))
    assert tsh.placements((("pod", "data"), "model", None), mesh) == [
        Shard(0), Shard(0), Shard(1)]
    assert tsh.placements((), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError):
        tsh.placements((("data", "pod"),), mesh)
    # an axis of size 1 holds the whole dim: it places as Replicate
    thin = FakeMesh((1, 4), ("data", "model"))
    assert tsh.placements((("data",), "model"), thin) == [Replicate(),
                                                          Shard(1)]


JAX_BLOCKS = """
from jax.sharding import NamedSharding
from repro.launch import specs as jspecs
from repro.models import registry as jreg
from repro.runtime import jax_compat
from repro.runtime.sharding import param_specs
mesh = jax_compat.make_mesh((2, 2), ("data", "model"))
devs = list(mesh.devices.flat)
for arch in jreg.ARCHS:
    sds = jspecs.params_specs(jreg.get_smoke_config(arch))
    specs = param_specs(sds, mesh)
    flat, _ = jax.tree_util.tree_flatten_with_path(sds)
    sflat = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    out = {}
    for (path, leaf), spec in zip(flat, sflat):
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        idx = NamedSharding(mesh, spec).devices_indices_map(leaf.shape)
        out[key] = [[(s.start or 0, leaf.shape[i] if s.stop is None
                      else s.stop) for i, s in enumerate(idx[d])]
                    for d in devs]
    RESULT[arch] = out
"""

RANK_BLOCKS = """
import ast
import torch
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import registry as treg
from repro_torch.runtime.sharding import place_model
blocks = ast.literal_eval(open(ARGS[0]).read())
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
for arch in treg.ARCHS:
    cfg = treg.get_smoke_config(arch)
    model = treg.build(cfg, device="cpu", masters=True)["init"](
        torch.Generator().manual_seed(2))
    full = {n: p.detach().clone() for n, p in model.named_parameters()}
    place_model(cfg, model, mesh)
    bad, n = [], 0
    for name, (path, index) in treg.jax_layout(cfg, full).items():
        sl = blocks[arch]["/".join(map(str, path))][RANK]
        if index is not None:      # the stacked (repeat,) dim is whole
            sl = sl[1:]
        want = full[name][tuple(slice(a, b) for a, b in sl)]
        p = dict(model.named_parameters())[name]
        n += 1
        if not torch.equal(p.to_local(), want):
            bad.append(name)
    RESULT[arch] = {"bad": bad, "n": n}
"""


def test_local_shards_equal_jax_device_blocks(tmp_path):
    """On a 2×2 gloo mesh (rank r is the row-major device r of
    ``repro``'s mesh, as in ``jax_compat.make_mesh``), each rank's local
    shard of every smoke-config leaf equals that device's block."""
    _, jres = torch_ranks.run(tmp_path, jax=(JAX_BLOCKS, 4), timeout=240)
    path = tmp_path / "blocks.txt"
    path.write_text(repr(jres))
    ranks, _ = torch_ranks.run(tmp_path, ranks=(RANK_BLOCKS, 4),
                               args=(path,), timeout=240)
    for r, res in enumerate(ranks):
        for arch in treg.ARCHS:
            assert res[arch]["n"] > 0
            assert res[arch]["bad"] == [], (r, arch)


MESH_OPS = """
import functools
import torch
import torch.nn.functional as F
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
import torch.distributed._functional_collectives as funcol
from repro_torch.launch.mesh import c10d_collectives, make_mesh
from repro_torch.models.attention import heads_local, mha
from repro_torch.models.transformer import _embed
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
g = torch.Generator().manual_seed(0)
x = torch.randn(8, 12, 4, generator=g)
R, S0, S1, S2 = Replicate(), Shard(0), Shard(1), Shard(2)
MOVES = [([S0, S1], [R, R]), ([S1, S0], [R, S2]), ([S0, R], [S1, R]),
         ([R, S2], [R, S1]), ("partial", [S0, R]), ("partial", [R, S1]),
         ("partial", [R, R])]

def moves():
    out = []
    for src, dst in MOVES:
        if src == "partial":
            t = DTensor.from_local(x * (RANK + 1), mesh, [Partial(), R],
                                   run_check=False)
        else:
            t = distribute_tensor(x, mesh, src, src_data_rank=None)
        out.append(t.redistribute(mesh, dst).to_local().clone())
    return out

def uneven_all_to_all():
    # along "data": rank c sends c + 2 j + 1 rows to its peer j
    c = mesh.get_coordinate()[0]
    ins = [c + 2 * j + 1 for j in range(2)]
    outs = [j + 2 * c + 1 for j in range(2)]
    y = torch.arange(sum(ins) * 3.0).reshape(-1, 3) + 100 * RANK
    return funcol.all_to_all_single(y, outs, ins, (mesh, 0)) * 1

native = moves() + [uneven_all_to_all()]
functional = funcol.all_gather_tensor
with c10d_collectives():
    routed = moves() + [uneven_all_to_all()]
RESULT["routed"] = [bool(torch.equal(a, b)) for a, b in zip(native, routed)]
RESULT["restored"] = funcol.all_gather_tensor is functional

attn = []
for H, Kv in ((4, 2), (6, 3), (4, 4)):
    q = torch.randn(4, 8, H, 8, generator=g)
    k, v = (torch.randn(4, 8, Kv, 8, generator=g) for _ in range(2))
    fn = functools.partial(mha, scale=0.3, causal=True, window=None,
                           cap=None)
    want = fn(q, k, v)
    got = heads_local(fn, *(distribute_tensor(t, mesh, [S0, S2],
                                              src_data_rank=None)
                            for t in (q, k, v)))
    attn.append((H, Kv, [str(p) for p in got.placements],
                 float((got.full_tensor() - want).abs().max())))
RESULT["attn"] = attn

w = torch.randn(16, 6, generator=g)
tok = torch.randint(0, 16, (4, 5), generator=g)
wd = distribute_tensor(w, mesh, [R, S0], src_data_rank=None)
td = distribute_tensor(tok, mesh, [S0, R], src_data_rank=None)
from torch.distributed.tensor.experimental import implicit_replication
with implicit_replication():
    e = _embed(td, wd)
RESULT["embed"] = float((e.full_tensor() - F.embedding(tok, w)).abs().max())
"""


@pytest.fixture(scope="module")
def mesh_ops(tmp_path_factory):
    ranks, _ = torch_ranks.run(tmp_path_factory.mktemp("ops"),
                               ranks=(MESH_OPS, 4), timeout=200)
    return ranks


def test_c10d_routed_collectives_equal_the_functional_ones(mesh_ops):
    """``c10d_collectives()`` (which a gloo mesh on the card needs, where
    torch 2.11's functional all-gather crashes): on the CPU every
    redistribution it serves (all-gather on dim 0 or not, reduce-scatter
    on dim 0 or not, all-reduce, all-to-all) and an all-to-all with
    uneven splits give the functional collectives' local shards exactly,
    and on leaving it the functional collectives are back."""
    for r in mesh_ops:
        assert r["routed"] == [True] * 8, r["routed"]
        assert r["restored"]


def test_heads_local_attention_equals_the_whole(mesh_ops):
    """The attention core on each rank's rows and heads equals it on the
    whole batch: heads over "model" when it divides H and Kv, else
    replicated on "model" (H 6, Kv 3)."""
    for r in mesh_ops:
        for H, Kv, placements, err in r["attn"]:
            assert err <= 1e-6, (H, Kv, err)
            assert placements[0] == str(Shard(0))
            assert placements[1] == str(
                Shard(2) if Kv % 2 == 0 else Replicate()), (H, Kv)


def test_vocab_sharded_embedding_is_exact(mesh_ops):
    for r in mesh_ops:
        assert r["embed"] == 0.0
