"""``train_loop(mesh=)`` in the port (4 gloo ranks on the CPU) against the
JAX package's ``train_loop(mesh=make_mesh(...))`` (4 simulated CPU
devices), 10 float32 steps from the same weights (the port's seeded
init, handed to JAX as its tree) on the same pipeline, at weight decay
0 (where C6 has no effect): minicpm on the (2, 2), (1, 4) and (4, 1)
("data", "model") meshes, deepseek-v2-lite at capacity factor 1.0
(each row's expert buffers hold 4 of its 16 tokens' pairs, so pairs
are dropped: checked) and zamba2 on (2, 2).  The losses agree to 1e-5
relative and the final masters to 1e-4 of max(1, max |x|), each
package's sharded run on its own mesh (2e-5 and 2e-4 for the case with
dropped pairs, whose run holds a routing near-tie: ``LOSS_RTOL``)."""
import dataclasses

import numpy as np
import pytest
import torch

import torch_ranks

SETUP = """
import dataclasses
import numpy as np
import torch
from repro_torch.models import registry as treg
CASES = [("minicpm_2b", (2, 2), None), ("minicpm_2b", (1, 4), None),
         ("minicpm_2b", (4, 1), None), ("deepseek_v2_lite", (2, 2), 1.0),
         ("zamba2_2p7b", (2, 2), None)]
PIPE = dict(seq_len=16, global_batch=4, seed=5)
OPT = dict(lr=3e-3, weight_decay=0.0, warmup_steps=3, total_steps=10)
LOOP = dict(steps=10, ckpt_every=1000, log_every=1000)

def port_cfg(arch, cf):
    cfg = dataclasses.replace(treg.get_smoke_config(arch), dtype="float32")
    return cfg if cf is None else dataclasses.replace(cfg,
                                                      capacity_factor=cf)

def start_tree(arch, cf):
    cfg = port_cfg(arch, cf)
    model = treg.build(cfg, device="cpu", masters=True)["init"](
        torch.Generator().manual_seed(1))
    return treg.params_to_jax(cfg, model)

def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in flat(tree[key], f"{prefix}{key}/").items()}
    if isinstance(tree, list):
        return {k: v for i, t in enumerate(tree)
                for k, v in flat(t, f"{prefix}{i}/").items()}
    return {prefix[:-1]: np.asarray(tree, np.float32)}

def key(arch, shape):
    return f"{arch}_{shape[0]}x{shape[1]}"
"""

JAX_BODY = SETUP + """
import jax.numpy as jnp
from repro.data.pipeline import TokenPipeline
from repro.launch.mesh import make_mesh
from repro.models import registry as jreg
from repro.optim.adamw import AdamWConfig
from repro.train.loop import TrainLoopConfig, train_loop
for arch, shape, cf in CASES:
    tree = start_tree(arch, cf)
    jcfg = dataclasses.replace(jreg.get_smoke_config(arch), dtype="float32")
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
    fns = dict(jreg.build(jcfg))
    fns["init"] = lambda k, tree=tree: jax.tree_util.tree_map(jnp.asarray,
                                                              tree)
    out = train_loop(jcfg, fns, TrainLoopConfig(**LOOP),
                     AdamWConfig(**OPT),
                     TokenPipeline(vocab=jcfg.vocab, **PIPE),
                     mesh=make_mesh(shape, ("data", "model")))
    RESULT[key(arch, shape)] = out["losses"]
    np.savez(OUT + f"/jax_{key(arch, shape)}.npz", **flat(out["params"]))
"""

RANK_BODY = SETUP + """
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import TrainLoopConfig, train_loop
for arch, shape, cf in CASES:
    cfg, tree = port_cfg(arch, cf), start_tree(arch, cf)
    fns = dict(treg.build(cfg, device="cpu", masters=True))
    fns["init"] = lambda g, cfg=cfg, tree=tree: treg.params_from_jax(
        cfg, tree, device="cpu", masters=True)
    out = train_loop(cfg, fns, TrainLoopConfig(**LOOP), AdamWConfig(**OPT),
                     TokenPipeline(vocab=cfg.vocab, **PIPE),
                     mesh=make_mesh(shape, ("data", "model"), device="cpu"))
    RESULT[key(arch, shape)] = out["losses"]
    final = treg.params_to_jax(cfg, out["model"])   # every rank gathers
    if RANK == 0:
        np.savez(OUT + f"/port_{key(arch, shape)}.npz", **flat(final))
"""

# With dropped pairs, step 5 of this run holds a near-tie in the routing
# that float32 rounding resolves either way, a discrete change to the
# step's loss and to the gradients of the tokens it moves.  Measured on
# the CPU: JAX's own (2, 2) mesh run against its unsharded run differs by
# 3.5e-6 in that loss and 4.9e-5 in the final masters; the port's mesh
# run against JAX's mesh run by 1.06e-5 and 1.5e-4, every other step
# within 3e-7.  That one case is held to 2e-5 (the unsharded loop
# comparison's tolerance in test_torch_train.py) and 2e-4;
# test_torch_train_mesh.py holds the step with dropped pairs, sharded
# against unsharded, to 1e-5 and 1e-4.
LOSS_RTOL = {"deepseek_v2_lite_2x2": 2e-5}
MASTER_TOL = {"deepseek_v2_lite_2x2": 2e-4}

NAMES = ["minicpm_2b_2x2", "minicpm_2b_1x4", "minicpm_2b_4x1",
         "deepseek_v2_lite_2x2", "zamba2_2p7b_2x2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("loop")
    ranks, jres = torch_ranks.run(tmp, ranks=(RANK_BODY, 4),
                                  jax=(JAX_BODY, 4), timeout=400)
    out = next(tmp.glob("run*"))
    return ranks, jres, out


@pytest.mark.parametrize("name", NAMES)
def test_mesh_loop_equals_jax_mesh_loop(runs, name):
    ranks, jres, out = runs
    for r in ranks:
        assert r[name] == ranks[0][name]          # one run, every rank
    assert len(jres[name]) == 10
    np.testing.assert_allclose(ranks[0][name], jres[name],
                               rtol=LOSS_RTOL.get(name, 1e-5))
    got = np.load(out / f"port_{name}.npz")
    want = np.load(out / f"jax_{name}.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        a, b = want[k], got[k]
        assert float(np.abs(a - b).max() / max(1.0, np.abs(a).max())) \
            <= MASTER_TOL.get(name, 1e-4), (name, k)


def test_deepseek_case_drops_pairs():
    """At capacity factor 1.0 the smoke deepseek's expert buffers (4 slots
    a row) drop pairs of the loop's first batch."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import registry as treg
    from repro_torch.models.mlp import MoE
    cfg = dataclasses.replace(treg.get_smoke_config("deepseek_v2_lite"),
                              dtype="float32", capacity_factor=1.0)
    fns = treg.build(cfg, device="cpu", masters=True)
    model = fns["init"](torch.Generator().manual_seed(1))
    dropped = []
    slots = MoE.slots

    def spy(gates, C):
        pos, keep = slots(gates, C)
        dropped.append(int(((gates > 0) & ~keep).sum()))
        return pos, keep

    batch = TokenPipeline(vocab=cfg.vocab, seq_len=16, global_batch=4,
                          seed=5).batch(0)
    MoE.slots = staticmethod(spy)
    try:
        fns["loss_fn"](model, {k: torch.as_tensor(v)
                               for k, v in batch.items()})
    finally:
        MoE.slots = staticmethod(slots)
    assert dropped and sum(dropped) > 0, dropped
