"""Checkpoints across meshes and packages: a checkpoint holds the JAX
tree, unsharded, so a run cut on one mesh resumes on another, on none,
or in the other package.  minicpm's smoke config, float32, weight decay
0, 10 steps; the port on 4 gloo ranks on the CPU, the JAX package on 4
simulated devices:

* the port's (2, 2) run cut at step 5 resumes on (2, 2), on (1, 4) and
  unsharded, each equal to the port's uncut (2, 2) run (losses 1e-6
  relative, final masters 1e-6 of max(1, max |x|));
* the same checkpoint resumes in the JAX package on its (2, 2) mesh,
  and a JAX (2, 2) run cut at step 5 resumes on the port's (2, 2) mesh,
  each equal to JAX's uncut (2, 2) run to the two packages' tolerance
  (losses 1e-5, masters 1e-4), as the port's uncut run is."""
import dataclasses

import numpy as np
import pytest

import torch_ranks

SETUP = """
import dataclasses
import numpy as np
import torch
from repro_torch.models import registry as treg
PIPE = dict(seq_len=16, global_batch=4, seed=7)
OPT = dict(lr=3e-3, weight_decay=0.0, warmup_steps=3, total_steps=10)
FULL = dict(steps=10, ckpt_every=1000, log_every=1000)
CUT = dict(steps=5, ckpt_every=5, log_every=1000)
TCFG = dataclasses.replace(treg.get_smoke_config("minicpm_2b"),
                           dtype="float32")
TREE = treg.params_to_jax(TCFG, treg.build(TCFG, device="cpu",
                                           masters=True)["init"](
    torch.Generator().manual_seed(3)))

def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in flat(tree[key], f"{prefix}{key}/").items()}
    if isinstance(tree, list):
        return {k: v for i, t in enumerate(tree)
                for k, v in flat(t, f"{prefix}{i}/").items()}
    return {prefix[:-1]: np.asarray(tree, np.float32)}
"""

JAX_SETUP = SETUP + """
import jax.numpy as jnp
from repro.data.pipeline import TokenPipeline
from repro.launch.mesh import make_mesh
from repro.models import registry as jreg
from repro.optim.adamw import AdamWConfig
from repro.train.loop import TrainLoopConfig, train_loop
jcfg = dataclasses.replace(jreg.get_smoke_config("minicpm_2b"),
                           dtype="float32")
fns = dict(jreg.build(jcfg))
fns["init"] = lambda k: jax.tree_util.tree_map(jnp.asarray, TREE)
mesh = make_mesh((2, 2), ("data", "model"))

def run(name, loop, **kw):
    out = train_loop(jcfg, fns, TrainLoopConfig(**loop), AdamWConfig(**OPT),
                     TokenPipeline(vocab=jcfg.vocab, **PIPE), mesh=mesh,
                     **kw)
    RESULT[name] = out["losses"]
    np.savez(OUT + f"/{name}.npz", **flat(out["params"]))
"""

RANK_SETUP = SETUP + """
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import TrainLoopConfig, train_loop
fns = dict(treg.build(TCFG, device="cpu", masters=True))
fns["init"] = lambda g: treg.params_from_jax(TCFG, TREE, device="cpu",
                                             masters=True)

def run(name, shape, loop, **kw):
    out = train_loop(TCFG, fns, TrainLoopConfig(**loop), AdamWConfig(**OPT),
                     TokenPipeline(vocab=TCFG.vocab, **PIPE),
                     mesh=make_mesh(shape, ("data", "model"), device="cpu"),
                     **kw)
    RESULT[name] = out["losses"]
    final = treg.params_to_jax(TCFG, out["model"])
    if RANK == 0:
        np.savez(OUT + f"/{name}.npz", **flat(final))
"""

JAX_FIRST = JAX_SETUP + """
run("jax_full", FULL)
run("jax_cut", dict(CUT, ckpt_dir=ARGS[0]))
"""

RANK_FIRST = RANK_SETUP + """
run("port_full", (2, 2), FULL)
run("port_cut", (2, 2), dict(CUT, ckpt_dir=ARGS[1]))
"""

JAX_SECOND = JAX_SETUP + """
run("jax_resumes_port", dict(FULL, ckpt_dir=ARGS[1]), resume=True)
"""

RANK_SECOND = RANK_SETUP + """
run("port_resumes_port_2x2", (2, 2), dict(FULL, ckpt_dir=ARGS[1]),
    resume=True)
run("port_resumes_port_1x4", (1, 4), dict(FULL, ckpt_dir=ARGS[1]),
    resume=True)
run("port_resumes_jax_2x2", (2, 2), dict(FULL, ckpt_dir=ARGS[0]),
    resume=True)
"""


def flat(tree, prefix="") -> dict:
    """{"a/0/b": array} of a nested dict / list tree."""
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in flat(tree[key], f"{prefix}{key}/").items()}
    if isinstance(tree, list):
        return {k: v for i, t in enumerate(tree)
                for k, v in flat(t, f"{prefix}{i}/").items()}
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def leaves(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def rel(a: dict, b: dict) -> float:
    assert sorted(a) == sorted(b)
    return max(float(np.abs(a[k] - b[k]).max() / max(1.0,
                                                     np.abs(a[k]).max()))
               for k in a)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    jck, pck = tmp / "jax_ck", tmp / "port_ck"
    first, jfirst = torch_ranks.run(tmp, ranks=(RANK_FIRST, 4),
                                    jax=(JAX_FIRST, 4), args=(jck, pck),
                                    timeout=300)
    second, jsecond = torch_ranks.run(tmp, ranks=(RANK_SECOND, 4),
                                      jax=(JAX_SECOND, 4), args=(jck, pck),
                                      timeout=300)
    outs = sorted(tmp.glob("run*"))
    npz = {p.stem: leaves(p) for o in outs for p in o.glob("*.npz")}
    losses = {**jfirst, **first[0], **jsecond, **second[0]}
    for r in first + second:          # one run, every rank
        for k, v in r.items():
            assert v == losses[k], k
    return losses, npz, pck


def test_port_checkpoint_resumes_on_any_mesh(runs):
    losses, npz, _ = runs
    want = losses["port_full"][5:]
    for name in ("port_resumes_port_2x2", "port_resumes_port_1x4"):
        assert len(losses[name]) == 5, name
        np.testing.assert_allclose(losses[name], want, rtol=1e-6)
        assert rel(npz["port_full"], npz[name]) <= 1e-6, name


def test_port_mesh_checkpoint_resumes_unsharded(runs):
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import registry as treg
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import TrainLoopConfig, train_loop
    losses, npz, pck = runs
    cfg = dataclasses.replace(treg.get_smoke_config("minicpm_2b"),
                              dtype="float32")
    out = train_loop(
        cfg, treg.build(cfg, device="cpu", masters=True),
        TrainLoopConfig(steps=10, ckpt_every=1000, log_every=1000,
                        ckpt_dir=str(pck)),
        AdamWConfig(lr=3e-3, weight_decay=0.0, warmup_steps=3,
                    total_steps=10),
        TokenPipeline(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=7),
        device="cpu", resume=True)
    assert out["steps_run"] == 5
    np.testing.assert_allclose(out["losses"], losses["port_full"][5:],
                               rtol=1e-6)
    assert rel(npz["port_full"],
               flat(treg.params_to_jax(cfg, out["model"]))) <= 1e-6


def test_checkpoints_resume_across_the_packages(runs):
    losses, npz, _ = runs
    want = losses["jax_full"]
    np.testing.assert_allclose(losses["port_full"], want, rtol=1e-5)
    assert rel(npz["jax_full"], npz["port_full"]) <= 1e-4
    for name in ("jax_resumes_port", "port_resumes_jax_2x2"):
        assert len(losses[name]) == 5, name
        np.testing.assert_allclose(losses[name], want[5:], rtol=1e-5)
        assert rel(npz["jax_full"], npz[name]) <= 1e-4, name
