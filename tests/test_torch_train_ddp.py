"""The port's compressed data-parallel step
(``repro_torch.optim.compression.make_train_step_ddp``) on 4 gloo ranks
against the JAX package's ``make_train_step_ddp`` on 4 simulated
devices: minicpm smoke config in float32, the same weights (the port's
seeded init, handed to JAX through ``params_to_jax``) and global
batches, 6 steps with the plain and with the int8 error-feedback
all-reduce.  ``compress_psum`` alone, on the same per-rank gradients
and residuals (JAX's under a vmap named "data", one device), gives
JAX's averaged gradients exactly (the same int8
codes and scales) and its residuals within 2 float32 ulps of the
gradient's size (XLA fuses the residual's multiply-subtract, PyTorch
rounds the product first).  Tolerances of the training runs:
each step's loss within 1e-5 relative with the plain all-reduce, 2e-4
with the compressed one (its int8 codes are rounded from gradients that
the two packages sum in other orders, and a code one step off moves its
element by a whole quantum, max |g| / 127 / 4)."""
import numpy as np
import pytest

import torch_ranks

STEPS = 6

SETUP = """
import dataclasses
import torch
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import registry as treg
TCFG = dataclasses.replace(treg.get_smoke_config("minicpm_2b"),
                           dtype="float32")
MODEL = treg.build(TCFG, device="cpu", masters=True)["init"](
    torch.Generator().manual_seed(4))
PIPE = TokenPipeline(vocab=TCFG.vocab, seq_len=16, global_batch=8, seed=3)
STEPS = int(ARGS[0])
"""

RANK_BODY = SETUP + """
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.optim.compression import (init_error_state,
                                           make_train_step_ddp)
opt = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=20)
fns = treg.build(TCFG, device="cpu", masters=True)
tree = treg.params_to_jax(TCFG, MODEL)
for compress in (False, True):
    model = treg.params_from_jax(TCFG, tree, device="cpu", masters=True)
    params = dict(model.named_parameters())
    st, err = adamw_init(params), init_error_state(params)
    step = make_train_step_ddp(TCFG, opt, fns["loss_fn"], dist.group.WORLD,
                               compress=compress)
    losses = []
    for s in range(STEPS):
        batch = {k: torch.as_tensor(v) for k, v in PIPE.batch(s).items()}
        model, st, err, m = step(model, st, err, batch)
        losses.append(float(m["loss"]))
    RESULT[str(compress)] = losses
    RESULT[str(compress) + "_embed0"] = model.embed[0].detach().numpy()
"""

JAX_BODY = SETUP + """
import jax.numpy as jnp
from repro.models import registry
from repro.optim.adamw import AdamWConfig, adamw_init
from repro.optim.compression import init_error_state, make_train_step_ddp
from repro.runtime import jax_compat
cfg = dataclasses.replace(registry.get_smoke_config("minicpm_2b"),
                          dtype="float32")
mesh = jax_compat.make_mesh((4,), ("data",))
opt = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=20)
fns = registry.build(cfg)
tree = jax.tree_util.tree_map(jnp.asarray, treg.params_to_jax(TCFG, MODEL))
for compress in (False, True):
    p, st, err = tree, adamw_init(tree), init_error_state(tree)
    step = make_train_step_ddp(cfg, opt, fns["loss_fn"], mesh,
                               compress=compress)
    losses = []
    for s in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in PIPE.batch(s).items()}
        p, st, err, m = step(p, st, err, batch)
        losses.append(float(m["loss"]))
    RESULT[str(compress)] = losses
    RESULT[str(compress) + "_embed0"] = np.asarray(p["embed"][0])
"""


PSUM_SHAPES = {"a": (33, 5), "b": (7,), "c": (2, 3, 4)}

PSUM_RANK = """
import torch
from repro_torch.optim.compression import compress_psum
shapes = %r
def leaves(seed, scale):
    rng = np.random.default_rng(seed)
    return {k: torch.as_tensor((rng.normal(size=s) * scale).astype(
        np.float32)) for k, s in shapes.items()}
g_hat, new_e = compress_psum(leaves(RANK, 1.0), leaves(100 + RANK, 1e-2),
                             dist.group.WORLD)
RESULT["g"] = {k: v.numpy() for k, v in g_hat.items()}
RESULT["e"] = {k: v.numpy() for k, v in new_e.items()}
""" % (PSUM_SHAPES,)

PSUM_JAX = """
import jax.numpy as jnp
from repro.optim.compression import compress_psum
shapes = %r
def leaves(seed, scale):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in shapes.items()}
g = {k: jnp.stack([leaves(r, 1.0)[k] for r in range(4)]) for k in shapes}
e = {k: jnp.stack([leaves(100 + r, 1e-2)[k] for r in range(4)])
     for k in shapes}
# the 4 ranks as a named vmap axis on one device: the same psums without
# the cross-thread rendezvous of 4 simulated devices
gh, ne = jax.jit(jax.vmap(lambda g, e: compress_psum(g, e, "data"),
                          axis_name="data"))(g, e)
RESULT["g"] = {k: np.asarray(v) for k, v in gh.items()}
RESULT["e"] = {k: np.asarray(v) for k, v in ne.items()}
""" % (PSUM_SHAPES,)


def test_compress_psum_equals_jax(tmp_path):
    ranks, ref = torch_ranks.run(tmp_path, ranks=(PSUM_RANK, 4),
                                 jax=(PSUM_JAX, 1), timeout=300)
    for r, got in enumerate(ranks):
        for k in PSUM_SHAPES:
            want = np.asarray(ref["g"][k], np.float32)[r]
            assert np.array_equal(np.asarray(got["g"][k], np.float32),
                                  want), (r, k)
            want = np.asarray(ref["e"][k], np.float32)[r]
            ulp = 2.0 ** -23 * 4.0           # |g + e| < 4 at these draws
            np.testing.assert_allclose(np.asarray(got["e"][k], np.float32),
                                       want, rtol=0, atol=2 * ulp)


def test_ddp_steps_equal_jax_on_four_ranks(tmp_path):
    ranks, ref = torch_ranks.run(tmp_path, ranks=(RANK_BODY, 4),
                                 jax=(JAX_BODY, 4), args=(STEPS,),
                                 timeout=300)
    for compress, tol in (("False", 1e-5), ("True", 2e-4)):
        want = np.asarray(ref[compress])
        assert len(want) == STEPS and np.all(np.isfinite(want))
        for r, got in enumerate(ranks):
            np.testing.assert_allclose(got[compress], want, rtol=tol,
                                       err_msg=f"rank {r} {compress}")
            # the masters stay replicated: every rank holds rank 0's
            assert got[compress + "_embed0"] == ranks[0][
                compress + "_embed0"]
    # training makes progress either way
    assert ref["True"][-1] < ref["True"][0]
