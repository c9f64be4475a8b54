"""The port's training substrate (``repro_torch.optim``, ``train``,
``data`` and ``launch.train``) against the JAX package's on the CPU:
schedules, clipping and one AdamW update on the same leaves, the token
pipeline bit for bit, the loss, microbatch accumulation, ``train_loop``
over 10 steps, resume within the port and across the two packages in
both directions, C6 (weight decay of the per-layer vectors), the CLI
and the example.  The JAX package comes in through fixtures."""
import dataclasses
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import registry as treg
from repro_torch.optim import adamw as tadamw
from repro_torch.train.loop import TrainLoopConfig, train_loop
from repro_torch.train.train_step import init_train_state, make_train_step

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The smoke configs' tensors are tiny: one intra-op thread runs
    them faster than a pool that contends with the suite's other
    workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from repro.data.pipeline import TokenPipeline as JPipe
    from repro.models import registry
    from repro.optim import adamw
    from repro.train import loop
    return types.SimpleNamespace(jax=jax, jnp=jnp, registry=registry,
                                 adamw=adamw, loop=loop, Pipe=JPipe)


def _leaves(jx, tree):
    return [np.asarray(x, np.float32)
            for x in jx.jax.tree_util.tree_leaves(tree)]


def _rel(a, b):
    return float(np.abs(a - b).max() / max(1.0, np.abs(a).max()))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

SCHEDULES = [dict(schedule="constant", warmup_steps=0),
             dict(schedule="constant", warmup_steps=7),
             dict(schedule="cosine", warmup_steps=10, total_steps=100),
             dict(schedule="cosine", warmup_steps=0, total_steps=37,
                  min_lr_frac=0.0),
             dict(schedule="wsd", warmup_steps=20, total_steps=200),
             dict(schedule="wsd", warmup_steps=5, total_steps=60,
                  decay_frac=0.3, min_lr_frac=0.05)]


@pytest.mark.parametrize("kw", SCHEDULES,
                         ids=lambda kw: f"{kw['schedule']}-{kw['warmup_steps']}")
def test_schedules_equal_jax_at_every_step(jx, kw):
    jcfg = jx.adamw.AdamWConfig(lr=3e-3, **kw)
    tcfg = tadamw.AdamWConfig(lr=3e-3, **kw)
    steps = np.arange(jcfg.total_steps + 6, dtype=np.int32)
    want = np.array([float(jx.adamw.schedule_lr(jcfg, jx.jnp.int32(s)))
                     for s in steps], np.float32)
    got = tadamw.schedule_lr(tcfg, torch.as_tensor(steps)).numpy()
    # within 3 float32 ulps: torch's cos and XLA's differ in the last bits
    np.testing.assert_allclose(got, want, rtol=3 * 2.0 ** -23, atol=0)
    assert got.dtype == np.float32


def _leaf_set(seed):
    rng = np.random.default_rng(seed)
    shapes = {"w": (8, 16), "b": (16,), "t": (4, 3, 5), "s": (7,)}
    return {k: (rng.normal(size=s) * 0.5).astype(np.float32)
            for k, s in shapes.items()}


def test_clip_by_global_norm_equals_jax(jx):
    grads = _leaf_set(1)
    for max_norm in (1.0, 100.0):
        want, wnorm = jx.adamw.clip_by_global_norm(
            {k: jx.jnp.asarray(v) for k, v in grads.items()}, max_norm)
        got, gnorm = tadamw.clip_by_global_norm(
            [torch.as_tensor(v.copy()) for v in grads.values()], max_norm)
        assert abs(float(gnorm) - float(wnorm)) <= 1e-6 * float(wnorm)
        for k, g in zip(grads, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("clip", [None, 0.5])
def test_adamw_updates_equal_jax(jx, clip):
    """Three successive updates of the same leaves (2-D and 3-D decayed,
    1-D exempt in both packages: these leaves are unstacked)."""
    kw = dict(lr=1e-2, weight_decay=0.1, clip_norm=clip, schedule="cosine",
              warmup_steps=2, total_steps=10)
    jcfg, tcfg = jx.adamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
    p0 = _leaf_set(0)
    jp = {k: jx.jnp.asarray(v) for k, v in p0.items()}
    jst = jx.adamw.adamw_init(jp)
    tp = {k: torch.as_tensor(v.copy()) for k, v in p0.items()}
    tst = tadamw.adamw_init(tp)
    for i in range(3):
        g = _leaf_set(10 + i)
        jp, jst, jm = jx.adamw.adamw_update(
            jcfg, jp, {k: jx.jnp.asarray(v) for k, v in g.items()}, jst)
        tp, tst, tm = tadamw.adamw_update(
            tcfg, tp, {k: torch.as_tensor(v) for k, v in g.items()}, tst)
        assert int(tst["step"]) == int(jst["step"]) == i + 1
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= 1e-9
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= (
            1e-6 * max(1.0, float(jm["grad_norm"])))
        for k in p0:
            for got, want in ((tp[k], jp[k]), (tst["m"][k], jst["m"][k]),
                              (tst["v"][k], jst["v"][k])):
                assert _rel(np.asarray(want), got.numpy()) <= 1e-6, k


def test_adamw_minimizes_a_quadratic():
    params = {"w": torch.tensor([3.0, -2.0])}
    state = tadamw.adamw_init(params)
    cfg = tadamw.AdamWConfig(lr=0.1, weight_decay=0.0, schedule="constant",
                             warmup_steps=0)
    for _ in range(200):
        params, state, _ = tadamw.adamw_update(
            cfg, params, {"w": 2 * params["w"]}, state)
    assert float(params["w"].abs().max()) < 1e-2


C6_ARCHS = ["minicpm_2b", "zamba2_2p7b", "xlstm_1p3b", "whisper_base"]


@pytest.mark.parametrize("arch", C6_ARCHS)
def test_c6_per_layer_vectors_are_not_decayed(jx, arch):
    """ROADMAP C6.  One update with zero gradients, lr 1e-2, weight decay
    0.1, a constant schedule and no clipping: ``repro`` moves every norm
    scale stacked in a scanned group by lr·wd (its ``ndim >= 2`` sees
    the layer axis) and leaves the top-level ``final_norm``; the port
    moves no per-layer 1-D leaf, and every leaf of two or more
    dimensions exactly as ``repro`` does."""
    kw = dict(lr=1e-2, weight_decay=0.1, clip_norm=None,
              schedule="constant", warmup_steps=0)
    cfg = treg.get_smoke_config(arch)
    model = treg.build(cfg, device="cpu", masters=True)["init"](
        torch.Generator().manual_seed(0))
    tree = treg.params_to_jax(cfg, model)
    jp = jx.jax.tree_util.tree_map(jx.jnp.asarray, tree)
    new, _, _ = jx.adamw.adamw_update(
        jx.adamw.AdamWConfig(**kw), jp,
        jx.jax.tree_util.tree_map(jx.jnp.zeros_like, jp),
        jx.adamw.adamw_init(jp))
    new = jx.jax.tree_util.tree_map(np.asarray, new)
    moved = 0
    for path, old in jx.jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = jx.jax.tree_util.keystr(path)
        got = np.asarray(dict(jx.jax.tree_util.tree_flatten_with_path(
            new)[0])[path])
        if key.endswith("['scale']"):
            if key.startswith("['group_") or key.startswith(
                    "['encoder']['layers']"):
                np.testing.assert_allclose(old - got, 1e-3 * old,
                                           rtol=0, atol=1e-7)
                moved += 1
            else:
                assert np.array_equal(got, old), key      # final_norm
    assert moved > 0

    params = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in params.items()}
    tadamw.adamw_update(tadamw.AdamWConfig(**kw), params,
                        {n: torch.zeros_like(p) for n, p in params.items()},
                        tadamw.adamw_init(params))
    want = treg.leaves_from_jax(cfg, new, params)
    n1 = 0
    for n, p in params.items():
        if p.ndim == 1:
            assert torch.equal(p, before[n]), n
            n1 += 1
        else:
            np.testing.assert_allclose(p.detach().numpy(), want[n],
                                       rtol=0, atol=1e-7, err_msg=n)
    assert n1 > 0


# ---------------------------------------------------------------------------
# data and loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (1, 5), (7, 1234)])
def test_token_pipeline_batches_are_bit_identical(jx, seed, step):
    kw = dict(vocab=97, seq_len=32, global_batch=8, seed=seed)
    jp, tp = jx.Pipe(**kw), TokenPipeline(**kw)
    for shard, n in ((0, 1), (0, 4), (3, 4), (1, 2)):
        want = jp.batch(step, shard=shard, n_shards=n)
        got = tp.batch(step, shard=shard, n_shards=n)
        assert want.keys() == got.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), (k, shard, n)


def test_ce_loss_equals_jax(jx):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    want = float(jx.registry._ce_loss(jx.jnp.asarray(logits),
                                      jx.jnp.asarray(labels), 50))
    got = float(treg._ce_loss(torch.as_tensor(logits),
                              torch.as_tensor(labels)))
    assert abs(got - want) <= 1e-6 * abs(want)
    bf = torch.as_tensor(logits).bfloat16()
    assert treg._ce_loss(bf, torch.as_tensor(labels)).dtype == torch.float32


# ---------------------------------------------------------------------------
# train step and loop
# ---------------------------------------------------------------------------

def _fcfg(arch, **over):
    return dataclasses.replace(treg.get_smoke_config(arch), dtype="float32",
                               **over)


def test_microbatches_equal_the_full_batch():
    """4 microbatches of 2 against 1 of 8 (qwen2.5 smoke, float32, no
    clipping): the same loss, gradients and updated masters."""
    cfg = _fcfg("qwen2p5_14b")
    fns = treg.build(cfg, device="cpu", masters=True)
    opt = tadamw.AdamWConfig(lr=1e-3, warmup_steps=0, clip_norm=None)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=16, global_batch=8)
    batch = {k: torch.as_tensor(v) for k, v in pipe.batch(0).items()}
    out = []
    for mb in (1, 4):
        model = fns["init"](torch.Generator().manual_seed(0))
        model, _, m = make_train_step(cfg, opt, fns["loss_fn"],
                                      microbatches=mb)(
            model, init_train_state(model), batch)
        out.append((float(m["loss"]), dict(model.named_parameters())))
    (l1, p1), (l4, p4) = out
    assert abs(l1 - l4) <= 1e-5 * l1
    for n in p1:
        g1, g4 = p1[n].grad, p4[n].grad
        assert float((g1 - g4).abs().max()) <= 1e-5 * max(
            1.0, float(g1.abs().max())), n
        assert float((p1[n] - p4[n]).detach().abs().max()) <= 5e-6, n


def test_batches_split_positions3_on_its_batch_axis():
    from repro_torch.train.train_step import split_batch
    batch = {"tokens": torch.arange(12).reshape(4, 3),
             "positions3": torch.arange(36).reshape(3, 4, 3)}
    parts = split_batch(batch, 2)
    assert torch.equal(parts[1]["tokens"], batch["tokens"][2:])
    assert torch.equal(parts[1]["positions3"], batch["positions3"][:, 2:])


def _jax_fns_from(jx, jcfg, tree):
    """The JAX function set with ``init`` returning ``tree``."""
    fns = dict(jx.registry.build(jcfg))
    fns["init"] = lambda key: jx.jax.tree_util.tree_map(jx.jnp.asarray,
                                                        tree)
    return fns


def _port_fns_from(tcfg, tree):
    fns = dict(treg.build(tcfg, device="cpu", masters=True))
    fns["init"] = lambda gen: treg.params_from_jax(tcfg, tree, device="cpu",
                                                   masters=True)
    return fns


LOOP_OPT = dict(lr=3e-3, weight_decay=0.0, warmup_steps=3, total_steps=10)


def _loop_setup(jx, arch):
    jcfg = dataclasses.replace(jx.registry.get_smoke_config(arch),
                               dtype="float32")
    tcfg = _fcfg(arch)
    model = treg.build(tcfg, device="cpu", masters=True)["init"](
        torch.Generator().manual_seed(1))
    tree = treg.params_to_jax(tcfg, model)
    pipe = dict(vocab=tcfg.vocab, seq_len=16, global_batch=4, seed=5)
    return (jcfg, _jax_fns_from(jx, jcfg, tree), jx.Pipe(**pipe),
            jx.adamw.AdamWConfig(**LOOP_OPT), tcfg, _port_fns_from(tcfg, tree),
            TokenPipeline(**pipe), tadamw.AdamWConfig(**LOOP_OPT))


def _assert_runs_equal(jx, jlosses, jparams, tlosses, tparams):
    np.testing.assert_allclose(tlosses, jlosses, rtol=2e-5)
    for a, b in zip(_leaves(jx, jparams), _leaves(jx, tparams)):
        assert _rel(a, b) <= 1e-4


@pytest.mark.parametrize("arch", ["minicpm_2b", "zamba2_2p7b"])
def test_train_loop_equals_jax(jx, arch):
    """10 steps from the same weights at weight decay 0 (where C6 has no
    effect): the same losses (2e-5) and final masters (1e-4 ×
    max(1, max |x|))."""
    jcfg, jfns, jpipe, jopt, tcfg, tfns, tpipe, topt = _loop_setup(jx, arch)
    loop = dict(steps=10, ckpt_every=1000, log_every=1000)
    want = jx.loop.train_loop(jcfg, jfns, jx.loop.TrainLoopConfig(**loop),
                              jopt, jpipe)
    got = train_loop(tcfg, tfns, TrainLoopConfig(**loop), topt, tpipe,
                     device="cpu")
    assert got["steps_run"] == 10
    _assert_runs_equal(jx, want["losses"], want["params"], got["losses"],
                       treg.params_to_jax(tcfg, got["model"]))


def test_resume_is_exact(tmp_path):
    cfg = _fcfg("gemma2_2b")
    fns = treg.build(cfg, device="cpu", masters=True)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=9)
    opt = tadamw.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=40)
    full = train_loop(cfg, fns, TrainLoopConfig(
        steps=12, ckpt_every=1000, log_every=1000), opt, pipe, device="cpu")
    d = str(tmp_path / "ck")
    train_loop(cfg, fns, TrainLoopConfig(
        steps=6, ckpt_every=3, log_every=1000, ckpt_dir=d), opt, pipe,
        device="cpu")
    resumed = train_loop(cfg, fns, TrainLoopConfig(
        steps=12, ckpt_every=1000, log_every=1000, ckpt_dir=d), opt, pipe,
        device="cpu", resume=True)
    assert resumed["steps_run"] == 6
    assert resumed["losses"] == full["losses"][6:]
    for a, b in zip(full["model"].parameters(),
                    resumed["model"].parameters()):
        assert torch.equal(a, b)
    assert int(resumed["opt"]["step"]) == 12


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_resume_across_the_packages(jx, tmp_path, writer):
    """A run cut at step 5 by one package and resumed to step 10 by the
    other equals the other's uncut run (the checkpoint holds the JAX
    tree: ``{"params", "opt": {"m", "v", "step"}}``)."""
    jcfg, jfns, jpipe, jopt, tcfg, tfns, tpipe, topt = _loop_setup(
        jx, "minicpm_2b")
    d = str(tmp_path / "ck")
    cut = dict(steps=5, ckpt_every=5, log_every=1000, ckpt_dir=d)
    full = dict(steps=10, ckpt_every=1000, log_every=1000)
    if writer == "jax":
        jx.loop.train_loop(jcfg, jfns, jx.loop.TrainLoopConfig(**cut), jopt,
                           jpipe)
        got = train_loop(tcfg, tfns, TrainLoopConfig(**{**full,
                         "ckpt_dir": d}), topt, tpipe, device="cpu",
                         resume=True)
        want = jx.loop.train_loop(jcfg, jfns,
                                  jx.loop.TrainLoopConfig(**full), jopt,
                                  jpipe)
        got_params = treg.params_to_jax(tcfg, got["model"])
    else:
        train_loop(tcfg, tfns, TrainLoopConfig(**cut), topt, tpipe,
                   device="cpu")
        got = jx.loop.train_loop(jcfg, jfns, jx.loop.TrainLoopConfig(
            **{**full, "ckpt_dir": d}), jopt, jpipe, resume=True)
        want = train_loop(tcfg, tfns, TrainLoopConfig(**full), topt, tpipe,
                          device="cpu")
        want["params"] = treg.params_to_jax(tcfg, want["model"])
        got_params = got["params"]
    assert got["steps_run"] == 5
    _assert_runs_equal(jx, want["losses"][5:], want["params"],
                       got["losses"], got_params)


def test_train_loop_refuses_serving_weights():
    cfg = _fcfg("minicpm_2b")
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=8, global_batch=2)
    with pytest.raises(ValueError, match="float32 masters"):
        train_loop(cfg, treg.build(cfg, device="cpu"), TrainLoopConfig(
            steps=1), tadamw.AdamWConfig(), pipe, device="cpu")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def test_entry_points_run_on_the_card_unless_asked_for_the_cpu():
    from repro_torch.launch import train as cli
    cfg = treg.get_smoke_config("minicpm-2b")
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=8, global_batch=2)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default applies")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        treg.build(cfg, masters=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_loop(cfg, treg.build(cfg, device="cpu", masters=True),
                   TrainLoopConfig(steps=1), tadamw.AdamWConfig(), pipe)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--arch", "minicpm-2b", "--smoke", "--steps", "1"])


@pytest.mark.parametrize("arch", ["minicpm-2b", "whisper-base",
                                  "qwen2-vl-72b"])
def test_cli_trains_on_the_cpu(arch, capsys):
    from repro_torch.launch import train as cli
    out = cli.main(["--arch", arch, "--smoke", "--steps", "6",
                    "--seq-len", "16", "--global-batch", "4",
                    "--microbatches", "2", "--device", "cpu"])
    assert len(out["losses"]) == 6 and np.all(np.isfinite(out["losses"]))
    assert "[train] done" in capsys.readouterr().out


def test_example_trains_preempts_and_resumes_on_the_cpu(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", ROOT / "examples" / "train_lm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    first, last = mod.main(["--device", "cpu", "--steps", "80",
                            "--ckpt-dir", str(tmp_path / "ck")])
    assert last < first - 1.0
    assert not (tmp_path / "ck").exists()


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
@pytest.mark.parametrize("arch", treg.ARCHS)
def test_cuda_train_step_equals_the_cpu(arch):
    """One float32 train step of each smoke config on the card and on
    the CPU from the same weights: the loss within 1e-5, every gradient
    and updated master within 1e-4 × max(1, max |x|) (lr 1e-5: at the
    first step AdamW moves every weight by about lr, whatever the
    gradient's size)."""
    cfg = _fcfg(arch)
    opt = tadamw.AdamWConfig(lr=1e-5, schedule="constant", warmup_steps=0)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=16, global_batch=4)
    from repro_torch.launch.train import stub_batches
    extra = stub_batches(cfg, 16, 4)
    batch = dict(pipe.batch(0), **(extra(0) if extra else {}))
    host = treg.build(cfg, device="cpu", masters=True)["init"](
        torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cpu", "cuda"):
        fns = treg.build(cfg, device=dev, masters=True)
        model = treg.params_from_jax(cfg, treg.params_to_jax(cfg, host),
                                     device=dev, masters=True)
        model, _, m = make_train_step(cfg, opt, fns["loss_fn"])(
            model, init_train_state(model),
            {k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
        out[dev] = (float(m["loss"]), {
            n: (p.detach().cpu(), p.grad.cpu() if p.grad is not None
                else torch.zeros(p.shape))
            for n, p in model.named_parameters()})
    assert abs(out["cpu"][0] - out["cuda"][0]) <= 1e-5 * out["cpu"][0]
    for n, (p, g) in out["cpu"][1].items():
        cp, cg = out["cuda"][1][n]
        assert float((p - cp).abs().max()) <= 1e-4 * max(
            1.0, float(p.abs().max())), n
        assert float((g - cg).abs().max()) <= 1e-4 * max(
            1.0, float(g.abs().max())), n


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_cuda_remat_and_microbatches_change_no_gradient():
    """On the card, minicpm's smoke config in float32: remat "block"
    gives the gradients of remat "none" (1e-6), and 2 microbatches those
    of 1 (1e-5), relative to max(1, max |g|)."""
    out = {}
    for remat, mb in (("none", 1), ("block", 1), ("block", 2)):
        cfg = _fcfg("minicpm_2b", remat=remat)
        fns = treg.build(cfg, device="cuda", masters=True)
        model = fns["init"](torch.Generator("cuda").manual_seed(0))
        pipe = TokenPipeline(vocab=cfg.vocab, seq_len=16, global_batch=8)
        batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in pipe.batch(0).items()}
        opt = tadamw.AdamWConfig(clip_norm=None)
        make_train_step(cfg, opt, fns["loss_fn"], microbatches=mb)(
            model, init_train_state(model), batch)
        out[remat, mb] = {n: p.grad.cpu() for n, p in
                          model.named_parameters()}
    for key, tol in ((("block", 1), 1e-6), (("block", 2), 1e-5)):
        for n, g in out["none", 1].items():
            assert float((g - out[key][n]).abs().max()) <= tol * max(
                1.0, float(g.abs().max())), (key, n)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_cuda_resume_is_exact(tmp_path):
    cfg = treg.get_smoke_config("minicpm_2b")
    fns = treg.build(cfg, device="cuda", masters=True)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=9)
    opt = tadamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    full = train_loop(cfg, fns, TrainLoopConfig(
        steps=10, ckpt_every=1000, log_every=1000), opt, pipe,
        device="cuda")
    d = str(tmp_path / "ck")
    train_loop(cfg, fns, TrainLoopConfig(
        steps=5, ckpt_every=5, log_every=1000, ckpt_dir=d), opt, pipe,
        device="cuda")
    resumed = train_loop(cfg, fns, TrainLoopConfig(
        steps=10, ckpt_every=1000, log_every=1000, ckpt_dir=d), opt, pipe,
        device="cuda", resume=True)
    np.testing.assert_allclose(resumed["losses"], full["losses"][5:],
                               rtol=1e-6)
    assert np.all(np.isfinite(full["grad_norms"]))
