"""The port's training loss and gradients (``registry.build(cfg,
masters=True)``'s ``loss_fn`` and autograd) against
``jax.value_and_grad`` of the JAX package's ``loss_fn``, on the same
weights (``params_from_jax``) and batch, for all ten smoke configs.
Tolerances: float32, the loss within 1e-5 and each gradient leaf within
1e-4 × max(1, max |g|).  In bfloat16 the loss is within 3e-2 of JAX's
bf16 loss, and each gradient leaf is held against JAX's float32
gradient on the same weights and batch (the value both bf16 runs
approximate): within max(3e-2, 3 × the distance of JAX's own bf16
gradient from it), on the same scale.  Two bf16 runs cannot be held to
3e-2 of each other leaf by leaf: XLA keeps f32 inside its fusions and
eager PyTorch rounds every op, and a bf16 gradient leaf lands up to
0.31 × max |g| from the float32 one in either package (the tied
embedding, where the head's and the gather's gradients cancel), now on
one side, now on the other.  Also: the MoE family with
each ``moe_impl``, qwen2-vl through embeddings and M-RoPE positions,
remat on equal to remat off, and the train-mode backward never reaching
a cache write.  The JAX package comes in through fixtures."""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.models import registry as treg

ARCHS = treg.ARCHS
MOE = ["deepseek_v2_lite", "phi3p5_moe"]


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
    from repro.models import registry
    return types.SimpleNamespace(jax=jax, registry=registry)


def _cfgs(jx, arch, **over):
    return (dataclasses.replace(jx.registry.get_smoke_config(arch), **over),
            dataclasses.replace(treg.get_smoke_config(arch), **over))


def _batch(cfg, embeds=False, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family in ("audio", "encdec"):
        batch["frames"] = (rng.normal(size=(B, cfg.encoder_frames,
                                            cfg.d_model)) * 0.02
                           ).astype(np.float32)
    if embeds:
        del batch["tokens"]
        batch["embeds"] = (rng.normal(size=(B, S, cfg.d_model)) * 0.02
                           ).astype(np.float32)
        grid = np.stack(np.divmod(np.arange(S), 4))      # a 4-wide image
        batch["positions3"] = np.broadcast_to(
            np.concatenate([np.zeros((1, S), np.int64), grid])[:, None],
            (3, B, S)).astype(np.int32)
    return batch


_JAX = {}


def _weights(arch, seed):
    """Float32 weights in the JAX tree's layout: the port's own seeded
    init through ``params_to_jax`` (drawing them in JAX costs seconds
    of compilation per config)."""
    cfg = treg.get_smoke_config(arch)
    model = treg.build(cfg, device="cpu", masters=True)["init"](
        torch.Generator().manual_seed(seed))
    return treg.params_to_jax(cfg, model)


def _jax_loss_and_grads(jx, cfg, batch, seed=0, key=None):
    """The weights, JAX's loss and gradients; memoized under ``key``
    (the weights under the arch)."""
    if key in _JAX:
        return _JAX[key]
    pkey = (cfg.name, seed)
    if pkey not in _JAX:
        _JAX[pkey] = _weights(cfg.name, seed)
    params = _JAX[pkey]
    (loss, _), grads = jx.jax.jit(jx.jax.value_and_grad(
        jx.registry.build(cfg)["loss_fn"], has_aux=True))(params, batch)
    as_np = lambda t: jx.jax.tree_util.tree_map(np.asarray, t)
    out = as_np(params), float(loss), as_np(grads)
    if key is not None:
        _JAX[key] = out
    return out


def _port_loss_and_grads(cfg, params, batch, model=None):
    model = model or treg.params_from_jax(cfg, params, device="cpu",
                                          masters=True)
    loss, metrics = treg.build(cfg, device="cpu", masters=True)["loss_fn"](
        model, {k: torch.as_tensor(v) for k, v in batch.items()})
    loss.backward()
    return model, float(loss.detach()), treg.params_to_jax(cfg, {
        n: p.grad if p.grad is not None else torch.zeros_like(p)
        for n, p in model.named_parameters()})


def _leaf_errors(jx, want, got):
    paths = jx.jax.tree_util.tree_flatten_with_path(want)[0]
    assert (jx.jax.tree_util.tree_structure(want)
            == jx.jax.tree_util.tree_structure(got))
    errs = {}
    for (path, w), g in zip(paths, jx.jax.tree_util.tree_leaves(got)):
        w = np.asarray(w, np.float32)
        errs[jx.jax.tree_util.keystr(path)] = float(
            np.abs(w - g).max() / max(1.0, np.abs(w).max()))
    return errs


CASES = ([(a, "float32", None) for a in ARCHS]
         + [(a, "bfloat16", None) for a in ARCHS]
         + [(a, dt, "scatter") for a in MOE
            for dt in ("float32", "bfloat16")])


def _check_against_jax(jx, arch, dtype, impl=None, embeds=False):
    over = {"moe_impl": impl} if impl else {}
    jcfg, tcfg = _cfgs(jx, arch, dtype=dtype, **over)
    batch = _batch(jcfg, embeds=embeds)
    ref = _jax_loss_and_grads(
        jx, dataclasses.replace(jcfg, dtype="float32"), batch,
        key=(arch, "float32", impl, embeds))
    params, jloss, jgrads = ref if dtype == "float32" else (
        _jax_loss_and_grads(jx, jcfg, batch))
    _, tloss, tgrads = _port_loss_and_grads(tcfg, params, batch)
    if dtype == "float32":
        assert abs(tloss - jloss) <= 1e-5 * max(1.0, abs(jloss)), (
            jloss, tloss)
        errs = _leaf_errors(jx, jgrads, tgrads)
        worst = max(errs, key=errs.get)
        assert errs[worst] <= 1e-4, (worst, errs[worst])
    else:
        assert abs(tloss - jloss) <= 3e-2 * max(1.0, abs(jloss)), (
            jloss, tloss)
        jax_errs = _leaf_errors(jx, ref[2], jgrads)
        errs = _leaf_errors(jx, ref[2], tgrads)
        bad = {k: (e, jax_errs[k]) for k, e in errs.items()
               if e > max(3e-2, 3 * jax_errs[k])}
        assert not bad, bad
    return tgrads


@pytest.mark.parametrize("arch,dtype,impl", CASES)
def test_loss_and_every_gradient_equal_jax(jx, arch, dtype, impl):
    _check_against_jax(jx, arch, dtype, impl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_trains_through_embeddings_and_mrope_positions(jx, dtype):
    tgrads = _check_against_jax(jx, "qwen2_vl_72b", dtype, embeds=True)
    # the embedding table is not on this path: its gradient is zero
    assert not np.any(tgrads["embed"])


def _count_block_calls(model):
    calls = [0]
    mods = list(model.layers) + list(getattr(
        getattr(model, "encoder", None), "layers", []))
    handles = [m.register_forward_pre_hook(
        lambda *_: calls.__setitem__(0, calls[0] + 1)) for m in mods]
    return calls, handles, len(mods)


@pytest.mark.parametrize("arch", ["minicpm_2b", "zamba2_2p7b",
                                  "xlstm_1p3b", "whisper_base",
                                  "deepseek_v2_lite"])
def test_remat_recomputes_each_unit_and_changes_no_value(arch):
    """``remat="block"`` runs every block's forward a second time in the
    backward pass (once per unit) and gives the same loss and gradients,
    bit for bit, as ``remat="none"``."""
    out = {}
    for remat in ("none", "block"):
        cfg = dataclasses.replace(treg.get_smoke_config(arch),
                                  dtype="float32", remat=remat)
        model = treg.build(cfg, device="cpu", masters=True)["init"](
            torch.Generator().manual_seed(3))
        calls, handles, n = _count_block_calls(model)
        _, loss, grads = _port_loss_and_grads(cfg, None, _batch(cfg), model)
        for h in handles:
            h.remove()
        assert calls[0] == (2 * n if remat == "block" else n), calls
        out[remat] = (loss, grads)
    assert out["none"][0] == out["block"][0]
    import jax
    for a, b in zip(jax.tree_util.tree_leaves(out["none"][1]),
                    jax.tree_util.tree_leaves(out["block"][1])):
        assert np.array_equal(a, b)


def _graph_nodes(root) -> set:
    seen, names, stack = set(), set(), [root]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        stack.extend(f for f, _ in fn.next_functions)
    return names


@pytest.mark.parametrize("arch", ["minicpm_2b", "deepseek_v2_lite",
                                  "zamba2_2p7b", "whisper_base"])
def test_train_mode_backward_never_reaches_a_cache_write(arch):
    """The loss's autograd graph holds no in-place slice write
    (``CopySlices``, what writing k/v into a cache records); the caches
    of a prefill run with autograd on do, so the check can see one."""
    cfg = dataclasses.replace(treg.get_smoke_config(arch), dtype="float32",
                              remat="none")
    fns = treg.build(cfg, device="cpu", masters=True)
    model = fns["init"](torch.Generator().manual_seed(0))
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg).items()}
    loss, _ = fns["loss_fn"](model, batch)
    assert "CopySlices" not in _graph_nodes(loss.grad_fn)
    loss.backward()
    kw = {"frames": batch["frames"]} if "frames" in batch else {}
    _, caches, _ = model(batch["tokens"], make_cache=True, max_len=20,
                         **kw)
    written = [c[k] for blk, c in zip(model.layers, caches)
               if blk.kind != "cross_attn" and isinstance(c, dict)
               for k in ("k", "ckv") if k in c]
    assert written and all("CopySlices" in _graph_nodes(t.grad_fn)
                           for t in written)


@pytest.mark.parametrize("arch", ARCHS)
def test_masters_are_the_serving_draws_kept_in_float32(arch):
    """``masters=True`` draws every tensor as serving does and keeps it
    in float32 as a parameter that takes a gradient; serving's held
    weights are those masters cast, and take none."""
    cfg = treg.get_smoke_config(arch)
    assert cfg.dtype == "bfloat16"
    held = treg.build(cfg, device="cpu")["init"](
        torch.Generator().manual_seed(7))
    masters = treg.build(cfg, device="cpu", masters=True)["init"](
        torch.Generator().manual_seed(7))
    for (n, h), (m_name, m) in zip(held.named_parameters(),
                                   masters.named_parameters()):
        assert n == m_name
        assert m.dtype == torch.float32 and m.requires_grad, n
        assert not h.requires_grad, n
        assert torch.equal(h, m.detach().to(h.dtype)), n
