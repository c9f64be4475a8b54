"""The port's mixture-of-experts family (``MoE``, ``MLA`` and the
deepseek-v2-lite and phi3.5-moe smoke configs) against the JAX
package's ``repro.models`` on the CPU, on the same numpy-seeded inputs
and the same weights (``params_from_jax``).  Every MoE case runs both
``moe_impl``s.  Tolerances: the modules in float32 within 1e-5, MoE in
bf16 on an identical bf16 input within 1e-2; serving in float32 within
1e-4 × max(1, max |logit|) with identical greedy tokens, in bf16 within
3e-2 (as for the dense family, ``tests/test_torch_models.py``).  The
dropped (token, expert) pairs at capacity must be the same pairs.  The
JAX package comes in through fixtures, so that on a GPU machine without
JAX the ``cuda`` cases still run."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.models import attention as tattn
from repro_torch.models import mlp as tmlp
from repro_torch.models import registry as treg
from repro_torch.models.transformer import LM
from test_torch_models import (_cfgs, _jax_params, _np, _rel, _serve_both,
                               _t, jx)  # noqa: F401  (jx is a fixture)

MOE = ["deepseek_v2_lite", "phi3p5_moe"]
IMPLS = ["einsum", "scatter"]
# total and active parameters at the published widths (repro's count)
FULL_COUNTS = {"deepseek_v2_lite": (15_706_484_224, 2_661_150_208),
               "phi3p5_moe": (41_872_527_360, 6_640_373_760)}


def _dropped_jax(jx, params, x, cfg):
    """The (batch, token, expert) triples JAX's router selects and its
    capacity drops: selected at a position >= C along S."""
    gates, _, _ = jx.mlp._route(params, jx.jnp.asarray(x), cfg)
    sel = np.asarray(gates) > 0
    pos = np.cumsum(sel.astype(np.int32), axis=1) - 1
    C = jx.mlp._capacity(cfg, x.shape[1])
    return set(zip(*np.nonzero(sel & (pos >= C))))


def _dropped_port(moe, x):
    gates, _ = moe.route(_t(x))
    pos, keep = moe.slots(gates, tmlp.capacity(moe.cfg, x.shape[1]))
    return set(zip(*np.nonzero(((gates > 0) & ~keep).numpy())))


def _load(module, tree):
    """Copy the JAX subtree ``tree`` into ``module`` ({"scale"} norms and
    nested dicts included)."""
    with torch.no_grad():
        for name, arr in tree.items():
            if isinstance(arr, dict) and "scale" in arr:
                arr = arr["scale"]
            if isinstance(arr, dict):
                _load(getattr(module, name), arr)
            else:
                getattr(module, name).copy_(_t(arr))


# ---------------------------------------------------------------------------
# parameter counts and the build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_count_params_equals_jax_for_the_moe_family(jx, arch):
    cfg, jcfg = treg.get_config(arch), jx.registry.get_config(arch)
    total, active = FULL_COUNTS[arch]
    assert jx.registry.count_params(jcfg) == total
    assert jx.registry.count_params(jcfg, active_only=True) == active
    assert treg.count_params(cfg) == total
    assert treg.count_params(cfg, active_only=True) == active
    assert cfg.active_param_count() == active


def test_moe_build_runs_on_the_card_unless_asked_for_the_cpu():
    cfg = treg.get_smoke_config("deepseek-v2-lite-16b")
    if torch.cuda.is_available():
        assert treg.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            treg.build(cfg)
    assert callable(treg.build(cfg, device="cpu")["decode"])


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def _moe_pair(jx, arch, dtype, impl):
    cfg, tcfg = _cfgs(jx, arch, dtype, moe_impl=impl)
    p = jx.mlp.init_moe(cfg, jx.jax.random.key(3))
    m = tmlp.MoE(tcfg, device="cpu")
    _load(m, jx.jax.tree_util.tree_map(np.asarray, p))
    return cfg, tcfg, p, m


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", MOE)
def test_moe_module_equals_jax_in_float32(jx, arch, impl):
    """At the serving example's prefill shape, 4 requests x 16 tokens."""
    cfg, tcfg, p, m = _moe_pair(jx, arch, "float32", impl)
    assert m.router.dtype == m.w_gate.dtype == torch.float32
    x = np.random.default_rng(4).normal(
        size=(4, 16, cfg.d_model)).astype(np.float32)
    want, waux = jx.mlp.moe(p, jx.jnp.asarray(x), cfg)
    with torch.no_grad():
        got, gaux = m(_t(x))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    assert gaux.dtype == torch.float32
    assert abs(float(gaux) - float(waux)) <= 1e-5 * abs(float(waux))
    dropped = _dropped_port(m, x)
    assert dropped, "no (token, expert) pair was dropped at capacity"
    assert dropped == _dropped_jax(jx, p, x, cfg)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", MOE)
def test_moe_module_equals_jax_in_bfloat16(jx, arch, impl):
    """Both sides get the same bf16 input (bf16 hidden states of XLA and
    PyTorch differ by a few ulps, which can flip a close routing); the
    expert weights are held in bf16, the router in float32."""
    cfg, tcfg, p, m = _moe_pair(jx, arch, "bfloat16", impl)
    assert m.w_gate.dtype == torch.bfloat16
    assert m.router.dtype == torch.float32
    x = np.random.default_rng(5).normal(
        size=(2, 16, cfg.d_model)).astype(np.float32)
    xb = jx.jnp.asarray(x).astype(jx.jnp.bfloat16)
    want, waux = jx.mlp.moe(p, xb, cfg)
    with torch.no_grad():
        got, gaux = m(_t(np.asarray(xb.astype(jx.jnp.float32))).to(
            torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert _rel(want.astype(jx.jnp.float32), got) <= 1e-2
    assert abs(float(gaux) - float(waux)) <= 1e-5 * abs(float(waux))


@pytest.mark.parametrize("q_lora", [0, 16])
def test_mla_prefill_and_absorbed_decode_equal_jax(jx, q_lora):
    """Prefill (decompressed keys and values) output and latent cache,
    then 4 absorbed decode steps, float32; ``q_lora=16`` takes the
    low-rank query branch no published config sets."""
    jnp = jx.jnp
    cfg, tcfg = _cfgs(jx, "deepseek_v2_lite", "float32", q_lora=q_lora)
    p = jx.attention.init_mla(cfg, jx.jax.random.key(6))
    layer = tattn.MLA(tcfg, device="cpu")
    assert hasattr(layer, "w_uq") == bool(q_lora)
    _load(layer, jx.jax.tree_util.tree_map(np.asarray, p))
    assert layer.kv_norm.dtype == torch.float32
    S, extra = 10, 4
    x = np.random.default_rng(7).normal(
        size=(2, S + extra, cfg.d_model)).astype(np.float32)
    want, jc = jx.attention.mla(p, jnp.asarray(x[:, :S]), cfg,
                                make_cache=True)
    with torch.no_grad():
        got, tc = layer(_t(x[:, :S]), make_cache=True, max_len=S + extra)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    for name in ("ckv", "kr"):
        np.testing.assert_allclose(_np(tc[name][:, :S]), _np(jc[name]),
                                   rtol=1e-5, atol=1e-5)
        assert not tc[name][:, S:].any()
    jc = {n: jnp.pad(a, ((0, 0), (0, extra), (0, 0))) for n, a in jc.items()}
    for t in range(S, S + extra):
        want, jc = jx.attention.mla(p, jnp.asarray(x[:, t:t + 1]), cfg,
                                    cache=jc, cache_pos=jnp.int32(t))
        with torch.no_grad():
            got, tc = layer(_t(x[:, t:t + 1]), cache=tc, cache_pos=t)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-5)
    for name in ("ckv", "kr"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), rtol=1e-5,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="past a cache"):
        layer(_t(x[:, :1]), cache=tc, cache_pos=S + extra)


# ---------------------------------------------------------------------------
# the weight carry and the slice: prefill + cached greedy decode
# ---------------------------------------------------------------------------

def test_held_moe_weights_are_the_masters_cast_to_bf16(jx):
    cfg, tcfg = _cfgs(jx, "deepseek_v2_lite", "bfloat16")
    _, tree = _jax_params(jx, cfg)
    model = treg.params_from_jax(tcfg, tree, device="cpu")
    dense, moe = model.layers[0], model.layers[2]   # group 0; group 1 rep 1
    g0, g1 = tree["group_0"][0], tree["group_1"][0]
    assert hasattr(dense, "mlp") and hasattr(moe, "moe")
    bf16 = [(moe.moe.w_gate, g1["moe"]["w_gate"][1]),
            (moe.moe.w_down, g1["moe"]["w_down"][1]),
            (moe.moe.shared.w_up, g1["moe"]["shared"]["w_up"][1]),
            (moe.attn.w_uk, g1["attn"]["w_uk"][1]),
            (moe.attn.wo, g1["attn"]["wo"][1]),
            (dense.mlp.w_gate, g0["mlp"]["w_gate"][0]),
            (dense.attn.wq, g0["attn"]["wq"][0])]
    for held, master in bf16:
        assert held.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            held.float().numpy(),
            np.asarray(jx.jnp.asarray(master).astype(
                jx.jnp.bfloat16).astype(jx.jnp.float32)))
    f32 = [(moe.moe.router, g1["moe"]["router"][1]),
           (moe.attn.kv_norm, g1["attn"]["kv_norm"]["scale"][1]),
           (moe.ln2, g1["ln2"]["scale"][1])]
    for held, master in f32:
        assert held.dtype == torch.float32
        np.testing.assert_array_equal(held.numpy(), master)
    n_held = sum(p.numel() * p.element_size() for p in model.parameters())
    n_f32 = sum(p.numel() for p in model.parameters()
                if p.dtype == torch.float32)
    assert n_held == 2 * treg.count_params(tcfg) + 2 * n_f32


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", MOE)
def test_moe_serving_equals_jax_in_float32(jx, arch, impl):
    """Prefill + 8 decode steps; the hidden states each MoE block of the
    port's prefill routes are routed by both packages too, and the
    pairs dropped at capacity must be the same (and some are)."""
    inputs = []

    def capture(model):
        for blk in model.layers:
            if hasattr(blk, "moe"):
                blk.moe.register_forward_pre_hook(
                    lambda mod, args: inputs.append((mod, args[0].numpy()))
                    if args[0].shape[1] > 1 else None)

    errs, same = _serve_both(jx, arch, "float32", on_model=capture,
                             moe_impl=impl)
    assert max(errs) <= 1e-4, errs
    assert all(same), same
    cfg, _ = _cfgs(jx, arch, "float32", moe_impl=impl)
    n_dropped = 0
    for mod, h in inputs:
        p = {"router": mod.router.detach().numpy()}
        got = _dropped_port(mod, h)
        assert got == _dropped_jax(jx, p, h, cfg)
        n_dropped += len(got)
    assert len(inputs) == cfg.n_layers - cfg.first_dense
    assert n_dropped > 0


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", MOE)
def test_moe_serving_equals_jax_in_bfloat16(jx, arch, impl):
    errs, _ = _serve_both(jx, arch, "bfloat16", moe_impl=impl)
    assert max(errs) <= 3e-2, errs


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_matches_forward_at_no_drop_capacity(arch, impl):
    """Prefill S tokens, decode 4 more one at a time: each step's logits
    equal a re-forward of the whole prefix (the port's own init, float32).
    The capacity factor is E/k, so that C >= S and no pair is dropped: at
    cf 1.25 a re-forward of S + t tokens has another capacity, and other
    drops, than the cached step, which is the JAX package's semantics."""
    base = treg.get_smoke_config(arch)
    cfg = dataclasses.replace(base, dtype="float32", moe_impl=impl,
                              capacity_factor=base.n_experts / base.top_k)
    fns = treg.build(cfg, device="cpu")
    model = fns["init"](torch.Generator().manual_seed(1))
    B, S, G = 2, 8, 4
    assert tmlp.capacity(cfg, S + G) >= S + G
    toks = _t(np.random.default_rng(3).integers(1, cfg.vocab, (B, S + G)))
    _, cache = fns["prefill"](model, {"tokens": toks[:, :S]}, max_len=S + G)
    for t in range(S, S + G):
        dec, cache = fns["decode"](model, cache, {"tokens": toks[:, t:t + 1]},
                                   t)
        full, _ = fns["prefill"](model, {"tokens": toks[:, :t + 1]})
        assert _rel(full[:, -1], dec[:, 0]) <= 2e-4


@pytest.mark.parametrize("arch", MOE)
def test_lm_aux_equals_forward_lm(jx, arch):
    """The summed auxiliary loss of the MoE blocks (``LM.forward``'s
    third output) against ``forward_lm``'s ``aux_total``, float32."""
    from repro.models.transformer import forward_lm
    cfg, tcfg = _cfgs(jx, arch, "float32")
    params, tree = _jax_params(jx, cfg, seed=2)
    model = treg.params_from_jax(tcfg, tree, device="cpu")
    toks = np.random.default_rng(8).integers(1, cfg.vocab, (2, 12))
    _, _, want = forward_lm(params, cfg, tokens=jx.jnp.asarray(toks))
    with torch.no_grad():
        logits, caches, got = model(_t(toks))
    assert caches is None and got.dtype == torch.float32
    assert float(got) > 0
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    dcfg = dataclasses.replace(treg.get_smoke_config("qwen2p5_14b"),
                               dtype="float32")
    dense = treg.build(dcfg, device="cpu")["init"](
        torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert float(dense(_t(toks % dcfg.vocab))[2]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", MOE)
def test_cuda_moe_serving_equals_cpu(arch, impl):
    """The same weights and tokens on the card and on the CPU, float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: no CUDA device is present")
    cfg = dataclasses.replace(treg.get_smoke_config(arch), dtype="float32",
                              moe_impl=impl)
    cpu = treg.build(cfg, device="cpu")
    gpu = treg.build(cfg, device="cuda")
    model = cpu["init"](torch.Generator().manual_seed(2))
    card = LM(cfg, device="meta").to_empty(device="cuda")
    card.load_state_dict(model.state_dict())
    toks = _t(np.random.default_rng(4).integers(1, cfg.vocab, (4, 16)))
    a, ca = cpu["prefill"](model, {"tokens": toks}, max_len=24)
    b, cb = gpu["prefill"](card, {"tokens": toks}, max_len=24)
    for t in range(8):
        assert _rel(a, b.cpu()) <= 1e-4
        tok = a[:, -1].argmax(-1)[:, None]
        a, ca = cpu["decode"](model, ca, {"tokens": tok}, 16 + t)
        b, cb = gpu["decode"](card, cb, {"tokens": tok}, 16 + t)
