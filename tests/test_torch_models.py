"""The port's LM serving path (``repro_torch.models``) against the JAX
package's ``repro.models`` on the CPU: each module on the same inputs and
weights, then the dense decoder family's prefill and cached decode on
the four smoke configs, with the JAX weights carried over by
``params_from_jax``.  Tolerances: float32 within 1e-4 × max(1, max
|logit|) with identical greedy tokens; bfloat16 within 3e-2 on the same
scale (XLA and PyTorch round bf16 products in other orders; each lands
about as far from the float32 logits as the other).  The JAX package
comes in through fixtures, so that on a GPU machine without JAX the
``cuda`` cases still run."""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models import registry as treg
from repro_torch.models.transformer import LM

DENSE = ["qwen2p5_14b", "granite_20b", "minicpm_2b", "gemma2_2b"]
ENCDEC_VLM = ["whisper_base", "qwen2_vl_72b"]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's model modules."""
    import jax
    import jax.numpy as jnp
    from repro.models import attention, common, mlp, registry
    return types.SimpleNamespace(jax=jax, jnp=jnp, attention=attention,
                                 common=common, mlp=mlp, registry=registry)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x, dtype=np.float32) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(1.0, np.abs(a).max()))


def _cfgs(jx, arch, dtype, **over):
    return (dataclasses.replace(jx.registry.get_smoke_config(arch),
                                dtype=dtype, **over),
            dataclasses.replace(treg.get_smoke_config(arch), dtype=dtype,
                                **over))


def _jax_params(jx, cfg, seed=0):
    params = jx.registry.build(cfg)["init"](jx.jax.random.key(seed))
    return params, jx.jax.tree_util.tree_map(np.asarray, params)


# ---------------------------------------------------------------------------
# configs and parameter counts
# ---------------------------------------------------------------------------

def test_configs_are_copies_field_for_field(jx):
    for arch in treg.ARCHS:
        for get in ("get_config", "get_smoke_config"):
            want = dataclasses.asdict(getattr(jx.registry, get)(arch))
            got = dataclasses.asdict(getattr(treg, get)(arch))
            assert got == want, (arch, get)
    from repro.configs import base
    from repro_torch.configs import base as tbase
    assert ({k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()})
    for name, shape in tbase.SHAPES.items():
        assert tbase.shape_lowers(shape) == base.shape_lowers(
            base.SHAPES[name])
        for arch in treg.ARCHS:
            assert tbase.cell_applicable(treg.get_config(arch), shape) == \
                base.cell_applicable(jx.registry.get_config(arch),
                                     base.SHAPES[name])


@pytest.mark.parametrize("arch", DENSE + ENCDEC_VLM)
def test_count_params_equals_jax_at_full_width(jx, arch):
    cfg = treg.get_config(arch)
    want = jx.registry.count_params(jx.registry.get_config(arch))
    assert treg.count_params(cfg) == want
    assert treg.count_params(cfg, active_only=True) == want
    assert cfg.param_count() == want


@pytest.mark.parametrize("arch", ENCDEC_VLM)
def test_encdec_and_vlm_families_build_count_and_serve(jx, arch):
    """whisper-base (``EncDec``) and qwen2-vl-72b (``LM``) build on the
    CPU, count their smoke configs' parameters as ``repro`` does, and
    serve a token prompt (whisper: with stub frames) and one decode
    step."""
    cfg = dataclasses.replace(treg.get_smoke_config(arch), dtype="float32")
    fns = treg.build(cfg, device="cpu")
    model = fns["init"](torch.Generator().manual_seed(0))
    assert type(model) is treg.model_class(cfg)
    n = sum(p.numel() for p in model.parameters())
    assert treg.count_params(cfg) == n == jx.registry.count_params(
        jx.registry.get_smoke_config(arch))
    rng = np.random.default_rng(1)
    batch = {"tokens": _t(rng.integers(1, cfg.vocab, (2, 8)))}
    if cfg.encoder_frames:
        batch["frames"] = _t(rng.normal(size=(
            2, cfg.encoder_frames, cfg.d_model)).astype(np.float32))
    logits, cache = fns["prefill"](model, batch, max_len=9)
    assert logits.shape == (2, 8, cfg.vocab) and len(cache) == len(
        model.layers)
    logits, _ = fns["decode"](model, cache, {
        "tokens": logits[:, -1:].argmax(-1)}, 8)
    assert logits.shape == (2, 1, cfg.vocab)
    assert torch.isfinite(logits).all()


def test_build_runs_on_the_card_unless_asked_for_the_cpu():
    cfg = treg.get_smoke_config("qwen2.5-14b")
    if torch.cuda.is_available():
        assert treg.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            treg.build(cfg)
    assert treg.resolve_device("cpu").type == "cpu"


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_dense_init_has_the_jax_distribution(jx):
    shape = (512, 64)
    want = np.asarray(jx.common.dense_init(jx.jax.random.key(0), shape))
    gen = torch.Generator().manual_seed(0)
    got = tcommon.dense_init(shape, generator=gen, device="cpu").numpy()
    std = 1 / np.sqrt(shape[0])
    for x in (want, got):
        assert np.abs(x).max() <= 2 * std * (1 + 1e-6)
        # a standard normal cut to [-2, 2] has std 0.8796
        assert abs(x.std() / std - 0.8796) < 0.02
        assert abs(x.mean()) < 0.02 * std
    gen = torch.Generator().manual_seed(0)
    bf = tcommon.dense_init(shape, generator=gen, device="cpu",
                            dtype=torch.bfloat16, scale=0.02)
    assert bf.dtype == torch.bfloat16
    assert np.abs(bf.float().numpy()).max() <= 0.04 * (1 + 1e-2)


@pytest.mark.parametrize("zero_centered", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_rope_softcap_equal_jax(jx, zero_centered, dtype):
    jnp = jx.jnp
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, 4, 16)).astype(np.float32) * 3
    scale = rng.normal(size=(16,)).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = jx.common.rmsnorm({"scale": jnp.asarray(scale)},
                             jnp.asarray(x).astype(jd), eps=1e-6,
                             zero_centered=zero_centered)
    got = tcommon.rmsnorm(_t(scale), _t(x).to(td), eps=1e-6,
                          zero_centered=zero_centered)
    tol = 2e-6 if dtype == "float32" else 1e-2
    assert got.dtype == td and _rel(want.astype(jnp.float32), got) <= tol

    pos = rng.integers(0, 4096, (2, 6))
    jsin, jcos = jx.common.rope_table(jnp.asarray(pos), 16, 1e6)
    tsin, tcos = tcommon.rope_table(_t(pos), 16, 1e6)
    np.testing.assert_allclose(_np(tsin), _np(jsin), rtol=0, atol=2e-6)
    np.testing.assert_allclose(_np(tcos), _np(jcos), rtol=0, atol=2e-6)
    want = jx.common.apply_rope(jnp.asarray(x).astype(jd), jsin, jcos)
    got = tcommon.apply_rope(_t(x).to(td), tsin, tcos)
    assert got.dtype == td and _rel(want, got) <= tol

    want = jx.common.softcap(jnp.asarray(x * 20).astype(jd), 30.0)
    got = tcommon.softcap(_t(x * 20).to(td), 30.0)
    assert got.dtype == td and _rel(want, got) <= tol
    t = _t(x)
    assert tcommon.softcap(t, None) is t


@pytest.mark.parametrize("case", [
    dict(causal=True),
    dict(causal=True, window=5),
    dict(causal=True, cap=2.0),
    dict(causal=True, q_offset=7, kv_len=10),
    dict(causal=False, kv_len=3, window=2, cap=5.0),
    dict(causal=True, q_offset=0, kv_len=0),       # every key masked
])
def test_plain_mha_equals_jax(jx, case):
    jnp = jx.jnp
    rng = np.random.default_rng(2)
    B, S, T, H, Kv, D = 2, 4, 12, 6, 2, 8
    if "q_offset" not in case:
        S = T
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, T, Kv, D)).astype(np.float32)
    v = rng.normal(size=(B, T, Kv, D)).astype(np.float32)
    want = jx.attention.plain_mha(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), scale=0.3, **case)
    got = tattn.plain_mha(_t(q), _t(k), _t(v), scale=0.3, **case)
    assert np.isfinite(_np(got)).all()
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_chunked_mha_matches_plain_and_jax(jx):
    jnp = jx.jnp
    rng = np.random.default_rng(0)
    B, S, H, Kv, D = 2, 64, 4, 2, 16
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Kv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Kv, D)).astype(np.float32)
    tq, tk, tv = _t(q), _t(k), _t(v)
    ref = tattn.plain_mha(tq, tk, tv, scale=0.25, causal=True)
    for sched in ("full", "tri"):
        got = tattn.chunked_mha(tq, tk, tv, scale=0.25, causal=True,
                                q_chunk=16, kv_chunk=16, schedule=sched)
        np.testing.assert_allclose(_np(got), _np(ref), rtol=2e-5, atol=2e-5)
        want = jx.attention.chunked_mha(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.25,
            causal=True, q_chunk=16, kv_chunk=16, schedule=sched)
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5,
                                   atol=2e-5)
    # sliding window and softcap
    for kw in (dict(window=24), dict(cap=1.5)):
        ref_w = tattn.plain_mha(tq, tk, tv, scale=0.25, causal=True, **kw)
        got_w = tattn.chunked_mha(tq, tk, tv, scale=0.25, causal=True,
                                  q_chunk=16, kv_chunk=16, **kw)
        np.testing.assert_allclose(_np(got_w), _np(ref_w), rtol=2e-5,
                                   atol=2e-5)
    # the dispatch rule: plain up to q_chunk, chunked past it
    np.testing.assert_array_equal(
        _np(tattn.mha(tq, tk, tv, scale=0.25, causal=True, window=None,
                      cap=None, q_chunk=64)), _np(ref))
    np.testing.assert_allclose(
        _np(tattn.mha(tq, tk, tv, scale=0.25, causal=True, window=None,
                      cap=None, q_chunk=16, kv_chunk=32)), _np(ref),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("arch", ["qwen2p5_14b", "granite_20b"])
def test_mlp_equals_jax(jx, arch):
    cfg, tcfg = _cfgs(jx, arch, "float32")
    p = jx.mlp.init_mlp(cfg, jx.jax.random.key(3))
    x = np.random.default_rng(4).normal(
        size=(2, 5, cfg.d_model)).astype(np.float32)
    want = jx.mlp.mlp(p, jx.jnp.asarray(x), cfg)
    m = tmlp.MLP(tcfg, device="cpu")
    with torch.no_grad():
        for name, arr in p.items():
            getattr(m, name).copy_(_t(arr))
        got = m(_t(x))
    assert tcfg.mlp == ("gelu" if arch == "granite_20b" else "swiglu")
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch,local", [("qwen2p5_14b", False),
                                        ("gemma2_2b", True)])
def test_attention_layer_prefill_and_decode_equal_jax(jx, arch, local):
    jnp = jx.jnp
    cfg, tcfg = _cfgs(jx, arch, "float32")
    p = jx.attention.init_attention(cfg, jx.jax.random.key(5))
    if cfg.qkv_bias:   # zeros at init: give the biases values to check
        rng = np.random.default_rng(6)
        p = {k: (jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
                 if k.startswith("b") else v) for k, v in p.items()}
    layer = tattn.Attention(tcfg, device="cpu")
    with torch.no_grad():
        for name, arr in p.items():
            getattr(layer, name).copy_(_t(arr))
    S, extra = 12, 3
    x = np.random.default_rng(7).normal(
        size=(2, S + extra, cfg.d_model)).astype(np.float32)
    want, jc = jx.attention.attention(p, jnp.asarray(x[:, :S]), cfg,
                                      layer_local=local, make_cache=True)
    with torch.no_grad():
        got, tc = layer(_t(x[:, :S]), layer_local=local, make_cache=True,
                        max_len=S + extra)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tc["k"][:, :S]), _np(jc["k"]),
                               rtol=1e-5, atol=1e-5)
    assert not tc["k"][:, S:].any()
    jc = {n: jnp.pad(a, ((0, 0), (0, extra), (0, 0), (0, 0)))
          for n, a in jc.items()}
    for t in range(S, S + extra):
        want, jc = jx.attention.attention(
            p, jnp.asarray(x[:, t:t + 1]), cfg, layer_local=local, cache=jc,
            cache_pos=jnp.int32(t))
        with torch.no_grad():
            got, tc = layer(_t(x[:, t:t + 1]), layer_local=local, cache=tc,
                            cache_pos=t)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(_np(tc["v"]), _np(jc["v"]), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="past a cache"):
        layer(_t(x[:, :1]), cache=tc, cache_pos=S + extra)


# ---------------------------------------------------------------------------
# the weight carry and the slice: prefill + cached greedy decode
# ---------------------------------------------------------------------------

def test_held_weights_are_the_masters_cast_to_bf16(jx):
    cfg, tcfg = _cfgs(jx, "qwen2p5_14b", "bfloat16")
    params, tree = _jax_params(jx, cfg)
    model = treg.params_from_jax(tcfg, tree, device="cpu")
    blk = model.layers[1]
    cases = [(model.embed, tree["embed"]),
             (model.lm_head, tree["lm_head"]),
             (blk.attn.wq, tree["group_0"][0]["attn"]["wq"][1]),
             (blk.attn.wo, tree["group_0"][0]["attn"]["wo"][1]),
             (blk.mlp.w_down, tree["group_0"][0]["mlp"]["w_down"][1])]
    for held, master in cases:
        assert held.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            held.float().numpy(),
            np.asarray(jx.jnp.asarray(master).astype(
                jx.jnp.bfloat16).astype(jx.jnp.float32)))
    for held, master in [(model.final_norm, tree["final_norm"]["scale"]),
                         (blk.ln1, tree["group_0"][0]["ln1"]["scale"][1]),
                         (blk.attn.bq, tree["group_0"][0]["attn"]["bq"][1])]:
        assert held.dtype == torch.float32
        np.testing.assert_array_equal(held.numpy(), master)
    n_held = sum(p.numel() * p.element_size() for p in model.parameters())
    n_f32 = sum(p.numel() for p in model.parameters()
                if p.dtype == torch.float32)
    assert n_held == 2 * treg.count_params(tcfg) + 2 * n_f32
    assert not any(p.requires_grad for p in model.parameters())


ATTENTION_CACHE = ("k", "v", "ckv", "kr")


def _grow_attention_cache(jnp, G):
    """A ``tree_map_with_path`` function that pads JAX's stacked
    attention cache leaves ((repeat, B, T, ...): GQA's ``k``/``v``, MLA's
    ``ckv``/``kr``) by ``G`` positions along T and leaves the recurrent
    states, which have no length axis, as they are."""
    def grow(path, x):
        if getattr(path[-1], "key", None) not in ATTENTION_CACHE:
            return x
        return jnp.pad(x, [(0, 0), (0, 0), (0, G)] + [(0, 0)] * (x.ndim - 3))
    return grow


def _serve_both(jx, arch, dtype, B=2, P=8, G=8, seed=0, on_model=None,
                **over):
    """Prefill ``P`` tokens and decode ``G`` more, greedy, in both
    packages on the same weights; the port is fed JAX's tokens.  ``over``
    replaces config fields in both; ``on_model`` is called with the
    port's model before the prefill.  Returns the per-step relative
    errors and whether every greedy token agreed."""
    jax, jnp = jx.jax, jx.jnp
    cfg, tcfg = _cfgs(jx, arch, dtype, **over)
    params, tree = _jax_params(jx, cfg, seed)
    model = treg.params_from_jax(tcfg, tree, device="cpu")
    if on_model is not None:
        on_model(model)
    fns, tfns = jx.registry.build(cfg), treg.build(tcfg, device="cpu")
    toks = np.random.default_rng(seed).integers(1, cfg.vocab, (B, P))
    jl, jc = jax.jit(fns["prefill"])(params, {"tokens": jnp.asarray(toks)})
    jc = jax.tree_util.tree_map_with_path(_grow_attention_cache(jnp, G), jc)
    tl, tc = tfns["prefill"](model, {"tokens": _t(toks)}, max_len=P + G)
    errs, same = [], []
    decode = jax.jit(fns["decode"])
    for t in range(G + 1):
        errs.append(_rel(jl.astype(jnp.float32), tl))
        jtok = np.asarray(jnp.argmax(jl[:, -1], -1))
        same.append(np.array_equal(jtok, tl[:, -1].argmax(-1).numpy()))
        if t == G:
            break
        jl, jc = decode(params, jc, {"tokens": jnp.asarray(jtok)[:, None]},
                        jnp.int32(P + t))
        tl, tc = tfns["decode"](model, tc, {"tokens": _t(jtok)[:, None]},
                                P + t)
    return errs, same


@pytest.mark.parametrize("arch", DENSE)
def test_serving_equals_jax_in_float32(jx, arch):
    errs, same = _serve_both(jx, arch, "float32")
    assert max(errs) <= 1e-4, errs
    assert all(same), same


@pytest.mark.parametrize("arch", DENSE)
def test_serving_equals_jax_in_bfloat16(jx, arch):
    errs, _ = _serve_both(jx, arch, "bfloat16")
    assert max(errs) <= 3e-2, errs


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward(arch):
    """Prefill S tokens then decode token S: the logits equal the full
    (S+1)-token forward at position S (the port's own init)."""
    cfg = dataclasses.replace(treg.get_smoke_config(arch), dtype="float32")
    fns = treg.build(cfg, device="cpu")
    model = fns["init"](torch.Generator().manual_seed(1))
    B, S = 2, 8
    toks = _t(np.random.default_rng(3).integers(1, cfg.vocab, (B, S + 1)))
    full, _ = fns["prefill"](model, {"tokens": toks})
    _, cache = fns["prefill"](model, {"tokens": toks[:, :S]}, max_len=S + 4)
    dec, _ = fns["decode"](model, cache, {"tokens": toks[:, S:]}, S)
    np.testing.assert_allclose(_np(dec[:, 0]), _np(full[:, -1]), rtol=2e-4,
                               atol=2e-4)
    last = dataclasses.replace(cfg, prefill_logits="last")
    lg, _ = treg.build(last, device="cpu")["prefill"](model, {"tokens": toks})
    assert lg.shape == (B, 1, cfg.vocab)
    np.testing.assert_allclose(_np(lg[:, 0]), _np(full[:, -1]), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", DENSE)
def test_cuda_serving_equals_cpu(arch):
    """The same weights and tokens on the card and on the CPU, float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: no CUDA device is present")
    cfg = dataclasses.replace(treg.get_smoke_config(arch), dtype="float32")
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
