"""The port's encoder-decoder and VLM families (whisper-base's encoder,
cross-attention and decoder; qwen2-vl's M-RoPE and embedding inputs)
against the JAX package's ``repro.models`` on the CPU, on the same
numpy-seeded inputs and the same weights (``params_from_jax``).
Tolerances: ``apply_mrope`` and ``layernorm`` within 1e-6, the attention
layer and the encoder in float32 within 1e-5; serving in float32 within
1e-4 × max(1, max |logit|) with identical greedy tokens, in bf16 within
3e-2 (as for the dense family, ``tests/test_torch_models.py``).  C5:
the JAX serving example pads every cache leaf whose axis 2 is the
prompt length, whisper's cross cache among them when F equals it; the
port never sizes a cross cache by ``max_len``.  The JAX package comes in
through fixtures, so that on a GPU machine without JAX the ``cuda``
cases still run."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import registry as treg
from test_torch_models import (_cfgs, _jax_params, _np, _rel,
                               _t, jx)  # noqa: F401  (jx is a fixture)
from test_torch_moe import _load

# repro's parameter counts at the published widths
FULL_COUNTS = {"whisper_base": 70_611_456, "qwen2_vl_72b": 72_706_203_648}
GRID = 4        # the tests' stub image: 4 x 4 patches


def _positions3(B, S, g=GRID):
    """Qwen2-VL's layout of a g × g image then S - g² text tokens: the
    patches at t = 0, h = row, w = col, the text at g, g + 1, … on all
    three axes.  (3, B, S) int32."""
    rows, cols = np.divmod(np.arange(g * g), g)
    text = np.broadcast_to(g + np.arange(S - g * g), (3, S - g * g))
    pos = np.concatenate([np.stack([0 * rows, rows, cols]), text], 1)
    return np.ascontiguousarray(
        np.broadcast_to(pos[:, None], (3, B, S)).astype(np.int32))


def _x(rng, *shape, scale=1.0):
    return rng.normal(size=shape).astype(np.float32) * scale


# ---------------------------------------------------------------------------
# common: M-RoPE and layer norm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mrope_and_layernorm_equal_jax(jx, dtype):
    """M-RoPE at qwen2-vl-72b's head (128, sections 16/24/24, theta 1e6)
    over a 16 × 16 image and 16 text tokens; the frequencies are
    computed in float32 as XLA computes them (torch's float32 ``pow``
    rounds alike there, float64 rounded once would not)."""
    jnp = jx.jnp
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 1e-2
    rng = np.random.default_rng(0)
    cfg = treg.get_config("qwen2-vl-72b")
    dh, sec = cfg.head_dim, cfg.mrope_sections
    pos3 = _positions3(2, 272, g=16)
    x = _x(rng, 2, 272, 4, dh, scale=3.0)
    want = jx.common.apply_mrope(jnp.asarray(x).astype(jd),
                                 jnp.asarray(pos3), dh, cfg.rope_theta, sec)
    got = tcommon.apply_mrope(_t(x).to(td), _t(pos3), dh, cfg.rope_theta,
                              sec)
    assert got.dtype == td
    err = _rel(want.astype(jnp.float32), got)
    assert err <= tol, ("apply_mrope", err)
    # text tokens (the same position on all three axes) get plain rope
    text = _t(np.broadcast_to(pos3[:1], pos3.shape).copy())
    err = _rel(tcommon.apply_rope(_t(x).to(td), *tcommon.rope_table(
        text[0], dh, cfg.rope_theta)), tcommon.apply_mrope(
            _t(x).to(td), text, dh, cfg.rope_theta, sec))
    assert err <= tol, ("text positions", err)
    with pytest.raises(ValueError, match="mrope sections"):
        tcommon.mrope_table(_t(pos3), dh, cfg.rope_theta, (16, 24, 16))

    x = _x(rng, 2, 6, 32, scale=3.0) + 1.5
    scale, bias = _x(rng, 32), _x(rng, 32)
    for params in ({"scale": scale}, {"scale": scale, "bias": bias}):
        want = jx.common.layernorm({k: jnp.asarray(v)
                                    for k, v in params.items()},
                                   jnp.asarray(x).astype(jd))
        got = tcommon.layernorm(_t(scale), _t(x).to(td),
                                bias=_t(bias) if "bias" in params else None)
        assert got.dtype == td
        err = _rel(want.astype(jnp.float32), got)
        assert err <= tol, ("layernorm", sorted(params), err)


# ---------------------------------------------------------------------------
# the attention layer: cross mode and M-RoPE
# ---------------------------------------------------------------------------

def _layer(jx, arch, cross=False, bias=False):
    """A JAX attention layer's parameters (the biases given values when
    ``bias``) and the port's layer holding them, float32."""
    jnp = jx.jnp
    cfg, tcfg = _cfgs(jx, arch, "float32", qkv_bias=bias)
    p = jx.attention.init_attention(cfg, jx.jax.random.key(5), cross=cross)
    rng = np.random.default_rng(6)
    p = {k: (jnp.asarray(_x(rng, *v.shape)) if k.startswith("b") else v)
         for k, v in p.items()}
    layer = tattn.Attention(tcfg, device="cpu")
    _load(layer, p)
    return cfg, p, layer


@pytest.mark.parametrize("bias", [False, True])
def test_cross_attention_prefill_and_decode_equal_jax(jx, bias):
    """Prefill attends 3 decoder states to 16 encoder frames and returns
    the cross cache, F long whatever ``max_len`` is; decode reads it and
    returns it unwritten."""
    jnp = jx.jnp
    cfg, p, layer = _layer(jx, "whisper_base", cross=True, bias=bias)
    rng = np.random.default_rng(7)
    F = cfg.encoder_frames
    x, enc = _x(rng, 2, 6, cfg.d_model), _x(rng, 2, F, cfg.d_model)
    want, jc = jx.attention.attention(p, jnp.asarray(x[:, :3]), cfg,
                                      is_cross=True,
                                      cross_inputs=jnp.asarray(enc),
                                      make_cache=True)
    with torch.no_grad():
        got, tc = layer(_t(x[:, :3]), is_cross=True, cross_inputs=_t(enc),
                        make_cache=True, max_len=40)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    assert tc["k"].shape == (2, F, cfg.n_kv, cfg.head_dim)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), rtol=1e-5,
                                   atol=1e-5)
    before = {n: t.clone() for n, t in tc.items()}
    for t in range(3, 6):
        want, jc = jx.attention.attention(
            p, jnp.asarray(x[:, t:t + 1]), cfg, is_cross=True, cache=jc,
            cache_pos=jnp.int32(t))
        with torch.no_grad():
            got, tc2 = layer(_t(x[:, t:t + 1]), is_cross=True, cache=tc,
                             cache_pos=t)
        assert tc2 is tc
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-5)
    for name in ("k", "v"):
        assert torch.equal(tc[name], before[name])


def test_mrope_attention_prefill_and_decode_equal_jax(jx):
    """qwen2-vl's layer (biases set): a prefill of a 4 × 4 image and 4
    text tokens with their M-RoPE positions, 3 decode steps at the next
    text positions, then one step with no ``positions3``, which takes
    plain rope from ``cache_pos`` as ``repro`` does."""
    jnp = jx.jnp
    cfg, p, layer = _layer(jx, "qwen2_vl_72b", bias=True)
    rng = np.random.default_rng(8)
    S, extra = GRID * GRID + 4, 4
    x = _x(rng, 2, S + extra, cfg.d_model)
    pos3 = _positions3(2, S + extra)
    want, jc = jx.attention.attention(
        p, jnp.asarray(x[:, :S]), cfg, positions3=jnp.asarray(pos3[:, :, :S]),
        make_cache=True)
    with torch.no_grad():
        got, tc = layer(_t(x[:, :S]), positions3=_t(pos3[:, :, :S]),
                        make_cache=True, max_len=S + extra)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    jc = {n: jnp.pad(a, ((0, 0), (0, extra), (0, 0), (0, 0)))
          for n, a in jc.items()}
    for t in range(S, S + extra):
        kw = {} if t == S + extra - 1 else {"positions3": pos3[:, :, t:t + 1]}
        want, jc = jx.attention.attention(
            p, jnp.asarray(x[:, t:t + 1]), cfg, cache=jc,
            cache_pos=jnp.int32(t), **{k: jnp.asarray(v)
                                       for k, v in kw.items()})
        with torch.no_grad():
            got, tc = layer(_t(x[:, t:t + 1]), cache=tc, cache_pos=t,
                            **{k: _t(v) for k, v in kw.items()})
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(_np(tc["k"]), _np(jc["k"]), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the encoder, the weights, the counts
# ---------------------------------------------------------------------------

def test_encoder_equals_jax(jx):
    from repro.models import encdec
    cfg, tcfg = _cfgs(jx, "whisper_base", "float32")
    params, tree = _jax_params(jx, cfg)
    model = treg.params_from_jax(tcfg, tree, device="cpu")
    frames = _x(np.random.default_rng(9), 2, cfg.encoder_frames,
                cfg.d_model, scale=0.5)
    want = encdec.encode(params, jx.jnp.asarray(frames), cfg)
    with torch.no_grad():
        got = model.encode(_t(frames))
    assert len(model.encoder.layers) == cfg.encoder_layers
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_held_encdec_weights_are_the_masters_cast_to_bf16(jx):
    """Norm scales in float32 and equal to the masters, every other
    tensor (the encoder's and the cross-attention's included) the master
    cast to bf16; nothing left out of the carry."""
    jnp = jx.jnp
    cfg, tcfg = _cfgs(jx, "whisper_base", "bfloat16")
    _, tree = _jax_params(jx, cfg)
    model = treg.params_from_jax(tcfg, tree, device="cpu")
    enc = tree["encoder"]["layers"]
    cases = {"encoder.layers.1.attn.wk": enc["attn"]["wk"][1],
             "encoder.layers.0.mlp.w_up": enc["mlp"]["w_up"][0],
             "layers.3.attn.wv": tree["group_0"][1]["attn"]["wv"][1],
             "encoder.layers.1.ln2": enc["ln2"]["scale"][1],
             "encoder.final_norm": tree["encoder"]["final_norm"]["scale"]}
    held = dict(model.named_parameters())
    for name, master in cases.items():
        if name.endswith(("ln2", "final_norm")):
            assert held[name].dtype == torch.float32
            np.testing.assert_array_equal(held[name].numpy(), master)
        else:
            assert held[name].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                held[name].float().numpy(), np.asarray(jnp.asarray(
                    master).astype(jnp.bfloat16).astype(jnp.float32)))
    assert [blk.kind for blk in model.layers] == ["attn", "cross_attn"] * 2
    assert sum(p.numel() for p in model.parameters()) == \
        jx.registry.count_params(cfg)


@pytest.mark.parametrize("arch", sorted(FULL_COUNTS))
def test_count_params_equals_jax_at_full_width(jx, arch):
    cfg = treg.get_config(arch)
    assert jx.registry.count_params(jx.registry.get_config(arch)) == \
        FULL_COUNTS[arch]
    assert treg.count_params(cfg) == FULL_COUNTS[arch]


def test_builds_run_on_the_card_unless_asked_for_the_cpu():
    for arch in FULL_COUNTS:
        cfg = treg.get_smoke_config(arch)
        if torch.cuda.is_available():
            assert treg.resolve_device(None).type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                treg.build(cfg)
        treg.build(cfg, device="cpu")


# ---------------------------------------------------------------------------
# serving: prefill + cached greedy decode against repro
# ---------------------------------------------------------------------------

def _prompt(cfg, tree, mode, B, P, seed):
    """The prefill batch (numpy) of ``mode``: "encdec" (tokens and stub
    frames), "embeds" (a stub image's patches then the tokens' float32
    embeddings, with the grid's M-RoPE positions), "tokens" (g² + P
    tokens under the grid's positions) or "plain" (tokens, no
    positions3: plain rope); and the M-RoPE position of the first
    generated token (None where decode feeds tokens only)."""
    rng = np.random.default_rng(seed)
    g2 = GRID * GRID
    n = P + g2 if mode == "tokens" else P
    toks = rng.integers(1, cfg.vocab, (B, n))
    if mode == "encdec":
        return {"tokens": toks, "frames": _x(
            rng, B, cfg.encoder_frames, cfg.d_model, scale=0.02)}, None
    if mode == "plain":
        return {"tokens": toks}, None
    if mode == "tokens":
        pos3 = _positions3(B, n)
        return {"tokens": toks, "positions3": pos3}, int(pos3.max()) + 1
    pos3 = _positions3(B, g2 + P)
    embeds = np.concatenate([_x(rng, B, g2, cfg.d_model, scale=0.02),
                             tree["embed"][toks]], 1)
    return {"embeds": embeds, "positions3": pos3}, int(pos3.max()) + 1


def _grow_self_caches(jx, cfg, G):
    """Pads JAX's stacked self-attention cache leaves (repeat, B, T, Kv,
    dh) by ``G`` positions along T and leaves the cross caches F long."""
    from repro.models.transformer import arch_groups
    units = [g.unit for g in arch_groups(cfg)]

    def grow(path, x):
        gi, li = path[0].idx, path[1].idx
        if units[gi][li][0] == "cross_attn":
            return x
        return jx.jnp.pad(x, [(0, 0), (0, 0), (0, G), (0, 0), (0, 0)])
    return grow


def _serve_pair(jx, arch, mode, dtype, B=2, P=8, G=8, seed=0):
    """Prefill and ``G`` greedy decode steps in both packages on the same
    weights; the port is fed JAX's tokens.  Returns the per-step
    relative errors and whether every greedy token agreed."""
    jax, jnp = jx.jax, jx.jnp
    cfg, tcfg = _cfgs(jx, arch, dtype)
    params, tree = _jax_params(jx, cfg, seed)
    model = treg.params_from_jax(tcfg, tree, device="cpu")
    fns, tfns = jx.registry.build(cfg), treg.build(tcfg, device="cpu")
    batch, pos = _prompt(cfg, tree, mode, B, P, seed)
    T = next(iter(batch.values())).shape[1]
    jl, jc = jax.jit(fns["prefill"])(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    jc = jax.tree_util.tree_map_with_path(_grow_self_caches(jx, cfg, G), jc)
    tl, tc = tfns["prefill"](model, {k: _t(v) for k, v in batch.items()},
                             max_len=T + G)
    decode = jax.jit(fns["decode"])
    errs, same = [], []
    for t in range(G + 1):
        errs.append(_rel(jl.astype(jnp.float32), tl))
        jtok = np.asarray(jnp.argmax(jl[:, -1], -1))
        same.append(np.array_equal(jtok, tl[:, -1].argmax(-1).numpy()))
        if t == G:
            break
        step = {"tokens": jtok[:, None]}
        if pos is not None:
            step["positions3"] = np.full((3, B, 1), pos + t, np.int32)
        jl, jc = decode(params, jc, {k: jnp.asarray(v)
                                     for k, v in step.items()},
                        jnp.int32(T + t))
        tl, tc = tfns["decode"](model, tc, {k: _t(v)
                                            for k, v in step.items()}, T + t)
    return errs, same


SERVES = [("whisper_base", "encdec"), ("qwen2_vl_72b", "embeds"),
          ("qwen2_vl_72b", "tokens"), ("qwen2_vl_72b", "plain")]


@pytest.mark.parametrize("arch,mode", SERVES)
def test_serving_equals_jax_in_float32(jx, arch, mode):
    errs, same = _serve_pair(jx, arch, mode, "float32")
    assert max(errs) <= 1e-4, errs
    assert all(same), same


@pytest.mark.parametrize("arch,mode", SERVES[:2])
def test_serving_equals_jax_in_bfloat16(jx, arch, mode):
    errs, _ = _serve_pair(jx, arch, mode, "bfloat16")
    assert max(errs) <= 3e-2, errs


def test_c5_cross_cache_keeps_its_frames(jx):
    """C5 on the JAX serving example's own batch (whisper's smoke config
    in float32, ``key(0)`` weights, 4 requests of P = 16 tokens and F =
    16 frames from ``default_rng(0)``, G = 24): the port's cross caches
    stay 16 frames long under a ``max_len`` of 40, and each of 8 greedy
    cached steps equals a re-forward of the prefix (1e-5); ``repro``'s
    first decode step equals its re-forward when the cross cache keeps
    its F frames (1.3e-7) and misses it by 0.228 (of max |logit| 0.514)
    under the example's rule, which pads every cache leaf whose axis 2
    is the prompt length."""
    jax, jnp = jx.jax, jx.jnp
    cfg, tcfg = _cfgs(jx, "whisper_base", "float32")
    F, P, G = cfg.encoder_frames, 16, 24
    assert F == P
    params, tree = _jax_params(jx, cfg, seed=0)
    model = treg.params_from_jax(tcfg, tree, device="cpu")
    rng = np.random.default_rng(0)        # examples/serve_lm.py's draws
    prompts = rng.integers(1, cfg.vocab, (4, P))
    frames = _x(rng, 4, F, cfg.d_model, scale=0.02)
    fns = treg.build(tcfg, device="cpu")
    logits, cache = fns["prefill"](model, {"tokens": _t(prompts),
                                           "frames": _t(frames)},
                                   max_len=P + G)
    kinds = [blk.kind for blk in model.layers]
    assert [c["k"].shape[1] for c in cache] == [
        F if k == "cross_attn" else P + G for k in kinds]
    toks = _t(prompts)
    for t in range(P, P + 8):
        toks = torch.cat([toks, logits[:, -1:].argmax(-1)], 1)
        logits, cache = fns["decode"](model, cache, {"tokens": toks[:, -1:]},
                                      t)
        ref, _ = fns["prefill"](model, {"tokens": toks,
                                        "frames": _t(frames)})
        assert _rel(ref[:, -1], logits[:, 0]) <= 1e-5
    assert [c["k"].shape[1] for c in cache][1::2] == [F] * cfg.n_layers

    jf = jx.registry.build(cfg)
    batch = {"tokens": jnp.asarray(prompts), "frames": jnp.asarray(frames)}
    logits, jc = jax.jit(jf["prefill"])(params, batch)
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
    ref, _ = jf["prefill"](params, {
        "tokens": jnp.concatenate([batch["tokens"], tok], 1),
        "frames": batch["frames"]})

    def example_rule(x):    # examples/serve_lm.py's grow
        if x.ndim >= 3 and x.shape[2] == P:
            pad = [(0, 0)] * x.ndim
            pad[2] = (0, G)
            return jnp.pad(x, pad)
        return x

    errs = {}
    for name, grow in (("kept", _grow_self_caches(jx, cfg, G)),
                       ("example", lambda path, x: example_rule(x))):
        c = jax.tree_util.tree_map_with_path(grow, jc)
        dec, _ = jf["decode"](params, c, {"tokens": tok}, jnp.int32(P))
        errs[name] = _rel(ref[:, -1], dec[:, 0])
    assert errs["kept"] <= 1e-5, errs
    assert errs["example"] > 0.2, errs


# ---------------------------------------------------------------------------
# the card against the CPU
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(FULL_COUNTS))
def test_cuda_encdec_and_vlm_serving_equal_cpu(arch):
    """The same weights and inputs on the card and on the CPU, float32:
    a prefill of 4 requests (whisper: 16 tokens and 16 frames; qwen2-vl:
    a 4 × 4 image and 16 text embeddings with their M-RoPE positions)
    and 8 greedy steps fed the CPU's tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: no CUDA device is present")
    cfg = dataclasses.replace(treg.get_smoke_config(arch), dtype="float32")
    cpu = treg.build(cfg, device="cpu")
    gpu = treg.build(cfg, device="cuda")
    host = cpu["init"](torch.Generator().manual_seed(2))
    card = treg.model_class(cfg)(cfg, device="meta").to_empty(device="cuda")
    card.load_state_dict(host.state_dict())
    mode = "encdec" if arch == "whisper_base" else "embeds"
    tree = {"embed": host.embed.detach().numpy()}
    batch, pos = _prompt(cfg, tree, mode, 4, 16, seed=4)
    batch = {k: _t(v) for k, v in batch.items()}
    T = next(iter(batch.values())).shape[1]
    a, ca = cpu["prefill"](host, batch, max_len=T + 8)
    b, cb = gpu["prefill"](card, batch, max_len=T + 8)
    for t in range(8):
        assert _rel(a, b.cpu()) <= 1e-4
        step = {"tokens": a[:, -1].argmax(-1)[:, None]}
        if pos is not None:
            step["positions3"] = torch.full((3, 4, 1), pos + t)
        a, ca = cpu["decode"](host, ca, step, T + t)
        b, cb = gpu["decode"](card, cb, step, T + t)
    assert _rel(a, b.cpu()) <= 1e-4
