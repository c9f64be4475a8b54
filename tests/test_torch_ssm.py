"""The port's recurrent families (``Mamba2``, ``MLSTM``, ``SLSTM``, the
zamba2 hybrid's shared attention, and the zamba2-2.7b and xlstm-1.3b
smoke configs) against the JAX package's ``repro.models`` on the CPU,
on the same numpy-seeded inputs and the same weights
(``params_from_jax``).  Tolerances: the modules in float32 within 1e-5,
in both their full-sequence and one-token forms; the port's chunked
forms against its own recurrent steps within 1e-4 relative and 1e-5
absolute (``tests/test_models.py``'s); serving in float32 within 1e-4 ×
max(1, max |logit|) with identical greedy tokens, in bf16 within 3e-2
(as for the dense family, ``tests/test_torch_models.py``).  The JAX
package comes in through fixtures, so that on a GPU machine without JAX
the ``cuda`` cases still run."""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.models import registry as treg
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as txlstm
from repro_torch.models.transformer import LM
from test_torch_models import (_cfgs, _jax_params, _np, _rel, _serve_both,
                               _t, jx)  # noqa: F401  (jx is a fixture)
from test_torch_moe import _load

RECURRENT = ["zamba2_2p7b", "xlstm_1p3b"]
# repro's parameter counts at the published widths
FULL_COUNTS = {"zamba2_2p7b": 2_969_653_408, "xlstm_1p3b": 1_135_757_480}
# the tensors held in float32 whatever the compute dtype
FLOAT32 = {"wi", "wf", "r_zifo", "b_zifo", "f_bias", "A_log", "D",
           "dt_bias", "norm", "ln1", "ln2", "final_norm"}


@pytest.fixture(scope="module")
def jr():
    """The JAX package's recurrent mixers."""
    import jax
    import jax.numpy as jnp
    from repro.models import ssm, xlstm
    return types.SimpleNamespace(jax=jax, jnp=jnp, ssm=ssm, xlstm=xlstm)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32) * 0.5


# (JAX init, full, decode, state init; port module) of each mixer
def _mixer(jr, kind):
    if kind == "mamba":
        return ("zamba2_2p7b", jr.ssm.init_mamba2, jr.ssm.mamba2,
                jr.ssm.mamba2_decode, tssm.Mamba2)
    m = jr.xlstm
    if kind == "mlstm":
        return ("xlstm_1p3b", m.init_mlstm, m.mlstm, m.mlstm_decode,
                txlstm.MLSTM)
    return ("xlstm_1p3b", m.init_slstm, m.slstm, m.slstm_decode,
            txlstm.SLSTM)


def _pair(jx, jr, kind, **over):
    """A JAX mixer's parameters and the port's module holding them, on
    the float32 smoke config with ``over``."""
    arch, init, full, step, cls = _mixer(jr, kind)
    cfg, tcfg = _cfgs(jx, arch, "float32", **over)
    p = init(cfg, jr.jax.random.key(3))
    m = cls(tcfg, device="cpu")
    _load(m, p)
    return cfg, p, m, full, step


# ---------------------------------------------------------------------------
# the modules against repro
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
@pytest.mark.parametrize("S", [12, 10])
def test_mixer_prefill_and_decode_equal_jax(jx, jr, kind, S):
    """The full pass with its returned state (S 12: three chunks of 4; S
    10: pick_chunk gives five of 2), then 3 one-token steps from that
    state, each output and the last state against repro."""
    jnp = jr.jnp
    cfg, p, m, full, step = _pair(jx, jr, kind, ssm_chunk=4)
    x = _x(cfg, 2, S + 3, seed=5)
    want, jst = full(p, jnp.asarray(x[:, :S]), cfg, return_state=True)
    with torch.no_grad():
        got, st = m(_t(x[:, :S]), return_state=True)
        _close(got, want)
        assert set(st) == set(jst)
        for name in st:
            assert st[name].dtype == torch.float32
            _close(st[name], jst[name])
        _close(m(_t(x[:, :S])), want)
        for t in range(S, S + 3):
            want, jst = step(p, jnp.asarray(x[:, t:t + 1]), jst, cfg)
            got, st = m(_t(x[:, t:t + 1]), state=st)
            _close(got, want)
    for name in st:
        _close(st[name], jst[name])


def test_pick_chunk_equals_jax(jr):
    for s in range(1, 70):
        for chunk in (1, 3, 4, 8, 16, 64, 256):
            c = tssm.pick_chunk(s, chunk)
            assert c == jr.ssm.pick_chunk(s, chunk)
            assert s % c == 0 and c <= chunk


def test_softplus_equals_jax(jr):
    x = np.linspace(-40, 40, 801).astype(np.float32)
    got = tssm.softplus(_t(x))
    _close(got, jr.jax.nn.softplus(jr.jnp.asarray(x)), 1e-6)
    _close(got, np.logaddexp(x.astype(np.float64), 0.0), 1e-6)


@pytest.mark.parametrize("P", [1, 2])
def test_short_prefill_then_decode_equals_the_full_sequence(jx, jr, P):
    """C4: a prefill of fewer than d_conv - 1 = 3 tokens left-pads the
    conv state, so the next decode step equals repro's full-sequence
    mamba2 over the P + 1 tokens; repro's own decode after that prefill
    fails on the short window."""
    jnp = jr.jnp
    cfg, p, m, full, step = _pair(jx, jr, "mamba")
    x = _x(cfg, 2, P + 1, seed=8)
    want = full(p, jnp.asarray(x), cfg)
    with torch.no_grad():
        _, st = m(_t(x[:, :P]), return_state=True)
        assert st["conv"].shape[1] == cfg.d_conv - 1
        assert not st["conv"][:, :cfg.d_conv - 1 - P].any()
        got, _ = m(_t(x[:, P:]), state=st)
    _close(got[:, 0], np.asarray(want)[:, P])
    _, jst = full(p, jnp.asarray(x[:, :P]), cfg, return_state=True)
    with pytest.raises(ValueError):
        step(p, jnp.asarray(x[:, P:]), jst, cfg)


@pytest.mark.parametrize("P", [1, 2])
def test_short_prompt_serves_equal_to_jax_prefill(jx, P):
    """C4 at the model: zamba2's smoke config prefills P tokens and
    decodes one; its logits equal repro's prefill of the P + 1 tokens."""
    jnp = jx.jnp
    cfg, tcfg = _cfgs(jx, "zamba2_2p7b", "float32")
    params, tree = _jax_params(jx, cfg, seed=4)
    model = treg.params_from_jax(tcfg, tree, device="cpu")
    toks = np.random.default_rng(9).integers(1, cfg.vocab, (2, P + 1))
    want, _ = jx.registry.build(cfg)["prefill"](
        params, {"tokens": jnp.asarray(toks)})
    fns = treg.build(tcfg, device="cpu")
    _, cache = fns["prefill"](model, {"tokens": _t(toks[:, :P])},
                              max_len=P + 1)
    got, _ = fns["decode"](model, cache, {"tokens": _t(toks[:, P:])}, P)
    assert _rel(np.asarray(want)[:, -1], got[:, 0]) <= 1e-5


# ---------------------------------------------------------------------------
# chunked against recurrent inside the port (tests/test_models.py's)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["mamba", "mlstm"])
def test_chunked_equals_recurrent(kind):
    arch = "zamba2_2p7b" if kind == "mamba" else "xlstm_1p3b"
    cfg = dataclasses.replace(treg.get_smoke_config(arch), dtype="float32",
                              ssm_chunk=4)
    cls = tssm.Mamba2 if kind == "mamba" else txlstm.MLSTM
    m = cls(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    B, S = 2, 12
    x = _t(_x(cfg, B, S, seed=1))
    init = (tssm.init_mamba2_state if kind == "mamba"
            else txlstm.init_mlstm_state)
    with torch.no_grad():
        y_par, state = m(x, return_state=True)
        st = init(cfg, B, device="cpu")
        ys = []
        for t in range(S):
            y, st = m(x[:, t:t + 1], state=st)
            ys.append(y)
    np.testing.assert_allclose(_np(torch.cat(ys, 1)), _np(y_par), rtol=1e-4,
                               atol=1e-5)
    first = "ssm" if kind == "mamba" else "S"
    np.testing.assert_allclose(_np(state[first]), _np(st[first]), rtol=1e-4,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# parameters: counts, held dtypes, deterministic inits, the shared block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", RECURRENT)
def test_count_params_equals_jax_for_the_recurrent_families(jx, arch):
    cfg = treg.get_config(arch)
    assert jx.registry.count_params(jx.registry.get_config(arch)) == \
        FULL_COUNTS[arch]
    assert treg.count_params(cfg) == FULL_COUNTS[arch]
    assert treg.count_params(cfg, active_only=True) == FULL_COUNTS[arch]


@pytest.mark.parametrize("arch", RECURRENT)
def test_held_weights_float32_where_repro_uses_them_uncast(jx, arch):
    """Gates, recurrent weights, biases, Mamba2's A_log/D/dt_bias and
    the norms stay float32 and equal to the masters; every other weight
    is its master cast to bf16."""
    jnp = jx.jnp
    cfg, tcfg = _cfgs(jx, arch, "bfloat16")
    _, tree = _jax_params(jx, cfg)
    flat = dict(jx.jax.tree_util.tree_flatten_with_path(tree)[0])
    masters = {}
    for path, arr in flat.items():
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        masters[tuple(k for k in keys if k != "scale")] = arr
    model = treg.params_from_jax(tcfg, tree, device="cpu")
    specs = treg.block_specs(tcfg)
    kinds = set()
    for name, held in model.named_parameters():
        keys = name.split(".")
        if keys[0] == "layers":
            gi, r, li, _, _ = specs[int(keys[1])]
            master = masters[(f"group_{gi}", li, *keys[2:])][r]
        else:
            master = masters[tuple(keys)]
        if keys[-1] in FLOAT32:
            assert held.dtype == torch.float32, name
            np.testing.assert_array_equal(held.numpy(), master)
            kinds.add(keys[-1])
        else:
            assert held.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(
                held.float().numpy(), np.asarray(jnp.asarray(master).astype(
                    jnp.bfloat16).astype(jnp.float32)))
    want = ({"A_log", "D", "dt_bias"} if arch == "zamba2_2p7b" else
            {"wi", "wf", "r_zifo", "b_zifo", "f_bias"})
    assert want <= kinds


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_deterministic_inits_equal_jax(jx, jr, kind):
    """D = 1, dt_bias = 0, f_bias = 3, b_zifo = 0 exactly; A_log =
    log(linspace(1, 16, H)) within one float32 ulp (XLA's CPU linspace
    and log do not round as numpy's float64 ones rounded once do); the
    drawn tensors keep repro's std (conv 0.5, wo 1/sqrt(H): the fan-in is
    the first axis).  80 heads, as zamba2-2.7b has: torch's float32
    linspace is not XLA's there."""
    arch, init, _, _, cls = _mixer(jr, kind)
    cfg, tcfg = _cfgs(jx, arch, "float32", d_model=320, ssm_heads=80)
    jp = {k: np.asarray(v) for k, v in
          init(cfg, jr.jax.random.key(0)).items() if not isinstance(v, dict)}
    mod = cls(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    for name in ("D", "dt_bias", "f_bias", "b_zifo"):
        if name in jp:
            np.testing.assert_array_equal(getattr(mod, name).numpy(),
                                          jp[name])
    if kind == "mamba":
        assert mod.A_log.shape == (80,)
        np.testing.assert_allclose(mod.A_log.numpy(), jp["A_log"],
                                   rtol=2.4e-7, atol=0)
    stds = {"conv": 0.5, "wo": 1 / np.sqrt(tcfg.n_heads)}
    for name, std in stds.items():
        if name in jp:
            for a in (getattr(mod, name).numpy(), jp[name]):
                # a standard normal cut to [-2, 2]: std 0.8796
                assert abs(a.std() / std - 0.8796) < 0.05, name
                assert np.abs(a).max() <= 2 * std * (1 + 1e-6)


def test_shared_attention_is_one_module_loaded_from_the_top_key(jx):
    cfg, tcfg = _cfgs(jx, "zamba2_2p7b", "float32")
    _, tree = _jax_params(jx, cfg)
    model = treg.params_from_jax(tcfg, tree, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    assert [n for n in names if ".attn." in n or n.endswith(".attn")] == []
    shared = [n for n in names if n.startswith("shared_attn.")]
    assert sorted(shared) == sorted(f"shared_attn.{k}"
                                    for k in tree["shared_attn"])
    for k, arr in tree["shared_attn"].items():
        np.testing.assert_array_equal(
            getattr(model.shared_attn, k).numpy(), arr)
    kinds = [m for (_, _, _, m, _) in treg.block_specs(tcfg)]
    assert kinds.count("shared_attn") == tcfg.n_layers // \
        tcfg.hybrid_attn_every
    assert sum(p.numel() for p in model.parameters()) == \
        jx.registry.count_params(cfg)
    for blk, kind in zip(model.layers, kinds):
        assert blk.kind == kind
        assert not hasattr(blk, "attn")
        if kind == "shared_attn":
            assert {n.split(".")[0] for n, _ in blk.named_parameters()} \
                == {"ln1", "ln2", "mlp"}


def test_recurrent_builds_run_on_the_card_unless_asked_for_the_cpu():
    for arch in RECURRENT:
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

@pytest.mark.parametrize("arch", RECURRENT)
@pytest.mark.parametrize("P", [8, 12, 16])
def test_recurrent_serving_equals_jax_in_float32(jx, arch, P):
    """P 8: one chunk of 8; 12: pick_chunk gives two of 6; 16: two of 8."""
    errs, same = _serve_both(jx, arch, "float32", P=P)
    assert max(errs) <= 1e-4, errs
    assert all(same), same


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_serving_equals_jax_in_bfloat16(jx, arch):
    errs, _ = _serve_both(jx, arch, "bfloat16")
    assert max(errs) <= 3e-2, errs


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_decode_matches_forward(arch):
    """Prefill 8 tokens, then decode 8 fed tokens; each step's logits
    equal a re-forward of the whole prefix (``ssm_chunk`` 4: the prefill
    and the re-forwards cross chunk boundaries; the port's own init)."""
    cfg = dataclasses.replace(treg.get_smoke_config(arch), dtype="float32",
                              ssm_chunk=4)
    fns = treg.build(cfg, device="cpu")
    model = fns["init"](torch.Generator().manual_seed(1))
    B, P, G = 2, 8, 8
    toks = _t(np.random.default_rng(3).integers(1, cfg.vocab, (B, P + G)))
    _, cache = fns["prefill"](model, {"tokens": toks[:, :P]}, max_len=P + G)
    for t in range(P, P + G):
        dec, cache = fns["decode"](model, cache,
                                   {"tokens": toks[:, t:t + 1]}, t)
        ref, _ = fns["prefill"](model, {"tokens": toks[:, :t + 1]})
        assert _rel(ref[:, -1], dec[:, 0]) <= 2e-4


@pytest.mark.cuda
@pytest.mark.parametrize("arch", RECURRENT)
def test_cuda_recurrent_serving_equals_cpu(arch):
    """The same weights and tokens on the card and on the CPU, float32:
    prefill of 4 × 16 tokens (two chunks of 8) and 8 greedy steps."""
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
    assert _rel(a, b.cpu()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_cuda_mixer_equals_cpu(kind):
    """Each mixer's full pass (S 12, three chunks of 4), its state and 3
    steps from it, on the card against the CPU, float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: no CUDA device is present")
    arch = "zamba2_2p7b" if kind == "mamba" else "xlstm_1p3b"
    cls = {"mamba": tssm.Mamba2, "mlstm": txlstm.MLSTM,
           "slstm": txlstm.SLSTM}[kind]
    cfg = dataclasses.replace(treg.get_smoke_config(arch), dtype="float32",
                              ssm_chunk=4)
    host = cls(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = cls(cfg, device="meta").to_empty(device="cuda")
    card.load_state_dict(host.state_dict())
    x = _t(_x(cfg, 2, 15, seed=6))
    with torch.no_grad():
        a, sa = host(x[:, :12], return_state=True)
        b, sb = card(x[:, :12].cuda(), return_state=True)
        assert _rel(a, b.cpu()) <= 1e-5
        for t in range(12, 15):
            a, sa = host(x[:, t:t + 1], state=sa)
            b, sb = card(x[:, t:t + 1].cuda(), state=sb)
            assert _rel(a, b.cpu()) <= 1e-5
    for name in sa:
        assert _rel(sa[name], sb[name].cpu()) <= 1e-5
