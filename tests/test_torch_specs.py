"""The port's shape stand-ins (``repro_torch.launch.specs``) against the
JAX package's ``ShapeDtypeStruct``s (``repro.launch.specs``): every
leaf of ``input_specs`` for each applicable (arch × shape), of
``params_specs`` and of ``cache_specs_struct`` at decode_32k and
long_500k, in ``repro``'s tree layout with the same shapes and dtypes;
all on the ``meta`` device, nothing allocated.  Mirrors
``tests/test_specs.py``, the shapes table and long_500k's
applicability included."""
import pytest
import torch

from repro_torch.configs.base import SHAPES, cell_applicable, shape_lowers
from repro_torch.launch import specs as tspecs
from repro_torch.models import registry as treg


def flat(tree, prefix=()) -> dict:
    """{key path: leaf} of a nested dict / list tree (None leaves
    dropped, as a JAX tree has none)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif tree is None:
        return {}
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flat(v, prefix + (k,)))
    return out


def jax_flat(jax, tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path):
            leaf for path, leaf in leaves}


def same(jax, got, want) -> None:
    g, w = flat(got), jax_flat(jax, want)
    assert set(g) == set(w)
    for k, leaf in g.items():
        assert leaf.device.type == "meta", k
        assert tuple(leaf.shape) == tuple(w[k].shape), k
        assert str(leaf.dtype).removeprefix("torch.") == str(w[k].dtype), k


@pytest.fixture(scope="module")
def jx():
    import jax
    from repro.launch import specs as jspecs
    from repro.models import registry as jreg
    return jax, jspecs, jreg


def test_shapes_table():
    assert SHAPES["train_4k"].seq_len == 4096
    assert SHAPES["train_4k"].global_batch == 256
    assert SHAPES["prefill_32k"].global_batch == 32
    assert SHAPES["decode_32k"].global_batch == 128
    assert SHAPES["long_500k"].seq_len == 524_288
    assert shape_lowers(SHAPES["train_4k"]) == "train_step"
    assert shape_lowers(SHAPES["long_500k"]) == "decode_step"


def test_long500k_applicability():
    runnable = sorted(treg.get_config(a).name for a in treg.ARCHS
                      if cell_applicable(treg.get_config(a),
                                         SHAPES["long_500k"])[0])
    assert runnable == ["xlstm-1.3b", "zamba2-2.7b"], runnable


@pytest.mark.parametrize("arch", treg.ARCHS)
def test_input_specs_equal_jax(jx, arch):
    jax, jspecs, jreg = jx
    cfg, jcfg = treg.get_config(arch), jreg.get_config(arch)
    n = 0
    for sname, shape in SHAPES.items():
        if not cell_applicable(cfg, shape)[0]:
            continue
        same(jax, tspecs.input_specs(cfg, shape),
             jspecs.input_specs(jcfg, shape))
        n += 1
    assert n >= 3


@pytest.mark.parametrize("arch", treg.ARCHS)
def test_params_specs_equal_jax(jx, arch):
    """Full width: the port's float32 masters stacked into ``repro``'s
    ``init`` tree (``group_{gi}`` lists, ``encoder.layers``)."""
    jax, jspecs, jreg = jx
    same(jax, tspecs.params_specs(treg.get_config(arch)),
         jspecs.params_specs(jreg.get_config(arch)))


@pytest.mark.parametrize("arch", treg.ARCHS)
def test_cache_specs_struct_equal_jax(jx, arch):
    """Attention caches in bf16, recurrent states in float32, stacked per
    group; each per-block cache of ``layer_caches`` is one repeat of its
    group's sub-layer."""
    jax, jspecs, jreg = jx
    cfg = treg.get_config(arch)
    for sname in ("decode_32k", "long_500k"):
        shape = SHAPES[sname]
        got = tspecs.cache_specs_struct(cfg, shape)
        same(jax, got, jspecs.cache_specs_struct(jreg.get_config(arch),
                                                 shape))
        from repro_torch.models.transformer import block_specs
        for (gi, _r, li, _m, _f), c in zip(block_specs(cfg),
                                           tspecs.layer_caches(cfg, shape)):
            want = got[gi][li]
            assert (c is None) == (want is None)
            for k, v in (c or {}).items():
                assert tuple(v.shape) == tuple(want[k].shape[1:])
                assert v.dtype == want[k].dtype


def test_nothing_is_allocated():
    cfg = treg.get_config("qwen2_vl_72b")
    leaves = flat(tspecs.params_specs(cfg))
    assert sum(v.numel() for v in leaves.values()) == treg.count_params(cfg)
    assert all(v.device == torch.device("meta") for v in leaves.values())
