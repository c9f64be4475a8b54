"""The port's public surface against the JAX package's, module by module.

Every module file under ``src/repro/`` is one case.  Its public names
(its ``__all__``, else its top-level ``def``, ``class`` and assignments
that do not start with ``_``) are read by parsing the source, so this
file never imports ``repro`` for the walk.  Each name must be found in
the port module of the same path under the same name, or be listed in
``RENAMED`` with a port target that exists, or in ``NO_COUNTERPART``
with the reason the port has none.  A module that ``repro`` gains later
fails here until it is ported or listed.

Beside the walk: every module of ``repro_torch`` must import first in a
fresh interpreter, and the helpers the port gained to close the surface
(``is_packed_backend``, ``run_program`` and the ``repro_torch.core``
package exports) are held against ``repro``'s."""
from __future__ import annotations

import ast
import importlib
import importlib.util
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

# "module:name" of repro (module relative to the package) -> "module:attr"
# of the port, where attr may be Class.method
RENAMED = {
    # the Pallas kernels -> their CUDA wrappers
    "kernels.fused_level:fused_level_pallas":
        "kernels.fused_level:fused_level",
    "kernels.fused_level:fused_level_packed_pallas":
        "kernels.fused_level:fused_level_packed",
    "kernels.embedding_join:embedding_join_pallas":
        "kernels.embedding_join:embedding_join",
    "kernels.support_count:support_count_pallas":
        "kernels.support_count:support_count",
    # the JAX graph tile lives with the wrappers that pad to it
    "kernels.embedding_join:DEFAULT_TILE_G": "kernels.ops:DEFAULT_TILE_G",
    # nothing to jit: the device candgen is called as it is
    "core.candgen:device_candgen_jit": "core.candgen:device_candgen",
    # the functional init/forward/decode entries -> nn.Modules
    "models.attention:init_attention": "models.attention:Attention",
    "models.attention:attention": "models.attention:Attention.forward",
    "models.attention:init_mla": "models.attention:MLA",
    "models.attention:mla": "models.attention:MLA.forward",
    "models.mlp:init_mlp": "models.mlp:MLP",
    "models.mlp:mlp": "models.mlp:MLP.forward",
    "models.mlp:init_moe": "models.mlp:MoE",
    "models.mlp:moe": "models.mlp:MoE.forward",
    "models.ssm:init_mamba2": "models.ssm:Mamba2",
    "models.ssm:mamba2": "models.ssm:Mamba2.forward",
    "models.ssm:mamba2_decode": "models.ssm:Mamba2.forward",
    "models.xlstm:init_mlstm": "models.xlstm:MLSTM",
    "models.xlstm:mlstm": "models.xlstm:MLSTM.forward",
    "models.xlstm:mlstm_decode": "models.xlstm:MLSTM.forward",
    "models.xlstm:init_slstm": "models.xlstm:SLSTM",
    "models.xlstm:slstm": "models.xlstm:SLSTM.forward",
    "models.xlstm:slstm_decode": "models.xlstm:SLSTM.forward",
    "models.encdec:init_encdec": "models.encdec:EncDec",
    "models.encdec:forward_encdec": "models.encdec:EncDec.forward",
    "models.encdec:encode": "models.encdec:EncDec.encode",
    "models.transformer:init_lm": "models.transformer:LM",
    "models.transformer:forward_lm": "models.transformer:LM.forward",
    # decode caches are allocated at prefill (make_cache=True)
    "models.transformer:init_cache": "models.transformer:LM.forward",
    # NamedShardings -> the port's placement functions
    "runtime.sharding:param_shardings": "runtime.sharding:place_model",
    "runtime.sharding:partition_sharding":
        "runtime.sharding:partition_block",
    # one ICI rate -> the span rule (NVLink inside a node, else the NIC)
    "roofline.hw:ICI_BW": "roofline.hw:link_bw",
    # HLO parsing -> counting the eager step
    "roofline.hlo:HloCost": "roofline.cost:StepCost",
    "roofline.hlo:parse_hlo_cost": "roofline.cost:count_step",
}

# "module:name" or a whole "module" of repro -> why the port has none
NO_COUNTERPART = {
    "core.mining:DonationPolicy":
        "donation is a no-op: eager PyTorch frees a buffer with its last "
        "reference",
    "core.mining:DonationRetryRebuild":
        "donation is a no-op, so no donated buffer is ever rebuilt",
    "models.common:split_keys":
        "explicit torch generators replace split JAX PRNG keys",
    "runtime.jax_compat":
        "shims over JAX versions (make_mesh, shard_map): no subject in "
        "PyTorch",
    "core.embedding:CandidateMeta":
        "C8, a fault of the reference: in repro's __all__ but defined "
        "nowhere in repro",
}


def _module_name(path: Path, package: str) -> str:
    """'core.mining' for src/<package>/core/mining.py, '' for the
    package's own __init__.py."""
    parts = path.relative_to(SRC / package).with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _module_files(package: str) -> list[Path]:
    return sorted((SRC / package).rglob("*.py"))


REPRO_MODULES = {_module_name(p, "repro"): p for p in _module_files("repro")}
PORT_MODULES = [_module_name(p, "repro_torch")
                for p in _module_files("repro_torch")]


def public_names(path: Path) -> list[str]:
    """The module's ``__all__``; without one, its top-level defs,
    classes and assignments (imports are not names of the module)."""
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            return list(ast.literal_eval(node.value))
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.append(node.target.id)
    return [n for n in names if not n.startswith("_")]


def _port(module: str):
    return importlib.import_module(
        "repro_torch" + (f".{module}" if module else ""))


def _resolve(target: str):
    module, attr = target.split(":")
    obj = _port(module)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def test_the_walk_finds_every_module_file():
    assert len(REPRO_MODULES) >= 63
    assert {"", "core", "core.mining", "kernels.ops",
            "runtime.jax_compat"} <= set(REPRO_MODULES)


@pytest.mark.parametrize("module", sorted(REPRO_MODULES),
                         ids=lambda m: m or "__init__")
def test_every_public_name_has_a_counterpart(module):
    if module in NO_COUNTERPART:
        assert importlib.util.find_spec(f"repro_torch.{module}") is None
        return
    missing = []
    for name in public_names(REPRO_MODULES[module]):
        key = f"{module}:{name}"
        if key in NO_COUNTERPART:
            continue
        if key in RENAMED:
            _resolve(RENAMED[key])            # the target must exist
        elif not hasattr(_port(module), name):
            missing.append(name)
    assert not missing, (f"repro.{module} names with no counterpart in "
                         f"repro_torch.{module}: {missing}")


def test_the_tables_name_only_what_repro_has():
    """Each entry of the two tables names a public name of ``repro`` (or,
    in NO_COUNTERPART, a whole module) that the port does not have under
    the same name, and NO_COUNTERPART gives a reason."""
    for key in list(RENAMED) + list(NO_COUNTERPART):
        module, _, name = key.partition(":")
        assert module in REPRO_MODULES, key
        if not name:
            continue
        assert name in public_names(REPRO_MODULES[module]), key
        spec = importlib.util.find_spec(f"repro_torch.{module}")
        assert spec is None or not hasattr(_port(module), name), key
    assert all(NO_COUNTERPART.values())


def test_every_port_module_imports_first():
    """Each module of ``repro_torch`` imports in an interpreter where no
    other module of the package is loaded yet (one process; every
    ``repro_torch`` entry of ``sys.modules`` is dropped between modules,
    so torch is imported once).  A package ``__init__`` that imports its
    submodules eagerly can make a module reach another half-loaded one."""
    names = ["repro_torch" + (f".{m}" if m else "") for m in PORT_MODULES]
    code = textwrap.dedent("""
        import importlib, sys, traceback
        sys.path.insert(0, sys.argv[1])
        bad = []
        for name in sys.argv[2:]:
            for k in [k for k in sys.modules
                      if k.split(".")[0] == "repro_torch"]:
                del sys.modules[k]
            try:
                importlib.import_module(name)
            except Exception:
                bad.append(name + ": " + traceback.format_exc(limit=-1))
        print("".join(bad) or "ok")
    """)
    proc = subprocess.run(
        [sys.executable, "-c", code, str(SRC), *names],
        capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok", proc.stdout
    assert len(names) >= 70


def test_star_import_of_the_port_binds_every_name_of_all():
    """Every name a port module's ``__all__`` lists is bound by ``import
    *``: the port has no C8 (``repro.core.embedding`` lists
    ``CandidateMeta`` in its ``__all__`` and defines it nowhere)."""
    for module in PORT_MODULES:
        ns = {}
        exec(f"from {_port(module).__name__} import *", ns)
        assert set(getattr(_port(module), "__all__", ())) <= set(ns), module


def test_c8_the_reference_star_import_raises():
    """C8 as the reference has it: ``from repro.core.embedding import *``
    raises on the name its ``__all__`` lists and nothing defines."""
    with pytest.raises(AttributeError, match="CandidateMeta"):
        exec("from repro.core.embedding import *", {})


def _core_exports() -> dict[str, str]:
    """name -> submodule of ``repro.core``'s package imports."""
    tree = ast.parse(REPRO_MODULES["core"].read_text())
    return {a.name: node.module for node in tree.body
            if isinstance(node, ast.ImportFrom) for a in node.names}


@pytest.mark.parametrize("name", sorted(_core_exports()))
def test_core_package_exports_the_submodules_objects(name):
    import repro_torch.core as core
    assert name in core.__all__
    sub = importlib.import_module(f"repro_torch.core.{_core_exports()[name]}")
    assert getattr(core, name) is getattr(sub, name)


def test_core_package_all_equals_repro():
    import repro_torch.core as core
    assert core.__all__ == public_names(REPRO_MODULES["core"])
    from repro_torch.core import Mirage, MirageConfig, MiningMesh, mine_host
    from repro_torch.core.mining import Mirage as M
    assert Mirage is M and MirageConfig and MiningMesh and mine_host
    with pytest.raises(AttributeError):
        core.not_a_name


@pytest.mark.parametrize("backend", ["ref", "pallas", "fused",
                                     "fused_packed", None])
def test_is_packed_backend_equals_jax(backend):
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops as tops
    assert tops.is_packed_backend(backend) == jops.is_packed_backend(backend)
    assert tops.is_fused_backend(backend) == jops.is_fused_backend(backend)


def test_run_program_is_seen_through_a_patch(monkeypatch):
    from repro_torch.core import device_loop as tdloop
    from repro_torch.core.mapreduce import MiningMesh
    args = (MiningMesh(), 2, "ref", "psum", False, 4, 5, 16, 32, 8, 4, 8,
            16, 6)
    # the cached program itself, the same object as _run_program's
    assert tdloop.run_program(*args) is tdloop._run_program(*args)
    seen = []

    def traced(*a, **kw):
        seen.append((a, kw))
        return "program"

    monkeypatch.setattr(tdloop, "_run_program", traced)
    assert tdloop.run_program(*args[:-1], n_triples=6) == "program"
    assert seen == [(args[:-1], {"n_triples": 6})]
