"""MIRAGE core: the paper's algorithm (host-exact + device).

The package exports the names of ``repro.core`` lazily (PEP 562): each
is imported from its submodule on first use.  ``kernels/ops.py`` imports
``core.candgen`` and ``core/mapreduce.py`` imports ``kernels.ops``, so
importing every submodule here would make ``import
repro_torch.kernels.ops`` reach the half-loaded ``kernels.ops`` through
this package."""
import importlib

_EXPORTS = {
    "Candidate": "candgen", "EdgeAlphabet": "candgen",
    "generate_candidates": "candgen",
    "Code": "dfscode", "is_canonical": "dfscode",
    "min_dfs_code": "dfscode", "rightmost_path": "dfscode",
    "Graph": "graphdb", "paper_toy_db": "graphdb",
    "pubchem_like_db": "graphdb", "random_db": "graphdb",
    "mine_host": "host_miner",
    "MiningMesh": "mapreduce",
    "DistMiningResult": "mining", "Mirage": "mining",
    "MirageConfig": "mining",
    "mine_naive": "naive",
    "make_partitions": "partition",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                    name)
    globals()[name] = value
    return value
