"""Quickstart on the PyTorch port: mine the paper's own toy database
(Fig. 1) and verify the 13 frequent subgraphs, then mine a molecule-like
dataset with the distributed engine, on the CUDA card (or the CPU).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

from repro_torch.core.graphdb import paper_toy_db, pubchem_like_db
from repro_torch.core.host_miner import mine_host
from repro_torch.core.mining import Mirage, MirageConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    # --- 1. the paper's Fig. 1 example, sequential baseline (paper Fig. 3)
    graphs = paper_toy_db()
    res = mine_host(graphs, minsup=2)
    print(f"paper toy DB: {len(res.frequent)} frequent subgraphs "
          f"(paper says 13), per level {[len(l) for l in res.levels]}")
    assert len(res.frequent) == 13

    # --- 2. the same mine, but through the distributed MIRAGE engine
    dist = Mirage(MirageConfig(minsup=2, n_partitions=2),
                  device=args.device).fit(graphs)
    assert dist.counts() == [len(l) for l in res.levels]
    print(f"distributed MIRAGE on {args.device} agrees with the sequential "
          f"baseline")

    # --- 3. a molecule-like dataset (PubChem-style statistics, paper Table I)
    mols = pubchem_like_db(60, seed=0, avg_edges=12)
    cfg = MirageConfig(minsup=0.25, n_partitions=4, scheme=2,
                       reduce="reduce_scatter", max_size=5)
    miner = Mirage(cfg, device=args.device)
    out = miner.fit(mols)
    print(f"molecule-like DB (60 graphs, minsup 25%): "
          f"{sum(out.counts())} frequent subgraphs, per level {out.counts()}"
          f" (backend {miner.backend})")
    for st in out.stats:
        print(f"  level {st.level}: {st.n_candidates} candidates -> "
              f"{st.n_frequent} frequent in {st.seconds:.2f}s")
    host = mine_host(mols, out.minsup, max_size=cfg.max_size)
    assert out.supports == {c: i.support for c, i in host.frequent.items()}
    print("molecule-like DB: frequent set and supports equal mine_host")
    return out


if __name__ == "__main__":
    main()
