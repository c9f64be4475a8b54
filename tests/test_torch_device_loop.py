"""The port's whole-run device loop (``pipeline="device_loop"``,
``candgen="device"``, DESIGN.md §13) against the JAX package's on the
CPU, bit for bit — every value is an integer, so no tolerance:

 1. the building blocks against the JAX array functions and the host
    oracles: ``min_dfs_canonical_array`` (state overflow included) vs
    ``is_canonical``, ``device_candidates`` vs ``generate_candidates``
    (exact order), ``device_schedule`` vs ``schedule_candidates``;
 2. ``Mirage.fit`` with the device loop against the JAX package's
    device loop and single-sync runs and ``mine_host``: levels in
    order, supports, stats rows and ``last_device_loop``, over the
    backends (``fused`` and ``pallas`` through their plain versions),
    packed and dense, early termination, ``unroll``, the tiny-budget
    fallback, the run-wire re-fetch and the memory clamp of SPP forced
    small (``tests/test_torch_device_loop_runs.py`` holds the escalation
    valve, the candgen="device" stepping stone, chunk checkpoints
    resumed across the two packages, the CLI and W = 2 and 4 as gloo
    ranks);
 3. the residency contract: one run-program build and one wire fetch
    per run, no host candgen between levels.

The JAX package is imported in the ``jx`` fixture only: the ``cuda``
case runs on a machine without JAX (``pytest -m cuda``)."""
import os
import types

import numpy as np
import pytest
import torch

from repro_torch.core import candgen as tcandgen
from repro_torch.core import device_loop as tdloop
from repro_torch.core import dfscode as tdfscode
from repro_torch.core import level_step as tlevel_step
from repro_torch.core import mining as tmining
from repro_torch.core.graphdb import Graph, random_db
from repro_torch.core.host_miner import mine_host
from repro_torch.core.mining import Mirage, MirageConfig
from repro_torch.core.partition import make_partitions
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime import faults
from repro_torch.runtime.errors import DeviceMemoryError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_device_loop.py's DB: levels of 12, 16 and 2 at minsup 3
DB_KW = dict(n_graphs=18, n_vertices=6, extra_edge_prob=0.35, n_vlabels=3,
             n_elabels=2, seed=42)
DB = random_db(**DB_KW)
# the JAX package's backend that runs the same kernels on the CPU
JAX_BACKEND = {"ref": "ref", "fused": "fused_interpret",
               "pallas": "interpret"}


@pytest.fixture(scope="module")
def jx():
    import jax  # noqa: F401  (the JAX package, on the CPU)
    from repro.core import candgen, dfscode, graphdb, mining
    return types.SimpleNamespace(candgen=candgen, dfscode=dfscode,
                                 graphdb=graphdb, mining=mining)


@pytest.fixture(scope="module")
def canon():
    return _oracle(DB, 3, 4)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The loop's tensors are tiny here: one intra-op thread runs them
    faster than a pool that contends with the suite's other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    faults.reset_log()
    yield
    faults.clear()
    faults.reset_log()


def _oracle(graphs, minsup, max_size):
    return sorted((c, i.support) for c, i in
                  mine_host(graphs, minsup, max_size=max_size)
                  .frequent.items())


def _stats(res):
    return [(s.level, s.n_candidates, s.n_frequent, s.overflow,
             s.escalations, s.survivor_cap, s.imbalance) for s in res.stats]


def _cfg(**kw):
    cfg = dict(minsup=3, n_partitions=2, max_size=4, backend="ref",
               pipeline="device_loop")
    cfg.update(kw)
    return cfg


def _pair(jx, graphs_kw=DB_KW, **kw):
    """(port miner, port result, JAX miner, JAX result) of one config."""
    cfg = _cfg(**kw)
    jcfg = dict(cfg, backend=JAX_BACKEND[cfg["backend"]])
    tm = Mirage(MirageConfig(**cfg), device="cpu")
    tres = tm.fit(random_db(**graphs_kw))
    jm = jx.mining.Mirage(jx.mining.MirageConfig(**jcfg))
    jres = jm.fit(jx.graphdb.random_db(**graphs_kw))
    return tm, tres, jm, jres


def _assert_same(tm, tres, jm, jres):
    assert tres.levels == jres.levels            # level ORDER too
    assert tres.supports == jres.supports
    assert _stats(tres) == _stats(jres)
    assert tres.total_overflow == jres.total_overflow
    assert tm.last_device_loop == jm.last_device_loop


@pytest.fixture(scope="module")
def code_pile():
    """Canonical and non-canonical children of every frequent pattern
    of two seeded DBs (the code pile of tests/test_device_loop.py)."""
    codes = []
    for seed in range(2):
        graphs = random_db(10, n_vertices=6, extra_edge_prob=0.4,
                           n_vlabels=3, n_elabels=2, seed=seed)
        res = mine_host(graphs, 2, max_size=4)
        alpha = tcandgen.EdgeAlphabet((c[0][2], c[0][3], c[0][4])
                                      for c in res.frequent if len(c) == 1)
        for code in res.frequent:
            rmp = tdfscode.rightmost_path(code)
            n_v = max(max(e[0], e[1]) for e in code) + 1
            vl = {}
            for (i, j, li, _le, lj) in code:
                vl[i], vl[j] = li, lj
            existing = {(min(e[0], e[1]), max(e[0], e[1])) for e in code}
            rmv = rmp[-1]
            for w in rmp[:-1]:
                if (min(rmv, w), max(rmv, w)) in existing:
                    continue
                for (e_lab, other) in alpha.partners(vl[rmv]):
                    if other == vl[w]:
                        codes.append(
                            code + ((rmv, w, vl[rmv], e_lab, vl[w]),))
            for w in rmp:
                for (e_lab, other) in alpha.partners(vl[w]):
                    codes.append(code + ((w, n_v, vl[w], e_lab, other),))
    return codes


# ---------------------------------------------------------------------------
# 1. building blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_vertex_slots,max_states", [(None, 64), (8, 64),
                                                       (8, 4), (8, 2)])
def test_canonicality_machine_matches_jax_and_host(jx, code_pile,
                                                   n_vertex_slots,
                                                   max_states):
    """The machine agrees with the JAX array function word for word —
    the overflow flag of a state budget too small included — and, where
    it does not overflow, with the host ``is_canonical``."""
    import jax
    import jax.numpy as jnp
    codes = code_pile
    assert len(codes) > 300
    L = max(len(c) for c in codes)
    NV = n_vertex_slots or L + 1
    arr = np.stack([tdfscode.code_to_array(c, L) for c in codes])
    fn = jax.jit(jax.vmap(lambda a: jx.dfscode.min_dfs_canonical_array(
        a, n_vertex_slots=NV, max_states=max_states)))
    want_c, want_o = map(np.asarray, fn(jnp.asarray(arr)))
    got_c, got_o = tdfscode.min_dfs_canonical_array(
        torch.from_numpy(arr), n_vertex_slots=NV, max_states=max_states)
    assert np.array_equal(got_c.numpy(), want_c)
    assert np.array_equal(got_o.numpy(), want_o)
    assert got_o.any() == (max_states < 64)
    host = np.array([tdfscode.is_canonical(c) for c in codes])
    fine = ~got_o.numpy()
    assert np.array_equal(got_c.numpy()[fine], host[fine])
    rmp = jax.jit(jax.vmap(
        lambda a: jx.dfscode.code_array_rightmost_path(a, NV)))(
        jnp.asarray(arr))
    for a, b in zip(rmp, tdfscode.code_array_rightmost_path(
            torch.from_numpy(arr), NV)):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_canonicality_machine_refuses_32_edges():
    with pytest.raises(ValueError, match="bitmask"):
        tdfscode.min_dfs_canonical_array(
            torch.full((1, 32, 5), -1, dtype=torch.int32),
            n_vertex_slots=33, max_states=4)


def _levels_of(seed):
    graphs = random_db(18, n_vertices=6, extra_edge_prob=0.35, n_vlabels=3,
                       n_elabels=2, seed=seed)
    res = mine_host(graphs, 5, max_size=4)
    alpha = tcandgen.EdgeAlphabet((c[0][2], c[0][3], c[0][4])
                                  for c in res.frequent if len(c) == 1)
    triples = sorted({t for c in alpha.canonical()
                      for t in (c, (c[2], c[1], c[0]))})
    by_level = {}
    for c in res.frequent:
        by_level.setdefault(len(c), []).append(c)
    return alpha, triples, [sorted(by_level[k]) for k in sorted(by_level)]


@pytest.mark.parametrize("seed", [43])
def test_device_candgen_matches_host_order_and_jax(jx, seed):
    """``device_candidates`` reproduces ``generate_candidates`` exactly —
    same candidates, same parent/extension metadata, same ORDER — and
    the JAX generator's arrays word for word, at the parents' own width
    and in the loop's wider, parent-padded layout, and with budgets too
    small (the overflow flags).  Real rows index parents and triples
    inside the stores; pad rows are [0, 0, 0, 1, 0]."""
    import jax.numpy as jnp
    alpha, triples, levels = _levels_of(seed)
    tri = np.asarray(triples, np.int32)
    checked = 0
    for parents in levels:
        host = tcandgen.generate_candidates(parents, alpha)
        lvl = len(parents[0])
        cb = max(8, 2 * len(host))
        shapes = [(lvl + 1, lvl + 2, 0, cb), (6, 8, 5, cb)]
        if lvl == 1:                        # budgets too small
            shapes.append((lvl + 1, lvl + 2, 0, 4))
        for L, NV, extra, cb in shapes:
            codes = np.full((len(parents) + extra, L, 5), -1, np.int32)
            for i, c in enumerate(parents):
                codes[i] = tdfscode.code_to_array(c, L)
            want = jx.candgen.device_candgen_jit(L, NV, 4 * cb, cb, 64)(
                jnp.asarray(codes), jnp.int32(len(parents)),
                jnp.asarray(tri))
            got = tcandgen.device_candgen(L, NV, 4 * cb, cb, 64)(
                torch.from_numpy(codes), len(parents), torch.from_numpy(tri))
            for a, b in zip(want, got):
                assert np.array_equal(np.asarray(a), b.numpy())
            meta, child, n_cand, flags = (x.numpy() for x in got)
            if flags.any():
                assert cb < len(host)
                continue
            assert int(n_cand) == len(host)
            assert (meta[:n_cand, 0] < len(parents)).all()
            assert (meta[:n_cand, 4] < len(triples)).all()
            assert (meta[n_cand:] == [0, 0, 0, 1, 0]).all()
            dev = tcandgen.candidates_from_arrays(meta, child, int(n_cand),
                                                  triples)
            assert [(d.code, d.parent, d.ext) for d in dev] == \
                [(h.code, h.parent, h.ext) for h in host]
            checked += len(host)
    assert checked > 0


def test_device_schedule_matches_host_and_jax(jx):
    """``device_schedule`` reproduces ``schedule_candidates``' tiling
    (meta, tiles, inverse map) and the JAX twin's arrays, and flags
    overflow when the rows run out."""
    import jax
    import jax.numpy as jnp
    schedule = jax.jit(jx.candgen.device_schedule,
                       static_argnames=("tile_c", "n_triples", "rows"))
    rng = np.random.default_rng(0)
    for trial in range(12):
        C = int(rng.integers(1, 60))
        T = int(rng.integers(2, 12))
        NP = int(rng.integers(1, 20))
        meta = np.stack([
            rng.integers(0, NP, C), rng.integers(0, 4, C),
            rng.integers(0, 5, C), rng.integers(0, 2, C),
            rng.integers(0, T, C)], axis=1).astype(np.int32)
        meta = meta[np.argsort(meta[:, 0], kind="stable")]
        tc = int(rng.choice([1, 2, 4, 8]))
        host = tcandgen.schedule_candidates(meta, tc,
                                            max_inflation=float("inf"))
        cb = C + int(rng.integers(0, 16))
        rows = max(host.meta.shape[0], cb) + tc * int(rng.integers(0, 3))
        rows = -(-rows // tc) * tc
        if trial % 4 == 3:                     # too few rows: overflow
            rows = max(tc, -(-host.meta.shape[0] // tc) * tc - tc)
        pmeta = np.concatenate(
            [meta, np.tile(np.asarray([0, 0, 0, 1, 0], np.int32),
                           (cb - C, 1))])
        got = tcandgen.device_schedule(torch.from_numpy(pmeta), C,
                                       tile_c=tc, n_triples=T, rows=rows)
        want = schedule(jnp.asarray(pmeta), jnp.int32(C), tile_c=tc,
                        n_triples=T, rows=rows)
        for a, b in zip(want, got):
            assert np.array_equal(np.asarray(a), b.numpy()), trial
        sched, tiles, inv, ovf = (x.numpy() for x in got)
        hs = host.meta.shape[0]
        assert bool(ovf) == (hs > rows), trial
        if hs <= rows:
            assert np.array_equal(sched[:hs], host.meta), trial
            assert (sched[hs:, 5] == 0).all(), trial
            assert np.array_equal(tiles[:hs // tc], host.tiles), trial
            assert np.array_equal(inv[:C], host.inv), trial


def test_chunk_cadence():
    c = ckpt.ChunkCadence(1, 6, 2)
    assert c.boundaries() == [3, 5, 6]
    assert c.n_chunks == 3
    assert c.max_fetches() == 3 + 2 * 2
    whole = ckpt.ChunkCadence(1, 6, None)
    assert whole.boundaries() == [6]
    assert whole.max_fetches() == 1
    assert ckpt.ChunkCadence(3, 4, 1).boundaries() == [4]
    with pytest.raises(ValueError):
        ckpt.ChunkCadence(4, 3)


def test_run_wire_layout():
    """The run wire's length and offsets are the JAX package's."""
    NL, SPP, L = 3, 4, 5
    body = np.arange(tdloop.run_wire_words(NL, SPP, L) - 1, dtype=np.int32)
    rw = tdloop.decode_run_wire(body, NL, SPP, L)
    assert rw.stats.shape == (NL, tdloop.NSTAT)
    assert rw.sups.shape == (NL, SPP) and rw.codes.shape == (NL, SPP, L, 5)
    o = NL * tdloop.NSTAT + NL * SPP + NL * SPP * L * 5
    assert (rw.k_final, rw.n_par, rw.total_overflow) == (o, o + 1, o + 3)


# ---------------------------------------------------------------------------
# 2. Mirage.fit with the device loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,packed", [("ref", True), ("ref", False),
                                            ("fused", True),
                                            ("pallas", True)])
def test_fit_matches_reference_single_sync_and_host(jx, canon, backend,
                                                    packed):
    """The port's device loop equals the JAX package's (levels in order,
    supports, stats rows, ``last_device_loop``), its single-sync run and
    ``mine_host``.  "pallas" runs the plain join on the device-built
    candidate table, which raises on a row outside the stores."""
    tm, tres, jm, jres = _pair(jx, backend=backend, packed_support=packed)
    _assert_same(tm, tres, jm, jres)
    assert tm.last_device_loop["completed"] and \
        tm.last_device_loop["chunks"] == 1
    assert sorted(tres.supports.items()) == canon
    ss = Mirage(MirageConfig(**_cfg(backend=backend, packed_support=packed,
                                    pipeline="single_sync")),
                device="cpu").fit(DB)
    assert tres.levels == ss.levels
    assert [s[:3] for s in _stats(tres)] == [s[:3] for s in _stats(ss)]


def test_early_termination_and_unroll_match_reference(jx, canon):
    """max_size far past the fixpoint: the bodies past the first empty
    frequent set are predicated off, and the decode stops at level 4;
    ``unroll`` 1 and 2 queue the same bodies in more calls."""
    tm, tres, jm, jres = _pair(jx, max_size=8)
    _assert_same(tm, tres, jm, jres)
    assert [len(l) for l in tres.levels] == [12, 16, 2]
    assert tres.stats[-1].level == 4
    whole = Mirage(MirageConfig(**_cfg()), device="cpu")
    want = whole.fit(DB)
    for unroll in (1, 2):
        m = Mirage(MirageConfig(**_cfg(device_loop_unroll=unroll)),
                   device="cpu")
        res = m.fit(DB)
        assert res.levels == want.levels and res.supports == want.supports
        assert _stats(res) == _stats(want)
        assert m.last_device_loop == whole.last_device_loop


def test_tiny_budget_falls_back_exactly(jx, canon):
    """A hopeless candidate budget bails with a flag; the miner replays
    the run through single-sync, equal to the JAX package's fallback."""
    tm, tres, jm, jres = _pair(jx, device_c_budget=8)
    assert tres.levels == jres.levels and tres.supports == jres.supports
    assert tm.last_device_loop == jm.last_device_loop
    assert not tm.last_device_loop["completed"]
    assert "flags" in tm.last_device_loop["fallback"]
    assert sorted(tres.supports.items()) == canon


def test_run_wire_bitflip_is_refetched(monkeypatch, canon):
    """A checksum-failing run wire is re-fetched from the device buffer;
    the injected fault is consumed exactly once."""
    copies = []
    orig = tlevel_step._copy_to_host
    monkeypatch.setattr(tlevel_step, "_copy_to_host",
                        lambda w: copies.append(1) or orig(w))
    sched = faults.FaultSchedule.parse("wire_bitflip@4")
    faults.install(sched)
    m = Mirage(MirageConfig(**_cfg()), device="cpu")
    res = m.fit(DB)
    assert all(s._remaining == 0 for s in sched.specs)
    assert len(copies) == 2 and m.last_device_loop["completed"]
    assert sorted(res.supports.items()) == canon


def test_no_host_candgen_or_dispatch_mid_loop(monkeypatch, canon):
    """During a completed run the host candgen runs exactly once (the
    budget-sizing call on the start level) and the per-level dispatcher
    never runs."""
    calls = []
    real = tmining.generate_candidates

    def counting(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

    def boom(*a, **kw):
        raise AssertionError("dispatch_level ran under device_loop")

    monkeypatch.setattr(tmining, "generate_candidates", counting)
    monkeypatch.setattr(tmining, "dispatch_level", boom)
    m = Mirage(MirageConfig(**_cfg()), device="cpu")
    res = m.fit(DB)
    assert m.last_device_loop["completed"]
    assert len(calls) == 1, f"{len(calls)} host candgen calls"
    assert sorted(res.supports.items()) == canon


def _path_db(n_graphs=6, length=9):
    def path(n):
        return Graph(np.zeros(n, np.int32),
                     np.stack([np.arange(n - 1), np.arange(1, n)], 1),
                     np.zeros(n - 1, np.int32))
    return [path(length) for _ in range(n_graphs)]


def test_one_program_build_and_one_fetch_per_run(monkeypatch):
    """The counterpart of ``test_compile_cache.py::
    test_device_loop_one_program_one_fetch``: a non-escalating run over
    6 levels builds ONE run program and performs ONE device→host copy,
    the run wire."""
    builds, copies = [], []
    orig_prog = tdloop._run_program
    orig_copy = tlevel_step._copy_to_host

    def traced(*key):
        builds.append(key)
        return orig_prog(*key)

    monkeypatch.setattr(tdloop, "_run_program", traced)
    monkeypatch.setattr(tlevel_step, "_copy_to_host",
                        lambda w: copies.append(1) or orig_copy(w))
    graphs = _path_db()
    miner = Mirage(MirageConfig(minsup=6, n_partitions=2, max_size=8,
                                backend="ref", pipeline="device_loop"),
                   device="cpu")
    res = miner.fit(graphs)
    assert miner.last_device_loop["completed"]
    assert len(res.stats) >= 6
    assert len(builds) == 1 and len(copies) == 1
    assert sorted(res.supports.items()) == _oracle(graphs, 6, 8)


def test_config_validation():
    with pytest.raises(ValueError, match="max_size"):
        MirageConfig(minsup=3, pipeline="device_loop")
    with pytest.raises(ValueError, match="bucket_shapes"):
        MirageConfig(minsup=3, max_size=4, pipeline="device_loop",
                     bucket_shapes=False)
    with pytest.raises(ValueError, match="escalate_on_overflow"):
        MirageConfig(minsup=3, max_size=4, pipeline="device_loop",
                     escalate_on_overflow=False)
    with pytest.raises(ValueError, match="candgen"):
        MirageConfig(minsup=3, candgen="quantum")
    assert not MirageConfig(minsup=3, max_size=4,
                            pipeline="device_loop").overlap_candgen
    assert not MirageConfig(minsup=3, candgen="device").overlap_candgen
    assert MirageConfig(minsup=3).overlap_candgen


def test_memory_clamp_of_the_slots_falls_back_exactly(canon):
    """The SPP clamp forced small on the CPU (as
    ``test_memory_survivor_cap`` forces the survivor cap's): room for
    the 12 start parents but not for level 2's 16 survivors trips
    FLAG_SLOT_OVF, and the single-sync replay is exact; room for no
    more than 11 slots raises ``DeviceMemoryError`` before anything is
    allocated."""
    free_m = Mirage(MirageConfig(**_cfg()), device="cpu")
    free_m.fit(DB)
    info = free_m.last_device_loop
    assert info["spp"] == 256                        # repro's, unclamped
    G = max(len(p) for p in make_partitions(DB, 3, 2).partitions)
    # one slot of the parent and of the child store: PP=2 partitions,
    # NV=8 vertex slots
    pair = 2 * 2 * G * info["max_embeddings"] * (4 * 8 + 1)
    m = Mirage(MirageConfig(**_cfg()), device="cpu")
    m._free_device_bytes = lambda: 2 * 14 * pair + 1
    res = m.fit(DB)
    assert not m.last_device_loop["completed"]
    assert "14 memory-clamped slots" in m.last_device_loop["fallback"]
    assert sorted(res.supports.items()) == canon
    m = Mirage(MirageConfig(**_cfg()), device="cpu")
    m._free_device_bytes = lambda: 2 * 11 * pair + 1
    with pytest.raises(DeviceMemoryError):
        m.fit(DB)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["fused_packed", "fused", "pallas"])
def test_cuda_device_loop_has_one_fetch_and_no_sync(monkeypatch, backend):
    """On the card every body runs under sync debug mode "error" — no
    device→host read from the first body to the wire fetch — and the
    run equals ``mine_host`` with one wire copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: no CUDA device is present")
    copies = []
    orig_copy = tlevel_step._copy_to_host
    orig_prog = tdloop._run_program

    def copy(w):
        torch.cuda.set_sync_debug_mode(0)
        copies.append(1)
        return orig_copy(w)

    def prog(*key):
        body = orig_prog(*key)

        def guarded(*a, **kw):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            return body(*a, **kw)
        return guarded

    monkeypatch.setattr(tlevel_step, "_copy_to_host", copy)
    monkeypatch.setattr(tdloop, "_run_program", prog)
    m = Mirage(MirageConfig(**_cfg(backend=backend,
                                   packed_support=backend != "fused")))
    try:
        res = m.fit(DB)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert m.last_device_loop["completed"] and len(copies) == 1
    assert sorted(res.supports.items()) == _oracle(DB, 3, 4)
