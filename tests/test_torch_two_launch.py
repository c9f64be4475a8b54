"""The two-launch backend "pallas" of the port against the JAX package's
two-launch Pallas kernels (interpret mode on the CPU), at three levels:
the kernels' plain versions, the single-sync level wire, and
``Mirage.fit`` on both pipelines that reach the kernels (single-sync
with ``backend="pallas"``, and ``pipeline="legacy"``).  Every comparison
is exact.  The CUDA kernels themselves run only on a card: the tests
marked ``cuda`` skip on a host without one.  The JAX package comes in
through the ``ref`` fixture, so that on a GPU machine without JAX
``pytest -m cuda tests/test_torch_two_launch.py`` still imports this
file and runs the CUDA cases."""
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.core import graphdb as tgraphdb
from repro_torch.core import mining as tmining
from repro_torch.core.host_miner import mine_host
from repro_torch.kernels import embedding_join as tej
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import support_count as tsc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ref():
    """The JAX package's two-launch kernels, their refs and the miners."""
    from repro.core import graphdb, level_step, mining
    from repro.kernels import ops, ref as kref
    from repro.kernels.embedding_join import embedding_join_pallas
    from repro.kernels.support_count import support_count_pallas
    return types.SimpleNamespace(
        ops=ops, kref=kref, join=embedding_join_pallas,
        reduce=support_count_pallas, level_step=level_step, mining=mining,
        graphdb=graphdb)


def _random_level(rng, C=7, P=5, G=20, M=8, K=4, T=6, F=8, PP=1,
                  masks="random"):
    """Random-but-consistent join inputs with a leading partition axis
    (ids in [0, 32), PAD -1).  ``masks``: "random" (dense, with holes),
    "holes" (sparse) or "prefix" (each row set from slot 0, as the
    stores are, to a length uniform in [0, width])."""
    def mask(shape):
        if masks == "prefix":
            n = rng.integers(0, shape[-1] + 1, shape[:-1])
            return np.arange(shape[-1]) < n[..., None]
        return rng.random(shape) < (0.1 if masks == "holes" else 0.7)

    pol = rng.integers(0, 32, (PP, P, G, M, K)).astype(np.int32)
    pmask = mask((PP, P, G, M))
    pol = np.where(rng.random((PP, P, G, M, K)) < 0.15, -1, pol)
    src = rng.integers(0, 32, (PP, T, G, F)).astype(np.int32)
    dst = rng.integers(0, 32, (PP, T, G, F)).astype(np.int32)
    emask = mask((PP, T, G, F))
    src = np.where(emask, src, -1)
    dst = np.where(emask, dst, -1)
    meta = np.stack([rng.integers(0, P, C), rng.integers(0, K, C),
                     rng.integers(0, K, C), rng.integers(0, 2, C),
                     rng.integers(0, T, C)], axis=1).astype(np.int32)
    return meta, pol, pmask, src, dst, emask


# (shape, what the case forces) — misaligned on purpose: G % 32 != 0 and
# every G % 4, G below the JAX graph tile of 128, a single candidate,
# all-backward and all-forward rows, all-zero masks, several partitions,
# long spans of prefix masks, sparse masks, stub/to outside [0, K)
CASES = [
    pytest.param(dict(C=9, G=37), None, id="G37"),
    pytest.param(dict(C=7, G=20, M=3, K=2, F=200), None, id="G20-F200"),
    pytest.param(dict(C=1, G=45), None, id="C1"),
    pytest.param(dict(C=8, G=33, K=3), "backward", id="all-backward"),
    pytest.param(dict(C=8, G=33, K=3), "forward", id="all-forward"),
    pytest.param(dict(C=6, G=24, T=3), "no-masks", id="zero-masks"),
    pytest.param(dict(C=6, P=3, G=70, M=4, K=3, T=3, F=5, PP=3), None,
                 id="PP3-G70"),
    pytest.param(dict(C=5, G=130), None, id="G130"),
    pytest.param(dict(C=6, G=43, M=40, F=12, masks="prefix"), None,
                 id="G43-M40-prefix"),
    pytest.param(dict(C=5, G=21, M=300, K=3, F=6, masks="prefix"), None,
                 id="M300-prefix"),
    pytest.param(dict(C=7, G=35, M=48, F=20, masks="holes"), None,
                 id="M48-holes"),
    pytest.param(dict(C=8, G=27, PP=2), "slots", id="PP2-slots"),
    # a candidate table padded to its bucket with copies of [0, 0, 0, 1, 0]
    pytest.param(dict(C=12, G=37), "padded-tail", id="padded-tail"),
    # runs of equal consecutive rows, and equal rows that are not adjacent
    pytest.param(dict(C=14, G=29, PP=2), "runs", id="runs"),
]


def _case(shape, force, seed):
    rng = np.random.default_rng(seed)
    meta, pol, pmask, src, dst, emask = _random_level(rng, **shape)
    if force == "backward":
        meta[:, 3] = 0
    elif force == "forward":
        meta[:, 3] = 1
    elif force == "no-masks":
        pmask[:] = False
        emask[:] = False
    elif force == "slots":                        # stub/to outside [0, K)
        K = pol.shape[-1]
        meta[::2, 1] = K + 1
        meta[1::3, 2] = -1
        meta[2::3, 2] = K
    elif force == "padded-tail":
        meta[-5:] = [0, 0, 0, 1, 0]
    elif force == "runs":
        meta[2:5] = meta[1]                       # a run of 4
        meta[8] = meta[1]                         # equal, not adjacent
        meta[10:12] = meta[9]                     # a run of 3
        meta[13] = meta[9]
    return meta, (pol, pmask, src, dst, emask)


def _tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("shape,force", CASES)
def test_plain_versions_match_jax_kernels(ref, shape, force):
    """kernels/ref.py against the JAX refs and the JAX Pallas kernels in
    interpret mode, per partition; the port's wrappers on CPU tensors
    (the whole partition stack at once) give the same."""
    meta, stores = _case(shape, force, seed=shape["G"] + shape["C"])
    t_meta, *t_stores = _tensors(meta, *stores)
    matched_t, count_t = tej.embedding_join(t_meta, *t_stores)
    sup_t, emb_t = tsc.support_count(matched_t, count_t)
    G = shape["G"]
    tg = 8 if G % 8 == 0 else G
    for pp in range(stores[0].shape[0]):
        one = [a[pp] for a in stores]
        m_r, c_r = tref.embedding_join_ref(meta, *_tensors(*one))
        m_j, c_j = ref.kref.embedding_join_ref(meta, *one)
        m_k, c_k = ref.join(meta, one[0], one[1].astype(np.int8), one[2],
                            one[3], one[4].astype(np.int8), tile_g=tg,
                            interpret=True)
        for got in (m_r, matched_t[pp]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(m_j))
            np.testing.assert_array_equal(got.numpy(), np.asarray(m_k))
        for got in (c_r, count_t[pp]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(c_j))
            np.testing.assert_array_equal(got.numpy(), np.asarray(c_k))
        s_r, e_r = tref.support_count_ref(m_r, c_r)
        s_j, e_j = ref.kref.support_count_ref(m_j, c_j)
        s_k, e_k = ref.reduce(m_k, c_k, tile_c=shape["C"], tile_g=G,
                              interpret=True)
        for got in ((s_r, e_r), (sup_t[pp], emb_t[pp])):
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(s_j))
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(s_k))
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(e_j))
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(e_k))
    if force == "no-masks":
        assert not matched_t.any() and not count_t.any()


@pytest.mark.parametrize("shape,force", CASES[:6])
def test_level_supports_match_jax_interpret(ref, shape, force):
    """ops.level_supports: the port's "pallas" against the JAX two-launch
    pipeline in interpret mode (which pads G and C), and every other
    port backend against it."""
    meta, stores = _case(shape, force, seed=7)
    one = [a[0] for a in stores]
    s_j, e_j = ref.ops.level_supports(meta, *one, backend="interpret",
                                      tile_g=8, tile_c=4)
    for backend in tops.BACKENDS:
        s_t, e_t = tops.level_supports(meta, *_tensors(*one),
                                       backend=backend, tile_c=4)
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j),
                                      err_msg=backend)
        np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j),
                                      err_msg=backend)


def test_wrappers_check_inputs_and_use_plain_versions_on_cpu():
    meta, stores = _case(dict(C=5, G=20, PP=2), None, seed=1)
    t_meta, *t = _tensors(meta, *stores)
    tej.reset_launches()
    tsc.reset_launches()
    matched, count = tej.embedding_join(t_meta, *t)
    assert matched.shape == count.shape == (2, 5, 20)
    assert matched.dtype == count.dtype == torch.int32
    tsc.support_count(matched, count)
    assert tej.launches == {"embedding_join": 0}
    assert tsc.launches == {"support_count": 0}
    with pytest.raises(TypeError, match="meta must be int32"):
        tej.embedding_join(t_meta.to(torch.int64), *t)
    with pytest.raises(ValueError, match=r"\(C, 5\)"):
        tej.embedding_join(t_meta[:, :4].contiguous(), *t)
    with pytest.raises(ValueError, match="contiguous"):
        strided = t[0].transpose(0, 1).contiguous().transpose(0, 1)
        tej.embedding_join(t_meta, strided, *t[1:])
    with pytest.raises(ValueError, match="PP, C, G"):
        tsc.support_count(matched, count[:, :, :-1])
    with pytest.raises(TypeError, match="count must be int32"):
        tsc.support_count(matched, count.to(torch.int64))


def test_reduce_geometry():
    """One warp per row while the rows fit the card; past that the grid
    stays at REDUCE_CTAS_PER_SM CTAs per SM and strides."""
    warps = tsc.REDUCE_WARPS
    assert tsc.reduce_geometry(1, 132) == (1, warps * 32)
    assert tsc.reduce_geometry(4096, 132) == (4096 // warps, warps * 32)
    cap = 132 * tsc.REDUCE_CTAS_PER_SM
    assert tsc.reduce_geometry(20_000, 132) == (cap, warps * 32)
    assert tsc.reduce_geometry(2 ** 40, 132)[0] == cap


# (packed, reduce, sharded) of the level-wire cases
WIRE_CASES = [
    pytest.param(False, "psum", False, id="dense-psum"),
    pytest.param(True, "reduce_scatter", True, id="packed-rs-sharded"),
]


@pytest.mark.parametrize("packed,reduce,sharded", WIRE_CASES)
def test_pallas_wire_matches_jax_interpret(ref, packed, reduce, sharded):
    """The single-sync level program with backend "pallas" gives the JAX
    level program's wire with backend "interpret" word for word,
    checksum and padded tail included (the two-launch kernels compute
    the padded candidate rows in full, and the two-launch backend stays
    dense under packing), and the same child store."""
    import jax.numpy as jnp

    from repro.core.mapreduce import MiningMesh as JMesh
    from repro_torch.core import level_step as tls
    from repro_torch.core.mapreduce import MiningMesh as TMesh
    from test_torch_level_step import _data, _pad_meta

    n_graphs, meta, stores, minsup, psup = _data()
    C = meta.shape[0]
    Cp = 64 * (-(-C // 64))
    meta_p = _pad_meta(meta, Cp)
    kw = dict(minsup=minsup, reduce=reduce, max_embeddings=8,
              survivor_cap=C, child_width=8, tile_c=4, level=2,
              sharded=sharded, packed=packed, psup=psup, n_graphs=n_graphs)
    pend_j = ref.level_step.dispatch_level(
        JMesh.single_device(), meta_p, C,
        *(jnp.asarray(a) for a in stores), backend="interpret",
        rebalance=True, threshold=1.25, donate=False, **kw)
    pend_t = tls.dispatch_level(TMesh(), meta_p, C, *_tensors(*stores),
                                backend="pallas", **kw)
    wire = pend_t.wire_d.numpy()
    np.testing.assert_array_equal(wire, np.asarray(pend_j.wire_d))
    np.testing.assert_array_equal(pend_t.pol.numpy(),
                                  np.asarray(pend_j.pol))
    np.testing.assert_array_equal(pend_t.pmask.numpy(),
                                  np.asarray(pend_j.pmask))
    body = tls.reassemble_wire(wire, stores[0].shape[0], packed=packed,
                               cp=Cp)
    assert body[C:Cp].any(), "the padded rows' supports ride in the tail"
    ref_wire = tls.dispatch_level(TMesh(), meta_p, C, *_tensors(*stores),
                                  backend="ref", **kw).wire_d.numpy()
    np.testing.assert_array_equal(wire, ref_wire)


DBS = {
    # tests/test_conformance.py::conformance_db
    "conformance": ("random_db", dict(n_graphs=18, n_vertices=6,
                                      extra_edge_prob=0.35, n_vlabels=3,
                                      n_elabels=2, seed=42), 5, 3),
    "paper_toy": ("paper_toy_db", {}, 2, None),
}

# (pipeline, port backend, the JAX backend it is held against on the CPU)
ROUTES = [
    pytest.param("single_sync", "pallas", "interpret", id="ss-pallas"),
    pytest.param("legacy", "pallas", "interpret", id="legacy-pallas"),
    pytest.param("legacy", "ref", "ref", id="legacy-ref"),
    pytest.param("legacy", "fused", "fused_interpret", id="legacy-fused"),
]


def _stats(res):
    return [(s.level, s.n_candidates, s.n_frequent, s.overflow,
             s.escalations, s.retried, s.survivor_cap, s.rebalanced,
             s.imbalance) for s in res.stats]


@pytest.mark.parametrize("pipeline,backend,jax_backend", ROUTES)
@pytest.mark.parametrize("db", sorted(DBS))
def test_fit_matches_jax_and_host_oracle(ref, db, pipeline, backend,
                                         jax_backend):
    name, kw, minsup, max_size = DBS[db]
    cfg = dict(minsup=minsup, max_size=max_size, n_partitions=2,
               pipeline=pipeline)
    want = ref.mining.Mirage(ref.mining.MirageConfig(
        backend=jax_backend, **cfg)).fit(getattr(ref.graphdb, name)(**kw))
    graphs = getattr(tgraphdb, name)(**kw)
    got = tmining.Mirage(tmining.MirageConfig(backend=backend, **cfg),
                         device="cpu").fit(graphs)
    oracle = mine_host(graphs, minsup, max_size=max_size)
    assert got.supports == {c: i.support for c, i in oracle.frequent.items()}
    assert got.levels == want.levels
    assert got.supports == want.supports
    assert (got.minsup, got.total_overflow) == (want.minsup,
                                                want.total_overflow)
    assert _stats(got) == _stats(want)
    assert all(s.audit == 0 for s in got.stats)


def test_legacy_config_rules(ref):
    """The legacy pipeline stays dense and psum, as in the JAX package:
    packed support is refused, reduce resolves to psum, and the miner
    neither buckets nor packs."""
    for mod in (tmining, ref.mining):
        with pytest.raises(ValueError, match="packed_support"):
            mod.MirageConfig(minsup=2, pipeline="legacy",
                             packed_support=True)
        assert mod.MirageConfig(minsup=2, pipeline="legacy").reduce == "psum"
        assert mod.MirageConfig(minsup=2).reduce == "reduce_scatter"
        assert mod.MirageConfig(minsup=2, pipeline="legacy",
                                reduce="reduce_scatter"
                                ).reduce == "reduce_scatter"
    miner = tmining.Mirage(tmining.MirageConfig(minsup=2, pipeline="legacy"),
                           device="cpu")
    assert miner._buckets() is None
    assert miner._packed_support(10) is False
    single = tmining.Mirage(tmining.MirageConfig(minsup=2), device="cpu")
    assert single._buckets() is not None and single._packed_support(10)


def test_legacy_reduce_scatter_matches_host_oracle():
    graphs = tgraphdb.paper_toy_db()
    oracle = mine_host(graphs, 2)
    for backend in ("pallas", "fused_packed"):
        res = tmining.Mirage(tmining.MirageConfig(
            minsup=2, n_partitions=2, pipeline="legacy", backend=backend,
            reduce="reduce_scatter"), device="cpu").fit(graphs)
        assert res.supports == {c: i.support
                                for c, i in oracle.frequent.items()}


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_legacy_checkpoint_resumes_across_packages(ref, tmp_path, writer):
    """A legacy run's checkpoint (unbucketed store, K+1 vertex slots)
    written by either package at max_size=2 resumes in the other to
    max_size=3 with the uninterrupted run's frequent set."""
    db = dict(n_vertices=8, extra_edge_prob=0.5, n_vlabels=2, n_elabels=1,
              seed=7)
    jg, tg = ref.graphdb.random_db(20, **db), tgraphdb.random_db(20, **db)
    ck = str(tmp_path / "ck")
    base = dict(minsup=6, n_partitions=4, pipeline="legacy",
                backend="ref", checkpoint_dir=ck)
    full = tmining.Mirage(tmining.MirageConfig(
        minsup=6, n_partitions=4, max_size=3), device="cpu").fit(tg)
    if writer == "repro":
        ref.mining.Mirage(ref.mining.MirageConfig(max_size=2, **base)).fit(jg)
        res = tmining.Mirage(tmining.MirageConfig(max_size=3, **base),
                             device="cpu").fit(tg, resume=True)
    else:
        tmining.Mirage(tmining.MirageConfig(max_size=2, **base),
                       device="cpu").fit(tg)
        res = ref.mining.Mirage(ref.mining.MirageConfig(max_size=3, **base)
                                ).fit(jg, resume=True)
    assert res.stats[0].level == 3, "must resume, not restart"
    assert res.levels == full.levels
    assert res.supports == full.supports


def test_cli_legacy_pallas_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.mine", "--dataset",
         "paper-toy", "--minsup", "2", "--partitions", "2", "--pipeline",
         "legacy", "--backend", "pallas", "--device", "cpu"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    assert proc.returncode == 0, proc.stderr
    assert "frequent patterns: 13" in proc.stdout
    assert "pipeline=legacy" in proc.stdout and "backend=pallas" in proc.stdout


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: no CUDA device is present")


def _poison_outputs(PP, C, G):
    """Free two blocks of the join outputs' size filled with -7, so that
    the kernel's outputs (torch.empty) start as garbage: an element the
    kernel fails to write then shows."""
    junk = [torch.full((PP, C, G), -7, dtype=torch.int32, device="cuda")
            for _ in range(2)]
    torch.cuda.synchronize()
    del junk


@pytest.mark.cuda
@pytest.mark.parametrize("shape,force", CASES)
def test_cuda_two_launch_kernels_equal_plain_versions(shape, force):
    _needs_card()
    meta, stores = _case(shape, force, seed=11)
    cpu = _tensors(meta, *stores)
    gpu = [x.cuda() for x in cpu]
    _poison_outputs(gpu[1].shape[0], meta.shape[0], gpu[1].shape[2])
    before = (tej.launches["embedding_join"], tsc.launches["support_count"])
    matched, count = tej.embedding_join(*gpu)
    sup, emb = tsc.support_count(matched, count)
    torch.cuda.synchronize()
    assert (tej.launches["embedding_join"],
            tsc.launches["support_count"]) == (before[0] + 1, before[1] + 1)
    m_r, c_r = tref.embedding_join_ref(*cpu)
    assert torch.equal(matched.cpu(), m_r)
    assert torch.equal(count.cpu(), c_r)
    s_r, e_r = tref.support_count_ref(m_r, c_r)
    assert torch.equal(sup.cpu(), s_r)
    assert torch.equal(emb.cpu(), e_r)


@pytest.mark.cuda
def test_cuda_join_writes_zeros_for_a_run_outside_the_stores():
    """Meta rows outside the stores (parent >= P, triple >= T, parent < 0)
    give zeros on the card, the followers of their runs too, while the
    rows around them equal the plain version's."""
    _needs_card()
    meta, stores = _case(dict(C=8, G=45, PP=2), None, seed=5)
    P, T = stores[0].shape[1], stores[2].shape[1]
    outside = np.array([[P, 0, 1, 1, 0]] * 3 + [[0, 0, 1, 0, T]] * 2
                       + [[-1, 0, 0, 1, 0]], np.int32)
    rows = np.concatenate([meta[:4], outside, meta[4:]])
    cpu = _tensors(rows, *stores)
    gpu = [x.cuda() for x in cpu]
    _poison_outputs(2, rows.shape[0], 45)
    matched, count = tej.embedding_join(*gpu)
    torch.cuda.synchronize()
    assert not matched[:, 4:10].any() and not count[:, 4:10].any()
    inside = np.r_[0:4, 10:rows.shape[0]]
    m_r, c_r = tref.embedding_join_ref(meta, *cpu[1:])
    assert torch.equal(matched.cpu()[:, inside], m_r)
    assert torch.equal(count.cpu()[:, inside], c_r)


@pytest.mark.cuda
def test_cuda_support_count_wraps_like_int32():
    """Sums past 2^31 wrap mod 2^32 exactly as the int32 sums of the
    plain version (and of the JAX kernel) do."""
    _needs_card()
    big = torch.full((1, 2, 4), 2 ** 30, dtype=torch.int32)
    big[0, 1] = -7
    sup, emb = tsc.support_count(big.cuda(), big.cuda())
    s_r, e_r = tref.support_count_ref(big, big)
    assert torch.equal(sup.cpu(), s_r) and torch.equal(emb.cpu(), e_r)
    assert int(s_r[0, 0]) == 0 and int(s_r[0, 1]) == -28


# (PP, C, G, offset of the data pointer in int32 elements)
REDUCE_CASES = [
    pytest.param(1, 5, 43, 0, id="G43"),            # G % 4 == 3
    pytest.param(2, 7, 1001, 1, id="offset4B"),     # data_ptr % 16 == 4
    pytest.param(1, 3, 2, 3, id="G2-offset12B"),    # rows shorter than a vector
    pytest.param(4, 5000, 3, 1, id="rows-past-grid"),
    pytest.param(2, 9, 5000, 2, id="G5000-offset8B"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("PP,C,G,offset", REDUCE_CASES)
def test_cuda_support_count_misaligned_and_strided(PP, C, G, offset):
    """Rows that do not start 16-byte aligned (G % 4 != 0, a contiguous
    tensor whose data pointer is offset) and more rows than the grid has
    warps: exact against the plain version, no copy."""
    _needs_card()
    rng = np.random.default_rng(G + offset)
    n = PP * C * G
    flat = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, 2 * (n + offset),
                                         dtype=np.int64).astype(np.int32))
    m_buf, c_buf = flat.cuda().split(n + offset)
    matched = m_buf[offset:].view(PP, C, G)
    count = c_buf[offset:].view(PP, C, G)
    assert matched.is_contiguous() and matched.data_ptr() % 16 == 4 * offset
    before = tsc.launches["support_count"]
    sup, emb = tsc.support_count(matched, count)
    torch.cuda.synchronize()
    assert tsc.launches["support_count"] == before + 1
    s_r, e_r = tref.support_count_ref(matched.cpu(), count.cpu())
    assert torch.equal(sup.cpu(), s_r) and torch.equal(emb.cpu(), e_r)


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", ["single_sync", "legacy"])
def test_cuda_pallas_fit_matches_host_oracle(pipeline):
    _needs_card()
    graphs = tgraphdb.paper_toy_db()
    oracle = mine_host(graphs, 2)
    res = tmining.Mirage(tmining.MirageConfig(
        minsup=2, n_partitions=2, pipeline=pipeline, backend="pallas")
    ).fit(graphs)
    assert res.supports == {c: i.support for c, i in oracle.frequent.items()}


def test_ctypes_signatures_match_the_sources():
    """The argument counts bound with ctypes match the C entry points of
    every CUDA source (a mismatch only shows when a kernel launches)."""
    import re

    from repro_torch.kernels import build
    found, names = {}, {}
    for path in sorted(build._CSRC.glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (\w+)\((.*?)\)',
                                       path.read_text(), re.S):
            kinds = [p.strip().rsplit(" ", 1)[0] for p in params.split(",")]
            names[name] = [p.strip().rsplit(" ", 1)[1]
                           for p in params.split(",")]
            assert kinds[-1] == "void*", f"{name}: the stream comes last"
            n_ptr = sum(k.endswith("void*") for k in kinds[:-1])
            assert kinds[n_ptr:-1] == ["int"] * (len(kinds) - 1 - n_ptr)
            found[name] = (n_ptr, len(kinds) - 1 - n_ptr)
    assert found == build._ENTRIES
    # the three joins take their geometry from build.join_geometry
    for name in ("fused_level_packed_launch", "fused_level_launch",
                 "embedding_join_launch"):
        assert names[name][-3:] == ["threads", "smem", "stream"], name
