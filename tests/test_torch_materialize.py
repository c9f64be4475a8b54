"""Pass 2's one launch a level, ``kernels.materialize.materialize_level``:
its plain version against the JAX package's ``materialize_one`` slot by
slot (the slots at or past ``n_keep`` PAD, false and without overflow),
and on a card the CUDA kernel against the plain version, bit for bit, on
the child store, its mask and the per-slot overflow; ``materialize_ol``
through the kernel against its plain path; and a single-sync fit on the
card against ``mine_host`` with one launch per dispatched level.  The
JAX package comes in through the ``ref`` fixture, so that on a GPU
machine without JAX ``pytest -m cuda tests/test_torch_materialize.py``
still imports this file and runs the CUDA cases."""
import numpy as np
import pytest
import torch

from repro_torch.core import embedding as temb
from repro_torch.kernels import materialize as tmat

PAD = -1


@pytest.fixture(scope="module")
def ref():
    """The JAX package's embedding module."""
    from repro.core import embedding
    return embedding


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: no CUDA device is present")


def _masks(rng, shape, kind):
    """"random" (dense, with holes), "holes" (sparse), "prefix" (each
    row set from slot 0, as the stores are) or "empty"."""
    if kind == "empty":
        return np.zeros(shape, bool)
    if kind == "prefix":
        n = rng.integers(0, shape[-1] + 1, shape[:-1])
        return np.arange(shape[-1]) < n[..., None]
    return rng.random(shape) < (0.1 if kind == "holes" else 0.7)


def _inputs(seed, S=6, P=4, G=13, M=6, K=3, T=4, F=7, PP=2, ids=6,
            masks="random", pmasks=None):
    """Random stores with vertex ids in [0, ids) (few ids, so that joins
    and overflows are common; PAD -1 sprinkled in) and S candidate rows
    of either direction with stub and to inside [0, K)."""
    rng = np.random.default_rng(seed)
    pol = rng.integers(0, ids, (PP, P, G, M, K)).astype(np.int32)
    pol = np.where(rng.random(pol.shape) < 0.1, PAD, pol).astype(np.int32)
    pmask = _masks(rng, (PP, P, G, M), pmasks or masks)
    src = rng.integers(0, ids, (PP, T, G, F)).astype(np.int32)
    dst = rng.integers(0, ids, (PP, T, G, F)).astype(np.int32)
    emask = _masks(rng, (PP, T, G, F), masks)
    cmeta = np.stack([rng.integers(0, P, S), rng.integers(0, K, S),
                      rng.integers(0, K + 1, S), rng.integers(0, 2, S),
                      rng.integers(0, T, S)], axis=1).astype(np.int32)
    return cmeta, (pol, pmask, src, dst, emask)


# (id, shape, what the case forces, n_keep as a function of S, Mc, W - K)
CASES = [
    pytest.param(dict(), None, lambda S: S, 4, 1, id="mixed"),
    pytest.param(dict(), "forward", lambda S: S, 4, 1, id="forward"),
    pytest.param(dict(), "backward", lambda S: S, 4, 1, id="backward"),
    pytest.param(dict(K=4), "to-inside", lambda S: S, 4, 0, id="W=K"),
    pytest.param(dict(K=3), "to-past-W", lambda S: S, 4, 1, id="to>=W"),
    pytest.param(dict(), "slots-outside", lambda S: S, 4, 1,
                 id="stub-to-outside"),
    pytest.param(dict(M=8, F=9, ids=3), None, lambda S: S, 2, 1,
                 id="overflow"),
    pytest.param(dict(), None, lambda S: 0, 4, 1, id="n_keep=0"),
    pytest.param(dict(), None, lambda S: 1, 4, 1, id="n_keep=1"),
    pytest.param(dict(), None, lambda S: S - 1, 4, 1, id="n_keep=S-1"),
    pytest.param(dict(), None, lambda S: S + 5, 4, 1, id="n_keep>S"),
    pytest.param(dict(PP=1, G=40), None, lambda S: S - 2, 3, 1, id="PP1"),
    pytest.param(dict(PP=8, G=21, S=5), None, lambda S: 3, 4, 1,
                 id="PP8"),
    pytest.param(dict(PP=32, G=9, S=4), None, lambda S: 2, 4, 1,
                 id="PP32"),
    pytest.param(dict(G=5), None, lambda S: S, 4, 1, id="G5"),
    pytest.param(dict(G=37, masks="prefix"), None, lambda S: S, 8, 1,
                 id="G37-prefix"),
    pytest.param(dict(pmasks="empty"), None, lambda S: S, 4, 1,
                 id="empty-parent-masks"),
    pytest.param(dict(F=40, M=3), None, lambda S: S, 16, 1, id="F40"),
    pytest.param(dict(F=70, M=5, G=9, masks="prefix", ids=4), "backward",
                 lambda S: S, 6, 1, id="F70-backward"),
    pytest.param(dict(M=50, F=5, masks="holes", ids=4), None, lambda S: S,
                 8, 1, id="M50-holes"),
    pytest.param(dict(M=33, F=33, G=6, ids=3), None, lambda S: S, 40, 2,
                 id="M33-F33-wide"),
]


def _case(shape, force, seed):
    cmeta, stores = _inputs(seed, **shape)
    K = stores[0].shape[-1]
    if force == "forward":
        cmeta[:, 3] = 1
    elif force == "backward":
        cmeta[:, 3] = 0
    elif force == "to-inside":                  # bucketed: W = K
        cmeta[:, 3] = 1
        cmeta[:, 2] = K - 1
    elif force == "to-past-W":                  # to at and past W = K + 1
        cmeta[:, 3] = 1
        cmeta[::2, 2] = K + 1
        cmeta[1::2, 2] = K + 4
    elif force == "slots-outside":              # stub/to outside [0, K)
        cmeta[::2, 1] = K + 1
        cmeta[1::3, 1] = -1
        cmeta[1::3, 2] = -1
        cmeta[2::3, 2] = K + 2
    return cmeta, stores


def _tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _run(cmeta, stores, n_keep, Mc, W, device="cpu"):
    t = [x.to(device) for x in _tensors(cmeta, *stores)]
    nk = torch.tensor(n_keep, dtype=torch.int32, device=device)
    return tmat.materialize_level(t[0], nk, *t[1:], max_embeddings=Mc,
                                  out_width=W)


@pytest.mark.parametrize("shape,force,n_keep,Mc,dw", CASES)
def test_plain_version_equals_jax_per_slot(ref, shape, force, n_keep, Mc,
                                           dw):
    """On CPU tensors the wrapper runs its plain version: each live slot
    is the JAX package's ``materialize_one`` of its row, per partition,
    and each dead slot is PAD, false and no overflow."""
    import jax.numpy as jnp
    cmeta, stores = _case(shape, force, seed=len(str(shape)) + Mc)
    S, K = cmeta.shape[0], stores[0].shape[-1]
    W, nk = K + dw, n_keep(S)
    ol, mask, over = _run(cmeta, stores, nk, Mc, W)
    PP, _, G = stores[0].shape[:3]
    assert ol.shape == (PP, S, G, Mc, W) and mask.shape == (PP, S, G, Mc)
    assert over.shape == (S,) and over.dtype == torch.int32
    for s in range(S):
        if s >= nk:
            assert (ol[:, s] == PAD).all() and not mask[:, s].any()
            assert int(over[s]) == 0
            continue
        total = 0
        for pp in range(PP):
            pol, pmask, src, dst, emask = (jnp.asarray(a[pp])
                                           for a in stores)
            ch, mk, ov = ref.materialize_one(
                ref.LevelOL(pol, pmask), src, dst, emask,
                jnp.asarray(cmeta[s]), max_embeddings=Mc, out_width=W)
            np.testing.assert_array_equal(ol[pp, s].numpy(), np.asarray(ch))
            np.testing.assert_array_equal(mask[pp, s].numpy(),
                                          np.asarray(mk))
            total += int(ov)
        assert int(over[s]) == total


def test_plain_version_takes_any_leading_dims_and_checks_inputs():
    """No leading dims gives the (S, G, Mc, W) store of the stacked one's
    partition; a bad shape or dtype raises before any work."""
    cmeta, stores = _inputs(3, PP=1)
    ol, mask, over = _run(cmeta, stores, 4, 4, 4)
    one = [a[0] for a in stores]
    ol1, mask1, over1 = _run(cmeta, one, 4, 4, 4)
    assert torch.equal(ol1, ol[0]) and torch.equal(mask1, mask[0])
    assert torch.equal(over1, over)
    t = _tensors(cmeta, *stores)
    nk = torch.tensor(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="below parent vertex width"):
        tmat.materialize_level(t[0], nk, *t[1:], max_embeddings=4,
                               out_width=2)
    with pytest.raises(ValueError, match=r"must be \(S, 5\)"):
        tmat.materialize_level(t[0][:, :4], nk, *t[1:], max_embeddings=4)
    with pytest.raises(ValueError, match="0-dim"):
        tmat.materialize_level(t[0], nk.reshape(1), *t[1:],
                               max_embeddings=4)
    with pytest.raises(TypeError, match="int32"):
        tmat.materialize_level(t[0], nk.long(), *t[1:], max_embeddings=4)


def _poisoned(*shapes_dtypes):
    """Fill blocks of the outputs' sizes with a poison byte and free them,
    so that the caching allocator hands them to the wrapper's outputs:
    an element the kernel does not write then shows."""
    torch.cuda.synchronize()
    bufs = [torch.full(s, 0x5A, dtype=torch.uint8, device="cuda")
            for s in shapes_dtypes]
    torch.cuda.synchronize()
    del bufs


@pytest.mark.cuda
@pytest.mark.parametrize("shape,force,n_keep,Mc,dw", CASES)
def test_cuda_kernel_equals_plain_version(shape, force, n_keep, Mc, dw):
    _needs_card()
    cmeta, stores = _case(shape, force, seed=len(str(shape)) + Mc + 1)
    S, K = cmeta.shape[0], stores[0].shape[-1]
    W, nk = K + dw, n_keep(S)
    PP, _, G = stores[0].shape[:3]
    _poisoned((PP * S * G * Mc * W * 4,), (PP * S * G * Mc,))
    before = tmat.launches["materialize_level"]
    got = _run(cmeta, stores, nk, Mc, W, device="cuda")
    torch.cuda.synchronize()
    assert tmat.launches["materialize_level"] == before + 1
    want = _run(cmeta, stores, nk, Mc, W)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("lead", [True, False], ids=["PP3", "no-lead"])
def test_cuda_materialize_ol_equals_plain_path(lead):
    _needs_card()
    cmeta, stores = _inputs(5, S=7, PP=3, G=19, M=9, F=11)
    if not lead:
        stores = [a[1] for a in stores]
    t = _tensors(*stores)
    outs = []
    for dev in ("cuda", "cpu"):
        x = [a.to(dev) for a in t]
        before = tmat.launches["materialize_level"]
        lvl, over = temb.materialize_ol(temb.LevelOL(x[0], x[1]), *x[2:],
                                        cmeta, max_embeddings=5)
        assert tmat.launches["materialize_level"] == before + (dev == "cuda")
        outs.append((lvl.ol.cpu(), lvl.mask.cpu(), over.cpu()))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_single_sync_fit_equals_mine_host_one_launch_a_level(
        monkeypatch):
    """A single-sync fit on the card equals ``mine_host``, and pass 2
    launches the kernel once per dispatched level (the DB and M are
    chosen so that no level retries)."""
    _needs_card()
    from repro_torch.core import graphdb
    from repro_torch.core import mining as tmining
    from repro_torch.core.host_miner import mine_host
    graphs = graphdb.pubchem_like_db(60, seed=3, avg_edges=12)
    dispatched = []
    real = tmining.dispatch_level

    def counted(*a, **kw):
        dispatched.append(kw.get("level"))
        return real(*a, **kw)

    monkeypatch.setattr(tmining, "dispatch_level", counted)
    before = tmat.launches["materialize_level"]
    res = tmining.Mirage(tmining.MirageConfig(
        minsup=12, n_partitions=4, max_embeddings=256)).fit(graphs)
    torch.cuda.synchronize()
    want = mine_host(graphs, 12)
    assert res.supports == {c: i.support for c, i in want.frequent.items()}
    assert not any(s.retried or s.escalations for s in res.stats)
    assert len(dispatched) >= 2
    assert tmat.launches["materialize_level"] - before == len(dispatched)


@pytest.mark.cuda
def test_cuda_device_loop_fit_equals_mine_host_one_launch_a_body():
    """A device-loop fit on the card equals ``mine_host``, and each level
    body launches pass 2's kernel once, the bodies past the run's end
    too."""
    _needs_card()
    from repro_torch.core import mining as tmining
    from repro_torch.core.graphdb import random_db
    from repro_torch.core.host_miner import mine_host
    graphs = random_db(18, n_vertices=6, extra_edge_prob=0.35, n_vlabels=3,
                       n_elabels=2, seed=42)
    before = tmat.launches["materialize_level"]
    miner = tmining.Mirage(tmining.MirageConfig(
        pipeline="device_loop", minsup=3, n_partitions=2, max_size=4))
    res = miner.fit(graphs)
    torch.cuda.synchronize()
    want = mine_host(graphs, 3, max_size=4)
    assert res.supports == {c: i.support for c, i in want.frequent.items()}
    info = miner.last_device_loop
    assert info is not None and info["completed"]
    bodies = (info["escalations"] + 1) * info["n_levels"]
    assert tmat.launches["materialize_level"] - before == bodies
