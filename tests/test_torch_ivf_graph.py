"""The port's kNN-graph refinement of the IVF index against the JAX
package's, on the CPU.

The graph build's device program, `block_knn_plain` (N1's plain version,
cortex_tpu_torch/ops/knn_graph.py), is held to the reference's
`_block_knn` per chunk, and `build_knn_graph` to the reference's, on the
same layout (carried across with IvfCorpus.load_jax_state). Tolerance:
the lists are equal wherever the scores next to an entry differ by more
than 1e-6. The int8 products are exact in both; the y . mu term (mud) is
an f32 matrix-vector product that XLA and torch sum in different orders,
so scores may differ in their last bits and swap a near-tie.

Then every single-device case of tests/test_ivf_graph.py on the port
(refinement, mutation, lifecycle without snapshots, the background build,
the refine flag, config wiring), and the parity of refined search: an
index loaded through load_jax_state from the reference's state(), graph
included, returns the reference's top-10 (ids equal, scores within 1e-5).
The JAX index runs its Pallas search path in interpret mode.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cortex_tpu_torch.vector.ivf as port_ivf
from cortex_tpu.ops import ivf_gather as jax_gather
from cortex_tpu.vector import knn_graph as ref_kg
from cortex_tpu.vector.index import BruteForceIndex
from cortex_tpu.vector.ivf import (IvfCorpus, TpuIvfIndex, _ivf_search_pallas,
                                   _ivf_search_pallas_hostbias)
from cortex_tpu.vector import VectorFilter
from cortex_tpu_torch.ops import knn_graph as port_ops
from cortex_tpu_torch.vector import TorchIvfIndex
from cortex_tpu_torch.vector import VectorFilter as TorchVectorFilter
from cortex_tpu_torch.vector import knn_graph as port_kg

DIM = 32
ATOL = 1e-5
NEAR_TIE = 1e-6


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setattr(jax_gather, "INTERPRET", True)
    monkeypatch.setattr(IvfCorpus, "_use_pallas", lambda self, cap: True)
    yield
    jax_gather.probed_scores.clear_cache()
    _ivf_search_pallas.clear_cache()
    _ivf_search_pallas_hostbias.clear_cache()


def clustered(n=600, noise=0.5, seed=1, dim=DIM, nc=20):
    """tests/test_ivf_graph.py's corpus: nc Gaussian centers, unit rows."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(nc, dim)).astype(np.float32)
    asg = rng.integers(0, nc, n)
    vecs = (centers[asg]
            + noise * rng.normal(size=(n, dim)).astype(np.float32))
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    ids = [f"n{i:04d}" for i in range(n)]
    return ids, vecs, rng


def brute(ids, vecs, kinds=None, agents=None):
    bf = BruteForceIndex(DIM)
    for i in range(len(ids)):
        bf.insert(ids[i], vecs[i],
                  kind=kinds[i] if kinds else None,
                  source_agent=agents[i] if agents else None)
    return bf


def recall_at10(idx, bf, q):
    got = idx.search_batch(q, 10)
    want = bf.search_batch(q, 10)
    hit = tot = 0
    for g, w in zip(got, want):
        gs = {i for i, _ in g if i}
        ws = {i for i, _ in w if i}
        hit += len(gs & ws)
        tot += len(ws)
    return hit / max(1, tot)


def port_index(**kw):
    return TorchIvfIndex(DIM, device="cpu", **kw)


def carried(n=400, nc=8, noise=0.6, nlist=8, nprobe=2, degree=16,
            kinds=None, agents=None, keep_graph=True, seed=1):
    """(reference index trained on clustered data, its state(), the port
    index loaded from that state, ids, vecs): the same layout in both."""
    ids, vecs, _ = clustered(n=n, nc=nc, noise=noise, seed=seed)
    ref = TpuIvfIndex(DIM, nlist=nlist, nprobe=nprobe, graph_degree=degree)
    ref.insert_batch(ids, vecs, kinds=kinds, agents=agents)
    ref._corpus.sync()
    st = ref._corpus.state()
    if not keep_graph:
        st.pop("ivf_nbrs", None)
    port = port_index(nlist=nlist, nprobe=nprobe, graph_degree=degree)
    port._corpus.load_jax_state(st)
    port._corpus.sync()
    return ref, st, port, ids, vecs


def plain_scores(emb_i8, rinv, slot_rows, mud):
    """N1's masked [ch, L, L] score plane, as block_knn_plain computes it."""
    s = port_ops.block_self_dot(emb_i8)
    s = s * rinv[:, :, None] * rinv[:, None, :] + mud[:, None, :]
    live = slot_rows >= 0
    eye = torch.eye(s.shape[1], dtype=torch.bool)
    return torch.where(live[:, None, :] & ~eye[None], s,
                       torch.full_like(s, -1e30))


def near_tie_free(scores, r):
    """[ch, L, r] bool: list positions whose score differs from both
    neighbours' (in the full descending order) by more than NEAR_TIE."""
    v = torch.sort(scores, dim=2, descending=True).values.numpy()
    gap_prev = np.full(v.shape, np.inf)
    gap_prev[:, :, 1:] = v[:, :, :-1] - v[:, :, 1:]
    gap_next = np.full(v.shape, np.inf)
    gap_next[:, :, :-1] = v[:, :, :-1] - v[:, :, 1:]
    return ((gap_prev > NEAR_TIE) & (gap_next > NEAR_TIE))[:, :, :r]


# ------------------------------------------------ N1's plain version


def layout_of(port):
    co = port._corpus
    _, emb, rinv, rows, _, _ = co._ivf_dev
    return co, emb, rinv, rows


@pytest.mark.parametrize("r", [1, 16, 63])
def test_block_knn_plain_matches_reference_per_chunk(r):
    ref, _, port, _, _ = carried(degree=16)
    co, emb, rinv, rows = layout_of(port)
    c, lcap = emb.shape[0], emb.shape[1]
    r = min(r, lcap - 1)
    ch = min(4, c)
    mu = torch.from_numpy(co._quant_mu)
    checked = 0
    for s in range(0, c, ch):
        s = min(s, c - ch)
        blk, ri, sr = emb[s:s + ch], rinv[s:s + ch], rows[s:s + ch]
        mud = port_ops.slot_mu_dot(blk, ri, mu)
        got = port_ops.block_knn_plain(blk, ri, sr, mud, r).numpy()
        want = np.asarray(ref_kg._block_knn(
            jnp.asarray(emb.numpy()), jnp.asarray(rinv.numpy()),
            jnp.asarray(rows.numpy()), jnp.asarray(co._quant_mu),
            jnp.int32(s), ch=ch, r=r))
        sure = near_tie_free(plain_scores(blk, ri, sr, mud), r)
        np.testing.assert_array_equal(got[sure], want[sure])
        checked += int(sure.sum())
    assert checked > 0.9 * c * lcap * r


def test_block_knn_plain_masks_self_dead_and_past_the_live_count():
    """Self and empty slots never appear; past the live count the list
    is -1, as the reference's top_k over NEG_INF gives."""
    rng = np.random.default_rng(5)
    ch, lcap, d, r = 3, 13, 20, 12
    emb = torch.from_numpy(rng.integers(-127, 128, (ch, lcap, d),
                                        dtype=np.int8))
    rinv = torch.from_numpy(rng.uniform(1e-3, 1e-2, (ch, lcap))
                            .astype(np.float32))
    rows = torch.from_numpy(rng.permutation(ch * lcap).astype(np.int32)
                            .reshape(ch, lcap))
    rows[0, 5:] = -1                          # 5 live slots in cluster 0
    rows[1, ::2] = -1
    mud = torch.from_numpy(rng.normal(size=(ch, lcap)).astype(np.float32))
    got = port_ops.block_knn_plain(emb, rinv, rows, mud, r).numpy()
    for c in range(ch):
        for i in range(lcap):
            lst = got[c, i]
            live = [int(x) for x in rows[c].numpy() if x >= 0
                    and x != int(rows[c, i])]
            n_live = len(live)
            assert (lst[:min(r, n_live)] >= 0).all()
            assert (lst[min(r, n_live):] == -1).all()
            assert set(lst[lst >= 0].tolist()) <= set(live)
            assert len(set(lst[lst >= 0].tolist())) == min(r, n_live)


def test_block_knn_plain_ties_go_to_the_lower_slot():
    """Equal scores rank by slot, as lax.top_k ranks them, on the same
    inputs as the reference's _block_knn: every score tied (zero rows,
    so mud = emb . mu = 0), and exact ties through the int8 product
    (duplicated nonzero rows). rinv are powers of two and mu holds
    multiples of 2^-6, so every product and sum is exact in both
    frameworks and no near-tie can swap: the lists compare whole."""
    ch, lcap, d = 1, 9, 4
    emb = torch.zeros((ch, lcap, d), dtype=torch.int8)
    rinv = torch.full((ch, lcap), 0.01)
    rows = torch.arange(100, 100 + lcap, dtype=torch.int32)[None]
    mu = torch.zeros(d)
    got = port_ops.block_knn_plain(emb, rinv, rows,
                                   port_ops.slot_mu_dot(emb, rinv, mu), 8)
    want = np.asarray(ref_kg._block_knn(
        jnp.asarray(emb.numpy()), jnp.asarray(rinv.numpy()),
        jnp.asarray(rows.numpy()), jnp.asarray(mu.numpy()), jnp.int32(0),
        ch=1, r=8))
    assert want[0, 0].tolist() == [101, 102, 103, 104, 105, 106, 107, 108]
    np.testing.assert_array_equal(got.numpy(), want)

    # duplicated nonzero rows: slot 2 k + 1 repeats slot 2 k, so every
    # list holds exact ties of the int8 product, mud included
    rng = np.random.default_rng(7)
    ch, lcap, d = 3, 24, 16
    half = rng.integers(-20, 21, (ch, lcap // 2, d)).astype(np.int8)
    emb = torch.from_numpy(np.repeat(half, 2, axis=1))
    rinv = torch.from_numpy(np.repeat(
        2.0 ** -rng.integers(5, 9, (ch, lcap // 2)), 2, axis=1)
        .astype(np.float32))
    rows = torch.from_numpy(rng.permutation(ch * lcap).astype(np.int32)
                            .reshape(ch, lcap))
    rows[1, 5] = -1                           # a dead slot
    mu = torch.from_numpy(rng.integers(-8, 9, d).astype(np.float32) / 64)
    mud = port_ops.slot_mu_dot(emb, rinv, mu)
    s = plain_scores(emb, rinv, rows, mud)
    srt = torch.sort(s, dim=2, descending=True).values
    assert int((srt[:, :, :-1] == srt[:, :, 1:]).sum()) > ch * lcap
    for r in (1, 7, 23):
        got = port_ops.block_knn_plain(emb, rinv, rows, mud, r)
        want = np.asarray(ref_kg._block_knn(
            jnp.asarray(emb.numpy()), jnp.asarray(rinv.numpy()),
            jnp.asarray(rows.numpy()), jnp.asarray(mu.numpy()),
            jnp.int32(0), ch=ch, r=r))
        np.testing.assert_array_equal(got.numpy(), want)
        # N1's wrapper on these (CPU) tensors gives the same lists
        assert torch.equal(port_ops.block_knn(emb, rinv, rows, mud, r), got)


def test_block_knn_wrapper_dispatch():
    """CPU tensors run the plain version without counting a launch;
    another device raises (no fallback)."""
    rng = np.random.default_rng(2)
    emb = torch.from_numpy(rng.integers(-127, 128, (2, 7, 16), dtype=np.int8))
    rinv = torch.full((2, 7), 0.01)
    rows = torch.arange(14, dtype=torch.int32).reshape(2, 7)
    mud = torch.zeros(2, 7)
    before = port_ops.block_knn.launches
    out = port_ops.block_knn(emb, rinv, rows, mud, 4)
    assert port_ops.block_knn.launches == before
    assert torch.equal(out, port_ops.block_knn_plain(emb, rinv, rows, mud, 4))
    assert out.dtype == torch.int32 and tuple(out.shape) == (2, 7, 4)
    with pytest.raises(RuntimeError, match="no kernel"):
        port_ops.block_knn(emb.to("meta"), rinv.to("meta"), rows.to("meta"),
                           mud.to("meta"), 4)


def test_build_knn_graph_matches_reference_spills_included():
    _, _, port, _, _ = carried(n=500, nc=10, nlist=8, degree=16)
    co, emb, rinv, rows = layout_of(port)
    live = np.where(co._live_h)[0].astype(np.int32)
    kw = dict(degree=16, cap=co._cap, rows=live, cluster_of=co._cluster_of,
              slot_of=co._slot_of, cluster_of2=co._cluster_of2,
              slot_of2=co._slot_of2)
    assert (co._cluster_of2[live] >= 0).any()          # spill engaged
    got = port_kg.build_knn_graph(emb, rinv, rows, co._quant_mu, **kw)
    want = ref_kg.build_knn_graph(
        jnp.asarray(emb.numpy()), jnp.asarray(rinv.numpy()),
        jnp.asarray(rows.numpy()), co._quant_mu, **kw)
    # host arrays (the background build's input) give the same table
    host = port_kg.build_knn_graph(emb.numpy(), rinv.numpy(), rows.numpy(),
                                   co._quant_mu, **kw)
    np.testing.assert_array_equal(host, got)
    # rows whose per-slot lists hold no near-tie must be equal
    mu = torch.from_numpy(co._quant_mu)
    mud = port_ops.slot_mu_dot(emb, rinv, mu)
    sure = near_tie_free(plain_scores(emb, rinv, rows, mud), 15).all(axis=2)
    ok1 = sure[co._cluster_of[live], co._slot_of[live]]
    has2 = co._cluster_of2[live] >= 0
    ok2 = np.ones(len(live), bool)
    ok2[has2] = sure[co._cluster_of2[live][has2], co._slot_of2[live][has2]]
    clean = live[ok1 & ok2]
    assert len(clean) > 0.9 * len(live)
    assert has2[ok1 & ok2].any()
    np.testing.assert_array_equal(got[clean], want[clean])
    assert (got[live] >= 0).any(axis=1).all()


def _numpy_merge(nl, *, degree, cap, rows, cluster_of, slot_of,
                 cluster_of2, slot_of2):
    """The reference's host merge (cortex_tpu/vector/knn_graph.py::
    build_knn_graph after its fetch) over [C, L, r0] lists."""
    out = np.full((cap, degree), -1, np.int32)
    prim = nl[cluster_of[rows], slot_of[rows]]
    has2 = cluster_of2[rows] >= 0
    solo = ~has2
    if solo.any():
        p = prim[solo]
        out[rows[solo], :p.shape[1]] = p[:, :degree]
    if has2.any():
        rs = rows[has2]
        sec = nl[cluster_of2[rs], slot_of2[rs]]
        a = prim[has2]
        cand = np.empty((len(a), 2 * a.shape[1]), np.int32)
        cand[:, 0::2] = a
        cand[:, 1::2] = sec
        valid = ref_kg.dedup_keep_first(cand, (cand >= 0)
                                        & (cand != rs[:, None]))
        comp = np.argsort(~valid, axis=1, kind="stable")[:, :degree]
        res = np.take_along_axis(np.where(valid, cand, -1), comp, axis=1)
        out[rs, :res.shape[1]] = res
    return out


def _merge_case(seed, c=7, lcap=12, r0=6, cap=90, n=50, spill=25):
    """Seeded per-slot lists: n live rows in distinct slots, `spill` of
    them with a second slot; -1 entries, a spilled row's own id in its
    lists, and its two lists sharing entries (in order and not)."""
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.choice(cap, n, replace=False)).astype(np.int32)
    maps = {k: np.full(cap, -1, np.int32) for k in (
        "cluster_of", "slot_of", "cluster_of2", "slot_of2")}
    cells = rng.permutation(c * lcap)
    maps["cluster_of"][rows], maps["slot_of"][rows] = divmod(cells[:n], lcap)
    sp = rows[rng.permutation(n)[:spill]]
    maps["cluster_of2"][sp], maps["slot_of2"][sp] = divmod(
        cells[n:n + spill], lcap)
    nl = rng.integers(0, cap, (c, lcap, r0)).astype(np.int32)
    nl[rng.random(nl.shape) < 0.2] = -1
    for k, row in enumerate(sp):
        l1 = nl[maps["cluster_of"][row], maps["slot_of"][row]]
        l2 = nl[maps["cluster_of2"][row], maps["slot_of2"][row]]
        l2[k % r0] = l1[(k + 1) % r0]            # shared across the two
        l2[(k + 2) % r0] = l1[(k + 2) % r0]      # at the same position
        l1[(k + 3) % r0] = row                   # the row itself
    return nl, rows, maps


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("degree", [6, 16])
def test_device_merge_equals_the_numpy_merge(seed, degree):
    """merge_lists (torch, here on the CPU) gives the reference's numpy
    merge's table, also read through a list_of map whose final chunk
    overlaps the one before (as build_knn_graph's chunks do). degree 16
    > 2 r0: the spilled rows' table rows keep -1 past their 12 slots."""
    nl, rows, maps = _merge_case(seed)
    kw = dict(degree=degree, cap=90, rows=rows, **maps)
    want = _numpy_merge(nl, **kw)
    ident = np.arange(len(nl))
    got = port_kg.merge_lists(torch.from_numpy(nl), ident, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # chunks of 4 clusters starting at 0 and 3: cluster 3 in both
    big = torch.from_numpy(np.concatenate([nl[0:4], nl[3:7]]))
    list_of = np.concatenate([np.arange(3), np.arange(4, 8)])
    np.testing.assert_array_equal(
        port_kg.merge_lists(big, list_of, **kw).numpy(), want)
    spilled = rows[maps["cluster_of2"][rows] >= 0]
    assert not (want[spilled] == spilled[:, None]).any()   # self dropped


@pytest.mark.parametrize("seed", [3, 4])
def test_dedup_keep_first_torch_equals_numpy(seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(-1, 6, (40, 12)).astype(np.int32)
    valid = (vals >= 0) & (rng.random(vals.shape) < 0.8)
    want = ref_kg.dedup_keep_first(vals, valid)
    np.testing.assert_array_equal(port_kg.dedup_keep_first(vals, valid),
                                  want)
    got = port_kg.dedup_keep_first_torch(torch.from_numpy(vals),
                                         torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), want)


def test_build_knn_graph_stats_split():
    """build_knn_graph reports its device, merge and fetch seconds."""
    _, _, port, _, _ = carried(n=300, nc=8, nlist=4, degree=8)
    co, emb, rinv, rows = layout_of(port)
    live = np.where(co._live_h)[0].astype(np.int32)
    stats = {}
    out = port_kg.build_knn_graph(
        emb, rinv, rows, co._quant_mu, degree=8, cap=co._cap, rows=live,
        cluster_of=co._cluster_of, slot_of=co._slot_of,
        cluster_of2=co._cluster_of2, slot_of2=co._slot_of2, stats=stats)
    assert out.shape == (co._cap, 8) and out.dtype == np.int32
    for k in ("device_s", "merge_s", "fetch_s"):
        assert stats[k] >= 0.0
    assert stats["chunks"] >= 1 and stats["r"] == 8


# ------------------------------------ tests/test_ivf_graph.py, ported


class TestGraphBuild:
    def test_single_cluster_graph_is_exact_knn(self):
        """nlist=1: every row shares the one block, so the built graph
        must equal the true kNN graph (int8-noise ties aside)."""
        ids, vecs, _ = clustered(n=120, nc=1, noise=1.0)
        idx = port_index(nlist=1, nprobe=1, graph_degree=8)
        idx.insert_batch(ids, vecs)
        idx.search_batch(vecs[:1], 3)         # sync -> _build_ivf
        co = idx._corpus
        assert co._nbrs_h is not None
        rows = np.array([co._row_of[i] for i in ids])
        inv = np.full(co._cap, -1, np.int64)
        inv[rows] = np.arange(len(ids))
        s = vecs @ vecs.T
        np.fill_diagonal(s, -2)
        true8 = np.argsort(-s, axis=1)[:, :8]
        agree = 0
        for j in range(len(ids)):
            got = set(inv[co._nbrs_h[rows[j]][co._nbrs_h[rows[j]] >= 0]])
            agree += len(got & set(true8[j])) / 8
        assert agree / len(ids) > 0.95

    def test_spilled_rows_merge_two_lists(self):
        ids, vecs, _ = clustered(n=400, nc=8, noise=0.6)
        idx = port_index(nlist=8, nprobe=8, graph_degree=16)
        idx.insert_batch(ids, vecs)
        idx.search_batch(vecs[:1], 3)
        co = idx._corpus
        rows = np.array([co._row_of[i] for i in ids])
        spilled = rows[co._cluster_of2[rows] >= 0]
        assert len(spilled)
        for r, lst in zip(spilled, co._nbrs_h[spilled]):
            vals = lst[lst >= 0]
            assert r not in vals
            assert len(vals) == len(set(vals.tolist()))

    def test_degree_zero_disables(self):
        ids, vecs, _ = clustered(n=200)
        idx = port_index(nlist=8, nprobe=2, graph_degree=0)
        idx.insert_batch(ids, vecs)
        assert idx._corpus._nbrs_h is None
        assert idx.search_batch(vecs[:2], 5)
        assert idx._corpus._nbrs_h is None


class TestRefinement:
    def test_recall_never_worse_and_scores_exact(self):
        ids, vecs, rng = clustered(n=1200, nc=30, noise=0.6)
        q = vecs[:48] + 0.3 * rng.normal(size=(48, DIM)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        bf = brute(ids, vecs)
        base = port_index(nlist=32, nprobe=2, graph_degree=0)
        base.insert_batch(ids, vecs)
        ref = port_index(nlist=32, nprobe=2, graph_degree=32)
        ref.insert_batch(ids, vecs)
        r0 = recall_at10(base, bf, q)
        r1 = recall_at10(ref, bf, q)
        assert r1 >= r0
        assert r1 > 0.85
        got = ref.search_batch(q, 10)
        byid = {ids[i]: vecs[i] for i in range(len(ids))}
        for b, row in enumerate(got):
            for nid, sc in row:
                assert abs(float(q[b] @ byid[nid]) - sc) < 1e-4

    def test_no_duplicate_ids_in_results(self):
        ids, vecs, rng = clustered(n=800, nc=16, noise=0.7)
        idx = port_index(nlist=16, nprobe=3, graph_degree=32)
        idx.insert_batch(ids, vecs)
        q = rng.normal(size=(16, DIM)).astype(np.float32)
        for row in idx.search_batch(q, 20):
            hits = [i for i, _ in row if i is not None]
            assert len(hits) == len(set(hits))

    def test_filters_hold_on_expanded_candidates(self):
        ids, vecs, rng = clustered(n=600, nc=12, noise=0.6)
        kinds = ["fact" if i % 3 else "event" for i in range(len(ids))]
        agents = [f"a{i % 4}" for i in range(len(ids))]
        idx = port_index(nlist=12, nprobe=2, graph_degree=32)
        idx.insert_batch(ids, vecs, kinds=kinds, agents=agents)
        q = rng.normal(size=(8, DIM)).astype(np.float32)
        for flt in (TorchVectorFilter(kinds=["fact"]),
                    TorchVectorFilter(source_agent="a1"),
                    TorchVectorFilter(exclude_ids=ids[::5])):
            got = idx.search_batch(q, 10, flt)
            assert any(got)
            for row in got:
                for nid, _ in row:
                    j = ids.index(nid)
                    if flt.kinds:
                        assert kinds[j] in flt.kinds
                    if flt.source_agent:
                        assert agents[j] == flt.source_agent
                    if flt.exclude_ids:
                        assert nid not in flt.exclude_ids

    def test_removed_node_never_surfaces_via_expansion(self):
        ids, vecs, _ = clustered(n=300, nc=6, noise=0.5)
        idx = port_index(nlist=6, nprobe=1, graph_degree=16)
        idx.insert_batch(ids, vecs)
        victim = ids[10]
        idx.remove(victim)
        for row in idx.search_batch(vecs[8:16], 20):
            assert victim not in [i for i, _ in row]

    def test_update_masks_out_edges(self):
        ids, vecs, rng = clustered(n=200, nc=4, noise=0.5)
        idx = port_index(nlist=4, nprobe=4, graph_degree=16)
        idx.insert_batch(ids, vecs)
        idx.search_batch(vecs[:1], 3)
        co = idx._corpus
        r = co._row_of[ids[5]]
        assert (co._nbrs_h[r] >= 0).any()
        nv = rng.normal(size=(DIM,)).astype(np.float32)
        idx.insert(ids[5], nv / np.linalg.norm(nv))
        assert (co._nbrs_h[r] == -1).all()
        assert idx.search_batch(vecs[:4], 5)


class TestLifecycle:
    def test_retrain_rebuilds_graph_not_boot_copy(self):
        """retrain() forces a fresh k-means; the carried-over graph must
        not survive it (here carried over from the reference's state())."""
        _, st, _, ids, _ = carried(n=300, nc=6, nlist=6, degree=16)
        rng = np.random.default_rng(3)
        idx2 = port_index(nlist=6, nprobe=2, graph_degree=16)
        idx2._corpus.load_jax_state(st)
        nv = rng.normal(size=(DIM,)).astype(np.float32)
        idx2.insert(ids[5], nv / np.linalg.norm(nv))
        idx2.retrain()
        co = idx2._corpus
        assert co._nbrs_h is not None
        assert (co._nbrs_h[co._row_of[ids[5]]] >= 0).any()

    def test_background_build_swaps_in(self, monkeypatch):
        """Layouts past WARM_MIN_SLOTS build the graph off the lock on a
        background thread; searches serve unrefined until the swap."""
        monkeypatch.setattr(port_ivf, "WARM_MIN_SLOTS", 1)
        ids, vecs, _ = clustered(n=300, nc=6, noise=0.6)
        idx = port_index(nlist=6, nprobe=2, graph_degree=16)
        idx.insert_batch(ids, vecs)
        idx.search_batch(vecs[:1], 3)      # triggers the build (async)
        co = idx._corpus
        deadline = time.monotonic() + 30
        while co._nbrs_h is None and time.monotonic() < deadline:
            time.sleep(0.05)
        assert co._nbrs_h is not None
        assert not co._graph_inflight
        assert co._graph_stats["background"] is True
        info = idx.index_info()
        assert info["graph_built"] is True and info["graph_error"] is None
        for row in idx.search_batch(vecs[:4], 10):
            hits = [i for i, _ in row if i is not None]
            assert len(hits) == len(set(hits))

    def test_background_build_masks_rows_mutated_in_flight(
            self, monkeypatch):
        monkeypatch.setattr(port_ivf, "WARM_MIN_SLOTS", 1)
        ids, vecs, rng = clustered(n=300, nc=6, noise=0.6)
        idx = port_index(nlist=6, nprobe=2, graph_degree=16)
        idx.insert_batch(ids, vecs)
        co = idx._corpus
        orig = port_kg.build_knn_graph
        gate = threading.Event()

        def slow_build(*a, **k):
            out = orig(*a, **k)
            gate.wait(10)
            return out

        monkeypatch.setattr(port_kg, "build_knn_graph", slow_build)
        idx.search_batch(vecs[:1], 3)      # spawn (held at the gate)
        nv = rng.normal(size=(DIM,)).astype(np.float32)
        idx.insert(ids[7], nv / np.linalg.norm(nv))   # in-flight write
        gate.set()
        deadline = time.monotonic() + 30
        while co._nbrs_h is None and time.monotonic() < deadline:
            time.sleep(0.05)
        assert co._nbrs_h is not None
        assert (co._nbrs_h[co._row_of[ids[7]]] == -1).all()

    def test_background_build_reads_host_planes_not_the_written_ones(
            self, monkeypatch):
        """The background build reads the host arrays _build_ivf made; an
        incremental write lands in the device planes, never in them."""
        monkeypatch.setattr(port_ivf, "WARM_MIN_SLOTS", 1)
        ids, vecs, rng = clustered(n=300, nc=6, noise=0.6)
        idx = port_index(nlist=6, nprobe=2, graph_degree=16)
        idx.insert_batch(ids, vecs)
        co = idx._corpus
        seen = {}
        gate = threading.Event()
        orig = port_kg.build_knn_graph

        def held_build(emb, *a, **k):
            seen["is_host"] = isinstance(emb, np.ndarray)
            seen["before"] = np.array(emb, copy=True)
            gate.wait(10)
            seen["after"] = np.array(emb, copy=True)
            return orig(emb, *a, **k)

        monkeypatch.setattr(port_kg, "build_knn_graph", held_build)
        idx.search_batch(vecs[:1], 3)
        for j in range(20):                   # incremental writes
            nv = rng.normal(size=(DIM,)).astype(np.float32)
            idx.insert(f"x{j}", nv / np.linalg.norm(nv))
        idx.search_batch(vecs[:1], 3)         # sync -> _apply_dirty
        gate.set()
        deadline = time.monotonic() + 30
        while co._nbrs_h is None and time.monotonic() < deadline:
            time.sleep(0.05)
        assert seen["is_host"]
        np.testing.assert_array_equal(seen["before"], seen["after"])
        assert not np.array_equal(seen["after"],
                                  co._ivf_dev[1].numpy())

    def test_failed_background_build_is_logged_and_leaves_graph_off(
            self, monkeypatch, caplog):
        monkeypatch.setattr(port_ivf, "WARM_MIN_SLOTS", 1)

        def broken(*a, **k):
            raise RuntimeError("block_knn: kernel launch failed: test")

        monkeypatch.setattr(port_kg, "build_knn_graph", broken)
        ids, vecs, _ = clustered(n=300, nc=6, noise=0.6)
        idx = port_index(nlist=6, nprobe=2, graph_degree=16)
        idx.insert_batch(ids, vecs)
        co = idx._corpus
        with caplog.at_level("ERROR", logger="cortex.ivf"):
            idx.search_batch(vecs[:1], 3)
            deadline = time.monotonic() + 30
            while co._graph_inflight and time.monotonic() < deadline:
                time.sleep(0.05)
        assert co._nbrs_h is None and not co._graph_inflight
        assert "kernel launch failed: test" in caplog.text
        assert idx.search_batch(vecs[:2], 5)        # serves unrefined
        info = idx.index_info()
        assert info["graph_built"] is False
        assert info["graph_error"] == ("RuntimeError: block_knn: kernel "
                                       "launch failed: test")

    def test_index_info_publishes_the_graph_state(self, monkeypatch):
        """index_info says whether refinement serves: not while the
        background build runs, yes once it swaps in, not (with the error)
        after a failed one, and a rebuild that succeeds clears the error;
        at degree 0 never."""
        monkeypatch.setattr(port_ivf, "WARM_MIN_SLOTS", 1)
        ids, vecs, _ = clustered(n=300, nc=6, noise=0.6)
        idx = port_index(nlist=6, nprobe=2, graph_degree=16)
        idx.insert_batch(ids, vecs)
        co = idx._corpus
        orig = port_kg.build_knn_graph
        gate = threading.Event()
        fail = [True]

        def held_build(*a, **k):
            gate.wait(10)
            if fail[0]:
                raise ValueError("block_knn: L=8192 needs more shared memory")
            return orig(*a, **k)

        def settle():
            deadline = time.monotonic() + 30
            while co._graph_inflight and time.monotonic() < deadline:
                time.sleep(0.05)
            assert not co._graph_inflight

        monkeypatch.setattr(port_kg, "build_knn_graph", held_build)
        idx.search_batch(vecs[:1], 3)          # spawn (held at the gate)
        info = idx.index_info()
        assert info["graph_degree"] == 16
        assert info["graph_built"] is False and info["graph_error"] is None
        gate.set()
        settle()
        info = idx.index_info()
        assert info["graph_built"] is False
        assert info["graph_error"].startswith("ValueError: block_knn: L=8192")
        fail[0] = False
        idx.retrain()
        settle()
        info = idx.index_info()
        assert info["graph_built"] is True and info["graph_error"] is None
        off = port_index(nlist=6, nprobe=2, graph_degree=0)
        off.insert_batch(ids, vecs)
        off.search_batch(vecs[:1], 3)
        assert off.index_info()["graph_built"] is False


class TestCarriedOver:
    """tests/test_ivf_graph.py's persistence cases, through the state the
    reference's snapshot holds (the port keeps no snapshot files)."""

    def test_carried_graph_is_the_references(self):
        ref, _, port, ids, _ = carried(n=400, nc=8, nlist=8, degree=16)
        port.search_batch(np.zeros((1, DIM), np.float32), 3)
        co, rco = port._corpus, ref._corpus
        for nid in ids:
            a = co._nbrs_h[co._row_of[nid]]
            b = rco._nbrs_h[rco._row_of[nid]]
            assert ([co._id_of[r] for r in a[a >= 0]]
                    == [rco._id_of[r] for r in b[b >= 0]])

    def test_state_without_graph_rebuilds(self):
        _, _, port, _, _ = carried(n=300, nc=6, nlist=6, degree=16,
                                   keep_graph=False)
        assert port._corpus._nbrs_h is not None   # built from the layout

    def test_degree_zero_drops_a_carried_graph(self):
        _, st, _, _, vecs = carried(n=300, nc=6, nlist=6, degree=16)
        port = port_index(nlist=6, nprobe=2, graph_degree=0)
        port._corpus.load_jax_state(st)
        port.search_batch(vecs[:1], 3)
        assert port._corpus._nbrs_h is None


@pytest.mark.parametrize("flt", ["none", "kinds", "agent", "exclude",
                                 "exclude_overflow"])
def test_refined_search_parity_through_carried_graph(flt):
    """The reference's state(), graph included, loaded into the port: at
    nprobe 2 both expand through the same graph, so the top-10 ids are
    equal and scores within ATOL."""
    n = 600
    kinds = ["fact" if i % 3 else "event" for i in range(n)]
    agents = [f"a{i % 4}" for i in range(n)]
    ref, st, port, ids, vecs = carried(n=n, nc=20, noise=0.6, nlist=16,
                                       nprobe=2, degree=32, kinds=kinds,
                                       agents=agents)
    assert "ivf_nbrs" in st and port._corpus._nbrs_h is not None
    rng = np.random.default_rng(9)
    q = vecs[:12] + 0.4 * rng.normal(size=(12, DIM)).astype(np.float32)
    kw = {"none": {}, "kinds": {"kinds": ["fact"]},
          "agent": {"source_agent": "a1"},
          "exclude": {"exclude_ids": ids[::11]},
          "exclude_overflow": {"exclude_ids": ids[:90]}}[flt]
    want = ref.search_batch(q, 10, VectorFilter(**kw))
    got = port.search_batch(q, 10, TorchVectorFilter(**kw))
    unrefined = port.search_batch(q, 10, TorchVectorFilter(**kw),
                                  refine=False)
    assert got != unrefined or flt != "none"   # expansion changed results
    for w, g in zip(want, got):
        assert [i for i, _ in g] == [i for i, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   atol=ATOL)


# ------------------------------------------------ flags and config


class TestRefineFlag:
    def test_refine_false_skips_expansion(self, monkeypatch):
        ids, vecs, _ = clustered(n=400, nc=8, noise=0.6)
        idx = port_index(nlist=8, nprobe=2, graph_degree=16)
        idx.insert_batch(ids, vecs)
        idx.search_batch(vecs[:1], 3)
        assert idx._corpus._nbrs_h is not None
        calls = []
        orig = idx._corpus._expand_candidates
        monkeypatch.setattr(
            idx._corpus, "_expand_candidates",
            lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
        idx.search_batch(vecs[:2], 5)
        assert calls
        calls.clear()
        idx.search_batch(vecs[:2], 5, refine=False)
        idx.search_stream(vecs[:4], 5, refine=False)
        idx.search_batch_async(vecs[:2], 5, refine=False)()
        assert not calls
        idx.search_stream(vecs[:4], 5)
        assert calls

    def test_linker_and_dedup_scans_pass_refine_false(self, monkeypatch):
        from cortex_tpu_torch.linker.auto_linker import AutoLinker
        from cortex_tpu_torch.linker.dedup import DedupScanner
        from cortex_tpu_torch.storage import MemoryStorage
        from cortex_tpu_torch.types import Node, Source
        from cortex_tpu_torch.vector.config import SimilarityConfig
        from cortex_tpu_torch.vector.embedding import HashingEmbedder

        store = MemoryStorage()
        emb = HashingEmbedder(dim=DIM)
        idx = port_index(nlist=2, nprobe=2, graph_degree=8)
        for i in range(40):
            n = Node.new("fact", f"fact number {i}",
                         f"body text for fact {i} " * 3,
                         Source(agent="tester"))
            n.embedding = emb.embed(n.title + " " + (n.body or ""))
            store.put_node(n)
            idx.insert(n.id, np.asarray(n.embedding, np.float32),
                       kind=n.kind)
        idx.search_batch(np.zeros((1, DIM), np.float32), 3)  # build
        assert idx._corpus._nbrs_h is not None
        calls = []
        orig = idx._corpus._expand_candidates
        monkeypatch.setattr(
            idx._corpus, "_expand_candidates",
            lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
        AutoLinker(store, idx, emb).run_cycle()
        DedupScanner(store, idx, SimilarityConfig()).scan()
        assert not calls


class TestConfigWiring:
    def test_config_key_flows_to_index(self):
        from cortex_tpu_torch import Cortex
        from cortex_tpu_torch.config import CortexConfig
        cfg = CortexConfig()
        cfg.embedding.index = "ivf"
        cfg.embedding.ivf_graph_degree = 8
        cx = Cortex.in_memory(cfg, device="cpu")
        try:
            assert cx.index._corpus._graph_degree == 8
            assert cx.index._corpus._target_recall == 0.0
        finally:
            cx.close()

    def test_validation(self):
        from cortex_tpu_torch.config import CortexConfig
        from cortex_tpu_torch.errors import ConfigError
        cfg = CortexConfig()
        cfg.embedding.ivf_graph_degree = -1
        with pytest.raises(ConfigError, match="ivf_graph_degree"):
            cfg.validate()

    def test_reference_defaults_open_store_and_search(self):
        """index = "ivf" with every other key at the reference's default
        (ivf_graph_degree = 32) opens, stores and searches, refined."""
        from cortex_tpu_torch import Cortex
        from cortex_tpu_torch.config import CortexConfig
        from cortex_tpu_torch.types import Node, Source
        cfg = CortexConfig()
        cfg.embedding.index = "ivf"
        cx = Cortex.in_memory(cfg, device="cpu")
        try:
            nodes = [Node.new("fact", f"default ivf note {i} topic{i % 7}",
                              f"body words {i % 11}", Source(agent="a"), 0.5)
                     for i in range(300)]
            cx.store_batch(nodes)
            from cortex_tpu_torch.vector.embedding import embedding_input
            got = cx.search(embedding_input(nodes[17]), 5, decay=False,
                            record_access=False)
            assert got[0][1].id == nodes[17].id
            co = cx.index._corpus
            assert co._graph_degree == 32 and co._nbrs_h is not None
            info = cx.index.index_info()
            assert info["graph_degree"] == 32 and info["graph_built"]
        finally:
            cx.close()
