"""The port's hybrid search against a plain one, and the in-memory
store's raw bulk load against its one-edge-at-a-time path.

HybridSearch (flat index and graph mirror on the CPU) answers seeded
queries over 2,000 clustered rows of width 64 and about 10,000 seeded
edges, in both of the mirror's host tiers (the object cache, and the
packed snapshot the mirror serves above PACKED_EDGE_THRESHOLD edges),
through `search_async`. tests/plain_hybrid.py, written from the
reference's definition in plain torch, answers the same queries.
Criterion: the same ids rank by rank, another id at a rank only where
the combined scores tie within 1e-6; vector and combined scores within
1e-5 (float32 products summed in another order); graph scores and
nearest anchors exactly equal (hop depths are integers). The queries
have 0 to 3 anchors, a kind filter, an edge-less anchor (inside the
vector leg, where the anchor-to-itself rule decides its score), and an
anchor outside the vector leg. `search(query)` is the embedding of its
text, `search_async` and the callable.

MemoryStorage's bulk_insert_node_rows / bulk_insert_edge_rows against
put_node / put_edge on the same seeded nodes and edges: the same
edge_endpoints multiset, edges_from / edges_to, stats().edge_count,
packed snapshot neighbour sets and multi_bfs depths; ids already stored
left as they are; one summary audit row a call.
"""

from collections import Counter

import numpy as np
import pytest

from cortex_tpu_torch.graph.cache import AdjacencyCache
from cortex_tpu_torch.graph.csr import DeviceGraphMirror
from cortex_tpu_torch.graph.packed import UNREACHED, PackedAdjacency
from cortex_tpu_torch.storage import MemoryStorage
from cortex_tpu_torch.types import Edge, EdgeProvenance, Node, Source
from cortex_tpu_torch.vector.embedding import HashingEmbedder
from cortex_tpu_torch.vector.hybrid import HybridQuery, HybridSearch
from cortex_tpu_torch.vector.index import TorchFlatIndex
from plain_hybrid import hybrid_search

N, D, CLUSTERS, EDGES = 2000, 64, 40, 10_000
SCORE_ATOL, TIE = 1e-5, 1e-6
KINDS = ("fact", "event", "decision", "goal")
LONELY = (999, 1999)              # rows without edges


def seeded_graph(seed=11):
    """Clustered unit rows, their kinds, and about EDGES distinct
    directed edges: 80 % inside the source's cluster, no self loops, one
    edge a pair, none at the LONELY rows."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((CLUSTERS, D))
    member = rng.integers(0, CLUSTERS, N)
    rows = centers[member] + 0.35 * rng.standard_normal((N, D)) / D ** 0.5 \
        * np.linalg.norm(centers[member], axis=1, keepdims=True)
    rows = (rows / np.linalg.norm(rows, axis=1, keepdims=True)).astype(
        np.float32)
    src = rng.integers(0, N, int(EDGES * 1.1))
    same = np.array([rng.choice(np.nonzero(member == member[s])[0])
                     for s in src])
    dst = np.where(rng.random(len(src)) < 0.8, same,
                   rng.integers(0, N, len(src)))
    keep = (src != dst) & ~np.isin(src, LONELY) & ~np.isin(dst, LONELY)
    pair = np.unique(src[keep] * N + dst[keep])
    pair = pair[rng.permutation(len(pair))][:EDGES]
    return rows, member, pair // N, pair % N


ROWS, MEMBER, SRC, DST = seeded_graph()
IDS = [f"n{r:04d}" for r in range(N)]
ROW_KINDS = [KINDS[r % 4] for r in range(N)]
PROV = EdgeProvenance.manual("test")


def edge_rows(src=SRC, dst=DST, prefix="e"):
    return [(f"{prefix}{j}", IDS[s], IDS[t], "related_to", 0.5, PROV, 1.0,
             1.0) for j, (s, t) in enumerate(zip(src.tolist(),
                                                dst.tolist()))]


def loaded_store():
    st = MemoryStorage()
    st.bulk_insert_node_rows((i, k, i, "") for i, k in zip(IDS, ROW_KINDS))
    st.bulk_insert_edge_rows(edge_rows())
    return st


def neighbours(r):
    return sorted(set(DST[SRC == r].tolist()) | set(SRC[DST == r].tolist()))


def cases():
    """(name, query vector, HybridQuery) of every case, with the row the
    query was drawn near."""
    rng = np.random.default_rng(5)
    out = []

    def near(r):
        q = ROWS[r] + 0.35 * rng.standard_normal(D).astype(np.float32) \
            / D ** 0.5
        return (q / np.linalg.norm(q)).astype(np.float32)

    linked = [r for r in range(N) if neighbours(r)]
    for j, r in enumerate(rng.choice(linked, 24, replace=False).tolist()):
        nb = neighbours(r)
        pool = [r] + nb
        m = j % 4                                   # 0-3 anchors
        anchors = [IDS[a] for a in rng.choice(pool, min(m, len(pool)),
                                              replace=False).tolist()]
        flt = ["event", "goal"] if j % 3 == 2 else None
        out.append((f"q{j}-{m}a" + ("-filtered" if flt else ""), near(r),
                    HybridQuery(query_text=f"q{j}", anchors=anchors,
                                limit=10, kind_filter=flt,
                                max_anchor_depth=2 + j % 2)))
    r = int(linked[7])
    far = next(a for a in range(N) if MEMBER[a] != MEMBER[r]
               and neighbours(a))
    out.append(("anchor-outside-the-vector-leg", near(r), HybridQuery(
        query_text="far", anchors=[IDS[far], IDS[r]], limit=10,
        max_anchor_depth=2)))
    out.append(("edge-less-anchor-in-the-leg", near(LONELY[0]), HybridQuery(
        query_text="lonely", anchors=[IDS[LONELY[0]], IDS[r]], limit=10,
        max_anchor_depth=2)))
    out.append(("edge-less-anchor-filtered", near(LONELY[1]), HybridQuery(
        query_text="lonely2", anchors=[IDS[neighbours(r)[0]],
                                       IDS[LONELY[1]]],
        limit=10, kind_filter=["goal"], max_anchor_depth=2)))
    return out


CASES = cases()


@pytest.fixture(params=["object_cache", "packed"])
def hybrid(request, monkeypatch):
    if request.param == "packed":
        monkeypatch.setattr(DeviceGraphMirror, "PACKED_EDGE_THRESHOLD", 0)
    st = loaded_store()
    index = TorchFlatIndex(D, device="cpu")
    index.insert_batch(IDS, ROWS, kinds=ROW_KINDS)
    mirror = DeviceGraphMirror(AdjacencyCache(st), storage=st, device="cpu")
    hy = HybridSearch(st, HashingEmbedder(D), index, mirror)
    yield hy
    assert mirror._packed_mode() == (request.param == "packed")
    index.close()


def same_answer(got, want, what):
    assert len(got) == len(want), what
    for rank, (g, w) in enumerate(zip(got, want)):
        if g.node.id != w[0]:
            assert abs(g.combined_score - w[3]) <= TIE, (what, rank)
    by_id = {w[0]: w for w in want}
    for g in got:
        w = by_id.get(g.node.id)
        if w is None:                   # a tie at the cut-off
            assert abs(g.combined_score - want[-1][3]) <= TIE, what
            continue
        assert abs(g.vector_score - w[1]) <= SCORE_ATOL, what
        assert abs(g.combined_score - w[3]) <= SCORE_ATOL, what
        assert (g.graph_score, g.nearest_anchor) == (w[2], w[4]), (
            what, g.node.id)


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_hybrid_matches_the_plain_search(hybrid, case):
    name, q, query = CASES[case]
    got = hybrid.search_async(q, query)()
    want = hybrid_search(ROWS, IDS, ROW_KINDS, SRC, DST, q, query.anchors,
                         kind_filter=query.kind_filter,
                         w=query.vector_weight, limit=query.limit,
                         hops=query.max_anchor_depth)
    same_answer(got, want, name)


def test_the_cases_cover_what_they_name():
    plain = {name: hybrid_search(ROWS, IDS, ROW_KINDS, SRC, DST, q,
                                 query.anchors,
                                 kind_filter=query.kind_filter,
                                 limit=query.limit,
                                 hops=query.max_anchor_depth)
             for name, q, query in CASES}
    assert {len(query.anchors) for _, _, query in CASES} == {0, 1, 2, 3}
    lonely = plain["edge-less-anchor-in-the-leg"]
    assert (IDS[LONELY[0]], 0) in [t[4] for t in lonely]
    far = CASES[-3][2].anchors[0]
    assert far not in {t[0] for t in plain["anchor-outside-the-vector-leg"]}
    assert any(t[2] == 0.5 for t in plain["anchor-outside-the-vector-leg"])
    assert all(ROW_KINDS[IDS.index(t[0])] == "goal"
               for t in plain["edge-less-anchor-filtered"])


def test_search_is_the_embedding_then_search_async(hybrid):
    for name, _, query in CASES[:8] + CASES[-2:]:
        emb = hybrid.embedder.embed(query.query_text)
        a = hybrid.search(query)
        b = hybrid.search_async(emb, query)()
        assert [(r.node.id, r.vector_score, r.graph_score, r.combined_score,
                 r.nearest_anchor) for r in a] == [
            (r.node.id, r.vector_score, r.graph_score, r.combined_score,
             r.nearest_anchor) for r in b], name


# ------------------------------------------------------------ bulk load


def one_by_one_store():
    st = MemoryStorage()
    for i, k in zip(IDS, ROW_KINDS):
        st.put_node(Node(id=i, kind=k, title=i, body=""))
    for row in edge_rows():
        st.put_edge(Edge(*row))
    return st


def edge_view(st):
    return {i: (sorted(e.id for e in st.edges_from(i)),
                sorted(e.id for e in st.edges_to(i))) for i in IDS}


def test_the_bulk_path_stores_what_put_edge_stores():
    a, b = one_by_one_store(), loaded_store()
    ends = [Counter(zip(*map(lambda c: sum(c, []), zip(*st.edge_endpoints(
        1000))))) for st in (a, b)]
    assert ends[0] == ends[1] and sum(ends[0].values()) == len(SRC)
    assert edge_view(a) == edge_view(b)
    assert a.stats().edge_count == b.stats().edge_count == len(SRC)
    assert a.stats().node_count == b.stats().node_count == N
    for eid in ("e0", f"e{len(SRC) - 1}"):
        assert a.get_edge(eid) == b.get_edge(eid)
    assert a.get_node(IDS[3]) == b.get_node(IDS[3])
    pa, pb = PackedAdjacency.build(a), PackedAdjacency.build(b)
    assert sorted(pa.ids) == sorted(pb.ids) and pa.edge_count == \
        pb.edge_count

    def nbrs(pk, i):
        r = pk.row_of[i]
        return {pk.ids[j] for j in pk.indices[pk.indptr[r]:pk.indptr[r + 1]]}

    for i in pa.ids:
        assert nbrs(pa, i) == nbrs(pb, i)
    for i in pa.ids[:25]:
        da = pa.multi_bfs([pa.row_of[i]], 3)
        db = pb.multi_bfs([pb.row_of[i]], 3)
        assert ({pa.ids[r]: int(x) for r, x in enumerate(da)
                 if x != UNREACHED}
                == {pb.ids[r]: int(x) for r, x in enumerate(db)
                    if x != UNREACHED})


def test_the_bulk_path_ignores_stored_ids_and_audits_once():
    st = loaded_store()
    assert st.index_seq() == N
    assert len(st.query_audit(action="bulk_import_nodes")) == 1
    audit = st.query_audit(action="bulk_import_edges")
    assert [e.target_id for e in audit] == [f"count={len(SRC)}"]
    assert not st.query_audit(action="edge_created")
    # the same ids again, with other endpoints and titles: nothing moves
    moved = edge_rows(DST, SRC)
    assert st.bulk_insert_edge_rows(moved) == 0
    assert st.bulk_insert_node_rows([(IDS[0], "goal", "other", "x")]) == 0
    assert st.get_node(IDS[0]).title == IDS[0]
    assert st.get_edge("e0").from_id == IDS[int(SRC[0])]
    assert len(st.query_audit(action="bulk_import_edges")) == 1
    assert st.index_seq() == N
    # an id twice in one call: the first is kept
    assert st.bulk_insert_edge_rows([
        ("x1", IDS[1], IDS[2], "related_to", 0.5, PROV, 1.0, 1.0),
        ("x1", IDS[3], IDS[4], "related_to", 0.5, PROV, 1.0, 1.0)]) == 1
    assert st.get_edge("x1").to_id == IDS[2]
    assert len(st.query_audit(action="bulk_import_edges")) == 2
    # a bulk edge is an edge like any other
    assert st.delete_edge("x1")
    assert "x1" not in {e.id for e in st.edges_from(IDS[1])}
    assert st.stats().edge_count == len(SRC)


def test_a_failed_bulk_call_stores_nothing():
    st = MemoryStorage()
    with pytest.raises(TypeError):
        st.bulk_insert_edge_rows(edge_rows()[:5] + [("bad",)])
    assert st.stats().edge_count == 0 and not st.query_audit()
    with pytest.raises(TypeError):
        st.bulk_insert_node_rows([("a", "fact", "a", ""), ("b",)])
    assert st.count_nodes() == 0 and st.index_seq() == 0


def test_the_store_takes_over_a_rows_containers():
    st = MemoryStorage()
    meta = {"a": 1}
    st.bulk_insert_node_rows([("m", "fact", "m", "", meta, [],
                               None, Source(agent="t"))])
    meta["a"] = 2
    assert st.get_node("m").metadata == {"a": 2}     # taken over
    n = st.get_node("m")
    n.title = "changed"
    assert st.get_node("m").title == "m"
