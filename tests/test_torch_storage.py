"""The port's copies of the reference's host modules, held against it.

cortex_tpu_torch keeps its own `errors`, `types`, `hooks`, `storage` and
native exact re-rank, so that it imports nothing of cortex_tpu. These
tests hold each copy to the reference: the sources agree line for line
but for imports, a SQLite file written by either package opens in the
other with equal nodes, edges, tags and audit rows, Node / Edge dicts
round-trip between the two, and the port's C++ re-rank returns what
the reference's and the numpy path return, tie order included.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from cortex_tpu import native as jax_native
from cortex_tpu.storage import NodeFilter as JaxNodeFilter
from cortex_tpu.storage import SqliteStorage as JaxSqlite
from cortex_tpu.types import Edge as JaxEdge
from cortex_tpu.types import Node as JaxNode
from cortex_tpu_torch import native as torch_native
from cortex_tpu_torch.storage import NodeFilter as TorchNodeFilter
from cortex_tpu_torch.storage import SqliteStorage as TorchSqlite
from cortex_tpu_torch.types import Edge as TorchEdge
from cortex_tpu_torch.types import Node as TorchNode

REPO = Path(__file__).resolve().parent.parent
COPIES = ("errors.py", "types.py", "hooks.py", "storage/__init__.py",
          "storage/base.py", "storage/memory_store.py",
          "storage/sqlite_store.py")
PACKAGES = {"jax": (JaxSqlite, JaxNode, JaxEdge, JaxNodeFilter),
            "torch": (TorchSqlite, TorchNode, TorchEdge, TorchNodeFilter)}
KINDS = ("fact", "event", "decision", "goal", "observation")


def _without_imports(text):
    return [line for line in text.splitlines()
            if not re.match(r"\s*(from|import)\s", line)]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_reference(rel):
    ref = (REPO / "cortex_tpu" / rel).read_text()
    port = (REPO / "cortex_tpu_torch" / rel).read_text()
    assert _without_imports(port) == _without_imports(ref)


# ------------------------------------------------------------- storage


def node_dicts(n, seed):
    """Seeded node dicts with fixed ids, tags, metadata and embeddings."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append({
            "id": f"node-{seed}-{i:04d}", "kind": KINDS[i % len(KINDS)],
            "title": f"title {i} w{int(rng.integers(0, 50))}",
            "body": " ".join(f"w{int(w)}" for w in rng.integers(0, 99, 8)),
            "metadata": {"n": i, "tag": f"m{i % 3}"},
            "tags": [f"t{int(t)}" for t in rng.choice(6, 2, replace=False)],
            "embedding": rng.standard_normal(8).astype(np.float32).tolist(),
            "source": {"agent": f"agent{i % 3}", "session": None,
                       "channel": None},
            "importance": float(rng.uniform(0.1, 0.9)),
            "access_count": int(rng.integers(0, 5)),
            "last_accessed_at": 1.7e9 + i, "created_at": 1.6e9 + i,
            "updated_at": 1.65e9 + i, "deleted": False})
    return out


def write_store(pkg, path):
    """A store written by one package: nodes (single, batch, bulk), an
    update, a soft delete, edges with a weight update and a delete, and
    metadata; every write audited."""
    sqlite, node_cls, edge_cls, _ = PACKAGES[pkg]
    st = sqlite(str(path))
    dicts = node_dicts(30, seed=1)
    nodes = [node_cls.from_dict(d) for d in dicts]
    for n in nodes[:5]:
        st.put_node(n, actor="tester")
    st.put_nodes_batch(nodes[5:20], actor="batch")
    st.bulk_put_nodes(nodes[20:], actor="bulk")
    nodes[3].title = "an updated title"
    st.put_node(nodes[3], actor="tester")
    prov = {"kind": "auto_similarity", "score": 0.75}
    for i in range(12):
        st.put_edge(edge_cls.from_dict({
            "id": f"edge-{i:03d}", "from": nodes[i].id,
            "to": nodes[i + 7].id, "relation": "relates_to",
            "weight": 0.05 * (i + 1), "provenance": prov,
            "created_at": 1.6e9 + i, "updated_at": 1.6e9 + i}),
            actor="linker")
    st.update_edge_weight_atomic("edge-002", 0.9)
    st.delete_edge("edge-005", actor="tester")
    st.delete_node(nodes[25].id, actor="tester")
    st.put_metadata("answer", "42")
    st.close()


def read_store(pkg, path):
    """Everything one package reads back from the file, as plain data."""
    sqlite, _, _, node_filter = PACKAGES[pkg]
    st = sqlite(str(path))
    try:
        nodes = sorted((n.to_dict() for n in st.list_nodes(
            node_filter(include_deleted=True))), key=lambda d: d["id"])
        edges = sorted((e.to_dict() for e in st.all_edges()),
                       key=lambda d: d["id"])
        audit = [(a.ts, a.action, a.target_id, a.actor, a.details)
                 for a in st.query_audit(limit=10_000)]
        tagged = sorted(n.id for n in st.list_nodes(node_filter(
            tags=["t1"], include_deleted=True)))
        return {"nodes": nodes, "edges": edges, "audit": audit,
                "tagged_t1": tagged, "meta": st.get_metadata("answer")}
    finally:
        st.close()


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_sqlite_file_opens_in_the_other_package(tmp_path, writer, reader):
    path = tmp_path / "cortex.db"
    write_store(writer, path)
    want = read_store(writer, path)
    got = read_store(reader, path)
    assert len(want["nodes"]) == 30 and len(want["edges"]) == 11
    assert len(want["audit"]) > 30 and want["tagged_t1"]
    assert got == want


def test_both_packages_write_the_same_file(tmp_path):
    write_store("jax", tmp_path / "a.db")
    write_store("torch", tmp_path / "b.db")
    a, b = read_store("jax", tmp_path / "a.db"), read_store(
        "jax", tmp_path / "b.db")
    # audit times and the updated_at of the delete and the weight update
    # are the wall clock of each write: compare the rest
    for rows in (a, b):
        rows["audit"] = [r[1:] for r in rows["audit"]]
        for d in rows["nodes"] + rows["edges"]:
            if d["id"] in ("node-1-0025", "edge-002"):
                d.pop("updated_at")
    assert a == b


@pytest.mark.parametrize("src,dst", [("jax", "torch"), ("torch", "jax")])
def test_node_and_edge_dicts_round_trip(src, dst):
    _, node_src, edge_src, _ = PACKAGES[src]
    _, node_dst, edge_dst, _ = PACKAGES[dst]
    for d in node_dicts(5, seed=3):
        n = node_src.from_dict(d)
        assert node_dst.from_dict(n.to_dict()).to_dict() == n.to_dict()
    e = edge_src.from_dict({"id": "e", "from": "a", "to": "b",
                            "relation": "supports", "weight": 0.3,
                            "provenance": {"kind": "manual",
                                           "created_by": "x"}})
    assert edge_dst.from_dict(e.to_dict()).to_dict() == e.to_dict()


# ----------------------------------------------------- host re-rank


def rerank_numpy(corpus, q, i, valid, kk):
    """The numpy path of the host re-rank (vector/shard.py::_finish_topk
    in both packages): gather, matmul, mask, stable argsort."""
    rows = np.where(valid, i, 0)
    g = corpus[rows.reshape(-1)].reshape(rows.shape[0], rows.shape[1], -1)
    exact = np.matmul(g, q[:, :, None])[:, :, 0]
    exact = np.where(valid, exact, -1e30)
    order = np.argsort(-exact, axis=1, kind="stable")[:, :kk]
    return (np.take_along_axis(exact, order, axis=1),
            np.take_along_axis(i, order, axis=1))


def rerank_inputs(seed, *, ties):
    """Corpus [300, 24], queries [9, 24], candidates [9, 48]. With
    ties, entries are multiples of 1/8 in [-1, 1] and queries small
    integers, so every dot product is exact in f32 whatever the
    summation order, and rows 10-29 repeat row 5: many exact ties."""
    rng = np.random.default_rng(seed)
    if ties:
        corpus = rng.integers(-8, 9, (300, 24)).astype(np.float32) / 8
        corpus[10:30] = corpus[5]
        q = rng.integers(-3, 4, (9, 24)).astype(np.float32)
    else:
        corpus = rng.standard_normal((300, 24)).astype(np.float32)
        q = rng.standard_normal((9, 24)).astype(np.float32)
    cand = rng.integers(0, 300, (9, 48)).astype(np.int32)
    if ties:
        cand[:, ::3] = rng.integers(5, 30, (9, 16))
    valid = rng.random((9, 48)) < 0.85
    return corpus, q, cand, valid


@pytest.mark.parametrize("ties", [True, False])
def test_host_rerank_equals_reference_and_numpy(ties):
    corpus, q, cand, valid = rerank_inputs(7, ties=ties)
    kk = 20
    port = torch_native.rerank_topk_native(corpus, q, cand, valid, kk)
    ref = jax_native.rerank_topk_native(corpus, q, cand, valid, kk)
    nv, ni = rerank_numpy(corpus, q, cand, valid, kk)
    assert port is not None, "the port's native re-rank did not build"
    assert ref is not None, "the reference's native re-rank did not build"
    pv, pi = port
    np.testing.assert_array_equal(pi, ref[1])
    np.testing.assert_array_equal(pi, ni)
    if ties:
        assert len(set(pv[0].tolist())) < kk       # the ties are there
        np.testing.assert_array_equal(pv, ref[0])
        np.testing.assert_array_equal(pv, nv)
    else:
        np.testing.assert_allclose(pv, ref[0], atol=1e-5)
        np.testing.assert_allclose(pv, nv, atol=1e-5)


def test_host_rerank_builds_outside_the_reference():
    path = torch_native.lib_path()
    assert torch_native.available() and path.exists()
    assert (REPO / "cortex_tpu_torch" / "_build") in path.parents
