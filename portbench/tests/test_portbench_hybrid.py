"""The hybrid configuration on the CPU at a tiny size: its generators,
its plain reference against brute force and the program's packed BFS,
its judge against planted faults and the TF32 control, the cell's files
by name, and sound runs of the system."""

import copy
import time

import numpy as np
import pytest
import torch

from portbench import data as flat_data
from portbench import graph_data, hybrid_reference, hybrid_search
from portbench import registry, run

CELL = "hybrid-1m-768.b1"
SEED = 2 ** 31 + 13
METRICS = ("proximity_ms.b1", "fuse_ms.b1", "reached_rows.b1",
           "hybrid_roofline.b1", "hybrid_idle.b1")


def tiny_hybrid(**cfg) -> registry.Cell:
    """The cell at a CPU size: 4,000 rows of width 64 in 80 clusters,
    about 18,000 edges, a pool of 256 queries, the flat index on its
    int8 path. No expect_info: it states the full-size index."""
    cell = copy.deepcopy(registry.cell(registry.benchmark(), CELL))
    cell.cfg.update({"rows": 4000, "dim": 64, "centers": 80,
                     "edge_draw": 20000}, **cfg)
    cell.cfg.pop("expect_info", None)
    cell.cfg["index"]["search_path"] = "quant"
    cell.traffic["pool"] = 256
    return cell


@pytest.fixture
def packed(monkeypatch):
    """The mirror's packed tier at the tiny size, as at 5M edges."""
    from cortex_tpu_torch.graph.csr import DeviceGraphMirror
    monkeypatch.setattr(DeviceGraphMirror, "PACKED_EDGE_THRESHOLD", 0)


def test_the_rows_are_the_flat_configurations(cpu):
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(SEED)
    g2.manual_seed(SEED)
    x, c = flat_data.clustered_rows(g1, cpu, 500, 32, groups=20)
    y, c2, member = graph_data.clustered_rows_and_members(g2, cpu, 500, 32,
                                                          groups=20)
    assert torch.equal(x, y) and torch.equal(c, c2)
    assert member.shape == (500,) and int(member.max()) < 20


def test_the_graph_is_seeded_and_keeps_its_laws():
    member = np.random.default_rng(3).integers(0, 40, 3000)
    a = graph_data.seeded_edges(member, 15000, SEED)
    b = graph_data.seeded_edges(member, 15000, SEED)
    c = graph_data.seeded_edges(member, 15000, SEED + 1)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    src, dst = a
    assert 12000 < len(src) <= 15000
    assert not (src == dst).any()
    assert len(np.unique(src * 3000 + dst)) == len(src)
    lonely = np.arange(3000) % 1000 == 999
    assert not lonely[src].any() and not lonely[dst].any()
    nb = graph_data.Neighbours(src, dst, 3000)
    assert max(len(nb.of(r)) for r in range(3000)) <= 64
    assert (member[src] == member[dst]).mean() > 0.7


def test_filtered_topk_equals_brute_force(cpu, monkeypatch):
    monkeypatch.setattr(hybrid_reference, "ROW_BLOCK", 700)
    rng = np.random.default_rng(5)
    rows = rng.standard_normal((3000, 48)).astype(np.float32)
    queries = rng.standard_normal((20, 48)).astype(np.float32)
    kind_of = np.arange(3000) % 4
    admitted = np.ones((20, 4), bool)
    admitted[::2] = [False, True, False, True]
    v, i = hybrid_reference.filtered_topk(rows, kind_of, queries, admitted,
                                          30, cpu)
    r = rows / np.linalg.norm(rows, axis=1, keepdims=True)
    q = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    s = q.astype(np.float64) @ r.T.astype(np.float64)
    s[~admitted[:, kind_of]] = -np.inf
    want = np.argsort(-s, axis=1, kind="stable")[:, :30]
    np.testing.assert_array_equal(i, want)
    np.testing.assert_allclose(v, np.take_along_axis(s, want, 1), atol=1e-6)


def test_the_reference_bfs_equals_the_packed_snapshots(cpu):
    """Depths by frontier expansion over the edge list against the
    program's PackedAdjacency.multi_bfs over a store of the same edges,
    from every anchor kind: with edges, and edge-less."""
    from cortex_tpu_torch.graph.packed import UNREACHED, PackedAdjacency
    from cortex_tpu_torch.storage import MemoryStorage
    from cortex_tpu_torch.types import EdgeProvenance
    member = np.random.default_rng(9).integers(0, 30, 2000)
    src, dst = graph_data.seeded_edges(member, 6000, SEED)
    st = MemoryStorage()
    prov = EdgeProvenance.imported("t")
    st.bulk_insert_edge_rows((f"e{j}", str(s), str(t), "related_to", 0.5,
                              prov, 0.0, 0.0)
                             for j, (s, t) in enumerate(zip(src, dst)))
    pk = PackedAdjacency.build(st)
    anchors = np.array([int(src[0]), int(dst[5]), 999, 17, 1999])
    at = np.tile(np.arange(2000), (len(anchors), 1))
    for hops in (1, 2, 3):
        got = hybrid_reference.depths_at(src, dst, 2000, anchors, at, hops,
                                         cpu)
        for a, row in zip(anchors.tolist(), got):
            want = np.full(2000, hybrid_reference.UNREACHED, np.int8)
            want[a] = 0
            if str(a) in pk.row_of:
                d = pk.multi_bfs([pk.row_of[str(a)]], hops)
                for r in np.nonzero(d != UNREACHED)[0].tolist():
                    want[int(pk.ids[r])] = d[r]
            np.testing.assert_array_equal(row, want)


def _reference_answers(cell, cpu, **kw):
    data = hybrid_search.make_data(cell.cfg, cell.traffic, SEED, cpu)
    return data, hybrid_search.control_outputs(cell.cfg, cell.traffic, data,
                                               cpu, **kw)


def _judge(cell, data, outputs, cpu):
    return hybrid_search.judge(cell.cfg, cell.traffic, data, outputs, cpu)


def test_the_judge_passes_the_reference_and_fails_planted_faults(cpu):
    cell = tiny_hybrid()
    data, outputs = _reference_answers(cell, cpu, tf32=False)
    v = _judge(cell, data, outputs, cpu)
    assert v.correct, v.checks
    assert v.values["recall"] == 1.0 and v.values["depth_mismatch"] == 0

    # a wrong depth: one result's graph score and nearest anchor moved
    qn, res = next((q, r) for q, r in outputs if r[0][4] is not None)
    rid, vs, g, c, (a, d) = res[0]
    bad = [(rid, vs, 1.0 / (2.0 + d), c, (a, d + 1))] + res[1:]
    v = _judge(cell, data, [(qn, bad)], cpu)
    assert not v.correct and v.checks["depth_mismatch"][0] == 1

    # a swapped id: another row's id under the first result's scores
    rid, *rest = res[0]
    other = str((int(rid) + 2) % len(data.ids))
    v = _judge(cell, data, [(qn, [(other, *rest)] + res[1:])], cpu)
    assert not v.correct

    # a missing answer and a short one are failed operations
    qn, res = outputs[3]
    v = _judge(cell, data, [(qn, None), (qn, res[:9])], cpu)
    assert v.failed == 2 and not v.correct


def test_the_tf32_control_comes_out_not_correct(cpu):
    """The reference with its vector leg in TF32 (its operand rounding
    emulated on the CPU) in the program's place fails the comparison, at
    the timed width."""
    cell = tiny_hybrid(dim=768, rows=3000, centers=60, edge_draw=15000)
    data, outputs = _reference_answers(cell, cpu)
    v = _judge(cell, data, outputs, cpu)
    assert not v.correct
    assert (v.checks["score_gap"][0] > v.checks["score_gap"][2]
            or v.checks["combined_gap"][0] > v.checks["combined_gap"][2])


def test_the_cell_resolves_with_its_metrics():
    cell = registry.cell(registry.benchmark(), CELL)
    assert cell.cfg["system"] == "hybrid" and cell.chips == 1
    assert [m["name"] for m in cell.per_layer] == list(METRICS)
    assert {m["name"] for m in cell.end_to_end} == {
        "latency_p50_ms", "recall_at_10", "setup_s"}
    assert all(m["moves"] == "latency_p50_ms" for m in cell.per_layer)
    for m in cell.per_layer:
        assert callable(registry.metric(m["name"]).read)
    assert callable(registry.system("hybrid").least_work)


def test_a_sound_run_of_the_system_is_correct(cpu, packed, monkeypatch):
    monkeypatch.setattr(run, "PROFILE_CALLS", 20)
    cell = tiny_hybrid()
    for trace in (False, True):
        result, lines = run.run_cell(cell, SEED, 0.5, trace, cpu,
                                     t0=time.perf_counter())
        assert result["correct"] is True, lines
        assert result["failed"] == 0 and result["attempted"] > 0
        checks = result["checks"]
        assert list(checks) == ["failed", "score_gap", "combined_gap",
                                "depth_mismatch", "rank_gap"]
        if not trace:
            m = result["metrics"]
            assert set(m) == {"latency_p50_ms", "recall_at_10", "setup_s"}
            assert m["recall_at_10"]["value"] > 0.99
        else:
            # no device in the CPU's trace: the readers read nothing
            assert result["metrics"] == {}
            assert result["device"]["busy_s"] == 0


def test_the_readers_read_the_programs_regions_and_counters(cpu, packed):
    """Regions and counters of hybrid calls made while tracing is on,
    read through the metric readers as from a traced run on a card."""
    from types import SimpleNamespace
    from cortex_tpu_torch.utils import tracing
    cell = tiny_hybrid()
    sysmod = registry.system("hybrid")
    data = sysmod.make_data(cell.cfg, cell.traffic, SEED, cpu)
    sut = sysmod.build(cell.cfg, data, cpu)
    sysmod.call(sut, data.batches[0], cell.traffic)
    tracing.reset_stats()
    tracing.reset_counters()
    tracing.enable(True)
    try:
        for q in data.batches[:40]:
            sysmod.call_async(sut, q, cell.traffic)()
    finally:
        tracing.enable(False)
    c = tracing.counters()
    assert c["hybrid.queries"] == 40 and c["search.queries"] == 40
    assert c.get("hybrid.device_walks", 0) == 0
    assert 40 <= c["hybrid.anchors"] <= 120 and c["hybrid.reached_rows"] > 0
    calls = tracing.regions()
    prox = [r for r in calls if r.name == "hybrid.proximity"]
    fuse = [r for r in calls if r.name == "hybrid.fuse"]
    disp = [r for r in calls if r.name == "search.dispatch"]
    assert len(prox) == len(fuse) == len(disp) == 40
    assert [r.call for r in prox] == [r.call for r in disp] == [
        r.call for r in fuse]
    trace = SimpleNamespace(busy_s=1.0, window_s=2.0, calls=40)
    fake = SimpleNamespace(trace=trace, least_s=0.01)
    got = {m: registry.metric(m).read(fake) for m in METRICS}
    assert got["proximity_ms.b1"] > 0 and got["fuse_ms.b1"] > 0
    assert got["reached_rows.b1"] == c["hybrid.reached_rows"] / 40
    assert got["hybrid_roofline.b1"] == pytest.approx(40.0)
    assert got["hybrid_idle.b1"] == pytest.approx(50.0)
    sysmod.close(sut)
