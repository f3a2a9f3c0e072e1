"""cortex_tpu_torch imports and runs with jax and cortex_tpu blocked.

One subprocess blocks jax and the JAX package (sys.modules['jax'] =
sys.modules['jaxlib'] = sys.modules['cortex_tpu'] = None, so any import
of them raises), imports every module of the port, runs tiny
store -> search passes on the CPU (the IVF index, the flat index and the
default config), an edges -> hybrid search pass through every tier of
the graph mirror and linker cycles with decay and dedup on SQLite (the
decay sweep through the out-of-process worker), a store -> search pass
through the text encoder (a "flax:<npz>" model), a gated store, a
rejected duplicate, a briefing, a query and a retention sweep, a
SQLite store closed and reopened from its index snapshot with an HTTP
search served over it (the port's server/http.py on a local port), the
public names the port shares with the reference (BruteForceIndex, the
native Dijkstra and decay sweep, profile_trace around entry()), and
reports what it saw as JSON; the tests below check that report.
`python -m cortex_tpu_torch --help` runs with the same blocks.
Another runs the decay worker itself (python -m cortex_tpu_torch.linker.decay_worker) with the
same blocks. A third shows that chip_smoke.py's own check fails once a
module of the JAX package is loaded.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, json, pkgutil, sys, tempfile
    from dataclasses import replace
    sys.modules["jax"] = None
    sys.modules["jaxlib"] = None
    sys.modules["cortex_tpu"] = None
    import torch
    import cortex_tpu_torch
    from cortex_tpu_torch.errors import ConfigError, DeviceUnavailable
    from cortex_tpu_torch.types import Node, Source
    from cortex_tpu_torch import Cortex
    from cortex_tpu_torch.config import CortexConfig
    from cortex_tpu_torch.utils.device import resolve_device
    from cortex_tpu_torch.vector import VectorFilter

    def cfg(**kw):
        c = CortexConfig()
        c.embedding.index = "ivf"
        c.embedding.model = "hash-64"
        for k, v in kw.items():
            setattr(c.embedding, k, v)
        return c

    def store_search(config, device="cpu"):
        cx = Cortex.in_memory(config, device=device)
        nodes = [Node.new("fact" if i % 2 else "event",
                          f"note {i} about topic{i % 5}", f"body word{i}",
                          Source(agent="a"), 0.5) for i in range(40)]
        cx.store_batch(nodes)
        hits = cx.search(f"note 3 about topic3", 5, record_access=False)
        flt = cx.search("note 3 about topic3", 5, flt=VectorFilter(
            kinds=["event"]), record_access=False)
        return cx, {"top1": hits[0][1].id == nodes[3].id,
                    "filtered_kinds": sorted({n.kind for _, n in flt}),
                    "index": cx.index.index_info()["kind"]}

    def ivf_state(cx):
        info = cx.index.index_info()
        co = cx.index._corpus
        return {"graph_degree": info["graph_degree"],
                "graph_built": co._nbrs_h is not None,
                "target_recall": info["target_recall"],
                "tuned": info["nprobe_tuned"] > 0}

    out = {}
    out["modules"] = sorted(
        m.name for m in pkgutil.walk_packages(cortex_tpu_torch.__path__,
                                              "cortex_tpu_torch.")
        if importlib.import_module(m.name) is not None)

    def hybrid_tiers():
        from cortex_tpu_torch.types import Edge, EdgeProvenance
        cx = Cortex.in_memory(CortexConfig(), device="cpu")
        nodes = [Node.new("fact", f"linked note {i} about topic{i % 3}",
                          f"body word{i}", Source(agent="a"), 0.5)
                 for i in range(30)]
        cx.store_batch(nodes)
        for i in range(29):
            cx.create_edge(Edge.new(nodes[i].id, nodes[i + 1].id,
                                    "related_to", 0.7,
                                    EdgeProvenance.manual("a")))
        seen = {}
        for tier, kw in {"host": {}, "relax": {"HOST_FRONTIER_BUDGET": 0},
                         "packed": {"PACKED_EDGE_THRESHOLD": 0,
                                    "HOST_FRONTIER_BUDGET": 0}}.items():
            for k, v in kw.items():
                setattr(cx.mirror, k, v)
            got = cx.search_hybrid("linked note 4 about topic1",
                                   [nodes[0].id], 5)
            seen[tier] = sorted((r.node.id == nodes[0].id, r.graph_score)
                                for r in got)
        return seen

    out["hybrid"] = hybrid_tiers()

    def linker_cycles(workdir):
        cx = Cortex.open(f"{workdir}/linker.db", CortexConfig(),
                         device="cpu")
        nodes = [Node.new("fact", f"linked entry {i} on topic{i % 4}",
                          f"body word{i % 6}", Source(agent=f"a{i}"),
                          0.5) for i in range(60)]
        cx.store_batch(nodes)
        first = cx.run_linker_cycle()        # decay and dedup are due
        imported = cx.bulk_import(
            [Node.new("fact", f"imported entry {i}", "imported body",
                      Source(agent="b"), 0.5) for i in range(5)])
        second = cx.run_linker_cycle()
        cx.close()
        return {"processed": first.nodes_processed,
                "edges": first.total_edges > 0,
                "imported": imported["nodes"],
                "second_processed": second.cycle_nodes_processed}

    with tempfile.TemporaryDirectory() as workdir:
        out["linker"] = linker_cycles(workdir)
    cx, ivf = store_search(cfg())
    out.update(ivf)
    # the flat index: asked for, the default config (index = "flat" with
    # ivf_graph_degree = 32, which only the IVF index reads), and the
    # IVF-only settings beside index = "flat"
    out["flat"] = {
        "flat": store_search(cfg(index="flat"))[1],
        "default": store_search(CortexConfig())[1],
        "flat_ivf_settings": store_search(cfg(
            index="flat", ivf_graph_degree=32, ivf_target_recall=0.9))[1],
    }

    def services(workdir):
        # the write gate, a briefing, the query DSL and retention on a
        # SQLite store, on the CPU
        from cortex_tpu_torch.errors import GateRejection
        from cortex_tpu_torch.policies import KindRetention, RetentionConfig
        c = CortexConfig()
        c.retention = RetentionConfig(
            by_kind={"observation": KindRetention(ttl_days=30)})
        cx = Cortex.open(f"{workdir}/services.db", c, device="cpu")
        first = Node.new("fact", "Database runs postgres fourteen",
                         "Our primary database is postgres fourteen.",
                         Source(agent="a"))
        stored = cx.store(first, gate=True) == first.id
        try:
            cx.store(Node.new("fact", first.title, first.body,
                              Source(agent="b")), gate=True)
            rejected = None
        except GateRejection as e:
            rejected = [e.check, e.existing_node == first.id]
        old = Node.new("observation", "Stale observation entry",
                       "Body long enough for the checks here.",
                       Source(agent="a"), 0.1)
        old.created_at = old.last_accessed_at = 1_600_000_000.0
        cx.store(old)
        brief = cx.briefing("a")
        got = {"stored": stored, "rejected": rejected,
               "briefing": first.title in brief,
               "query": [n.id == first.id for n in cx.query("kind:fact")],
               "retention": list(cx.run_retention()),
               "swept_from_index": old.id not in cx.index}
        cx.close()
        return got

    with tempfile.TemporaryDirectory() as workdir:
        out["services"] = services(workdir)

    def served(workdir):
        # the snapshot boot, then a search served over HTTP on the CPU
        import asyncio
        from aiohttp.test_utils import TestClient, TestServer
        from cortex_tpu_torch.server.http import create_app
        from cortex_tpu_torch.server.state import ServerState
        path = f"{workdir}/served.db"
        cx = Cortex.open(path, CortexConfig(), device="cpu")
        nodes = [Node.new("fact", f"served note {i} about topic{i % 3}",
                          f"body word{i}", Source(agent="a"), 0.5)
                 for i in range(20)]
        cx.store_batch(nodes)
        cx.close()
        cx = Cortex.open(path, CortexConfig(), device="cpu")
        booted = cx._chain_bs is not None and len(cx.index) == 20

        async def search():
            client = TestClient(TestServer(create_app(ServerState(
                cortex=cx))))
            await client.start_server()
            try:
                r = await client.get("/search", params={
                    "q": nodes[4].title, "limit": "3"})
                return r.status, await r.json()
            finally:
                await client.close()

        status, body = asyncio.run(search())
        cx.close()
        return {"snapshot_boot": booted, "status": status,
                "top1": body["data"][0]["node"]["id"] == nodes[4].id,
                "hits": len(body["data"])}

    with tempfile.TemporaryDirectory() as workdir:
        out["served"] = served(workdir)

    def surface(workdir):
        # the reference's public names the port also carries
        import os
        import numpy as np
        from cortex_tpu_torch.entry import entry
        from cortex_tpu_torch.native import (decay_sweep_native,
                                             dijkstra_maxprod)
        from cortex_tpu_torch.ops import (cosine_scores, cosine_topk,
                                          cosine_topk_quant,
                                          cosine_topk_xla, normalize_rows)
        from cortex_tpu_torch.utils import profile_trace
        from cortex_tpu_torch.vector import (BruteForceIndex, DeviceCorpus,
                                             SimilarityConfig, STEmbedder,
                                             apply_score_decay)
        bf = BruteForceIndex(4)
        bf.insert("a", np.array([1, 0, 0, 0], np.float32))
        bf.insert("b", np.array([0, 1, 0, 0], np.float32))
        path, w = dijkstra_maxprod(np.array([0, 1, 2, 2], np.int32),
                                   np.array([1, 2], np.int32),
                                   np.array([0.5, 0.5], np.float32), 0, 2)
        _, flags = decay_sweep_native(np.ones(2, np.float32),
                                      np.ones(2, np.float32),
                                      np.array([0, 9], np.float32),
                                      0.01, 0.1)
        with profile_trace(workdir):
            step, args = entry("cpu")
            v, i = step(*args)
        return {"bf_top1": bf.search_batch(np.eye(4, dtype=np.float32)[:1],
                                           1)[0][0][0],
                "path": path.tolist(), "weight": w,
                "flags": flags.tolist(), "entry": list(v.shape),
                "traces": len(os.listdir(workdir)),
                "named": all(callable(f) for f in (
                    cosine_scores, cosine_topk, cosine_topk_quant,
                    cosine_topk_xla, normalize_rows, SimilarityConfig,
                    STEmbedder, apply_score_decay, DeviceCorpus))}

    with tempfile.TemporaryDirectory() as workdir:
        out["surface"] = surface(workdir)
    out["jax_loaded"] = any(
        m == "jax" or m.startswith(("jax.", "jaxlib"))
        for m, v in sys.modules.items() if v is not None)
    out["cortex_tpu_loaded"] = sorted(
        m for m, v in sys.modules.items()
        if v is not None and (m == "cortex_tpu"
                              or m.startswith("cortex_tpu.")))

    def raises(fn, exc):
        try:
            fn()
        except exc as e:
            return str(e)
        return None

    if not torch.cuda.is_available():
        out["cuda_refused"] = raises(lambda: resolve_device("cuda"),
                                     DeviceUnavailable)
        out["cortex_cuda_refused"] = raises(
            lambda: Cortex.in_memory(cfg()), DeviceUnavailable)
    # the mesh indexes ([embedding] sharded = true) on eight cpu devices
    sharded = {
        "flat": dict(index="flat", sharded=True),
        "sharded": dict(sharded=True),
    }
    # the kNN-graph refinement and the nprobe tuner (ivf_nlist 8 so the
    # 40 nodes make more than the tuner's 8 lists)
    out["ivf_options"] = {}
    for name, kw in {"graph": dict(ivf_graph_degree=32),
                     "tuner": dict(ivf_target_recall=0.9, ivf_nlist=9)
                     }.items():
        cx_o, got = store_search(cfg(**kw))
        out["ivf_options"][name] = dict(got, **ivf_state(cx_o))
    out["sharded"] = {}
    for name, kw in sharded.items():
        cx_s, got = store_search(cfg(**kw), device=["cpu"] * 8)
        out["sharded"][name] = dict(got, cls=type(cx_s.index).__name__,
                                    mesh=cx_s.index.index_info()["mesh"])
    # widths: IVF past d 1040 opens, stores and searches; past the scan
    # kernels' 4096 it is refused at open, as is the flat index's int8
    # scan (search_path auto or quant), but not its exact product
    out["ivf_1536"] = store_search(cfg(model="hash-1536",
                                       dimension=1536))[1]
    wide = dict(model="hash-4097", dimension=4097)
    out["width_errors"] = {
        name: raises(lambda kw=kw: Cortex.in_memory(cfg(**kw, **wide),
                                                    device="cpu"),
                     ConfigError)
        for name, kw in {"ivf": {}, "flat": dict(index="flat"),
                         "flat_quant": dict(index="flat",
                                            search_path="quant"),
                         "flat_exact": dict(index="flat",
                                            search_path="exact")}.items()}

    def local_weights(weights_dir):
        # an empty model dir holds no weights: hashing, as in the
        # reference; a flax:<npz> model serves the device encoder
        from cortex_tpu_torch.models.encoder import (BertEncoderConfig,
                                                     init_params, save_npz)
        empty = Cortex.in_memory(cfg(model=weights_dir), device="cpu")
        enc_cfg = BertEncoderConfig(vocab_size=64, hidden=32, layers=1,
                                    heads=2, intermediate=64,
                                    max_position=64)
        words = sorted({w for i in range(40) for w in (
            f"note {i} about topic{i % 5} body word{i}").split()})
        vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words
        npz = f"{weights_dir}/enc.npz"
        save_npz(npz, init_params(replace(enc_cfg, vocab_size=len(vocab))),
                 replace(enc_cfg, vocab_size=len(vocab)), vocab=vocab)
        flax_cx, got = store_search(cfg(index="flat", model=f"flax:{npz}",
                                        dimension=32))
        return {"empty_dir": empty.embedder.model_name,
                "flax": type(flax_cx.embedder).__name__,
                "flax_name": flax_cx.embedder.model_name == f"flax:{npz}",
                "flax_top1": got["top1"]}

    with tempfile.TemporaryDirectory() as weights_dir:
        out["local_weights"] = local_weights(weights_dir)
    ivf_defaults = CortexConfig()
    ivf_defaults.embedding.index = "ivf"
    ivf_defaults.embedding.model = "hash-64"
    cx_d, got = store_search(ivf_defaults)
    out["ivf_defaults"] = dict(got, **ivf_state(cx_d))
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def report():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_every_module_imports_without_jax(report):
    mods = set(report["modules"])
    for name in ("graph.csr", "graph.engine", "graph.packed",
                 "graph.traversal", "graph.paths", "graph.host_csr",
                 "graph.temporal",
                 "ops.graph_bfs", "vector.hybrid", "native", "api",
                 "linker.auto_linker", "linker.config", "linker.decay",
                 "linker.decay_worker", "linker.dedup", "linker.metrics",
                 "linker.rules", "ops.decay", "utils.tracing",
                 "vector.config", "models.encoder", "models.tokenizer",
                 "models.convert", "ops.encoder", "ops.knn_graph",
                 "vector.knn_graph", "kinds", "relations", "gate",
                 "gate.schema", "query.dsl", "policies.audit",
                 "policies.retention", "briefing.engine",
                 "briefing.precompute", "prompt.resolver",
                 "prompt.rollback", "prompt.selection", "server",
                 "server.batcher", "server.conversions",
                 "server.cortex_pb2", "server.grpc_service", "server.http",
                 "server.mcp", "server.metrics", "server.observability",
                 "server.serve", "server.state", "server.viz",
                 "server.webhooks", "cli", "cli.agent_prompt", "cli.data",
                 "cli.main", "cli.shell", "ingest", "ingest.events",
                 "ingest.file_ingest", "ingest.nats_client",
                 "ingest.warren", "storage.encrypted", "plugins",
                 "parallel", "parallel.sharding", "parallel.sharded_index",
                 "parallel.sharded_ivf", "multichip", "__main__"):
        assert f"cortex_tpu_torch.{name}" in mods


def test_public_surface_without_jax(report):
    assert report["surface"] == {"bf_top1": "a", "path": [0, 1, 2],
                                 "weight": 0.25, "flags": [0, 2],
                                 "entry": [32, 16], "traces": 1,
                                 "named": True}


def test_linker_runs_without_jax(report):
    # cycle 0 runs the decay sweep through the worker and links 40
    # nodes: created within 30 minutes of each other, each pair takes a
    # temporal-proximity edge, 50 a node, and the cycle's budget of
    # 2,000 edges stops it after the 40th. The import then moves the
    # cursor past every stored row.
    assert report["linker"] == {"processed": 40, "edges": True,
                                "imported": 5, "second_processed": 0}


WORKER = textwrap.dedent("""
    import json, runpy, sys
    sys.modules["jax"] = None
    sys.modules["jaxlib"] = None
    sys.modules["cortex_tpu"] = None
    sys.argv = ["decay_worker", *sys.argv[1:]]
    try:
        runpy.run_module("cortex_tpu_torch.linker.decay_worker",
                         run_name="__main__")
        rc = 0
    except SystemExit as e:
        rc = e.code
    print(json.dumps({"rc": rc, "loaded": sorted(
        m for m, v in sys.modules.items() if v is not None and (
            m in ("jax", "cortex_tpu")
            or m.startswith(("jax.", "jaxlib", "cortex_tpu.")))),
        "engine": "cortex_tpu_torch.linker.decay" in sys.modules}))
""")


def test_decay_worker_runs_without_jax(tmp_path):
    from cortex_tpu_torch.storage import SqliteStorage
    from cortex_tpu_torch.types import Edge, EdgeProvenance, Node, Source
    path = str(tmp_path / "decay.db")
    store = SqliteStorage(path)
    nodes = [Node.new("fact", f"worker entry {i}", "body",
                      Source(agent="a"), 0.5) for i in range(20)]
    store.put_nodes_batch(nodes)
    old = 1_700_000_000.0
    store.bulk_put_edges([
        Edge(id=f"e{i}", from_id=nodes[i].id, to_id=nodes[i + 1].id,
             relation="related_to", weight=0.3,
             provenance=EdgeProvenance.imported("seed"), created_at=old,
             updated_at=old) for i in range(19)])
    store.close()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    cfg = json.dumps({"daily_decay_rate": 0.01, "prune_threshold": 0.1,
                      "delete_threshold": 0.05, "importance_shield": 0.8,
                      "access_reinforcement_days": 7.0,
                      "exempt_manual": True})
    proc = subprocess.run(
        [sys.executable, "-c", WORKER, path, cfg, "cpu", "1",
         repr(old + 200 * 86400.0)], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    # 0.3 * exp(-0.01 * 0.6 * 200) = 0.09: pruned, not deleted
    assert json.loads(lines[-2]) == {"pruned": 19, "deleted": 0}
    assert json.loads(lines[-1]) == {"rc": 0, "loaded": [],
                                     "engine": True}


def test_hybrid_tiers_run_without_jax(report):
    # every tier of the mirror gives the same proximity (a chain of 30)
    tiers = report["hybrid"]
    assert tiers["host"] == tiers["relax"] == tiers["packed"]
    assert [True, 1.0] in tiers["host"]


def test_chip_smoke_fails_once_the_jax_package_is_loaded():
    code = textwrap.dedent("""
        import sys, types
        import chip_smoke
        chip_smoke.check_no_reference_import()          # nothing loaded
        sys.modules["cortex_tpu.graph.csr"] = types.ModuleType("x")
        try:
            chip_smoke.check_no_reference_import()
        except AssertionError as e:
            print("refused:", e)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "refused: the JAX package was imported" in proc.stdout
    assert "cortex_tpu.graph.csr" in proc.stdout


def test_store_search_runs_without_jax(report):
    assert report["top1"] is True
    assert report["filtered_kinds"] == ["event"]


def test_jax_never_imported(report):
    assert report["jax_loaded"] is False


def test_cortex_tpu_never_imported(report):
    # after store -> search on the IVF index, the flat index and the
    # default config: no module of the JAX package was loaded
    assert report["cortex_tpu_loaded"] == []


def test_cuda_absent_raises(report):
    import torch
    if torch.cuda.is_available():
        pytest.skip("CUDA is present here: resolve_device does not raise")
    assert "CUDA is not available" in report["cuda_refused"]
    assert report["cortex_cuda_refused"]


@pytest.mark.parametrize("name", ["flat", "graph", "tuner", "sharded",
                                  "local_weights"])
def test_unported_config_raises_config_error(report, name):
    if name in ("flat", "sharded"):
        # ported: [embedding] sharded = true with the flat index (flat)
        # and the IVF index (sharded) opens, stores and searches without
        # jax on a mesh of eight cpu devices
        got = report["sharded"][name]
        kind = "flat" if name == "flat" else "ivf"
        assert got["top1"] is True and got["index"] == kind
        assert got["filtered_kinds"] == ["event"]
        assert got["cls"] == ("ShardedFlatIndex" if kind == "flat"
                              else "ShardedIvfIndex")
        assert got["mesh"] == {"shards": 8, "replicas": 1}
        return
    if name in ("graph", "tuner"):
        # ported: ivf_graph_degree / ivf_target_recall with index = "ivf"
        # (the only index that reads them) open, store and search without
        # jax: the graph is built, the tuner picks an nprobe
        got = report["ivf_options"][name]
        assert got["top1"] is True and got["index"] == "ivf"
        assert got["filtered_kinds"] == ["event"]
        if name == "graph":
            assert got["graph_degree"] == 32 and got["graph_built"]
        else:
            assert got["target_recall"] == 0.9 and got["tuned"]
        return
    if name == "local_weights":
        # the text encoder is ported: nothing refuses a model with
        # weights. An empty local model dir falls back to hashing, as in
        # the reference; a flax:<npz> model opens and serves without jax
        assert report["local_weights"] == {
            "empty_dir": "hash-384", "flax": "TorchEncoderEmbedder",
            "flax_name": True, "flax_top1": True}
        return


def test_ivf_past_d_1040_stores_and_searches(report):
    assert report["ivf_1536"] == {"top1": True, "filtered_kinds": ["event"],
                                  "index": "ivf"}


@pytest.mark.parametrize("name", ["ivf", "flat", "flat_quant",
                                  "flat_exact"])
def test_dimension_past_the_scan_kernels_raises_at_open(report, name):
    msg = report["width_errors"][name]
    if name == "flat_exact":
        assert msg is None          # the exact product has no such limit
        return
    assert msg is not None and "4096" in msg and "dimension=4097" in msg


def test_reference_defaults_are_refused(report):
    # no longer refused: with index = "ivf", the reference's other
    # defaults (ivf_graph_degree = 32, the kNN-graph refinement) open,
    # store and search without jax, with the graph built
    assert report["ivf_defaults"] == {
        "top1": True, "filtered_kinds": ["event"], "index": "ivf",
        "graph_degree": 32, "graph_built": True, "target_recall": 0.0,
        "tuned": False}


@pytest.mark.parametrize("name", ["flat", "default", "flat_ivf_settings"])
def test_flat_index_stores_and_searches_without_jax(report, name):
    got = report["flat"][name]
    assert got == {"top1": True, "filtered_kinds": ["event"],
                   "index": "flat"}


def test_reference_defaults_open_the_flat_index(report):
    # the port keeps the reference defaults: index = "flat" with
    # ivf_graph_degree = 32, which the flat index does not read
    assert report["flat"]["default"]["index"] == "flat"


def test_write_gate_raises_config_error(report):
    # the write gate is ported: a gated store is accepted and a planted
    # duplicate of it is rejected by the conflict check, without jax
    got = report["services"]
    assert got["stored"] is True
    assert got["rejected"] == ["conflict", True]


def test_briefing_query_retention_run_without_jax(report):
    got = report["services"]
    assert got["briefing"] is True
    assert got["query"] == [True]
    assert got["retention"] == [1, 0] and got["swept_from_index"]


def test_snapshot_boot_and_served_search_without_jax(report):
    assert report["served"] == {"snapshot_boot": True, "status": 200,
                                "top1": True, "hits": 3}


CLI_HELP = textwrap.dedent("""
    import runpy, sys
    sys.modules["jax"] = None
    sys.modules["jaxlib"] = None
    sys.modules["cortex_tpu"] = None
    sys.argv = ["cortex_tpu_torch", "--help"]
    try:
        runpy.run_module("cortex_tpu_torch", run_name="__main__")
    except SystemExit as e:
        print("exit", e.code)
    print("loaded", sorted(
        m for m, v in sys.modules.items() if v is not None and (
            m in ("jax", "cortex_tpu")
            or m.startswith(("jax.", "jaxlib", "cortex_tpu.")))))
""")


def test_cli_help_runs_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", CLI_HELP], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert "--device DEVICE" in out and "serve" in out and "mcp" in out
    assert out.splitlines()[-2:] == ["exit 0", "loaded []"]
