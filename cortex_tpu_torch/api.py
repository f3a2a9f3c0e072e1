"""Embedded Cortex of the port: store -> search over the flat index
(the default) or the IVF index, edges, the graph engine and hybrid
search, the auto-linker with edge decay, and the write gate, briefings,
retention, the prompt subsystem and the query DSL; text is embedded by
the configured model, the device text encoder for a model with weights
on disk (`vector/embedding.py::default_embedder`).

Counterpart of cortex_tpu/api.py::Cortex, limited to the slices this
package ports: open / in_memory, store (gate= runs the four-check write
gate under the admission lock, skip_quality= its bypass) / store_batch
(both run the classifier hooks) / bulk_import / update_node /
delete_node, get_node / list_nodes / query (the DSL), search with the
score-decay re-rank and access recording, create_edge / delete_edge,
search_hybrid (vector similarity x graph proximity), traverse /
neighborhood / find_paths, briefing / briefing_full, stats,
run_linker_cycle, run_retention, reindex, the typed constructors (fact,
decision, ...) and close. Storage (SQLite or memory), node types, hooks,
the graph engine, the auto-linker, the gate, the briefing engine, the
retention engine and audit log, the prompt resolver and rollback monitor
and the query DSL are the port's copies of the reference's modules; the
text encoder (models/encoder.py) runs its forward, the device graph
mirror (graph/csr.py) its hop depths, the linker's decay engine its
sweep (D1), and the gate's conflict check its search, on `device`.

At open the index is rebuilt from the stored embeddings (index
snapshots are not ported). The device is an argument: "cuda" (the
default) raises when CUDA is absent; the CPU runs only when asked for.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .briefing import Briefing, BriefingEngine, GraphVersion
from .config import CortexConfig, check_ported
from .errors import GateRejection as GateRejectionError
from .gate import SchemaValidator, WriteGate
from .graph import (BOTH, DeviceGraphMirror, GraphEngine, PathRequest,
                    Subgraph, TraversalRequest)
from .hooks import HookRegistry, MutationHook
from .linker import AutoLinker
from .policies import AuditLog, RetentionEngine
from .prompt import PromptResolver, RollbackMonitor
from .query import parse_and_compile
from .storage import MemoryStorage, NodeFilter, SqliteStorage, Storage
from .types import Edge, Node, Source
from .utils.device import resolve_device
from .vector.embedding import default_embedder
from .vector.hybrid import HybridQuery, HybridResult, HybridSearch
from .vector.index import TorchFlatIndex, VectorFilter
from .vector.ivf import TorchIvfIndex
from .vector.scoring import apply_score_decay_batch


class Cortex:
    """Embedded engine. `Cortex.open(path)` for durable SQLite-backed
    state; `Cortex.in_memory()` for tests and ephemeral use."""

    def __init__(self, storage: Storage,
                 config: Optional[CortexConfig] = None, *,
                 device="cuda"):
        self.config = config or CortexConfig()
        check_ported(self.config)
        self.device = resolve_device(device)
        self.storage = storage
        # held across every store-write + index-mutation pair
        self._persist_lock = threading.Lock()
        self.embedder = default_embedder(self.config.embedding.model,
                                         self.config.embedding.dimension,
                                         device=self.device)
        self.index = self._make_index()
        self._rebuild_index()
        self.graph = GraphEngine(storage)
        self.mirror = DeviceGraphMirror(self.graph.cache, device=self.device)
        self.graph_version = GraphVersion()
        self.hooks = HookRegistry()
        self.hybrid = HybridSearch(storage, self.embedder, self.index,
                                   self.mirror)
        self.briefing_engine = BriefingEngine(
            storage, self.graph, self.index, self.embedder, self.hybrid,
            self.graph_version, self.config.briefing)
        self.linker = AutoLinker(
            storage, self.index, self.embedder, self.config.auto_linker,
            persist_lock=self._persist_lock,
            on_index_pair_failure=self._index_pair_failed)
        # the decay sweep (D1) runs on this engine's device
        self.linker.decay_engine.device = self.device
        self.retention = RetentionEngine(self.config.retention,
                                         self.config.score_decay)
        self.audit = AuditLog(storage)
        self.schema_validator = SchemaValidator(self.config.schemas)
        self.prompts = PromptResolver(storage)
        self.rollback_monitor = RollbackMonitor(storage,
                                                self.config.prompt_rollback)
        # classifier plugins: callables node -> Optional[str]
        self.classifiers: List = []
        # serializes gate check + store across callers, so that two
        # concurrent near-duplicates cannot both pass the conflict check
        # before either is stored
        self.admission_lock = threading.Lock()

    # ------------------------------------------------------------------ boot
    @staticmethod
    def open(path: str, config: Optional[CortexConfig] = None, *,
             device="cuda") -> "Cortex":
        """Open durable SQLite-backed state at `path`."""
        sync_mode = (config.server.sqlite_synchronous
                     if config is not None else "normal")
        storage = SqliteStorage(path, synchronous=sync_mode)
        try:
            return Cortex(storage, config, device=device)
        except BaseException:
            storage.close()
            raise

    @staticmethod
    def in_memory(config: Optional[CortexConfig] = None, *,
                  device="cuda") -> "Cortex":
        return Cortex(MemoryStorage(), config, device=device)

    def _make_index(self) -> TorchFlatIndex:
        e = self.config.embedding
        if e.index == "ivf":
            return TorchIvfIndex(self.embedder.dimension, nlist=e.ivf_nlist,
                                 nprobe=e.ivf_nprobe, spill=e.ivf_spill,
                                 graph_degree=e.ivf_graph_degree,
                                 target_recall=e.ivf_target_recall,
                                 device=self.device)
        return TorchFlatIndex(self.embedder.dimension,
                              search_path=e.search_path,
                              storage_dtype=e.device_dtype,
                              device=self.device)

    def _rebuild_index(self) -> None:
        """Insert every stored embedding of the configured width."""
        nodes = [n for n in self.storage.list_nodes(NodeFilter())
                 if n.embedding is not None
                 and len(n.embedding) == self.embedder.dimension]
        if nodes:
            self.index.insert_batch(
                [n.id for n in nodes],
                np.stack([np.asarray(n.embedding, np.float32)
                          for n in nodes]),
                kinds=[n.kind for n in nodes],
                agents=[n.source.agent for n in nodes])

    def close(self) -> None:
        self.storage.close()

    # ------------------------------------------------------------ mutation
    def _apply_classifiers(self, node: Node) -> None:
        """Classifier plugins enrich metadata; their faults never block
        a write (the reference's contract)."""
        for clf in self.classifiers:
            try:
                label = clf(node)
                if label:
                    node.metadata.setdefault("classification", label)
            except Exception:  # noqa: BLE001
                pass

    def _on_write(self) -> None:
        self.graph.invalidate()
        self.graph_version.bump()

    def store(self, node: Node, *, gate: bool = False,
              skip_quality: bool = False, actor: str = "library") -> str:
        """Embed + persist + index + fire hooks. With gate=True the
        four-check write gate runs first (skip_quality: only the schema
        check) and raises GateRejection on failure."""
        self._apply_classifiers(node)
        if node.embedding is None:
            node.embedding = self.embedder.embed_node(node).tolist()
        if gate:
            # gate + persist under the admission lock; hooks fire after
            # its release, so a hook's own gated store cannot deadlock
            with self.admission_lock:
                rej = WriteGate.check_all(
                    node, np.asarray(node.embedding, np.float32),
                    self.index, self.storage, self.config.write_gate,
                    self.schema_validator, skip_quality=skip_quality)
                if rej is not None:
                    raise GateRejectionError(
                        rej.check, rej.reason, rej.suggestion,
                        existing_node=rej.existing_node,
                        existing_title=rej.existing_title)
                is_update = self._persist(node, actor)
        else:
            is_update = self._persist(node, actor)
        self.hooks.notify_node("updated" if is_update else "created", node)
        return node.id

    def _index_pair_failed(self) -> None:
        """The storage half of a store+index pair committed but the
        index half raised: the in-memory index now diverges from
        storage. The flags are the reference's; index snapshots (not
        ported yet) will read them. Reopening rebuilds the index from
        storage and recovers the row."""
        self._index_diverged = True
        self._index_base_synced = False
        logging.getLogger("cortex.api").exception(
            "index mutation failed after its storage write committed; "
            "reopen to rebuild the index from storage")

    def _persist(self, node: Node, actor: str) -> bool:
        """Store + index + version bump (no hooks). Returns is_update."""
        with self._persist_lock:
            is_update = self.storage.get_node(node.id) is not None
            self.storage.put_node(node, actor=actor)
            try:
                self.index.insert(node.id,
                                  np.asarray(node.embedding, np.float32),
                                  kind=node.kind,
                                  source_agent=node.source.agent)
            except BaseException:
                self._index_pair_failed()
                raise
        self._on_write()
        return is_update

    def store_batch(self, nodes: Sequence[Node], *,
                    actor: str = "library") -> List[str]:
        """Batch admission: classifiers, one embed_batch + one index
        insert."""
        if not nodes:
            return []
        for n in nodes:
            self._apply_classifiers(n)
        missing = [n for n in nodes if n.embedding is None]
        if missing:
            embs = self.embedder.embed_nodes(missing)
            for j, n in enumerate(missing):
                n.embedding = embs[j].tolist()
        with self._persist_lock:
            self.storage.put_nodes_batch(nodes, actor=actor)
            try:
                self.index.insert_batch(
                    [n.id for n in nodes],
                    np.stack([np.asarray(n.embedding, np.float32)
                              for n in nodes]),
                    kinds=[n.kind for n in nodes],
                    agents=[n.source.agent for n in nodes])
            except BaseException:
                self._index_pair_failed()
                raise
        self._on_write()
        for n in nodes:
            self.hooks.notify_node("created", n)
        return [n.id for n in nodes]

    def bulk_import(self, nodes: Sequence[Node], *,
                    edges: Sequence = (),
                    actor: str = "bulk-import",
                    batch: int = 100_000,
                    advance_linker_cursor: bool = True) -> dict:
        """Bulk-load path: bypasses the write gate, classifiers and
        hooks; embeds missing vectors in
        large batches; persists through the storage bulk path
        (additive: existing ids are left untouched, in storage and in
        the index); uploads embeddings via index.insert_batch; loads
        edges raw WITHOUT endpoint validation (import files are
        self-consistent).

        advance_linker_cursor=True marks the imported rows as already
        processed, so the auto-linker does not link the imported
        backlog; pass False to let imported nodes flow through normal
        link discovery.

        Returns {"nodes": inserted, "edges": inserted}."""
        nodes = list(nodes)
        n_inserted = 0
        for s in range(0, len(nodes), batch):
            chunk = nodes[s:s + batch]
            # additive contract applies to the INDEX too: storage skips
            # existing ids, so upserting their vectors would leave the
            # index describing content storage never accepted
            present = self.storage.existing_node_ids(
                [n.id for n in chunk])
            fresh = [n for n in chunk if n.id not in present]
            if not fresh:
                continue
            missing = [n for n in fresh if n.embedding is None]
            for ms in range(0, len(missing), 4096):
                mc = missing[ms:ms + 4096]
                embs = self.embedder.embed_nodes(mc)
                for j, n in enumerate(mc):
                    n.embedding = embs[j].tolist()
            with self._persist_lock:
                n_inserted += self.storage.bulk_put_nodes(fresh,
                                                          actor=actor)
                try:
                    self.index.insert_batch(
                        [n.id for n in fresh],
                        np.stack([np.asarray(n.embedding, np.float32)
                                  for n in fresh]),
                        kinds=[n.kind for n in fresh],
                        agents=[n.source.agent for n in fresh])
                except BaseException:
                    self._index_pair_failed()
                    raise
        e_inserted = 0
        edges = list(edges)
        for s in range(0, len(edges), batch):
            e_inserted += self.storage.bulk_put_edges(edges[s:s + batch],
                                                      actor=actor)
        if advance_linker_cursor and nodes:
            top = max(nodes, key=lambda n: (n.created_at, n.id))
            # the live linker's in-memory cursor, not only the stored
            # metadata: its next cycle would otherwise scan from the
            # stale in-memory cursor and then store it over this one
            self.linker.advance_cursor(top.created_at, top.id)
        self._on_write()
        return {"nodes": n_inserted, "edges": e_inserted}

    def update_node(self, node: Node, *, actor: str = "library") -> None:
        """Re-embed on update."""
        node.embedding = self.embedder.embed_node(node).tolist()
        node.updated_at = time.time()
        with self._persist_lock:
            self.storage.put_node(node, actor=actor)
            self.index.insert(node.id,
                              np.asarray(node.embedding, np.float32),
                              kind=node.kind,
                              source_agent=node.source.agent)
        self._on_write()
        self.hooks.notify_node("updated", node)

    def delete_node(self, node_id: str, *, hard: bool = False,
                    actor: str = "library") -> bool:
        node = self.storage.get_node(node_id)
        if node is None:
            return False
        with self._persist_lock:
            ok = (self.storage.hard_delete_node(node_id, actor=actor)
                  if hard else
                  self.storage.delete_node(node_id, actor=actor))
            if ok:
                self.index.remove(node_id)
        if ok:
            self._on_write()
            self.hooks.notify_node("deleted", node)
        return ok

    def create_edge(self, edge: Edge, *, actor: str = "library") -> str:
        self.storage.put_edge(edge, actor=actor)
        self._on_write()
        self.hooks.notify_edge("created", edge)
        return edge.id

    def delete_edge(self, edge_id: str, *, actor: str = "library") -> bool:
        edge = self.storage.get_edge(edge_id)
        ok = self.storage.delete_edge(edge_id, actor=actor)
        if ok and edge is not None:
            self._on_write()
            self.hooks.notify_edge("deleted", edge)
        return ok

    def add_hook(self, hook: MutationHook) -> None:
        self.hooks.add(hook)

    # --------------------------------------------------------------- queries
    def get_node(self, node_id: str) -> Optional[Node]:
        return self.storage.get_node(node_id)

    def list_nodes(self, f: Optional[NodeFilter] = None) -> List[Node]:
        return self.storage.list_nodes(f)

    def query(self, dsl: str) -> List[Node]:
        """Query-DSL filtered listing."""
        return self.storage.list_nodes(parse_and_compile(dsl))

    def overfetch_k(self, limit: int, decay: bool = True) -> int:
        """Candidate count for the device search before the decay
        re-rank: (limit*3).max(30) when decay is on."""
        if decay and self.config.score_decay.enabled:
            return max(limit * 3, 30)
        return limit

    def search(self, query: str, limit: int = 10, *,
               flt: Optional[VectorFilter] = None,
               decay: bool = True,
               recency_bias: Optional[float] = None,
               record_access: bool = True) -> List[Tuple[float, Node]]:
        """Device search + vectorized score-decay re-rank."""
        emb = self.embedder.embed(query)
        hits = self.index.search(emb, self.overfetch_k(limit, decay), flt)
        return self.finish_search(hits, limit, decay=decay,
                                  recency_bias=recency_bias,
                                  record_access=record_access)

    def finish_search(self, hits, limit: int = 10, *,
                      decay: bool = True,
                      recency_bias: Optional[float] = None,
                      record_access: bool = True
                      ) -> List[Tuple[float, Node]]:
        """Hydrate + decay-re-rank retrieved (node_id, score) hits, then
        record the access of each returned node."""
        cfg = self.config.score_decay
        nodes, raw = [], []
        fetched = self.storage.get_nodes([nid for nid, _ in hits])
        for nid, score in hits:
            n = fetched.get(nid)
            if n is None or n.deleted:
                continue
            nodes.append(n)
            raw.append(score)
        if decay:
            final = apply_score_decay_batch(
                cfg, np.asarray(raw, np.float32), nodes, now=time.time(),
                recency_bias=recency_bias)
        else:
            final = np.asarray(raw, np.float32)
        order = np.argsort(-final, kind="stable")[:limit]
        out = [(float(final[i]), nodes[i]) for i in order]
        if record_access:
            bump = []
            for _, n in out:
                if self.linker.decay_engine.should_reinforce(n):
                    # reset the decay clock on the node's edges, at most
                    # once per access_reinforcement_days
                    self.linker.decay_engine.reinforce(n.id, node=n)
                else:
                    bump.append(n)
            if bump:
                # one guarded UPDATE for all plain bumps
                applied = self.storage.record_access_batch(
                    [n.id for n in bump])
                for n in bump:
                    got = applied.get(n.id)
                    if got is not None:
                        n.access_count, n.last_accessed_at = got
        return out

    def search_hybrid(self, query: str, anchors: Sequence[str] = (),
                      limit: int = 10, *,
                      vector_weight: float = 0.7,
                      kind_filter: Optional[List[str]] = None,
                      max_anchor_depth: int = 3) -> List[HybridResult]:
        return self.hybrid.search(HybridQuery(
            query_text=query, anchors=list(anchors),
            vector_weight=vector_weight, limit=limit,
            kind_filter=kind_filter, max_anchor_depth=max_anchor_depth))

    def traverse(self, req: TraversalRequest) -> Subgraph:
        return self.graph.traverse(req)

    def neighborhood(self, node_id: str, depth: int = 1,
                     direction=BOTH) -> Subgraph:
        return self.graph.traverse(TraversalRequest(
            start=[node_id], max_depth=depth, direction=direction))

    def find_paths(self, req: PathRequest):
        return self.graph.find_paths(req)

    def briefing(self, agent_id: str, *, compact: bool = False) -> str:
        b = self.briefing_engine.generate(agent_id)
        return self.briefing_engine.render(b, compact=compact)

    def briefing_full(self, agent_id: str) -> Briefing:
        return self.briefing_engine.generate(agent_id)

    def stats(self):
        return self.storage.stats()

    # ------------------------------------------------------------ background
    def run_linker_cycle(self):
        m = self.linker.run_cycle()
        self._on_write()
        return m

    def run_retention(self) -> Tuple[int, int]:
        """The retention engine's sweep and purge; each deletion pairs
        the store write with the index removal under the persist lock,
        so a swept node leaves the live index (and the gate's conflict
        check) at once."""
        def soft(nid: str) -> bool:
            with self._persist_lock:
                ok = self.storage.delete_node(nid, actor="retention")
                if ok:
                    self.index.remove(nid)
            return ok

        def hard(nid: str) -> bool:
            with self._persist_lock:
                ok = self.storage.hard_delete_node(nid, actor="retention")
                if ok:
                    self.index.remove(nid)
            return ok

        swept = self.retention.sweep(self.storage, deleter=soft)
        purged = self.retention.purge_expired(self.storage, deleter=hard)
        if swept or purged:
            self._on_write()
        return swept, purged

    def reindex(self) -> int:
        """Re-embed every live node into a new index (after a model
        change), under the admission lock so that no write lands between
        the node snapshot and the swap. Every holder of the index is
        re-pointed, then the old index is closed: its device memory
        returns to the allocator and an IVF index's background graph
        build is discarded and joined."""
        with self.admission_lock:
            nodes = self.storage.list_nodes(NodeFilter())
            if not nodes:
                return 0
            embs = self.embedder.embed_nodes(nodes)
            for j, n in enumerate(nodes):
                n.embedding = embs[j].tolist()
            with self._persist_lock:
                self.storage.put_nodes_batch(nodes)
                old, self.index = self.index, self._make_index()
                self._rebuild_index()
            self.hybrid.index = self.index
            self.briefing_engine.index = self.index
            self.linker.index = self.index
            old.close()
            self._on_write()
            return len(nodes)

    # --------------------------------------------- convenience constructors
    @staticmethod
    def _make(kind: str, title: str, body: str, importance: float) -> Node:
        return Node.new(kind, title, body, Source(agent="library"),
                        importance)

    @staticmethod
    def fact(title: str, importance: float = 0.5) -> Node:
        return Cortex._make("fact", title, title, importance)

    @staticmethod
    def decision(title: str, body: str, importance: float = 0.5) -> Node:
        return Cortex._make("decision", title, body, importance)

    @staticmethod
    def event(title: str, body: str, importance: float = 0.5) -> Node:
        return Cortex._make("event", title, body, importance)

    @staticmethod
    def goal(title: str, body: str, importance: float = 0.5) -> Node:
        return Cortex._make("goal", title, body, importance)

    @staticmethod
    def observation(title: str, body: str, importance: float = 0.5) -> Node:
        return Cortex._make("observation", title, body, importance)

    @staticmethod
    def pattern(title: str, body: str, importance: float = 0.5) -> Node:
        return Cortex._make("pattern", title, body, importance)

    @staticmethod
    def preference(title: str, body: str, importance: float = 0.5) -> Node:
        return Cortex._make("preference", title, body, importance)

    @staticmethod
    def agent(title: str, body: str, importance: float = 0.8) -> Node:
        return Cortex._make("agent", title, body, importance)
