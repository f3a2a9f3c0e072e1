"""Embedded Cortex of the port: store -> search over the flat index
(the default) or the IVF index, edges, the graph engine and hybrid
search.

Counterpart of cortex_tpu/api.py::Cortex, limited to the slices this
package ports: open / in_memory, store / store_batch / update_node /
delete_node, get_node / list_nodes, search with the score-decay re-rank
and access recording, create_edge / delete_edge, search_hybrid (vector
similarity x graph proximity), traverse / neighborhood / find_paths, and
close. Storage (SQLite or memory), node types, hooks and the graph
engine are the port's copies of the reference's modules; the device
graph mirror (graph/csr.py) runs its hop depths on `device`.

At open the index is rebuilt from the stored embeddings (index
snapshots are not ported). The device is an argument: "cuda" (the
default) raises when CUDA is absent; the CPU runs only when asked for.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .config import GATE_ITEM, CortexConfig, check_ported
from .errors import ConfigError
from .graph import (BOTH, DeviceGraphMirror, GraphEngine, PathRequest,
                    Subgraph, TraversalRequest)
from .hooks import HookRegistry, MutationHook
from .linker.decay import DecayEngine
from .storage import MemoryStorage, NodeFilter, SqliteStorage, Storage
from .types import Edge, Node
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
                                         self.config.embedding.dimension)
        self.index = self._make_index()
        self._rebuild_index()
        self.graph = GraphEngine(storage)
        self.mirror = DeviceGraphMirror(self.graph.cache, device=self.device)
        self.hooks = HookRegistry()
        self.hybrid = HybridSearch(storage, self.embedder, self.index,
                                   self.mirror)
        self.decay_engine = DecayEngine(storage, self.config.decay)

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
    def _on_write(self) -> None:
        self.graph.invalidate()

    def store(self, node: Node, *, gate: bool = False,
              actor: str = "library") -> str:
        """Embed + persist + index + fire hooks."""
        if gate:
            raise ConfigError(
                f"store(gate=True): the write gate is not ported yet "
                f"({GATE_ITEM})")
        if node.embedding is None:
            node.embedding = self.embedder.embed_node(node).tolist()
        is_update = self._persist(node, actor)
        self.hooks.notify_node("updated" if is_update else "created", node)
        return node.id

    def _persist(self, node: Node, actor: str) -> bool:
        """Store + index (no hooks). Returns is_update."""
        with self._persist_lock:
            is_update = self.storage.get_node(node.id) is not None
            self.storage.put_node(node, actor=actor)
            self.index.insert(node.id,
                              np.asarray(node.embedding, np.float32),
                              kind=node.kind,
                              source_agent=node.source.agent)
        return is_update

    def store_batch(self, nodes: Sequence[Node], *,
                    actor: str = "library") -> List[str]:
        """Batch admission: one embed_batch + one index insert."""
        if not nodes:
            return []
        missing = [n for n in nodes if n.embedding is None]
        if missing:
            embs = self.embedder.embed_nodes(missing)
            for j, n in enumerate(missing):
                n.embedding = embs[j].tolist()
        with self._persist_lock:
            self.storage.put_nodes_batch(nodes, actor=actor)
            self.index.insert_batch(
                [n.id for n in nodes],
                np.stack([np.asarray(n.embedding, np.float32)
                          for n in nodes]),
                kinds=[n.kind for n in nodes],
                agents=[n.source.agent for n in nodes])
        for n in nodes:
            self.hooks.notify_node("created", n)
        return [n.id for n in nodes]

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
                if self.decay_engine.should_reinforce(n):
                    # reset the decay clock on the node's edges, at most
                    # once per access_reinforcement_days
                    self.decay_engine.reinforce(n.id, node=n)
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
