"""AutoLinker: the background graph-growing loop.

Behavioral parity with crates/cortex-core/src/linker/auto_linker.rs:
  - cursor protocol: cursor + cycle count persisted in storage metadata,
    resumed at boot (:94-132); config-change detection (threshold /
    embedding model) resets the cursor to epoch for a full re-scan
    (:137-182)
  - run_cycle (:185-364): scan nodes since cursor -> ensure embeddings ->
    candidate search -> link rules per (node, neighbor) with per-node
    edge cap (50) + generic-content warning (30) -> batch edge create
    (<=2000/cycle) tolerating Duplicate/Invalid races -> periodic decay
    (every 60 cycles) -> periodic dedup (every 360) -> persist cursor
  - apply_link_rules (:401-444): similarity rule, legacy structural
    rules (when enabled), config rules, contradiction detector
  - reinforce-on-access (:457-459)

TPU redesign (the "auto-link pairs/sec" north star): the per-node ANN
loop becomes ONE batched device search — all M new nodes' embeddings as
a [M, d] query block against the corpus, k=candidate_k, fused
cosine+top-k on the MXU — then rules evaluate on host over the gathered
pairs. Embedding backfill is batched likewise.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..storage.base import NodeFilter, Storage
from ..types import Node
from ..utils import span
from ..vector.embedding import EmbeddingService, embedding_input
from ..vector.index import VectorIndex
from .config import AutoLinkerConfig
from .decay import DecayEngine
from .dedup import DedupScanner
from .metrics import LinkerMetrics
from .rules import (ContradictionDetector, FeatureCache, ProposedEdge,
                    StructuralRules, similarity_rule)

log = logging.getLogger(__name__)

CURSOR_KEY = "auto_linker_cursor"
CURSOR_ID_KEY = "auto_linker_cursor_id"
CYCLE_COUNT_KEY = "auto_linker_cycle_count"
LAST_THRESHOLD_KEY = "auto_linker_last_threshold"
LAST_MODEL_KEY = "auto_linker_last_model"
DEDUP_CURSOR_KEY = "auto_linker_dedup_cursor"
DEDUP_CURSOR_ID_KEY = "auto_linker_dedup_cursor_id"

_EMBED_BATCH = 512
#: per due-cycle page cap for the incremental dedup scan — bounds the
#: cycle under a bulk-import backlog (a full scan is 277 s at 1M;
#: explicit triggers can still run DedupScanner.scan() unpaged)
_DEDUP_PAGE = 2000


class AutoLinker:
    def __init__(self, storage: Storage, index: VectorIndex,
                 embedder: EmbeddingService,
                 config: Optional[AutoLinkerConfig] = None,
                 persist_lock: Optional[threading.Lock] = None,
                 on_index_pair_failure=None):
        self.storage = storage
        self.index = index
        self.embedder = embedder
        # pairs every store-write with its index mutation atomically
        # w.r.t. Cortex.save_index_snapshot's capture — without it a
        # mid-cycle checkpoint could certify an index missing a node
        # whose index_seq bump it records, and the seq-equality
        # early-return would then pin the incomplete snapshot
        self.persist_lock = persist_lock or threading.Lock()
        # notifies the owner that a storage write committed but its
        # index mutation raised — checkpoints must stop certifying
        # until a rebuild (Cortex._index_pair_failed)
        self.on_index_pair_failure = on_index_pair_failure
        self.config = config or AutoLinkerConfig()
        self.config.validate()
        self.metrics = LinkerMetrics()
        self.decay_engine = DecayEngine(storage, self.config.decay)
        self.structural = StructuralRules()
        self.contradictions = ContradictionDetector(
            self.config.similarity.contradiction_threshold)
        self.cursor = self._load_float(CURSOR_KEY, 0.0)
        # id tiebreak: created_at collides within tight ingest loops, and
        # a strict > timestamp filter would skip same-timestamp siblings
        # of the last processed node forever (UUIDv7 ids are time-ordered,
        # so (created_at, id) is a total order)
        self.cursor_id = self.storage.get_metadata(CURSOR_ID_KEY) or ""
        self.dedup_cursor = self._load_float(DEDUP_CURSOR_KEY, 0.0)
        self.dedup_cursor_id = (
            self.storage.get_metadata(DEDUP_CURSOR_ID_KEY) or "")
        self.cycle_count = int(self._load_float(CYCLE_COUNT_KEY, 0.0))
        self.metrics.cursor = self.cursor
        self.metrics.cycles_completed = self.cycle_count

    # ------------------------------------------------------------ persistence
    def _load_float(self, key: str, default: float) -> float:
        v = self.storage.get_metadata(key)
        try:
            return float(v) if v is not None else default
        except ValueError:
            return default

    def advance_cursor(self, created_at: float, node_id: str) -> None:
        """Mark everything at or before (created_at, node_id) as
        already processed — the bulk-import skip-linking contract.
        Monotonic max against the LIVE cursors (in-memory AND
        persisted): writing metadata alone leaves a running linker's
        stale in-memory cursor to re-scan the imported backlog and
        then clobber the stored value at its next _save_state. A
        cycle racing this call can still persist a lower cursor from
        its captured page once; the following cycle re-reads past it
        (one page of redundant scan, bounded by max_nodes_per_cycle)."""
        if (created_at, node_id) > (self.cursor, self.cursor_id):
            self.cursor = created_at
            self.cursor_id = node_id
        if (created_at, node_id) > (self.dedup_cursor,
                                    self.dedup_cursor_id):
            self.dedup_cursor = created_at
            self.dedup_cursor_id = node_id
        self._save_state()

    def _save_state(self) -> None:
        self.storage.put_metadata_many({
            CURSOR_KEY: repr(self.cursor),
            CURSOR_ID_KEY: self.cursor_id,
            DEDUP_CURSOR_KEY: repr(self.dedup_cursor),
            DEDUP_CURSOR_ID_KEY: self.dedup_cursor_id,
            CYCLE_COUNT_KEY: str(self.cycle_count),
        })

    def _check_config_change(self) -> None:
        cur_thr = self.config.similarity.auto_link_threshold
        cur_model = self.embedder.model_name
        stored_thr = self.storage.get_metadata(LAST_THRESHOLD_KEY)
        stored_model = self.storage.get_metadata(LAST_MODEL_KEY)
        thr_changed = (stored_thr is not None
                       and abs(float(stored_thr) - cur_thr) > 1e-9)
        model_changed = (stored_model is not None
                         and stored_model != cur_model)
        if thr_changed or model_changed:
            log.info("linker config change (threshold %s -> %s, model %s -> "
                     "%s); resetting cursor", stored_thr, cur_thr,
                     stored_model, cur_model)
            self.cursor = 0.0
            self.cursor_id = ""
            self.dedup_cursor = 0.0     # thresholds changed: re-scan
            self.dedup_cursor_id = ""
            self.metrics.cursor = 0.0
        self.storage.put_metadata(LAST_THRESHOLD_KEY, repr(cur_thr))
        self.storage.put_metadata(LAST_MODEL_KEY, cur_model)

    # ----------------------------------------------------------------- scan
    def _nodes_since_cursor(self, limit: int) -> List[Node]:
        """Keyset PAGE: an indexed (created_at, id) range scan with a
        LIMIT (storage.list_nodes_since), so cycle cost tracks the page
        size — the reference re-lists everything per cycle
        (auto_linker.rs:367-375), and even our earlier indexed-but-
        unbounded scan deserialized the whole backlog (~40 s per cycle
        at a 1M-node backlog, holding the storage lock and starving
        every concurrent search/write — measured in the 1M mixed-
        workload bench)."""
        return self.storage.list_nodes_since(self.cursor, self.cursor_id,
                                             limit)

    def _backlog_after(self, page: List[Node], limit: int) -> int:
        """Remaining-backlog metric. Only when the page saturated its
        limit (otherwise the backlog is zero by construction) — one SQL
        COUNT on the same index, no deserialization. The count is >=
        over by the already-processed rows sharing the cursor's exact
        timestamp (created_after is inclusive); that is at most the
        same-instant write burst and this feeds a gauge, not control
        flow."""
        if len(page) < limit:
            return 0
        try:
            total = self.storage.count_nodes(
                NodeFilter(created_after=self.cursor))
        except Exception:  # noqa: BLE001 — metric only
            return 0
        return max(0, total - len(page))

    def _ensure_embeddings(self, nodes: List[Node]) -> None:
        """Batch-embed any nodes lacking embeddings; persist + index.
        Embedding compute runs outside the persist lock; the store
        writes + the index insert are one atomic pair under it."""
        missing = [n for n in nodes if n.embedding is None]
        for start in range(0, len(missing), _EMBED_BATCH):
            chunk = missing[start:start + _EMBED_BATCH]
            embs = self.embedder.embed_batch(
                [embedding_input(n) for n in chunk])
            for j, n in enumerate(chunk):
                n.embedding = embs[j].tolist()
        to_index = [n for n in nodes if n.id not in self.index]
        if not missing and not to_index:
            return
        with self.persist_lock:
            if missing:
                # one transaction (per-node put_node commits fsync per
                # row — seconds per cycle at a full 500-node page)
                self.storage.put_nodes_batch(missing)
            if to_index:
                try:
                    self.index.insert_batch(
                        [n.id for n in to_index],
                        np.stack([np.asarray(n.embedding, np.float32)
                                  for n in to_index]),
                        kinds=[n.kind for n in to_index],
                        agents=[n.source.agent for n in to_index])
                except BaseException:
                    if self.on_index_pair_failure is not None:
                        self.on_index_pair_failure()
                    raise

    # ---------------------------------------------------------------- rules
    def _apply_link_rules(self, node: Node, neighbor: Node, score: float,
                          cache: Optional[FeatureCache] = None
                          ) -> List[ProposedEdge]:
        out: List[ProposedEdge] = []
        e = similarity_rule(node, neighbor, score, self.config.similarity)
        if e is not None:
            out.append(e)
        if self.config.use_legacy_rules():
            out.extend(self.structural.evaluate_all(node, neighbor, score,
                                                    cache))
        for rule in self.config.rules:
            out.extend(rule.evaluate(node, neighbor, score))
        c = self.contradictions.check(node, neighbor, score, cache)
        if c is not None:
            out.append(self.contradictions.to_edge(c))
        return out

    # ---------------------------------------------------------------- cycle
    def run_cycle(self, now: float | None = None) -> LinkerMetrics:
        start = time.monotonic()
        now = time.time() if now is None else now
        self.metrics.reset_cycle()

        self._check_config_change()
        limit = self.config.max_nodes_per_cycle
        with span("linker.scan"):
            batch = self._nodes_since_cursor(limit)
        decay_due = self.cycle_count % self.config.decay_every_n_cycles == 0
        dedup_due = self.cycle_count % self.config.dedup_every_n_cycles == 0
        # dedup pages lag the main scan by _DEDUP_PAGE per due cycle;
        # a remaining backlog keeps an otherwise-idle cycle active so
        # it drains on the dedup schedule, not only when decay_due
        # happens to coincide
        dedup_behind = ((self.dedup_cursor, self.dedup_cursor_id)
                        < (self.cursor, self.cursor_id))

        if not batch and not decay_due and not (dedup_due and dedup_behind):
            # idle cycle: still advance the schedule clock — without
            # this, once the count parks on a non-multiple an idle
            # server NEVER reaches the next decay/dedup-due cycle, so
            # old edges never decay until some unrelated write
            # arrives. Persist only every 10th idle tick (review r5
            # #6): one commit per interval forever on an idle server
            # buys nothing — a crash loses at most 10 idle increments,
            # delaying the next decay by that many cycles.
            self.cycle_count += 1
            self.metrics.cycles_completed = self.cycle_count
            if self.cycle_count % 10 == 0:
                self.storage.put_metadata(CYCLE_COUNT_KEY,
                                          str(self.cycle_count))
            self.metrics.cycle_duration_secs = time.monotonic() - start
            return self.metrics

        with span("linker.backlog_count"):
            self.metrics.backlog_size = self._backlog_after(batch, limit)
        proposed: List[ProposedEdge] = []

        if batch:
            with span("linker.embed"):
                self._ensure_embeddings(batch)
            queries = np.stack([np.asarray(n.embedding, np.float32)
                                for n in batch])
            # pipelined candidate search: dispatch chunk searches
            # back-to-back (JAX dispatch is async) so device execution
            # and transfer overlap the host rule evaluation below; on a
            # network-attached TPU this also overlaps the round trips
            chunk = 128
            # refine=False: graph-refined indexes widen candidates for
            # SERVING recall; the linker's similarity rules threshold
            # at 0.75+ (far above the structural-miss band), and the
            # expansion's extra host re-rank rows measured as a 2-4 s
            # per-cycle tax in the 300k IVF mixed soak
            with span("linker.search"):
                if (len(batch) > chunk
                        and hasattr(self.index, "search_stream")):
                    # single-drain stream: chunks dispatch back-to-back,
                    # results concatenate on device, ONE fetch — per-
                    # chunk draining pays a host<->device RTT per chunk
                    all_hits = self.index.search_stream(
                        queries, self.config.candidate_k, batch=chunk,
                        refine=False)
                elif (len(batch) > chunk
                        and hasattr(self.index, "search_batch_async")):
                    finishers = [self.index.search_batch_async(
                        queries[s:s + chunk], self.config.candidate_k,
                        refine=False)
                        for s in range(0, len(batch), chunk)]
                    all_hits = []
                    for fin in finishers:
                        all_hits.extend(fin())
                else:
                    all_hits = self.index.search_batch(
                        queries, self.config.candidate_k, refine=False)

            node_cache: Dict[str, Node] = {n.id: n for n in batch}
            # hydrate every candidate neighbor in one batched read —
            # up to page x candidate_k point reads per cycle otherwise
            cand_ids = {nid for hits in all_hits for nid, _ in hits
                        if nid not in node_cache}
            if cand_ids:
                with span("linker.hydrate"):
                    node_cache.update(self.storage.get_nodes(cand_ids))

            def fetch(nid: str) -> Optional[Node]:
                n = node_cache.get(nid)
                if n is None:
                    n = self.storage.get_node(nid)
                    if n is not None:
                        node_cache[nid] = n
                return n

            feat_cache = FeatureCache()   # per-node text features, cycle-scoped
            cap = self.config.max_edges_per_cycle
            rules_span = span("linker.rules")
            rules_span.__enter__()
            for j, node in enumerate(batch):
                if len(proposed) >= cap:
                    # edge budget exhausted: stop BEFORE advancing the
                    # cursor past this node so the remaining nodes are
                    # rescanned next cycle instead of silently losing
                    # their links (the cursor filter is created_at >
                    # cursor)
                    self.metrics.backlog_size += len(batch) - j
                    break
                existing: Set[Tuple[str, str]] = {
                    (e.to_id, e.relation)
                    for e in self.storage.edges_from(node.id)}
                node_edge_count = 0
                for nid, score in all_hits[j]:
                    if nid == node.id:
                        continue
                    neighbor = fetch(nid)
                    if neighbor is None or neighbor.deleted:
                        continue
                    for e in self._apply_link_rules(node, neighbor, score,
                                                    feat_cache):
                        if e.relation == "contradicts":
                            self.metrics.add_contradictions_found(1)
                        key = (e.to_id, e.relation)
                        if key in existing:
                            continue
                        existing.add(key)
                        proposed.append(e)
                        node_edge_count += 1
                    if node_edge_count >= self.config.max_edges_per_node:
                        break
                if node_edge_count >= self.config.generic_content_threshold:
                    log.warning("node %s produced %d candidate edges — "
                                "possible generic content", node.id,
                                node_edge_count)
                self.metrics.add_nodes_processed(1)
                if (node.created_at, node.id) > (self.cursor,
                                                 self.cursor_id):
                    self.cursor = node.created_at
                    self.cursor_id = node.id
            rules_span.__exit__(None, None, None)

        if proposed:
            # one transaction, losers of write races skipped in place
            # (auto_linker.rs:292-303); per-edge put_edge commits fsync
            # per row — measured seconds/cycle at the 2000-edge budget
            with span("linker.edge_write"):
                created = self.storage.put_edges_batch(
                    [e.to_edge() for e in proposed], tolerant=True)
            self.metrics.add_edges_created(created)

        if decay_due:
            with span("linker.decay"):
                db_path = getattr(self.storage, "path", None)
                if (self.config.decay_in_subprocess and db_path
                        and db_path != ":memory:"):
                    try:
                        pruned, deleted = \
                            self.decay_engine.apply_decay_isolated(
                                db_path, now)
                    except Exception:  # noqa: BLE001 — inline fallback
                        log.warning(
                            "subprocess decay sweep failed; running "
                            "inline this cycle", exc_info=True)
                        pruned, deleted = \
                            self.decay_engine.apply_decay(now)
                else:
                    pruned, deleted = self.decay_engine.apply_decay(now)
            self.metrics.add_edges_pruned(pruned)
            self.metrics.add_edges_deleted(deleted)

        if dedup_due:
            # INCREMENTAL: only nodes past the dedup cursor are used
            # as queries (a pair both sides unchanged since the last
            # scan was already reported then), paged so a bulk-import
            # backlog can't absorb a cycle — the full scan measured
            # 277 s inside a cycle at 1M. Full scans remain available
            # via DedupScanner.scan() (explicit trigger / CLI).
            with span("linker.dedup"):
                # caught up (or a legacy cursor persisted AHEAD of the
                # main cursor): skip the page read entirely — reading
                # 2000 rows under the storage lock only to filter all
                # of them out would repeat every dedup-due cycle
                if ((self.dedup_cursor, self.dedup_cursor_id)
                        >= (self.cursor, self.cursor_id)):
                    page = []
                else:
                    page = self.storage.list_nodes_since(
                        self.dedup_cursor, self.dedup_cursor_id,
                        _DEDUP_PAGE)
                # only nodes the MAIN scan has already processed are
                # eligible: its _ensure_embeddings step is what gets
                # them embedded + indexed. Advancing the cursor past a
                # not-yet-indexed node would exempt it from dedup
                # FOREVER (scan() filters it out this time and the
                # keyset never revisits it) — so the page is truncated
                # at the main cursor and the tail waits for it.
                page = [n for n in page
                        if (n.created_at, n.id)
                        <= (self.cursor, self.cursor_id)]
                scanner = DedupScanner(
                    self.storage, self.index, self.config.similarity,
                    persist_lock=self.persist_lock,
                    on_index_pair_failure=self.on_index_pair_failure)
                result = scanner.scan(page)
                self.metrics.add_duplicates_found(len(result.duplicates))
                for pair in result.duplicates:
                    scanner.execute_action(pair)
                if page:
                    self.dedup_cursor = page[-1].created_at
                    self.dedup_cursor_id = page[-1].id

        self.cycle_count += 1
        self.metrics.cycles_completed = self.cycle_count
        self.metrics.cursor = self.cursor
        with span("linker.bookkeeping"):
            stats = self.storage.stats()
            self.metrics.total_nodes = stats.node_count
            self.metrics.total_edges = stats.edge_count
            self._save_state()
        self.metrics.cycle_duration_secs = time.monotonic() - start
        log.info("%s", self.metrics.summary())
        return self.metrics

    # --------------------------------------------------------------- access
    def reinforce(self, node_id: str) -> int:
        return self.decay_engine.reinforce(node_id)
