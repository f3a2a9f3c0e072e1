"""Device adjacency mirror: padded neighbor tables + hop depths on device.

Counterpart of cortex_tpu/graph/csr.py on torch tensors. Graph-proximity
scoring for hybrid search (crates/cortex-core/src/vector/hybrid.rs:189-225
walks a BFS from each anchor) needs hop depths from a few anchors. Ragged
adjacency is packed into a fixed-degree neighbor table on `device`

    nbrs [N, MAX_DEG] int32   (row indices into the mirror; -1 = pad)

and depths come from four tiers, chosen per call by what the frontier
needs: a host frontier BFS over the AdjacencyCache (small frontiers);
above PACKED_EDGE_THRESHOLD edges the packed CSR snapshot
(graph/packed.py), walked on the host over only the rows each anchor
reaches (_sparse_walk); the device frontier walk
(G1, ops/graph_bfs.frontier_bfs, or frontier_bfs_compact on the packed
snapshot's table) over the resident table; and the full
min-plus relaxation (G2, ops/graph_bfs.bfs_relax)

    dist <- min(dist, min_over_deg(dist[nbrs]) + 1)

when the walk's frontier overflows or many anchors need a depth each.
While tracing is active (utils/tracing.py) the packed tier counts the
anchors its host walk serves (hybrid.host_walks), those it routes to the
device walk (hybrid.device_walks) and the walks whose result it
recomputes on the host (hybrid.host_fallbacks).
Degree is capped (hub truncation) the way the reference caps auto-edges
per node at 50 (linker/auto_linker.rs:261-273). The mirror versions
itself against the AdjacencyCache so it rebuilds only after graph
mutations. `device` is "cuda" (the default; raises without CUDA), "cpu"
(the kernels' plain torch versions) or a torch.device.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.graph_bfs import (bfs_relax, frontier_bfs, frontier_bfs_compact,
                             unpack_compact)
from ..utils.device import resolve_device
from ..utils import tracing
from .cache import AdjacencyCache
from .packed import UNREACHED, PackedAdjacency

log = logging.getLogger("cortex.csr")

INF_DEPTH = np.int32(2**30)
DEFAULT_MAX_DEG = 64


def _pad_deg(d: int) -> int:
    return max(8, ((d + 7) // 8) * 8)


def _sparse_walk(pk: PackedAdjacency, src: int, hops: int, budget: int,
                 seen: np.ndarray) -> Optional[tuple]:
    """PackedAdjacency.multi_bfs from one source row, touching only
    the rows it reaches: (rows, int32 depths), the rows of each depth
    ascending and the depths in order, or None when the visited count
    exceeds `budget` (the same hop-by-hop check as multi_bfs). `seen`
    is an [n] int8 scratch of UNREACHED; the walk marks what it reaches
    there and puts those entries back before it returns, overflow
    included."""
    found = [np.array([src], np.int64)]
    seen[src] = 0
    visited = 1
    frontier = found[0]
    try:
        for h in range(hops):
            nb = pk._expand(frontier)
            if nb.size == 0:
                break
            nb = np.unique(nb)
            nb = nb[seen[nb] == UNREACHED]
            if nb.size == 0:
                break
            found.append(nb)
            seen[nb] = h + 1
            visited += nb.size
            if visited > budget:
                return None
            frontier = nb
        return (np.concatenate(found),
                np.repeat(np.arange(len(found), dtype=np.int32),
                          [len(f) for f in found]))
    finally:
        for rows in found:
            seen[rows] = UNREACHED


def _depth_map(ids: List[str], n_anchors: int,
               reached: List[tuple]) -> Dict[str, np.ndarray]:
    """{node id: [n_anchors] int32 depths, INF_DEPTH where that anchor
    does not reach} from each walk's (anchor column, rows, depths),
    built as one [R, n_anchors] matrix over the R distinct rows."""
    cols, rows, depths = zip(*reached)
    uniq, inv = np.unique(np.concatenate(rows), return_inverse=True)
    mat = np.full((len(uniq), n_anchors), INF_DEPTH, np.int32)
    mat[inv.reshape(-1), np.repeat(cols, [len(r) for r in rows])] = \
        np.concatenate(depths)
    return dict(zip(map(ids.__getitem__, uniq.tolist()), mat))


class DeviceGraphMirror:
    """Undirected padded-neighbor adjacency on device, keyed to a
    node-id <-> row mapping shared with the embedding corpus."""

    #: edge count above which proximity routes through the packed CSR
    #: (graph/packed.py) instead of the object-graph AdjacencyCache —
    #: ~200M AdjacencyEntry objects at the reference's 100M-edge
    #: ceiling is tens of GB of heap + GC collapse; the packed build
    #: is ~1 GB of numpy at the same scale
    PACKED_EDGE_THRESHOLD = int(os.environ.get(
        "CORTEX_PACKED_ADJ_EDGES", "2000000"))
    #: packed snapshots serve STALE for at most this long under write
    #: churn: a per-write rebuild at 100M edges would be a rebuild
    #: storm (the scan itself is minutes), and proximity tolerates
    #: bounded staleness (new edges join the next snapshot; the
    #: reference's invalidate-on-write cache has no answer at all at
    #: this scale — it caps there)
    REBUILD_MIN_S = float(os.environ.get(
        "CORTEX_ADJ_REBUILD_MIN_S", "30"))
    #: device compaction width for packed-tier results (reached rows
    #: per anchor set; deg^hops for real anchor fans is << this)
    PACKED_OUT_CAP = 16384

    def __init__(self, cache: AdjacencyCache, *,
                 max_deg: int = DEFAULT_MAX_DEG,
                 storage=None, device="cuda"):
        self._device = resolve_device(device)
        self._cache = cache
        self._storage = storage if storage is not None \
            else getattr(cache, "_storage", None)
        self._max_deg = max_deg
        self._built_version = -1
        self._row_of: Dict[str, int] = {}
        self._id_of: List[str] = []
        self._nbrs: Optional[torch.Tensor] = None
        self.truncated_nodes = 0   # hubs that lost neighbors to the cap
        # packed tier state (scale mode); the device neighbor table and
        # the walk's depth scratch cache on each PackedAdjacency snapshot,
        # not here (see _packed_device_nbrs)
        self._packed: Optional[PackedAdjacency] = None
        self._packed_version = -1
        self._packed_lock = threading.Lock()
        self.packed_overflows = 0  # device walks that hit the cap
        self.packed_rebuilds = 0

    @property
    def n(self) -> int:
        return len(self._id_of)

    def row_of(self, node_id: str) -> Optional[int]:
        self.ensure()
        return self._row_of.get(node_id)

    def id_of(self, row: int) -> str:
        return self._id_of[row]

    def ensure(self) -> None:
        if self._built_version == self._cache.version and \
                self._nbrs is not None:
            return
        ids = sorted(self._cache.all_node_ids())
        self._row_of = {i: r for r, i in enumerate(ids)}
        self._id_of = ids
        n = len(ids)
        deg = _pad_deg(self._max_deg)
        nbrs = np.full((max(n, 8), deg), -1, np.int32)
        self.truncated_nodes = 0
        for i, nid in enumerate(ids):
            seen = set()
            col = 0
            for a in (self._cache.outgoing(nid) + self._cache.incoming(nid)):
                r = self._row_of.get(a.neighbor)
                if r is None or r in seen:
                    continue
                if col >= deg:
                    self.truncated_nodes += 1
                    break
                nbrs[i, col] = r
                seen.add(r)
                col += 1
        self._nbrs = torch.as_tensor(nbrs, device=self._device)
        self._built_version = self._cache.version

    # ------------------------------------------------------- host fast path
    #: frontier budget before falling back to the device tiers —
    #: hybrid anchor BFS touches O(deg^hops) nodes, tiny on real
    #: graphs, while the device min-plus pass costs O(N*deg*hops)
    #: regardless of frontier. The device form only wins when the
    #: frontier is a large fraction of the graph.
    HOST_FRONTIER_BUDGET = 200_000

    #: engine-wide hop ceiling. The device relaxation runs at most 8
    #: rounds (ops/graph_bfs.MAX_HOPS), so the host fast path clamps
    #: to the SAME ceiling — otherwise hybrid graph scores would depend
    #: on which path the frontier-size heuristic picked for a given
    #: corpus (ADVICE r2 #5). Residual divergence that remains by
    #: construction: the device table truncates hub nodes at max_deg
    #: neighbors (self.truncated_nodes counts them), so for frontiers
    #: big enough to route to the device, hub fan-out beyond max_deg is
    #: approximated; the host path is exact below the budget.
    HOP_CAP = 8

    # ---------------------------------------------------- packed tier
    def _packed_mode(self) -> bool:
        """True when the edge set is too big for the object cache.
        The decision is sticky once made (a corpus does not shrink
        under the threshold mid-serving) and re-checks at most every
        10 s otherwise: storage.stats() is a COUNT(*) on some
        backends — seconds at 100M rows, so it must never sit on the
        per-query path."""
        if self._storage is None:
            return False
        if self._packed is not None or getattr(self, "_mode_big",
                                               False):
            return True          # once at scale, stay packed
        now = time.monotonic()
        if now - getattr(self, "_mode_checked_at", -1e9) < 10.0:
            return False         # last check said small
        try:
            big = (self._storage.stats().edge_count
                   > self.PACKED_EDGE_THRESHOLD)
        except Exception:  # noqa: BLE001 — stats failure = small mode
            big = False
        if big:
            self._mode_big = True
        else:
            self._mode_checked_at = now
        return big

    #: seconds to wait after a failed packed build before re-trying —
    #: without this every query would repeat the minutes-long build
    #: attempt on the serving path
    BUILD_BACKOFF_S = 30.0

    def _ensure_packed(self) -> PackedAdjacency:
        """Current packed snapshot; rebuilds (debounced) when the
        graph version moved. EVERY reader — including the one that
        trips a rebuild — serves the previous immutable snapshot
        immediately; the rebuild itself runs on one background thread
        (a 100M-edge build is minutes and no serving request should
        ever carry it). Only the very first build, when no snapshot
        exists yet, runs inline and blocks — there is nothing older to
        serve. A failed build backs off BUILD_BACKOFF_S."""
        pk = self._packed
        ver = self._cache.version
        if pk is not None and (
                self._packed_version == ver
                or time.monotonic() - pk.built_at < self.REBUILD_MIN_S):
            return pk
        if pk is not None:
            # check-and-set under the lock: two readers that both see
            # a stale snapshot must not each spawn a minutes-long
            # 100M-edge background scan
            spawn = False
            with self._packed_lock:
                if not getattr(self, "_rebuild_inflight", False):
                    self._rebuild_inflight = True
                    spawn = True
            if spawn:

                def bg():
                    try:
                        self._build_and_swap(ver)
                    except Exception:  # noqa: BLE001 — stays stale
                        log.warning(
                            "packed adjacency rebuild failed; "
                            "serving the previous snapshot",
                            exc_info=True)
                    finally:
                        self._rebuild_inflight = False

                threading.Thread(target=bg, name="packed-rebuild",
                                 daemon=True).start()
            return pk
        # first build: inline, serialized, with failure backoff
        if time.monotonic() < getattr(self, "_build_backoff_until",
                                      0.0):
            raise RuntimeError(
                "packed adjacency build failed recently; backing off")
        with self._packed_lock:
            if self._packed is not None:   # lost the first-build race
                return self._packed
            try:
                return self._build_and_swap(ver)
            except Exception:
                self._build_backoff_until = (time.monotonic()
                                             + self.BUILD_BACKOFF_S)
                raise

    def _build_and_swap(self, ver: int) -> PackedAdjacency:
        t0 = time.perf_counter()
        # re-read the version at scan start: the caller captured `ver`
        # before the debounce window, so edges written since then are
        # in the scan but a pre-scan stamp would mark the snapshot
        # stale and trigger a spurious full rebuild even with no
        # further writes. Scan-start (not swap-time) keeps deletions
        # racing the minutes-long build conservatively re-buildable.
        ver = max(ver, self._cache.version)
        pk = PackedAdjacency.build(self._storage)
        self._packed = pk
        self._packed_version = ver
        self.packed_rebuilds += 1
        log.info("packed adjacency: %d edges -> %d rows in %.1fs",
                 pk.edge_count, pk.n, time.perf_counter() - t0)
        return pk

    def _packed_device_nbrs(self, pk: PackedAdjacency) -> torch.Tensor:
        """Device neighbor table FOR THIS SNAPSHOT — cached on the
        snapshot object itself, never on the mirror: interning order
        shifts between snapshots, so pairing an old table with a new
        snapshot's ids would attribute depths to the wrong nodes."""
        dev = getattr(pk, "_nbrs_dev", None)
        if dev is None:
            nbrs, trunc = pk.neighbor_table(self._max_deg)
            dev = torch.as_tensor(nbrs, device=self._device)
            pk._nbrs_dev = dev
            pk._nbrs_trunc = trunc
        self.truncated_nodes = getattr(pk, "_nbrs_trunc", 0)
        return dev

    def _packed_device_scratch(self, pk: PackedAdjacency,
                               nbrs: torch.Tensor) -> torch.Tensor:
        """The compact walk's [N] depth scratch for this snapshot's table,
        filled with INF_DEPTH once, when made; every walk leaves it so
        (ops/graph_bfs.frontier_bfs_compact). Cached beside the table,
        for the same reason."""
        scratch = getattr(pk, "_dist_scratch_dev", None)
        if scratch is None:
            scratch = torch.full((nbrs.shape[0],), int(INF_DEPTH),
                                 dtype=torch.int32, device=self._device)
            pk._dist_scratch_dev = scratch
        return scratch

    def _packed_per_anchor(self, anchor_ids: Sequence[str],
                           max_hops: int) -> tuple:
        """per_anchor over the packed tiers — returns (anchors_used,
        depth_map) resolved against ONE snapshot: the host walk per
        anchor over only the rows it reaches; budget overflow routes
        THAT anchor to the device frontier walk with on-device
        compaction. An unavailable snapshot (first build failed, in
        backoff) degrades to no proximity — hybrid then scores
        vector-only rather than 500ing."""
        try:
            pk = self._ensure_packed()
        except Exception:  # noqa: BLE001 — backoff/build failure
            log.warning("packed adjacency unavailable; serving "
                        "vector-only proximity", exc_info=True)
            return [], {}
        known = [a for a in anchor_ids if a in pk.row_of]
        if not known:
            return [], {}
        reached = []      # (anchor column, rows, depths) a walk
        # the walk's [n] scratch, from a pool cached on the snapshot
        # (beside its device table, for the same reason): a call owns
        # one until it appends it back, so concurrent calls never share
        # one, and the pool holds one a concurrent call at most
        pool = pk.__dict__.setdefault("_host_scratch", [])
        try:
            seen = pool.pop()
        except IndexError:
            seen = np.full(pk.n, UNREACHED, np.int8)
        try:
            for j, a in enumerate(known):
                walked = _sparse_walk(pk, pk.row_of[a], max_hops,
                                      self.HOST_FRONTIER_BUDGET, seen)
                if walked is not None:
                    tracing.count("hybrid.host_walks")
                    reached.append((j, *walked))
                    continue
                # device frontier walk (the 100M-edge tier): one launch from
                # a host anchor (no sync to enqueue), and one fetch of the
                # reached pairs with their count and flag
                tracing.count("hybrid.device_walks")
                nbrs = self._packed_device_nbrs(pk)
                packed = frontier_bfs_compact(
                    nbrs, torch.tensor([pk.row_of[a]], dtype=torch.int32),
                    min(max_hops, self.HOP_CAP),
                    self.DEVICE_FRONTIER_CAP, self.PACKED_OUT_CAP,
                    self._packed_device_scratch(pk, nbrs)).cpu().numpy()
                rows_h, depth_h, count, overflow = unpack_compact(packed)
                if overflow or count >= min(self.PACKED_OUT_CAP,
                                            nbrs.shape[0]):
                    # frontier-cap overflow OR the compaction width
                    # filled: the device result is a SUBSET. Correctness
                    # falls back to the exact packed host BFS without a
                    # budget — O(visited) numpy, seconds at multi-million
                    # reach; slower than the device walk but never
                    # silently zero-scoring reachable nodes.
                    self.packed_overflows += 1
                    tracing.count("hybrid.host_fallbacks")
                    reached.append((j, *_sparse_walk(
                        pk, pk.row_of[a], max_hops, sys.maxsize, seen)))
                    continue
                reached.append((j, rows_h, depth_h))
        finally:
            pool.append(seen)
        return known, _depth_map(pk.ids, len(known), reached)

    def _in_graph(self, node_id: str) -> bool:
        if self._packed_mode():
            try:
                return node_id in self._ensure_packed().row_of
            except Exception:  # noqa: BLE001 — backoff/build failure
                return False
        return bool(self._cache.outgoing(node_id)
                    or self._cache.incoming(node_id))

    def _host_bfs(self, src: str, max_hops: int,
                  budget: int) -> Optional[Dict[str, int]]:
        """Frontier BFS over the host adjacency (exact — no degree
        cap, unlike the padded device table). None when the visited
        count blows the budget (caller falls back to device)."""
        if not self._in_graph(src):
            return {}
        dist = {src: 0}
        frontier = [src]
        for h in range(max_hops):
            nxt = []
            for u in frontier:
                for a in self._cache.outgoing(u):
                    if a.neighbor not in dist:
                        dist[a.neighbor] = h + 1
                        nxt.append(a.neighbor)
                for a in self._cache.incoming(u):
                    if a.neighbor not in dist:
                        dist[a.neighbor] = h + 1
                        nxt.append(a.neighbor)
                if len(dist) > budget:
                    return None
            if not nxt:
                break
            frontier = nxt
        return dist

    def per_anchor_depths(self, anchor_ids: Sequence[str],
                          max_hops: int) -> Dict[str, "np.ndarray"]:
        """depth-from-each-anchor; see per_anchor (this drops the
        anchor-order half of its result)."""
        return self.per_anchor(anchor_ids, max_hops)[1]

    def per_anchor(self, anchor_ids: Sequence[str], max_hops: int
                   ) -> tuple:
        """(anchors_used, {node_id: [A] int32 depths}) — depth from
        each anchor, with the anchor list in DEPTH-ARRAY COLUMN ORDER,
        both derived from one adjacency snapshot. Callers must index
        depth columns with the returned list, never a separately
        resolved membership: a background packed-snapshot swap between
        two resolutions can change membership and misalign columns
        (ADVICE r4 — an IndexError or wrong nearest_anchor on a live
        hybrid request). Host frontier BFS per anchor first (tiny
        frontiers, no device build needed); the device relaxation
        over an [A, N] distance matrix (G2) is the fallback for
        frontiers that cover a large fraction of the graph. Depth
        entries are omitted when unreachable from every anchor."""
        max_hops = min(max_hops, self.HOP_CAP)
        if self._packed_mode():
            return self._packed_per_anchor(anchor_ids, max_hops)
        known = [a for a in anchor_ids if self._in_graph(a)]
        per: List[Optional[Dict[str, int]]] = [
            self._host_bfs(a, max_hops, self.HOST_FRONTIER_BUDGET)
            for a in known]
        if all(d is not None for d in per):
            out: Dict[str, np.ndarray] = {}
            for j, d in enumerate(per):
                for nid, depth in d.items():
                    row = out.get(nid)
                    if row is None:
                        row = np.full(len(known), INF_DEPTH, np.int32)
                        out[nid] = row
                    row[j] = depth
            return known, out
        self.ensure()
        if self._nbrs is None or self.n == 0:
            return [], {}
        rows = [(a, self._row_of[a]) for a in anchor_ids
                if a in self._row_of]
        if not rows:
            return [], {}
        n_pad = self._nbrs.shape[0]
        dist0 = np.full((len(rows), n_pad), INF_DEPTH, np.int32)
        for j, (_, r) in enumerate(rows):
            dist0[j, r] = 0
        dist = bfs_relax(self._nbrs,
                         torch.as_tensor(dist0, device=self._device),
                         min(max_hops, 8)).cpu().numpy()   # [A, n_pad]
        out: Dict[str, np.ndarray] = {}
        reachable = (dist[:, :self.n] <= max_hops).any(axis=0)
        for i in np.nonzero(reachable)[0]:
            out[self._id_of[int(i)]] = dist[:, int(i)]
        return [a for a, _ in rows], out

    def anchor_row_ids(self, anchor_ids: Sequence[str]) -> List[str]:
        """Anchor ids present in the graph, in per_anchor_depths order.
        Membership comes from the host adjacency (same set as the
        device row map) so no device build is forced. NOTE: for
        pairing with depth arrays use per_anchor — it returns the
        order from the same snapshot the depths were computed on."""
        return [a for a in anchor_ids if self._in_graph(a)]

    def _host_multi_bfs(self, srcs: Sequence[str], max_hops: int,
                        budget: int) -> Optional[Dict[str, int]]:
        """Multi-source frontier BFS on host adjacency; None over budget."""
        frontier = [a for a in srcs if self._in_graph(a)]
        dist = {a: 0 for a in frontier}
        for h in range(max_hops):
            nxt = []
            for u in frontier:
                for a in self._cache.outgoing(u):
                    if a.neighbor not in dist:
                        dist[a.neighbor] = h + 1
                        nxt.append(a.neighbor)
                for a in self._cache.incoming(u):
                    if a.neighbor not in dist:
                        dist[a.neighbor] = h + 1
                        nxt.append(a.neighbor)
                if len(dist) > budget:
                    return None
            if not nxt:
                break
            frontier = nxt
        return dist

    def depths_from(self, anchor_ids: Sequence[str],
                    max_hops: int) -> Dict[str, int]:
        """Min depth from any anchor for every reachable node (<= max_hops).
        Tiered: host frontier BFS first (N-independent, needs the host
        adjacency); then the DEVICE frontier BFS over the resident
        neighbor table (r3 — the 100M-edge path: no host cache
        required); the full min-plus relaxation only when the frontier
        overflows the device walk's cap too."""
        max_hops = min(max_hops, self.HOP_CAP)
        host = self._host_multi_bfs(anchor_ids, max_hops,
                                    self.HOST_FRONTIER_BUDGET)
        if host is not None:
            return host
        self.ensure()
        if self._nbrs is None or self.n == 0:
            return {}
        rows = [self._row_of[a] for a in anchor_ids if a in self._row_of]
        if not rows:
            return {}
        dist = self._device_dist(rows, max_hops)[:self.n]
        hit = np.nonzero(dist <= max_hops)[0]
        return {self._id_of[i]: d
                for i, d in zip(hit.tolist(), dist[hit].tolist())}

    #: frontier slots for the device walk; hybrid anchor sets expand
    #: deg^hops ~ thousands — well under this. Overflow (or more
    #: anchors than slots) falls back to the full relaxation.
    DEVICE_FRONTIER_CAP = 8192

    def _device_dist(self, rows: Sequence[int], max_hops: int
                     ) -> np.ndarray:
        """[n_pad] hop distances from `rows` via the device table:
        frontier walk first, full relaxation on overflow. The anchors
        are hop 0's frontier, so more anchors than frontier slots is an
        overflow."""
        n_pad = self._nbrs.shape[0]
        overflow = True
        dist = None
        if len(rows) <= self.DEVICE_FRONTIER_CAP:
            dist, overflow = frontier_bfs(
                self._nbrs, torch.as_tensor(np.asarray(rows, np.int32)),
                min(max_hops, self.HOP_CAP), self.DEVICE_FRONTIER_CAP)
            overflow = bool(overflow)
        if overflow:
            dist0 = np.full((1, n_pad), INF_DEPTH, np.int32)
            dist0[0, list(rows)] = 0
            dist = bfs_relax(self._nbrs,
                             torch.as_tensor(dist0, device=self._device),
                             min(max_hops, 8))[0]
        return dist.cpu().numpy()

    def proximity_scores(self, anchor_ids: Sequence[str],
                         max_hops: int) -> Dict[str, float]:
        """graph score = 1 / (1 + depth) (hybrid.rs:189-225)."""
        return {i: 1.0 / (1.0 + d)
                for i, d in self.depths_from(anchor_ids, max_hops).items()}

    def batch_graph_scores(self, anchor_ids: Sequence[str],
                           max_hops: int,
                           candidate_ids: Sequence[Sequence[Optional[str]]]
                           ) -> np.ndarray:
        """[B, M] graph scores (1/(1+depth), 0 when unreachable/None)
        for already-retrieved candidate ids — the batch form of the
        hybrid fusion. Host frontier BFS serves small anchor frontiers
        with zero device work; otherwise the multi-source BFS runs
        ONCE on device and depths are gathered only at the candidate
        rows, so the [N] distance vector never leaves the device."""
        b = len(candidate_ids)
        m = max((len(r) for r in candidate_ids), default=0)
        out = np.zeros((b, m), np.float32)
        if m == 0:
            return out
        max_hops = min(max_hops, self.HOP_CAP)
        host = self._host_multi_bfs(anchor_ids, max_hops,
                                    self.HOST_FRONTIER_BUDGET)
        if host is not None:
            for i, rlist in enumerate(candidate_ids):
                for j, nid in enumerate(rlist):
                    d = host.get(nid)
                    if d is not None and d <= max_hops:
                        out[i, j] = 1.0 / (1.0 + d)
            return out
        self.ensure()
        if self._nbrs is None or self.n == 0:
            return out
        srcs = [self._row_of[a] for a in anchor_ids if a in self._row_of]
        if not srcs:
            return out
        rows = np.zeros((b, m), np.int32)
        present = np.zeros((b, m), bool)
        for i, rlist in enumerate(candidate_ids):
            for j, nid in enumerate(rlist):
                r = self._row_of.get(nid) if nid is not None else None
                if r is not None:
                    rows[i, j] = r
                    present[i, j] = True
        d = self._device_dist(srcs, max_hops)[rows]
        reach = present & (d <= max_hops)
        out[reach] = 1.0 / (1.0 + d[reach])
        return out
