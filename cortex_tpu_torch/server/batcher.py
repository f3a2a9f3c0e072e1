"""Micro-batchers: concurrent requests share device dispatches.

SURVEY §3.2's TPU consequence: the reference embeds and searches per
request; here concurrent requests queue and a micro-batcher flushes
them as ONE device call when the batch fills or a few milliseconds
elapse — per-request latency stays flat while throughput scales with
batch size instead of dispatch count.

- EmbedBatcher: write admission (`POST /nodes`) shares embed batches.
- SearchBatcher: read side (`GET /search`, gRPC SimilaritySearch)
  shares one embed_batch + one search_batch per filter group; the
  per-request tails (decay re-rank, hydration, access recording) stay
  per-caller.
"""

from __future__ import annotations

import asyncio
import time
from typing import List, Optional, Tuple

import numpy as np

from ..utils import tracing


class BatcherClosed(RuntimeError):
    """Raised for a submit racing shutdown. A dedicated type so
    callers' fall-back-to-direct-path handlers can't accidentally
    swallow OTHER RuntimeErrors (XLA device failures are RuntimeError
    subclasses — re-running a failed search against a broken device
    doubles the damage and hides the root cause)."""


class _MicroBatcher:
    """Enqueue/flush machinery shared by both batchers. Items are
    tuples with the caller's future LAST. Subclasses implement
    `_flush_batch(batch)` to resolve those futures."""

    _cancel_msg = "batch cancelled"

    def __init__(self, *, max_batch: int, max_wait_ms: float):
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self._pending: List[Tuple] = []
        self._flusher: Optional[asyncio.Task] = None
        self._closed = False
        self.batches = 0
        self.items = 0
        # submit time of the oldest queued item, while tracing is active
        self._oldest_ns: Optional[int] = None

    async def _submit(self, *payload):
        if self._closed:
            raise BatcherClosed("batcher is closed")
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        if not self._pending and tracing.active():
            self._oldest_ns = time.perf_counter_ns()
        self._pending.append((*payload, fut))
        if len(self._pending) >= self.max_batch:
            await self._flush()
        elif self._flusher is None or self._flusher.done():
            self._flusher = asyncio.create_task(self._delayed_flush())
        return await fut

    async def _delayed_flush(self) -> None:
        await asyncio.sleep(self.max_wait)
        await self._flush()

    async def _flush(self) -> None:
        if not self._pending:
            return
        batch, self._pending = self._pending, []
        oldest, self._oldest_ns = self._oldest_ns, None
        if oldest is not None:
            tracing.elapsed("server.batch_wait", oldest)
        tracing.count("server.batches")
        tracing.count("server.batch_queries", len(batch))
        try:
            await self._flush_batch(batch)
            self.batches += 1
            self.items += len(batch)
        except BaseException as e:  # incl. CancelledError — a swapped
            for item in batch:      # batch must never strand its waiters
                fut = item[-1]
                if not fut.done():
                    fut.set_exception(
                        e if isinstance(e, Exception)
                        else BatcherClosed(self._cancel_msg))
            if not isinstance(e, Exception):
                raise
        finally:
            # items that arrived WHILE this flush awaited saw a
            # not-yet-done flusher task and scheduled nothing — without
            # this re-arm they strand forever if no later request comes
            if self._pending:
                self._flusher = asyncio.create_task(self._delayed_flush())

    async def _flush_batch(self, batch) -> None:
        raise NotImplementedError

    async def close(self) -> None:
        """Drain everything, then stop. New submissions fail fast once
        closing starts, which is what guarantees the drain terminates;
        in-flight flushes are awaited (cancelling one mid-batch would
        error its waiters)."""
        self._closed = True
        while True:
            f = self._flusher
            if f is not None and not f.done():
                try:
                    await f
                except Exception:  # noqa: BLE001
                    pass
            if self._pending:
                await self._flush()
                continue
            f = self._flusher
            if f is None or f.done():
                return
            f.cancel()          # idle re-armed flusher, nothing to do
            return


class EmbedBatcher(_MicroBatcher):
    """Concurrent write admissions share one embed_batch device call."""

    _cancel_msg = "embed batch cancelled"

    def __init__(self, embedder, *, max_batch: int = 64,
                 max_wait_ms: float = 5.0):
        super().__init__(max_batch=max_batch, max_wait_ms=max_wait_ms)
        self.embedder = embedder

    async def embed(self, text: str) -> np.ndarray:
        return await self._submit(text)

    async def _flush_batch(self, batch) -> None:
        embs = await asyncio.to_thread(self.embedder.embed_batch,
                                       [t for t, _ in batch])
        for j, (_, fut) in enumerate(batch):
            if not fut.done():
                fut.set_result(np.asarray(embs[j], np.float32))


def _filter_key(flt) -> tuple:
    """Canonical grouping key for a VectorFilter: the device scan's
    masks are per-batch, so only identically-filtered queries can share
    a dispatch."""
    if flt is None:
        return ()
    return (tuple(sorted(flt.kinds)) if flt.kinds else None,
            flt.source_agent,
            tuple(sorted(flt.exclude_ids)) if flt.exclude_ids else None)


class SearchBatcher(_MicroBatcher):
    """Read-side coalescing: concurrent search requests arriving within
    a few ms share ONE embed_batch + ONE search_batch device dispatch
    per filter group. The reference serves each query as its own HNSW
    walk (http/routes.rs:887-988); on TPU a [B,d]x[d,N] batched scan
    costs barely more than [1,d] — the bench-measured batch-64 rate is
    ~36k QPS vs ~2-3k at batch 1 through a dispatch-latency-bound
    transport — so the server aggregates its own concurrency instead
    of paying one dispatch per request."""

    _cancel_msg = "search batch cancelled"

    def __init__(self, index, embedder, *, max_batch: int = 64,
                 max_wait_ms: float = 3.0):
        super().__init__(max_batch=max_batch, max_wait_ms=max_wait_ms)
        self.index = index
        self.embedder = embedder

    async def search(self, text: str, k: int, flt=None):
        """Returns the [(node_id, score)] hit list for this query alone."""
        return await self._submit(text, k, flt)

    async def _flush_batch(self, batch) -> None:
        embs = await asyncio.to_thread(
            self.embedder.embed_batch, [t for t, _, _, _ in batch])
        embs = np.asarray(embs, np.float32)
        groups: dict = {}
        for j, (_, k, flt, _) in enumerate(batch):
            groups.setdefault(_filter_key(flt), []).append(j)
        for idx in groups.values():
            flt = batch[idx[0]][2]
            kmax = max(batch[j][1] for j in idx)
            rows = await asyncio.to_thread(
                self.index.search_batch, embs[idx], kmax, flt)
            for j, hits in zip(idx, rows):
                fut = batch[j][3]
                if not fut.done():
                    fut.set_result(hits[:batch[j][1]])
