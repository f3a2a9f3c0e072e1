"""Host bookkeeping of the device corpus.

Counterpart of cortex_tpu/vector/shard.py::DeviceCorpus, keeping what
every device layout shares: the authoritative host mirror (fp32 rows,
liveness, kind and agent codes), the id <-> row maps, the capacity
ladder, dirty tracking, the fixed-shape filter encoding with its exact
host-bias fallback, the k and candidate-width rules, and the exact fp32
re-rank of device candidates against the host mirror.

A subclass supplies the device layout: `sync` pushes host changes to
the device and `_dispatch_search` enqueues the candidate search
(vector/ivf.py::IvfCorpus). The flat layout of the reference is not
ported yet.

Concurrency: dispatch and every mutation hold the corpus lock. Device
work is enqueued on the current CUDA stream, so a later in-place layout
update runs after an earlier search's kernels. The device-to-host fetch
runs outside the lock; if rows were freed and reassigned meanwhile
(generation changed), the search is re-issued.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cortex_tpu.errors import IndexError_
from cortex_tpu.native import rerank_topk_native

from ..ops.similarity import NEG_INF, normalize_rows

MIN_CAP = 1024
MAX_FILTER_KINDS = 16
MAX_EXCLUDE = 64
NO_FILTER = -1
PAD_CODE = -2
# the C++ re-rank parallelizes across queries (ctypes releases the
# GIL); single-core it's a wash with numpy's BLAS path, so only prefer
# it when there are cores to use
_USE_NATIVE_RERANK = (os.cpu_count() or 1) > 1
#: re-issues of a search whose rows were reassigned mid-fetch before
#: the last attempt runs holding the lock
_RETRIES = 3


class Interner:
    """string -> int32 code, append-only."""

    def __init__(self):
        self._code: Dict[str, int] = {}

    def code(self, name: str) -> int:
        return self._code.setdefault(name, len(self._code))

    def lookup(self, name: str) -> int:
        """Code for name, or PAD_CODE (matches nothing) when unseen."""
        return self._code.get(name, PAD_CODE)


class DeviceCorpus:
    """Host mirror + id <-> row maps of a device-resident corpus."""

    #: above this row count the capacity ladder grows 1.25x per step
    #: instead of doubling (a 10M-row corpus would otherwise pad to 16.7M)
    GENTLE_GROWTH_ROWS = 4 << 20

    def __init__(self, dim: int, *, device: torch.device):
        self.dim = dim
        self._device = torch.device(device)
        self._cap = 0
        self._emb_h = np.zeros((0, dim), np.float32)
        self._live_h = np.zeros((0,), bool)
        self._kind_h = np.full((0,), PAD_CODE, np.int32)
        self._agent_h = np.full((0,), PAD_CODE, np.int32)
        self._row_of: Dict[str, int] = {}
        self._id_of: List[Optional[str]] = []
        self._free: List[int] = []
        self._dirty: set[int] = set()
        self._recycled: set[int] = set()   # freed rows, not yet reassigned
        self._generation = 0               # bumps when a row is reassigned
        self._full_resync = True
        self._quant_mu = np.zeros(dim, np.float32)   # int8 centering shift
        self.kinds = Interner()
        self.agents = Interner()
        self._lock = threading.RLock()

    # ------------------------------------------------------------- mutation
    def __len__(self) -> int:
        with self._lock:
            return len(self._row_of)

    def __contains__(self, node_id: str) -> bool:
        return node_id in self._row_of

    def _next_cap(self, need: int) -> int:
        """The capacity-ladder step that covers `need` rows: doubling
        up to GENTLE_GROWTH_ROWS, then 1.25x steps aligned to 8."""
        new_cap = max(MIN_CAP, self._cap)
        while new_cap < need:
            if new_cap >= self.GENTLE_GROWTH_ROWS:
                new_cap = ((new_cap + new_cap // 4) + 7) // 8 * 8
            else:
                new_cap *= 2
        return new_cap

    def _grow(self, need: int) -> None:
        """Extend the host mirror to the ladder step covering `need`;
        the device layout is rebuilt at the next sync."""
        new_cap = self._next_cap(need)
        if new_cap == self._cap:
            return
        pad = new_cap - self._cap
        self._emb_h = np.vstack(
            [self._emb_h, np.zeros((pad, self.dim), np.float32)])
        self._live_h = np.concatenate([self._live_h, np.zeros(pad, bool)])
        self._kind_h = np.concatenate(
            [self._kind_h, np.full(pad, PAD_CODE, np.int32)])
        self._agent_h = np.concatenate(
            [self._agent_h, np.full(pad, PAD_CODE, np.int32)])
        self._free.extend(range(self._cap, new_cap))
        self._id_of.extend([None] * pad)
        self._cap = new_cap
        self._full_resync = True

    def upsert_batch(self, ids: Sequence[str], vectors: np.ndarray,
                     kinds: Sequence[str], agents: Sequence[str]) -> None:
        """Insert or overwrite rows. Row assignment, code interning and
        growth follow the reference step for step, so both packages
        place the same ids on the same rows; the mirror writes are then
        one vectorized assignment (the last write of an id wins)."""
        vectors = np.asarray(vectors)
        if vectors.ndim != 2 or vectors.shape[1] != self.dim:
            raise IndexError_(
                f"vector dim {vectors.shape} != corpus dim {self.dim}")
        vectors = normalize_rows(vectors)
        with self._lock:
            new_count = sum(1 for i in ids if i not in self._row_of)
            if new_count > len(self._free):
                self._grow(self._cap - len(self._free) + new_count)
            last: Dict[int, int] = {}         # row -> index of its last write
            kc = np.empty(len(ids), np.int32)
            ac = np.empty(len(ids), np.int32)
            for j, nid in enumerate(ids):
                row = self._row_of.get(nid)
                if row is None:
                    if not self._free:
                        self._grow(self._cap + 1)
                    row = self._free.pop()
                    if row in self._recycled:
                        # a previously-removed row gets a NEW id: a search
                        # fetched against the old mapping must re-map
                        self._recycled.discard(row)
                        self._generation += 1
                    self._row_of[nid] = row
                    self._id_of[row] = nid
                last[row] = j
                kc[j] = self.kinds.code(kinds[j])
                ac[j] = self.agents.code(agents[j])
            rows = np.fromiter(last.keys(), np.int64, len(last))
            src = np.fromiter(last.values(), np.int64, len(last))
            self._emb_h[rows] = vectors[src]
            self._live_h[rows] = True
            self._kind_h[rows] = kc[src]
            self._agent_h[rows] = ac[src]
            self._dirty.update(last.keys())

    def remove(self, node_id: str) -> bool:
        with self._lock:
            row = self._row_of.pop(node_id, None)
            if row is None:
                return False
            self._live_h[row] = False
            self._emb_h[row] = 0.0
            self._kind_h[row] = PAD_CODE
            self._agent_h[row] = PAD_CODE
            self._id_of[row] = None
            self._free.append(row)
            self._recycled.add(row)   # reassignment invalidates fetches
            self._dirty.add(row)
            return True

    # ---------------------------------------------------------------- device
    def sync(self) -> None:
        """Push host changes to the device layout (subclass)."""
        raise NotImplementedError

    def _dispatch_search(self, q_np: np.ndarray, ak, aa, ex, k_bucket: int,
                         host_bias: Optional[np.ndarray] = None):
        """Enqueue the candidate search for normalized queries q_np.
        Returns (values, rows, needs_rescore) as device tensors
        (subclass)."""
        raise NotImplementedError

    def _host_bias(self, kinds, agent, exclude_ids) -> np.ndarray:
        """Exact [cap] additive bias computed on the host mirrors — the
        overflow path when filter lists don't fit the fixed-shape device
        encoding. Never truncates."""
        bias = np.where(self._live_h, 0.0, NEG_INF).astype(np.float32)
        if kinds is not None:
            codes = [self.kinds.lookup(k) for k in kinds]
            ok = np.isin(self._kind_h, np.asarray(codes, np.int32))
            bias = np.where(ok, bias, NEG_INF)
        if agent is not None:
            aa = self.agents.lookup(agent)
            bias = np.where(self._agent_h == aa, bias, NEG_INF)
        if exclude_ids:
            rows = [self._row_of[i] for i in exclude_ids
                    if i in self._row_of]
            bias[rows] = NEG_INF
        return bias.astype(np.float32)

    def _filter_codes(self, kinds, agent, exclude_ids):
        """Encode filters as fixed-shape arrays (16 kinds, 1 agent, 64
        excluded rows). When a list exceeds its shape, returns the exact
        host bias as the 4th element instead of truncating."""
        if ((kinds is not None and len(kinds) > MAX_FILTER_KINDS)
                or (exclude_ids and len(exclude_ids) > MAX_EXCLUDE)):
            return None, None, None, self._host_bias(kinds, agent,
                                                     exclude_ids)
        ak = np.full(MAX_FILTER_KINDS, PAD_CODE, np.int32)
        if kinds is None:
            ak[0] = NO_FILTER
        else:
            codes = [self.kinds.lookup(k) for k in kinds]
            ak[:len(codes)] = codes
        aa = np.int32(NO_FILTER if agent is None
                      else self.agents.lookup(agent))
        ex = np.full(MAX_EXCLUDE, NO_FILTER, np.int32)
        if exclude_ids:
            rows = [self._row_of[i] for i in exclude_ids
                    if i in self._row_of]
            ex[:len(rows)] = rows
        return ak, aa, ex, None

    def _k_bucket(self, k: int) -> Tuple[int, int]:
        """(kk, k_bucket): k rounded up to a power of two (>= 8). The
        candidate width derives from the bucket (_cand_count), so it
        decides how many candidates reach the exact re-rank."""
        kk = min(k, self._cap)
        k_bucket = 8
        while k_bucket < kk:
            k_bucket *= 2
        return kk, min(k_bucket, self._cap)

    def _cand_count(self, k_bucket: int) -> int:
        """Candidate over-provisioning for the int8 scan: int8 noise
        must move a true top-k row past the candidate boundary to escape
        the set, so keep max(2k, k+16, 64) candidates."""
        return min(self._cap, max(2 * k_bucket, k_bucket + 16, 64))

    # ---------------------------------------------------------------- search
    def topk(self, queries: np.ndarray, k: int, *,
             kinds: Optional[Sequence[str]] = None,
             agent: Optional[str] = None,
             exclude_ids: Optional[Sequence[str]] = None
             ) -> Tuple[np.ndarray, List[List[Optional[str]]]]:
        """Batched search. Returns (scores [B,k], ids [B][k]); dead or
        padded hits have score <= -1e29 and id None."""
        q_np = normalize_rows(np.asarray(queries, np.float32))
        flt = (kinds, agent, exclude_ids)
        for _ in range(_RETRIES):
            out = self._topk_once(q_np, k, flt)
            if out is not None:
                return out
        with self._lock:      # holding the lock, no row can be reassigned
            out = self._topk_once(q_np, k, flt)
        if out is None:
            raise RuntimeError("corpus generation changed under its lock")
        return out

    def _topk_once(self, q_np: np.ndarray, k: int, flt):
        """One dispatch + fetch + re-rank; None when rows were reassigned
        between the dispatch and the fetch."""
        b = q_np.shape[0]
        with self._lock:
            if len(self._row_of) == 0:
                return (np.full((b, k), NEG_INF, np.float32),
                        [[None] * k for _ in range(b)])
            self.sync()
            ak, aa, ex, hb = self._filter_codes(*flt)
            kk, k_bucket = self._k_bucket(k)
            gen = self._generation
            v, i, rescore = self._dispatch_search(q_np, ak, aa, ex,
                                                  k_bucket, host_bias=hb)
        # the fetch waits for the device: outside the lock
        v = v.cpu().numpy()
        i = i.cpu().numpy()
        return self._finish_topk(v, i, k, kk, gen, q_np, rescore)

    def _finish_topk(self, v: np.ndarray, i: np.ndarray, k: int, kk: int,
                     generation: int, q_np: np.ndarray, rescore: bool):
        """Map fetched rows to ids. rescore=True: the device returned an
        int8-scored candidate list; re-rank it exactly against the fp32
        host mirror. Returns None when rows were reassigned since the
        dispatch (the caller re-issues the search)."""
        with self._lock:
            if generation != self._generation:
                return None
            valid = v > -1e29
            # a row removed after dispatch is zeroed in the mirror but
            # its old device score still marks it valid: mask dead-now
            # rows so they surface as (<= -1e29, None)
            valid &= self._live_h[np.where(valid, i, 0)]
            if rescore:
                nat = (rerank_topk_native(self._emb_h, q_np, i, valid, kk)
                       if _USE_NATIVE_RERANK else None)
                if nat is not None:
                    v, i = nat
                else:
                    rows = np.where(valid, i, 0)
                    g = self._emb_h[rows.reshape(-1)].reshape(
                        rows.shape[0], rows.shape[1], self.dim)
                    exact = np.matmul(g, q_np[:, :, None])[:, :, 0]
                    exact = np.where(valid, exact, NEG_INF)
                    order = np.argsort(-exact, axis=1,
                                       kind="stable")[:, :kk]
                    v = np.take_along_axis(exact, order, axis=1)
                    i = np.take_along_axis(i, order, axis=1)
            else:
                v = np.where(valid, v, NEG_INF)[:, :kk]
                i = i[:, :kk]
            if kk < k:
                v = np.pad(v, ((0, 0), (0, k - kk)),
                           constant_values=NEG_INF)
                i = np.pad(i, ((0, 0), (0, k - kk)))
            ids = [[self._id_of[r] if v[b_, j] > -1e29 else None
                    for j, r in enumerate(row)]
                   for b_, row in enumerate(i)]
        return v, ids
