"""The device corpus: the flat index's layout and search, and the host
bookkeeping every device layout shares.

Counterpart of cortex_tpu/vector/shard.py::DeviceCorpus. The host side
is the reference's: the authoritative host mirror (fp32 rows, liveness,
kind and agent codes), the id <-> row maps, the capacity ladder, dirty
tracking, the fixed-shape filter encoding with its exact host-bias
fallback, the k and candidate-width rules, and the exact fp32 re-rank
of device candidates against the host mirror.

The device layout of the flat index (the reference's default):

    emb        [cap, d]  f32, or bf16 centered on the live mean
    live       [cap]     bool
    kind_code  [cap]     int32
    agent_code [cap]     int32
    emb_i8     [cap, d]  int8, centered on the live mean  (quant path)
    rinv       [cap]     f32 dequant factors              (quant path)

A sync writes dirty rows in place (index_copy_) into every plane, or
uploads everything when more than max(4096, cap // 8) rows are dirty.
Capacity growth appends dead rows to the device planes (torch.cat), so
live rows keep their values and centering shifts, as the reference's
in-place pad does. Above the memory budget (CORTEX_HBM_BUDGET_GB,
default 12) only the int8 shadow and the masks stay on the device
(quant-only residency) and the exact re-rank runs on the host mirror.

Search paths (`_choose_path`): `quant` is the int8 candidate scan (K1)
plus the exact fp32 device re-rank (K2), or K1 plus the host re-rank
when the device holds no fp32 copy; `approx` and `xla` are the product
in the storage dtype plus an exact top-k. `auto` takes `quant` on a
CUDA device at cap >= QUANT_MIN_CAP and `xla` elsewhere, as the
reference does off the TPU.

A subclass may supply another layout: `sync` pushes host changes to
the device and `_dispatch_search` enqueues the candidate search
(vector/ivf.py::IvfCorpus); every other method is shared.

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

from ..errors import IndexError_
from ..native import rerank_topk_native
from ..ops.similarity import (NEG_INF, cosine_topk_approx,
                              cosine_topk_quant_exact, cosine_topk_xla,
                              normalize_rows, quant_candidates,
                              quantize_queries, quantize_rows_centered)

MIN_CAP = 1024
MAX_FILTER_KINDS = 16
MAX_EXCLUDE = 64
NO_FILTER = -1
PAD_CODE = -2
#: below this capacity `auto` serves through the product + exact top-k
#: even on a CUDA device: the int8 scan's gain only matters at scale
QUANT_MIN_CAP = 4096
SEARCH_PATHS = ("auto", "exact", "approx", "quant")
#: widest candidate list the device re-rank (K2) sorts in shared
#: memory; a wider one (k above 8192) re-ranks on the host
MAX_DEVICE_RERANK = 16384
# the C++ re-rank parallelizes across queries (ctypes releases the
# GIL); single-core it's a wash with numpy's BLAS path, so only prefer
# it when there are cores to use
_USE_NATIVE_RERANK = (os.cpu_count() or 1) > 1
#: re-issues of a search whose rows were reassigned mid-fetch before
#: the last attempt runs holding the lock
_RETRIES = 3


class Interner:
    """string <-> int32 code, append-only."""

    def __init__(self):
        self._code: Dict[str, int] = {}
        self._name: List[str] = []

    def code(self, name: str) -> int:
        c = self._code.get(name)
        if c is None:
            c = len(self._name)
            self._code[name] = c
            self._name.append(name)
        return c

    def name(self, code: int) -> str:
        return self._name[code]

    def lookup(self, name: str) -> int:
        """Code for name, or PAD_CODE (matches nothing) when unseen."""
        return self._code.get(name, PAD_CODE)


def build_bias(live: torch.Tensor, kind_code: torch.Tensor,
               agent_code: torch.Tensor, ak, aa, ex) -> torch.Tensor:
    """[cap] additive f32 bias on the planes' device: 0 for admissible
    rows, <= NEG_INF otherwise. Counterpart of shard.py::_build_bias,
    as elementwise torch on the device-resident planes. ak [16] / aa /
    ex [64] are the host filter codes of `_filter_codes` (ak[0] ==
    NO_FILTER: no kind filter; ex padded with NO_FILTER); a filter that
    is off costs nothing."""
    dev = live.device
    bias = torch.where(live, 0.0, NEG_INF)
    ak = np.asarray(ak, np.int32)
    if ak[0] != NO_FILTER:
        codes = torch.from_numpy(ak).to(dev)
        ok = (kind_code[:, None] == codes[None, :]).any(dim=1)
        bias = bias + torch.where(ok, 0.0, NEG_INF)
    if int(aa) != NO_FILTER:
        bias = bias + torch.where(agent_code == int(aa), 0.0, NEG_INF)
    ex = np.asarray(ex, np.int64)
    rows = ex[(ex >= 0) & (ex < live.shape[0])]
    if len(rows):
        hit = torch.zeros(live.shape[0], dtype=torch.bool, device=dev)
        hit[torch.from_numpy(rows).to(dev)] = True
        bias = bias + torch.where(hit, NEG_INF, 0.0)
    return bias


class DeviceCorpus:
    """Host mirror + id <-> row maps of a device-resident corpus, and the
    flat device layout (see the module docstring)."""

    #: above this row count the capacity ladder grows 1.25x per step
    #: instead of doubling (a 10M-row corpus would otherwise pad to 16.7M)
    GENTLE_GROWTH_ROWS = 4 << 20

    def __init__(self, dim: int, *, device: torch.device,
                 search_path: str = "auto",
                 storage_dtype: str = "float32"):
        if search_path not in SEARCH_PATHS:
            raise IndexError_(f"search_path must be one of {SEARCH_PATHS}, "
                              f"got {search_path!r}")
        self.dim = dim
        self._device = torch.device(device)
        self._search_path = search_path
        # bf16 halves device residency and scan bytes; the host mirror
        # stays fp32 for the exact re-rank
        self._storage_dtype = (torch.bfloat16 if storage_dtype == "bfloat16"
                               else torch.float32)
        #: (emb or None, live, kind_code, agent_code) device planes
        self._dev: Optional[Tuple[Optional[torch.Tensor], ...]] = None
        #: (emb_i8, rinv): the centered int8 shadow of the quant path
        self._dev_q: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._bf16_mu: Optional[np.ndarray] = None   # bf16 centering shift
        # device-memory budget of the corpus (bytes): above it only the
        # int8 shadow and the masks stay on the device
        self._hbm_budget = float(os.environ.get(
            "CORTEX_HBM_BUDGET_GB", "12")) * (1 << 30)
        self._emb_resident = True
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
        self._grow_pad = 0                 # dead rows to pad at next sync
        self._quant_mu = np.zeros(dim, np.float32)   # int8 centering shift
        self.kinds = Interner()
        self.agents = Interner()
        self._lock = threading.RLock()
        self._released = False             # release() dropped the planes

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
        if self._can_grow_on_device():
            # the next sync pads the device planes with dead rows; the
            # live rows keep their values and centering shifts
            self._grow_pad += pad
        else:
            self._full_resync = True

    def _can_grow_on_device(self) -> bool:
        """The reference's rule: the flat corpus pads its resident planes
        in place when the residency decision holds at the new capacity.
        Without flat planes (none uploaded yet, or the IVF layout, which
        re-packs on growth) the next sync is a full one."""
        if self._dev is None:
            return False
        if self._dev[0] is not None:
            return self._emb_fits()
        return self._cap * self.dim <= self._hbm_budget

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
    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        """A device copy of a host array (never a view of the mirror)."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self._device,
                                                            copy=True)

    def _live_mean(self) -> Optional[np.ndarray]:
        live = self._live_h
        return (self._emb_h[live].mean(axis=0).astype(np.float32)
                if live.any() else None)

    def _emb_for_device(self, rows: Optional[np.ndarray] = None,
                        mu: Optional[np.ndarray] = None) -> torch.Tensor:
        """Device rows of emb: f32 as they are, or bf16 CENTERED on the
        live mean (rounding error then scales with the residual, which
        is what tells rows apart; the per-query q.mu goes back onto the
        returned scores in _finish_topk). A full upload (rows=None)
        takes a fresh mean (mu, when the caller has it); row updates
        reuse the last one, since any fixed shift is ranking-correct."""
        src = self._emb_h if rows is None else self._emb_h[rows]
        if self._storage_dtype != torch.bfloat16:
            return self._to_dev(src)
        if rows is None:
            self._bf16_mu = mu if mu is not None else self._live_mean()
        if self._bf16_mu is not None:
            src = src - self._bf16_mu[None, :]
        return torch.from_numpy(np.ascontiguousarray(src, np.float32)).to(
            torch.bfloat16).to(self._device)

    def _quant_enabled(self) -> bool:
        """Whether the int8 shadow is kept on the device."""
        return (self._search_path == "quant"
                or (self._search_path == "auto"
                    and self._device.type == "cuda"))

    def _emb_fits(self) -> bool:
        """Whether emb fits on the device beside the int8 shadow under
        the budget. False -> quant-only residency."""
        if not self._quant_enabled():
            return True           # nothing else to keep; let it OOM loudly
        esize = 2 if self._storage_dtype == torch.bfloat16 else 4
        return self._cap * self.dim * (esize + 1) <= self._hbm_budget

    def _sync_quant(self, rows: Optional[np.ndarray],
                    mu: Optional[np.ndarray] = None) -> None:
        """Refresh the int8 shadow from the fp32 host mirror, quantized
        on the host with the reference's numpy code (bit-identical rows
        in both packages), centered on the live mean. rows=None: full
        upload with a fresh mean (mu, when the caller has it); otherwise
        the dirty rows, in place, against the last mean."""
        if rows is None:
            if mu is None:
                mu = self._live_mean()
            if mu is None:
                mu = np.zeros(self.dim, np.float32)
            q, rinv, self._quant_mu = quantize_rows_centered(self._emb_h, mu)
            self._dev_q = (self._to_dev(q), self._to_dev(rinv))
            return
        q, rinv, _ = quantize_rows_centered(self._emb_h[rows],
                                            self._quant_mu)
        idx = self._to_dev(rows.astype(np.int64))
        emb_i8, ri = self._dev_q
        emb_i8.index_copy_(0, idx, self._to_dev(q))
        ri.index_copy_(0, idx, self._to_dev(rinv))

    def _upload_full(self, quant: bool) -> None:
        self._emb_resident = self._emb_fits()
        # one live-mean pass serves both the bf16 and the int8 centering
        mu_live = None
        if quant or (self._emb_resident
                     and self._storage_dtype == torch.bfloat16):
            mu_live = self._live_mean()
        emb = (self._emb_for_device(mu=mu_live) if self._emb_resident
               else None)
        self._dev = (emb, self._to_dev(self._live_h),
                     self._to_dev(self._kind_h), self._to_dev(self._agent_h))
        self._grow_pad = 0                    # the planes are at full cap
        if quant:
            self._sync_quant(None, mu=mu_live)

    def _pad_planes(self, pad: int) -> None:
        """Capacity growth on the device: append `pad` dead rows to every
        plane (the new rows are dirty and get written by the sync)."""
        def grown(t, value):
            return torch.cat([t, torch.full((pad,) + tuple(t.shape[1:]),
                                            value, dtype=t.dtype,
                                            device=t.device)])
        emb, live, kind_code, agent_code = self._dev
        self._dev = (None if emb is None else grown(emb, 0),
                     grown(live, False), grown(kind_code, PAD_CODE),
                     grown(agent_code, PAD_CODE))
        if self._dev_q is not None:
            self._dev_q = (grown(self._dev_q[0], 0),
                           grown(self._dev_q[1], 0.0))

    def release(self) -> None:
        """Drop the device planes for good (an index replaced by a
        rebuild): their memory returns to the allocator, and a later
        search raises instead of uploading them again."""
        with self._lock:
            self._released = True
            self._dev = None
            self._dev_q = None

    def _check_live(self) -> None:
        if self._released:
            raise IndexError_("the index was released (replaced by a "
                              "rebuild)")

    def sync(self) -> None:
        """Push host changes to the device planes. Cheap when clean."""
        with self._lock:
            self._check_live()
            if self._cap == 0:
                return
            quant = self._quant_enabled()
            if (self._dev is None or self._full_resync
                    or (quant and self._dev_q is None)):
                self._upload_full(quant)
                self._full_resync = False
                self._dirty.clear()
                return
            if self._grow_pad:
                self._pad_planes(self._grow_pad)
                self._grow_pad = 0
            if not self._dirty:
                return
            if len(self._dirty) > max(4096, self._cap // 8):
                self._upload_full(quant)
            else:
                rows = np.fromiter(self._dirty, np.int64, len(self._dirty))
                idx = self._to_dev(rows)
                emb, live, kind_code, agent_code = self._dev
                if emb is not None:
                    emb.index_copy_(0, idx, self._emb_for_device(rows))
                live.index_copy_(0, idx, self._to_dev(self._live_h[rows]))
                kind_code.index_copy_(0, idx,
                                      self._to_dev(self._kind_h[rows]))
                agent_code.index_copy_(0, idx,
                                       self._to_dev(self._agent_h[rows]))
                if quant:
                    self._sync_quant(rows)
            self._dirty.clear()

    def _choose_path(self, k_bucket: int,
                     emb_resident: Optional[bool] = None) -> str:
        """Serving-path policy of the reference: `exact` forces the
        exact product; quant-only residency leaves only `quant`; `auto`
        takes `quant` on a CUDA device at scale (the reference: on a
        TPU), else `xla`."""
        if emb_resident is None:
            emb_resident = self._emb_resident
        if not emb_resident:
            return "quant"
        if self._search_path == "exact":
            return "xla"
        if self._search_path in ("approx", "quant"):
            return self._search_path
        if self._device.type == "cuda" and self._cap >= QUANT_MIN_CAP:
            return "quant"
        return "xla"

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
    def _dispatch_search(self, q_np: np.ndarray, ak, aa, ex, k_bucket: int,
                         host_bias: Optional[np.ndarray] = None):
        """Enqueue the bias build and the search of normalized queries
        q_np on the device planes. host_bias (the exact [cap] bias of an
        overflowing filter) replaces the fixed-shape filter codes.
        Returns (values, rows, needs_rescore) as device tensors; with
        needs_rescore the rows are int8-scored candidates for the host
        re-rank. Callers hold the corpus lock."""
        emb, live, kind_code, agent_code = self._dev
        path = self._choose_path(k_bucket, emb_resident=emb is not None)
        q = self._to_dev(q_np)
        bias = (self._to_dev(host_bias) if host_bias is not None
                else build_bias(live, kind_code, agent_code, ak, aa, ex))
        if path == "quant":
            cand = self._cand_count(k_bucket)
            emb_i8, rinv = self._dev_q
            if (self._storage_dtype == torch.float32 and emb is not None
                    and cand <= MAX_DEVICE_RERANK):
                # fp32 rows on the device: K1 + the exact device re-rank
                v, i = cosine_topk_quant_exact(emb_i8, rinv, emb, q,
                                               k_bucket, cand, bias)
                return v, i, False
            # bf16 or quant-only residency: no exact device copy, so K1
            # alone and the exact re-rank on the host mirror
            qi8, qs = quantize_queries(q)
            v, i = quant_candidates(emb_i8, rinv, qi8, qs, bias, cand)
            return v, i, True
        if path == "approx" and self._cap >= QUANT_MIN_CAP:
            v, i = cosine_topk_approx(emb, q, k_bucket, bias)
        else:
            v, i = cosine_topk_xla(emb, q, k_bucket, bias)
        return v, i, False

    def _dispatch(self, q_np: np.ndarray, k: int, flt, chunk: int = 0):
        """Under the corpus lock: sync, encode the filters, enqueue the
        search (in query chunks of `chunk` rows when chunk > 0, each on
        the same layout) and capture what the fetch needs. Returns None
        for an empty corpus, else (values, rows, rescore, kk, generation,
        bf16 mu of the dispatched layout)."""
        with self._lock:
            if len(self._row_of) == 0:
                return None
            self.sync()
            ak, aa, ex, hb = self._filter_codes(*flt)
            kk, k_bucket = self._k_bucket(k)
            gen = self._generation
            mu = self._bf16_mu
            step = chunk if chunk > 0 else max(1, q_np.shape[0])
            vs, rs, rescore = [], [], False
            for s0 in range(0, max(1, q_np.shape[0]), step):
                v, i, rescore = self._dispatch_search(
                    q_np[s0:s0 + step], ak, aa, ex, k_bucket, host_bias=hb)
                vs.append(v)
                rs.append(i)
        if len(vs) > 1:
            return torch.cat(vs), torch.cat(rs), rescore, kk, gen, mu
        return vs[0], rs[0], rescore, kk, gen, mu

    def _collect(self, dispatched, q_np: np.ndarray, k: int, flt=None,
                 refine: bool = True):
        """Fetch a dispatched search (outside the lock: the copy waits
        for the device) and finish it; None when rows were reassigned
        since the dispatch. flt and refine go to _finish_topk."""
        b = q_np.shape[0]
        if dispatched is None:
            return (np.full((b, k), NEG_INF, np.float32),
                    [[None] * k for _ in range(b)])
        v, i, rescore, kk, gen, mu = dispatched
        return self._finish_topk(v.cpu().numpy(), i.cpu().numpy(), k, kk,
                                 gen, q_np, rescore, mu, flt=flt,
                                 refine=refine)

    def _resolve(self, first, redispatch, q_np: np.ndarray, k: int,
                 flt=None, refine: bool = True):
        """Collect `first`; while rows were reassigned under it, re-issue
        (bounded), the last time holding the lock so nothing can move."""
        out = self._collect(first, q_np, k, flt, refine)
        for _ in range(_RETRIES):
            if out is not None:
                return out
            out = self._collect(redispatch(), q_np, k, flt, refine)
        if out is None:
            with self._lock:
                out = self._collect(redispatch(), q_np, k, flt, refine)
        if out is None:
            raise RuntimeError("corpus generation changed under its lock")
        return out

    def topk_async(self, queries: np.ndarray, k: int, *,
                   kinds: Optional[Sequence[str]] = None,
                   agent: Optional[str] = None,
                   exclude_ids: Optional[Sequence[str]] = None,
                   refine: bool = True):
        """Dispatch a batched search without fetching it; returns a
        zero-arg callable that blocks for (scores [B, k], ids [B][k]).
        Dead or padded hits have score <= -1e29 and id None. refine=False
        skips _expand_candidates."""
        q_np = normalize_rows(np.asarray(queries, np.float32))
        flt = (kinds, agent, exclude_ids)
        first = self._dispatch(q_np, k, flt)
        return lambda: self._resolve(
            first, lambda: self._dispatch(q_np, k, flt), q_np, k, flt,
            refine)

    def topk(self, queries: np.ndarray, k: int, *,
             kinds: Optional[Sequence[str]] = None,
             agent: Optional[str] = None,
             exclude_ids: Optional[Sequence[str]] = None
             ) -> Tuple[np.ndarray, List[List[Optional[str]]]]:
        """Batched search. Returns (scores [B,k], ids [B][k]); dead or
        padded hits have score <= -1e29 and id None."""
        return self.topk_async(queries, k, kinds=kinds, agent=agent,
                               exclude_ids=exclude_ids)()

    def topk_stream(self, queries: np.ndarray, k: int, *,
                    batch: int = 512,
                    kinds: Optional[Sequence[str]] = None,
                    agent: Optional[str] = None,
                    exclude_ids: Optional[Sequence[str]] = None,
                    refine: bool = True):
        """Bulk search over a query stream: every chunk of `batch`
        queries is enqueued on one layout, the results are concatenated
        on the device and fetched once. The same results as topk over
        the whole stream."""
        q_all = np.asarray(queries, np.float32)
        if q_all.ndim != 2:
            raise ValueError("topk_stream expects [NQ, d]")
        if q_all.shape[0] == 0:
            return np.zeros((0, k), np.float32), []
        q_np = normalize_rows(q_all)
        flt = (kinds, agent, exclude_ids)

        def dispatch():
            return self._dispatch(q_np, k, flt, chunk=max(1, int(batch)))
        return self._resolve(dispatch(), dispatch, q_np, k, flt, refine)

    def _expand_candidates(self, i, valid, q_np, flt):
        """Hook: widen the candidate list between the fetch and the exact
        re-rank (the graph-refined IVF index overrides it). Runs under
        the corpus lock. flt is the host-form (kinds, agent, exclude_ids)
        triple, so expanded rows can be filter-checked against the host
        mirrors; q_np feeds multi-hop frontier selection. Returns (i,
        valid), possibly wider; the exact re-rank scores whatever is
        valid, so expansion can only add candidates."""
        return i, valid

    def _finish_topk(self, v: np.ndarray, i: np.ndarray, k: int, kk: int,
                     generation: int, q_np: np.ndarray, rescore: bool,
                     bf16_mu: Optional[np.ndarray] = None, flt=None,
                     refine: bool = True):
        """Map fetched rows to ids. rescore=True: the device returned an
        int8-scored candidate list; with refine, _expand_candidates may
        widen it (flt: the host-form filters); then it is re-ranked
        exactly against the fp32 host mirror. Otherwise the device scores
        are final, and bf16_mu (the centering shift of the DISPATCHED
        layout, not the current one) puts the per-query q.mu back onto
        them. Returns None when rows were reassigned since the dispatch
        (the caller re-issues)."""
        with self._lock:
            if generation != self._generation:
                return None
            valid = v > -1e29
            # a row removed after dispatch is zeroed in the mirror but
            # its old device score still marks it valid: mask dead-now
            # rows so they surface as (<= -1e29, None)
            valid &= self._live_h[np.where(valid, i, 0)]
            if rescore:
                if refine:
                    # refinement is a serving-recall feature; the bulk
                    # scans (auto-linker, dedup) pass refine=False: their
                    # similarity thresholds sit far above the structural
                    # miss band, and the extra host re-rank rows would
                    # tax every cycle
                    i, valid = self._expand_candidates(i, valid, q_np, flt)
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
                v, i, valid = v[:, :kk], i[:, :kk], valid[:, :kk]
                if bf16_mu is not None:
                    comp = (q_np @ bf16_mu).astype(np.float32)
                    v = v + comp[:, None]
                v = np.where(valid, v, NEG_INF).astype(np.float32)
            if kk < k:
                v = np.pad(v, ((0, 0), (0, k - kk)),
                           constant_values=NEG_INF)
                i = np.pad(i, ((0, 0), (0, k - kk)))
            ids = [[self._id_of[r] if v[b_, j] > -1e29 else None
                    for j, r in enumerate(row)]
                   for b_, row in enumerate(i)]
        return v, ids

    # ---------------------------------------------------------- snapshot
    def state(self) -> Dict[str, np.ndarray]:
        """Host copy of the contents, in the reference's form: ids,
        vectors (normalized fp32), kinds and agents (names)."""
        with self._lock:
            ids = [i for i in self._id_of if i is not None]
            rows = [self._row_of[i] for i in ids]
            return {
                "ids": np.array(ids, dtype=object),
                "vectors": self._emb_h[rows].copy(),
                "kinds": np.array([self.kinds.name(self._kind_h[r])
                                   for r in rows], dtype=object),
                "agents": np.array([self.agents.name(self._agent_h[r])
                                    for r in rows], dtype=object),
            }

    def load_jax_state(self, st) -> None:
        """Load the dict that cortex_tpu's DeviceCorpus.state() returns
        (ids, vectors, kinds, agents, all numpy): rows in `ids` order, as
        the reference's loader inserts them, so both packages place the
        same ids on the same rows."""
        self.upsert_batch([str(i) for i in st["ids"]],
                          np.asarray(st["vectors"], np.float32),
                          [str(k) for k in st["kinds"]],
                          [str(a) for a in st["agents"]])
