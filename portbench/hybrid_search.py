"""What a hybrid-search configuration runs: its inputs, the entry the
window drives, the wait for a ready system, the comparison with the plain
reference that decides `correct`, and the control of that comparison.

One operation is one hybrid query: a query vector, its anchors (the
nodes an agent holds, near its question) and maybe a kind filter,
answered through `HybridSearch.search_async`. systems/hybrid.py adds how
the system is built and the least work of a call.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import hybrid_reference as href
from . import reference
from .graph_data import Neighbours, clustered_rows_and_members, seeded_edges
from .verdict import Verdict

#: the vector leg over-fetches this many times the limit
# (crates/cortex-core/src/vector/hybrid.rs:125)
FETCH = 3


@dataclass
class HybridData:
    """The benchmark's own inputs, on the host: what the program gets and
    what the reference reads."""

    rows: np.ndarray                  # [N, d] float32 unit rows
    ids: List[str]                    # row r is id str(r)
    kinds: List[str]                  # row r is kind k{r % kinds}
    src: np.ndarray                   # [E] directed edges, row numbers
    dst: np.ndarray
    pool: np.ndarray                  # [P, d] float32 unit queries
    anchors: List[List[int]]          # each query's anchor rows, in order
    filters: List[Optional[List[str]]]   # each query's kind filter
    batches: List[tuple]              # (query vector, HybridQuery) a call


@dataclass
class HybridSystem:
    """The system under test (systems/*.py's build) and what wait_ready
    checks it against."""

    hybrid: object                    # HybridSearch
    edges: int                        # directed edges loaded


def draw_queries(traffic: dict, nb: Neighbours, n: int, seed: int):
    """(query rows, anchors, filters) of the traffic's pool: each query a
    row that has edges; its anchors 1 to 3 (the traffic's range, as far
    as there are) distinct rows drawn from that row and its neighbours,
    in the drawn order; every `filter_every`-th query filtered to the
    traffic's kinds; in every `lonely_every`-th the last anchor an
    edge-less row (row i % 1000 == 999) instead."""
    rng = np.random.default_rng((int(seed), 1))
    linked = np.nonzero(nb.degree() > 0)[0]
    rows = linked[rng.integers(0, len(linked), traffic["pool"])]
    lo, hi = traffic["anchors"]
    anchors, filters = [], []
    for j, r in enumerate(rows.tolist()):
        near = np.concatenate(([r], nb.of(r)))
        m = min(int(rng.integers(lo, hi + 1)), len(near))
        a = rng.choice(near, m, replace=False).tolist()
        if (j + 1) % traffic["lonely_every"] == 0:
            lonely = (r // 1000) * 1000 + 999
            a[-1] = lonely if lonely < n else lonely - 1000
        anchors.append(a)
        filters.append(list(traffic["filter_kinds"])
                       if (j + 1) % traffic["filter_every"] == 0 else None)
    return rows, anchors, filters


def make_data(cfg: dict, traffic: dict, seed: int,
              dev: torch.device) -> HybridData:
    """The configuration's rows (the flat configuration's, drawn on dev
    from one generator seeded with `seed`), its edges and the traffic's
    pool: noisy copies of the query rows, the same spread, from the same
    generator."""
    from cortex_tpu_torch.vector.hybrid import HybridQuery
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    n, d = cfg["rows"], cfg["dim"]
    x, _, member = clustered_rows_and_members(
        gen, dev, n, d, groups=cfg["centers"], spread=cfg["spread"])
    src, dst = seeded_edges(member.cpu().numpy(), cfg["edge_draw"],
                            int(seed), cap=cfg["degree_cap"])
    qrows, anchors, filters = draw_queries(traffic, Neighbours(src, dst, n),
                                           n, seed)
    q = x[torch.from_numpy(qrows).to(dev)]
    q = q + cfg["query_spread"] * torch.randn(
        q.shape, device=dev, generator=gen) / d ** 0.5
    pool = (q / q.norm(dim=1, keepdim=True)).cpu().numpy()
    rows = x.cpu().numpy()
    del x, q
    ids = [str(r) for r in range(n)]
    batches = [(pool[j], HybridQuery(
        query_text="", anchors=[ids[a] for a in anchors[j]],
        vector_weight=traffic["vector_weight"], limit=traffic["k"],
        kind_filter=filters[j],
        max_anchor_depth=traffic["max_anchor_depth"]))
        for j in range(len(pool))]
    return HybridData(
        rows=rows, ids=ids, kinds=[f"k{r % cfg['kinds']}" for r in range(n)],
        src=src, dst=dst, pool=pool, anchors=anchors, filters=filters,
        batches=batches)


def call(sut, q: tuple, traffic: dict):
    """One timed hybrid search: its results."""
    return sut.hybrid.search_async(*q)()


def call_async(sut, q: tuple, traffic: dict):
    """The same search split in two: the vector leg enqueued and the
    proximity leg run now, and the returned callable that fuses."""
    return sut.hybrid.search_async(*q)


def ops(q: tuple) -> int:
    return 1


def wait_ready(sut, cfg: dict) -> None:
    """Check that the system serves as the configuration states: the
    index as `expect_info` says, and the graph mirror in its packed mode
    on a snapshot of every edge drawn, with no row cut to the mirror's
    degree cap. Raises when it does not: such a run is no sound run of
    the configuration."""
    info = sut.hybrid.index.index_info()
    for key, want in cfg.get("expect_info", {}).items():
        if info.get(key) != want:
            raise RuntimeError(f"index_info()[{key!r}] is {info.get(key)!r}"
                               f", the configuration states {want!r}")
    mirror = sut.hybrid.mirror
    if not mirror._packed_mode():
        raise RuntimeError("the graph mirror is not in its packed mode")
    edges = mirror._ensure_packed().edge_count
    if edges != sut.edges:
        raise RuntimeError(f"the packed snapshot holds {edges} edges of "
                           f"{sut.edges}")
    if mirror.truncated_nodes:
        raise RuntimeError(f"{mirror.truncated_nodes} rows cut to the "
                           "mirror's degree cap")


def close(sut) -> None:
    sut.hybrid.index.close()


def _result(r) -> tuple:
    """(id, vector score, graph score, combined, nearest anchor) of a
    HybridResult, or of such a tuple."""
    if hasattr(r, "node"):
        return (r.node.id, r.vector_score, r.graph_score, r.combined_score,
                r.nearest_anchor)
    return tuple(r)


def _parse(results, k: int, data: HybridData, qno: int):
    """An answer's result tuples with each id's row number, or None when
    it is malformed or answers another question: not k results, an id
    that names no row or comes twice, or a row whose kind the query's
    filter excludes."""
    if results is None or len(results) != k:
        return None
    try:
        out = [_result(r) for r in results]
        rows = [int(t[0]) for t in out]
    except (TypeError, ValueError, AttributeError):
        return None
    n = len(data.ids)
    if len(set(rows)) != k or min(rows) < 0 or max(rows) >= n:
        return None
    flt = data.filters[qno]
    if flt is not None and any(data.kinds[r] not in flt for r in rows):
        return None
    return rows, out


def judge(cfg: dict, traffic: dict, data: HybridData, outputs,
          dev: torch.device) -> Verdict:
    """Compare every answer the window returned with the reference.

    outputs: (query number, results or None for a call that raised) per
    call. Identical answers to one query are compared once and counted as
    often as they came. A query whose answer is missing or malformed
    (`_parse`), or that returns a row no sound vector leg holds (its
    fp32 cosine below the reference's last fetched one by more than the
    score_gap limit), is failed. Compared numbers, each over every result
    of every distinct answer:
      score_gap     the largest |returned vector score - the reference's
                    fp32 cosine of that query and row|: the vector leg
                    is exact in float32;
      combined_gap  the largest |returned combined score - w x that
                    cosine - (1 - w) x the reference's graph score|: the
                    fusion adds nothing but rounding;
      depth_mismatch  results whose graph score or nearest anchor
                    (id, depth) differs from the reference BFS's: hop
                    depths are integers, so exactly;
      rank_gap      the largest distance by which a returned result's
                    reference combined score lies below the reference's
                    10th best: the answer is the top `limit`. The 10th is
                    taken over the fetched rows that every sound vector
                    leg holds, those above the last fetched one by more
                    than the score_gap limit (a row within it of the cut
                    may fall either side in float32);
      recall        the mean share of the reference's fused top `limit`
                    returned, a failed query counting 0 (recall_at_10).
    """
    k, hops, w = (traffic["k"], traffic["max_anchor_depth"],
                  traffic["vector_weight"])
    limits = cfg["limits"]
    tie = limits["score_gap"]
    seen: Dict[tuple, list] = {}
    attempted = failed = 0
    for qno, results in outputs:
        attempted += 1
        parsed = _parse(results, k, data, qno)
        if parsed is None:
            failed += 1
            continue
        key = (qno, tuple(parsed[1]))
        if key in seen:
            seen[key][0] += 1
        else:
            seen[key] = [1, qno, parsed[0], parsed[1]]
    names = ("score_gap", "combined_gap", "depth_mismatch", "rank_gap")
    if not seen:
        checks = {"failed": (failed, "<=", 0)}
        checks.update({m: (None, "<=", limits[m]) for m in names})
        return Verdict(attempted, failed, checks, {"recall": 0.0})
    answers = list(seen.values())
    queries = sorted({a[1] for a in answers})
    fetched = _vector_leg(cfg, data, queries, FETCH * k, dev)
    # every row whose depth a comparison needs, a query: its fetched rows
    # and the rows any of its answers returned
    need = {qn: list(fetched[qn][0]) for qn in queries}
    for _, qn, rows, _ in answers:
        need[qn] += [r for r in rows if r not in need[qn]]
    depth = _depths(data, need, hops, dev)
    qidx = np.asarray([a[1] for a in answers], np.int64)
    ridx = np.asarray([a[2] for a in answers], np.int64)
    pair = reference.pair_scores(data.rows, data.pool, qidx, ridx, dev)
    score_gap = combined_gap = rank_gap = 0.0
    mismatch = outside = 0
    recall = 0.0
    for (count, qn, rows, out), cos in zip(answers, pair):
        frows, fscores = fetched[qn]
        names_a = [data.ids[a] for a in data.anchors[qn]]
        col = {r: j for j, r in enumerate(need[qn])}
        ref = href.fuse(frows, fscores, depth[qn], names_a, data.ids, w,
                        hops, len(frows))
        sure = sorted((t[3] for t in ref if t[1] > fscores[-1] + tie),
                      reverse=True)
        tenth = sure[k - 1] if len(sure) >= k else -np.inf
        bad = False
        for (rid, v, g, c, nearest), r, x in zip(out, rows, cos):
            g_ref, near_ref = href.graph_score(depth[qn][:, col[r]],
                                               names_a, hops)
            c_ref = w * float(x) + (1.0 - w) * g_ref
            score_gap = max(score_gap, abs(float(v) - float(x)))
            combined_gap = max(combined_gap, abs(float(c) - c_ref))
            if g != g_ref or _nearest(nearest) != near_ref:
                mismatch += count
            rank_gap = max(rank_gap, tenth - c_ref)
            bad |= float(x) < fscores[-1] - tie
        if bad:
            outside += count
            continue
        want = {t[0] for t in ref[:k]}
        recall += count * len(want & {t[0] for t in out}) / k
    failed += outside
    values = {"score_gap": score_gap, "combined_gap": combined_gap,
              "depth_mismatch": mismatch, "rank_gap": rank_gap,
              "recall": recall / max(1, attempted),
              "distinct_answers": len(answers)}
    checks = {"failed": (failed, "<=", 0)}
    checks.update({m: (values[m], "<=", limits[m]) for m in names})
    return Verdict(attempted, failed, checks, values)


def _nearest(nearest):
    return None if nearest is None else (nearest[0], int(nearest[1]))


def _vector_leg(cfg: dict, data: HybridData, queries: List[int], fetch: int,
                dev, *, tf32: bool = False) -> Dict[int, Tuple[list, list]]:
    """The reference's vector leg of each query: (rows, fp32 scores),
    best first."""
    nk = cfg["kinds"]
    kind_of = (np.arange(len(data.ids)) % nk).astype(np.int64)
    admitted = np.ones((len(queries), nk), bool)
    for i, qn in enumerate(queries):
        if data.filters[qn] is not None:
            admitted[i] = [f"k{c}" in data.filters[qn] for c in range(nk)]
    v, r = href.filtered_topk(data.rows, kind_of, data.pool[queries],
                              admitted, fetch, dev, tf32=tf32)
    return {qn: (r[i].tolist(), v[i].tolist())
            for i, qn in enumerate(queries)}


def _depths(data: HybridData, need: Dict[int, list], hops: int,
            dev) -> Dict[int, np.ndarray]:
    """Each query's [anchors, needed rows] depths from the reference BFS."""
    width = max(len(v) for v in need.values())
    anchors, at, owner = [], [], []
    for qn, rows in need.items():
        for a in data.anchors[qn]:
            anchors.append(a)
            at.append(rows + [rows[0]] * (width - len(rows)))
            owner.append(qn)
    d = href.depths_at(data.src, data.dst, len(data.ids),
                       np.asarray(anchors, np.int64),
                       np.asarray(at, np.int64), hops, dev)
    out: Dict[int, list] = {qn: [] for qn in need}
    for qn, row in zip(owner, d):
        out[qn].append(row[:len(need[qn])])
    return {qn: np.asarray(v, np.int8).reshape(len(v), len(need[qn]))
            for qn, v in out.items()}


def control_outputs(cfg: dict, traffic: dict, data: HybridData, dev, *,
                    tf32: bool = True):
    """(query number, results) for one pass over the pool, answered by
    the reference with its vector leg in TF32 (the control: one
    precision below the configuration's float32; tf32=False answers
    as the reference itself)."""
    k, hops, w = (traffic["k"], traffic["max_anchor_depth"],
                  traffic["vector_weight"])
    queries = list(range(len(data.pool)))
    fetched = _vector_leg(cfg, data, queries, FETCH * k, dev, tf32=tf32)
    depth = _depths(data, {qn: list(fetched[qn][0]) for qn in queries},
                    hops, dev)
    return [(qn, href.fuse(fetched[qn][0], fetched[qn][1], depth[qn],
                           [data.ids[a] for a in data.anchors[qn]],
                           data.ids, w, hops, k)) for qn in queries]
