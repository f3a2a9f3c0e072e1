"""The port's index API against the reference's: `search`,
`search_batch`, `search_batch_async` and `search_stream` take the
reference's parameters (names, kinds, defaults; `refine` keyword-only,
default True), and `refine=False` gives the same hits as `refine=True` on
the flat index and on an IVF index without the kNN graph (neither has a
refinement to skip); with the graph, `refine=False` serves exactly the
unrefined index's hits. The finish leg's id map and hit lists, built over
plain lists, are bit-identical to the per-element loops they replaced.
"""

import inspect

import numpy as np
import pytest

from cortex_tpu.vector.index import TpuFlatIndex
from cortex_tpu.vector.index import VectorIndex as JaxVectorIndex
from cortex_tpu.vector.ivf import TpuIvfIndex
from cortex_tpu_torch.ops.similarity import NEG_INF, normalize_rows
from cortex_tpu_torch.vector import TorchFlatIndex, VectorFilter
from cortex_tpu_torch.vector.index import VectorIndex, _hits
from cortex_tpu_torch.vector.ivf import TorchIvfIndex

METHODS = ["search", "search_batch", "search_batch_async", "search_stream"]
PAIRS = [(VectorIndex, JaxVectorIndex), (TorchFlatIndex, TpuFlatIndex),
         (TorchIvfIndex, TpuIvfIndex)]


def params(fn):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("port,ref", PAIRS, ids=lambda c: c.__name__)
def test_signature_matches_reference(port, ref, method):
    want = getattr(ref, method, None)
    if want is None:            # the interface declares only two of them
        assert getattr(port, method, None) is None
        return
    got = params(getattr(port, method))
    assert got == params(want)
    assert ("refine", inspect.Parameter.KEYWORD_ONLY, True) in got


def unit_rows(n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def index(kind, graph_degree=0):
    n, d = 300, 32
    ix = (TorchFlatIndex(d, search_path="quant", device="cpu")
          if kind == "flat" else
          TorchIvfIndex(d, nlist=8, nprobe=3, graph_degree=graph_degree,
                        device="cpu"))
    ix.insert_batch([f"n{i}" for i in range(n)], unit_rows(n, d, 1),
                    kinds=[f"k{i % 3}" for i in range(n)])
    return ix


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_refine_false_gives_the_same_hits(kind):
    ix = index(kind)
    q = unit_rows(9, 32, 2)
    flt = VectorFilter(kinds=["k1"])
    for f in (None, flt):
        want = ix.search_batch(q, 7, f)
        assert ix.search_batch(q, 7, f, refine=False) == want
        assert ix.search_batch(q, 7, f, refine=True) == want
        assert ix.search_batch_async(q, 7, f, refine=False)() == want
        # other batch shapes may round scores differently: each against
        # itself with refine on
        assert ix.search_stream(q, 7, f, batch=4, refine=False) == \
            ix.search_stream(q, 7, f, batch=4)
        assert ix.search(q[0], 7, f, refine=False) == ix.search(q[0], 7, f)
    with pytest.raises(TypeError):            # keyword-only, as in the reference
        ix.search_batch(q, 7, None, False)


def test_refine_false_skips_the_graph():
    """With the kNN graph (the default degree 32), refine=False serves the
    hits of the same layout without a graph; refine=True may add rows."""
    plain, graph = index("ivf"), index("ivf", graph_degree=32)
    q = unit_rows(9, 32, 2)
    for f in (None, VectorFilter(kinds=["k1"])):
        want = plain.search_batch(q, 7, f)
        assert graph.search_batch(q, 7, f, refine=False) == want
        assert graph.search_stream(q, 7, f, batch=4, refine=False) == \
            plain.search_stream(q, 7, f, batch=4)
    assert graph._corpus._nbrs_h is not None
    assert plain._corpus._nbrs_h is None


# ------------------------------------------------ the finish leg's hit lists

def per_element_finish_topk(co, v, i, k, kk, generation, q_np, rescore,
                            bf16_mu=None, flt=None, refine=True):
    """DeviceCorpus._finish_topk as it was before its id map went over
    plain lists (its regions and counter left out): the id map indexes
    a numpy scalar per hit."""
    with co._lock:
        if generation != co._generation:
            return None
        valid = v > -1e29
        valid &= co._live_h[np.where(valid, i, 0)]
        if not rescore:
            v, i, valid = v[:, :kk], i[:, :kk], valid[:, :kk]
            if bf16_mu is not None:
                comp = (q_np @ bf16_mu).astype(np.float32)
                v = v + comp[:, None]
            v = np.where(valid, v, NEG_INF).astype(np.float32)
        if rescore:
            if refine:
                i, valid = co._expand_candidates(i, valid, q_np, flt)
            v, i = co._rerank_host(i, valid, q_np, kk)
        if kk < k:
            v = np.pad(v, ((0, 0), (0, k - kk)),
                       constant_values=NEG_INF)
            i = np.pad(i, ((0, 0), (0, k - kk)))
        ids = [[co._id_of[r] if v[b_, j] > -1e29 else None
                for j, r in enumerate(row)]
               for b_, row in enumerate(i)]
    return v, ids


def per_element_hits(scores, ids):
    """vector/index.py::_hits as it was: float() of a numpy scalar per
    hit."""
    return [[(nid, float(scores[b, j])) for j, nid in enumerate(row)
             if nid is not None]
            for b, row in enumerate(ids)]


FINISH_ROWS = 100          # fewer than the largest k
FINISH_KINDS = {
    "flat": dict(search_path="quant"),                # K1 + K2, no rescore
    "flat-bf16": dict(storage_dtype="bfloat16"),      # the bf16 shift
    "flat-host": dict(search_path="quant",
                      storage_dtype="bfloat16"),      # K1, host re-rank
    "ivf": dict(nlist=8, nprobe=3, graph_degree=8),   # expansion, host re-rank
}


def finish_index(kind):
    """FINISH_ROWS live rows of a full capacity, row 0 among them: a
    dead hit's row may then name a live row, so its id must come from
    the score, not from the id map."""
    d = 32
    kw = FINISH_KINDS[kind]
    ix = (TorchIvfIndex(d, device="cpu", **kw) if kind == "ivf"
          else TorchFlatIndex(d, device="cpu", **kw))
    n = 1024
    ix.insert_batch([f"n{i}" for i in range(n)], unit_rows(n, d, 5),
                    kinds=[f"k{i % 3}" for i in range(n)])
    co = ix._corpus
    assert co._cap == n
    for i in range(n):
        if co._row_of[f"n{i}"] >= FINISH_ROWS:
            ix.remove(f"n{i}")
    assert len(ix) == FINISH_ROWS and co._id_of[0] is not None
    return ix


def assert_finish_matches_per_element(ix, b, k, seed):
    """For no filter and a kind filter: topk_async, search_batch_async
    and a bare dispatch go out on one layout; rows the first queries
    would return are removed before any is fetched (live at dispatch,
    dead at the finish). The callables' (scores, ids) and hits must
    equal the per-element finish of the bare dispatch, bit for bit,
    with str ids and Python float scores."""
    co = ix._corpus
    q = unit_rows(b, 32, seed)
    q_np = normalize_rows(q)
    for flt in (VectorFilter(), VectorFilter(kinds=["k1"])):
        kinds = flt.kinds
        before = ix.search_batch(q[:3], 2, flt)
        dead = {hits[0][0] for hits in before if hits}
        legacy = co._dispatch(q_np, k, (kinds, None, []))
        topk = co.topk_async(q, k, kinds=kinds, exclude_ids=[])
        hits = ix.search_batch_async(q, k, flt)
        for nid in dead:
            assert ix.remove(nid)
        scores, ids = topk()
        got = hits()
        v, i, rescore, kk, gen, mu = legacy
        want_v, want_ids = per_element_finish_topk(
            co, v.cpu().numpy(), i.cpu().numpy(), k, kk, gen, q_np,
            rescore, mu, flt=(kinds, None, []))
        assert scores.dtype == want_v.dtype and scores.shape == (b, k)
        assert scores.tobytes() == want_v.tobytes()
        assert ids == want_ids
        want = per_element_hits(want_v, want_ids)
        assert got == want and _hits(scores, ids) == want
        assert all(type(nid) is str and type(s) is float
                   for row in got for nid, s in row)
        assert all(nid is None or type(nid) is str
                   for row in ids for nid in row)
        assert not dead & {nid for row in got for nid, _ in row}
        live = len(co._row_of) if kinds is None else sum(
            co._kind_h[r] == co.kinds.lookup("k1")
            for r in co._row_of.values())
        if k > live:               # the tail of every query is None
            assert all(row[-1] is None for row in ids)
            assert all(len(row) < k for row in got)


@pytest.mark.parametrize("k", [1, 10, 64, 128])
@pytest.mark.parametrize("b", [1, 7, 64, 256])
@pytest.mark.parametrize("kind", sorted(FINISH_KINDS))
def test_finish_builds_the_per_element_hits(kind, b, k):
    assert_finish_matches_per_element(finish_index(kind), b, k, seed=b + k)


@pytest.mark.parametrize("kind", sorted(FINISH_KINDS))
def test_finish_pads_past_the_capacity(kind):
    """k above the capacity: kk < k, and the tail is padded."""
    ix = finish_index(kind)
    k = ix._corpus._cap + 8
    assert ix._corpus._k_bucket(k)[0] < k
    assert_finish_matches_per_element(ix, 7, k, seed=3)
