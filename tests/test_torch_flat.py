"""The port's flat index (TorchFlatIndex on the CPU) and its default-config
Cortex against the JAX package's (TpuFlatIndex, cortex_tpu.Cortex on
JAX_PLATFORMS=cpu), on the same seeded inputs.

Both packages place the same ids on the same rows, quantize the same
int8 rows and re-rank exactly in fp32, so final hits are held rank by
rank: ids equal (a tie may swap), scores within 1e-5 for the index and
1e-4 for Cortex (decay factors are taken at each call's own clock).
Off the TPU the reference's `auto` serves through the exact product, as
the port's does off CUDA; `quant` runs the int8 scan (K1's plain
version) and the exact re-rank (K2's, or the host re-rank for bf16 and
quant-only residency).
"""

import copy

import numpy as np
import pytest

from cortex_tpu import Cortex as JaxCortex
from cortex_tpu.config import CortexConfig as JaxConfig
from cortex_tpu.storage import MemoryStorage
from cortex_tpu.vector import TpuFlatIndex
from cortex_tpu.vector import VectorFilter as JaxFilter
from cortex_tpu_torch import Cortex
from cortex_tpu_torch.config import CortexConfig
from cortex_tpu_torch.storage import MemoryStorage as TorchMemoryStorage
from cortex_tpu_torch.vector import TorchFlatIndex, VectorFilter
from test_torch_api import (SEARCHES, assert_same, port_nodes, queries,
                            seeded_nodes)

ATOL = 1e-5
PATHS = ["exact", "approx", "quant", "auto"]
DTYPES = ["float32", "bfloat16"]


def unit_rows(n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def meta_of(n):
    kinds = [f"kind{i % 20}" for i in range(n)]
    agents = [("alice", "bob", "carol")[i % 3] for i in range(n)]
    return kinds, agents


def make_pair(n, d, path="auto", dtype="float32", seed=0):
    """(reference index, port index) holding the same n seeded rows."""
    vecs = unit_rows(n, d, seed)
    ids = [f"n{i}" for i in range(n)]
    kinds, agents = meta_of(n)
    ref = TpuFlatIndex(d, search_path=path, storage_dtype=dtype)
    port = TorchFlatIndex(d, search_path=path, storage_dtype=dtype,
                          device="cpu")
    for ix in (ref, port):
        ix.insert_batch(ids, vecs, kinds=kinds, agents=agents)
    return ref, port, vecs


def assert_same_hits(want, got, atol=ATOL):
    """Per query: scores rank by rank, ids equal except where scores
    tie to within atol."""
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert len(w) == len(g)
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   atol=atol)
        for (wi, ws), (gi, _) in zip(w, g):
            if wi != gi:
                assert any(i == gi and abs(s - ws) <= atol for i, s in w)


def both(**kw):
    return JaxFilter(**kw), VectorFilter(**kw)


FILTERS = {
    "none": {},
    "kinds": {"kinds": ["kind1", "kind7", "kind12"]},
    "agent": {"source_agent": "bob"},
    "exclude": {"exclude_ids": [f"n{i}" for i in range(0, 600, 11)]},
    "exclude_overflow": {"exclude_ids": [f"n{i}" for i in range(0, 900, 9)]},
    "kinds_overflow": {"kinds": [f"kind{i}" for i in range(18)]},
}

_PAIRS = {}


def cached_pair(path, dtype):
    """5,000 rows of d = 64 (cap 8192: `approx` takes its own path at
    cap >= 4096), built once per (path, dtype) for this module."""
    key = (path, dtype)
    if key not in _PAIRS:
        _PAIRS[key] = make_pair(5000, 64, path, dtype)
    return _PAIRS[key]


@pytest.mark.parametrize("flt", list(FILTERS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("path", PATHS)
def test_search_parity(path, dtype, flt):
    ref, port, _ = cached_pair(path, dtype)
    q = unit_rows(6, 64, seed=99)
    f_ref, f_port = both(**FILTERS[flt])
    want = ref.search_batch(q, 10, f_ref)
    got = port.search_batch(q, 10, f_port)
    assert_same_hits(want, got)
    if "exclude_ids" in FILTERS[flt]:
        banned = set(FILTERS[flt]["exclude_ids"])
        assert not banned & {i for h in got for i, _ in h}


@pytest.mark.parametrize("path", PATHS)
def test_resolved_path_off_cuda(path):
    _, port, _ = cached_pair(path, "float32")
    info = port.index_info()
    assert info["kind"] == "flat" and info["size"] == 5000
    assert info["capacity"] == 8192 and info["search_path"] == path
    # off CUDA, auto serves through the exact product, as the reference
    # does off the TPU
    assert info["resolved_path"] == {"auto": "xla", "exact": "xla"}.get(
        path, path)


@pytest.mark.parametrize("d", [37, 384])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("path", ["exact", "quant", "auto"])
def test_removes_reinserts_and_growth(path, dtype, d):
    """Searches between removes, re-inserts with new vectors and growth
    past MIN_CAP (900 rows in a 1,024-row capacity, then 1,300)."""
    ref, port, vecs = make_pair(900, d, path, dtype, seed=d)
    q = unit_rows(5, d, seed=7)
    assert_same_hits(ref.search_batch(q, 10), port.search_batch(q, 10))
    gone = [f"n{i}" for i in range(0, 900, 17)]
    for ix in (ref, port):
        for i in gone:
            assert ix.remove(i)
    assert_same_hits(ref.search_batch(q, 10), port.search_batch(q, 10))
    fresh = unit_rows(400, d, seed=d + 1)
    ids = gone[:20] + [f"m{i}" for i in range(380)]
    for ix in (ref, port):
        ix.insert_batch(ids, fresh, kinds=["new"] * 400,
                        agents=["dave"] * 400)
    assert port._corpus._cap == 2048
    assert_same_hits(ref.search_batch(q, 10), port.search_batch(q, 10))
    f_ref, f_port = both(kinds=["new"])
    assert_same_hits(ref.search_batch(q, 10, f_ref),
                     port.search_batch(q, 10, f_port))
    assert port._corpus._row_of == ref._corpus._row_of
    hits = port.search_batch(fresh[:30], 1)
    assert [h[0][0] for h in hits] == ids[:30]


@pytest.mark.parametrize("dtype", DTYPES)
def test_quant_only_residency(monkeypatch, dtype):
    """A budget too small for the fp32 rows keeps only the int8 shadow
    and the masks on the device; the re-rank runs on the host mirror,
    through inserts after the first upload."""
    monkeypatch.setenv("CORTEX_HBM_BUDGET_GB", "0.00001")
    ref, port, _ = make_pair(400, 64, "quant", dtype, seed=3)
    q = unit_rows(4, 64, seed=21)
    assert_same_hits(ref.search_batch(q, 10), port.search_batch(q, 10))
    co = port._corpus
    assert co._emb_resident is False and co._dev[0] is None
    assert co._dev_q is not None
    assert port.index_info()["resolved_path"] == "quant"
    extra = unit_rows(20, 64, seed=33)
    for ix in (ref, port):
        ix.insert_batch([f"x{i}" for i in range(20)], extra)
    assert_same_hits(ref.search_batch(q, 10), port.search_batch(q, 10))


@pytest.mark.parametrize("path", ["quant", "exact"])
def test_search_stream_equals_search_batch(path):
    """The stream's chunks (8, 8 and 5 queries) and the one 21-query
    batch give the same ids; scores agree to ATOL, as the reference's
    contract test holds them (tests/test_vector.py): the CPU BLAS may
    block an fp32 product differently for 5 rows and for 21."""
    ref, port, _ = make_pair(600, 64, path, seed=5)
    q = unit_rows(21, 64, seed=13)
    f_ref, f_port = both(kinds=["kind3", "kind4"])
    stream = port.search_stream(q, 10, f_port, batch=8)
    batch = port.search_batch(q, 10, f_port)
    assert len(stream) == len(batch) == 21
    for s, b in zip(stream, batch):
        assert [i for i, _ in s] == [i for i, _ in b]
        np.testing.assert_allclose([v for _, v in s], [v for _, v in b],
                                   atol=ATOL)
    assert_same_hits(ref.search_stream(q, 10, f_ref, batch=8), stream)


def test_search_batch_async_and_threshold():
    ref, port, vecs = make_pair(300, 37, "quant", seed=8)
    done = port.search_batch_async(vecs[:4], 5)
    assert [h[0][0] for h in done()] == ["n0", "n1", "n2", "n3"]
    want = ref.search_threshold(vecs[9], 0.1, limit=50)
    got = port.search_threshold(vecs[9], 0.1, limit=50)
    assert got[0][0] == "n9" and all(s >= 0.1 for _, s in got)
    assert_same_hits([want], [got])


def test_load_jax_state():
    ref, _, _ = make_pair(700, 64, "quant", seed=11)
    ref.remove("n3")
    port = TorchFlatIndex(64, search_path="quant", device="cpu")
    port._corpus.load_jax_state(ref._corpus.state())
    assert len(port) == 699 and "n3" not in port
    # state() lists rows in row order, which a load assigns anew
    st, want = port._corpus.state(), ref._corpus.state()
    so, wo = np.argsort(st["ids"]), np.argsort(want["ids"])
    assert list(st["ids"][so]) == list(want["ids"][wo])
    # an insert normalizes its rows again: an ulp may move
    np.testing.assert_allclose(st["vectors"][so], want["vectors"][wo],
                               rtol=0, atol=1e-7)
    assert list(st["kinds"][so]) == list(want["kinds"][wo])
    assert list(st["agents"][so]) == list(want["agents"][wo])
    q = unit_rows(5, 64, seed=12)
    assert_same_hits(ref.search_batch(q, 10), port.search_batch(q, 10))


#: the resolver's cases: (kinds, agent, exclude_ids); "absent" and n5
#: (removed) are ids no row holds
RESOLVE_CASES = {
    "none": (None, None, None),
    "kinds": (["kind1", "kind7", "kind12"], None, None),
    "kinds_empty": ([], None, None),
    "kind_unknown": (["kind3", "nope"], None, None),
    "kinds_16": ([f"kind{i}" for i in range(16)], None, None),
    "kinds_17": ([f"kind{i}" for i in range(17)], None, None),
    "agent": (None, "bob", None),
    "agent_unknown": (None, "mallory", None),
    "exclude_absent_repeated": (None, None,
                                ["n3", "n3", "absent", "n5", "n40", "n3"]),
    "exclude_64": (None, None, [f"n{i}" for i in range(0, 320, 5)]),
    # 65 ids as given, 50 of them present: the count as given overflows
    "exclude_65": (None, None, [f"n{i}" for i in range(250, 315)]),
    "all": (["kind1", "kind2", "kind6"], "carol",
            ["n1", "n21", "n26", "absent"]),
}
OVERFLOWS = {"kinds_17", "exclude_65"}


def resolve_pair():
    """(reference corpus, port corpus) over one state: the reference
    inserts its rows in `ids` order, as the port's load_jax_state does,
    then both remove n5."""
    from cortex_tpu.vector.shard import DeviceCorpus as JaxCorpus
    from cortex_tpu_torch.vector.shard import DeviceCorpus
    n = 300
    kinds, agents = meta_of(n)
    st = {"ids": np.array([f"n{i}" for i in range(n)], dtype=object),
          "vectors": unit_rows(n, 16, seed=21),
          "kinds": np.array(kinds, dtype=object),
          "agents": np.array(agents, dtype=object)}
    ref = JaxCorpus(16)
    ref.upsert_batch(list(st["ids"]), st["vectors"], kinds, agents)
    port = DeviceCorpus(16, device="cpu")
    port.load_jax_state(st)
    assert ref.remove("n5") and port.remove("n5")
    assert port._id_of == ref._id_of
    return ref, port


def bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("case", list(RESOLVE_CASES))
def test_search_filter_equals_reference_codes_and_bias(case):
    """One resolve (DeviceCorpus._search_filter) gives the reference's
    _filter_codes lists, its overflow rule and, bit for bit, its exact
    _host_bias; the host predicate admits exactly the rows where that
    bias is 0."""
    from cortex_tpu_torch.vector.shard import NO_FILTER
    ref, port = resolve_pair()
    args = RESOLVE_CASES[case]
    ak, aa, ex, hb = ref._filter_codes(*args)
    flt = port._search_filter(*args)
    assert (hb is not None) == (case in OVERFLOWS)
    if hb is None:
        assert flt.host_bias is None
        for got, want in ((flt.ak, ak), (flt.aa, aa), (flt.ex, ex)):
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want)
        assert flt.filtered == bool(ak[0] != NO_FILTER or aa != NO_FILTER
                                    or ex[0] != NO_FILTER)
    else:
        assert flt.host_bias.dtype == np.float32
        np.testing.assert_array_equal(bits(flt.host_bias), bits(hb))
        assert (flt.ak == NO_FILTER).all() and flt.aa == NO_FILTER
        assert (flt.ex == NO_FILTER).all() and not flt.filtered
    want = np.asarray(ref._host_bias(*args))
    np.testing.assert_array_equal(bits(flt.exact_bias()), bits(want))
    np.testing.assert_array_equal(flt.admits(), want == 0)
    rows = np.random.default_rng(4).integers(0, port._cap, (3, 90))
    np.testing.assert_array_equal(flt.admits(rows), (want == 0)[rows])
    # the expansion's resolve: the same predicate, no [cap] bias built
    host = port._search_filter(*args, host_only=True)
    assert host.host_bias is None
    np.testing.assert_array_equal(host.admits(rows), (want == 0)[rows])


def test_empty_index_and_k_past_size():
    port = TorchFlatIndex(16, device="cpu")
    assert port.search_batch(unit_rows(2, 16, 1), 5) == [[], []]
    port.insert_batch(["a", "b"], unit_rows(2, 16, 2))
    hits = port.search_batch(unit_rows(1, 16, 3), 5)
    assert sorted(i for i, _ in hits[0]) == ["a", "b"]


# --------------------------------------------------------------- Cortex


class Pair:
    """Both engines with a default config (hash embedder at 384-d, as
    the default model has no local weights), on memory or SQLite."""

    def __init__(self, kind, tmp_path, **embedding):
        self.kind, self.tmp_path = kind, tmp_path
        self.jcfg, self.tcfg = JaxConfig(), CortexConfig()
        for cfg in (self.jcfg, self.tcfg):
            for key, v in embedding.items():
                setattr(cfg.embedding, key, v)
        self.mem = (MemoryStorage(), TorchMemoryStorage())
        self.open()

    def open(self):
        if self.kind == "memory":
            self.ref = JaxCortex(self.mem[0], self.jcfg)
            self.port = Cortex(self.mem[1], self.tcfg, device="cpu")
        else:
            self.ref = JaxCortex.open(str(self.tmp_path / "jax.db"),
                                      self.jcfg)
            self.port = Cortex.open(str(self.tmp_path / "torch.db"),
                                    self.tcfg, device="cpu")

    def reopen(self):
        self.close()
        self.open()

    def close(self):
        if self.kind == "sqlite":
            self.ref.close()
            self.port.close()

    def both(self, fn):
        return fn(self.ref, JaxFilter), fn(self.port, VectorFilter)


CORTEX_CASES = {"memory": ("memory", {}), "sqlite": ("sqlite", {}),
                "quant": ("memory", {"search_path": "quant"})}


@pytest.fixture(params=list(CORTEX_CASES))
def pair(request, tmp_path):
    kind, embedding = CORTEX_CASES[request.param]
    p = Pair(kind, tmp_path, **embedding)
    nodes = seeded_nodes(100)
    p.ref.store_batch(copy.deepcopy(nodes))
    p.port.store_batch(port_nodes(nodes))
    for node in seeded_nodes(3, seed=1):
        p.ref.store(copy.deepcopy(node))
        p.port.store(port_nodes([node])[0])
    p.nodes = nodes
    p.deleted = nodes[7].id
    assert p.ref.delete_node(p.deleted) and p.port.delete_node(p.deleted)
    yield p
    p.close()


def test_default_config_is_the_flat_index(pair):
    info = pair.port.index.index_info()
    assert info["kind"] == "flat" and info["size"] == 102
    want = "quant" if pair.tcfg.embedding.search_path == "quant" else "xla"
    assert info["resolved_path"] == want
    assert pair.port.embedder.dimension == 384


@pytest.mark.parametrize("how", list(SEARCHES))
def test_cortex_search_parity(pair, how):
    for q in queries(pair.nodes):
        want, got = pair.both(lambda cx, F: SEARCHES[how](cx, F, q))
        assert got
        assert_same(want, got)
        assert pair.deleted not in {n.id for _, n in got}


def test_cortex_host_bias_and_reopen(pair):
    excl = [n.id for n in pair.nodes[20:90]]             # > 64 ids
    q = queries(pair.nodes)[0]
    want, got = pair.both(lambda cx, F: cx.search(
        q, 10, flt=F(exclude_ids=excl), record_access=False))
    assert_same(want, got)
    assert not {n.id for _, n in got} & set(excl)
    before = [pair.port.search(q, 10, record_access=False)
              for q in queries(pair.nodes)]
    pair.reopen()
    assert len(pair.port.index) == len(pair.ref.index) == 102
    for q, old in zip(queries(pair.nodes), before):
        want, got = pair.both(lambda cx, F: cx.search(
            q, 10, record_access=False))
        assert_same(want, got)
        assert_same(old, got)
