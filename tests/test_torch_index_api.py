"""The port's index API against the reference's: `search`,
`search_batch`, `search_batch_async` and `search_stream` take the
reference's parameters (names, kinds, defaults; `refine` keyword-only,
default True), and `refine=False` gives the same hits as `refine=True` on
the flat and IVF indexes (neither has a kNN-graph refinement to skip).
"""

import inspect

import numpy as np
import pytest

from cortex_tpu.vector.index import TpuFlatIndex
from cortex_tpu.vector.index import VectorIndex as JaxVectorIndex
from cortex_tpu.vector.ivf import TpuIvfIndex
from cortex_tpu_torch.vector import TorchFlatIndex, VectorFilter
from cortex_tpu_torch.vector.index import VectorIndex
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


def index(kind):
    n, d = 300, 32
    ix = (TorchFlatIndex(d, search_path="quant", device="cpu")
          if kind == "flat" else
          TorchIvfIndex(d, nlist=8, nprobe=3, device="cpu"))
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
