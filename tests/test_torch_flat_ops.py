"""The port's flat-search ops (cortex_tpu_torch/ops/similarity.py and
vector/shard.py::build_bias) against their JAX twins, on the CPU.

The same seeded numpy inputs go through both packages; on the CPU the
port's kernel wrappers run their plain torch versions (the card tests
in test_torch_kernel_cuda.py hold the kernels to those). Tolerances:

  * the exact product and bias: scores within 1e-6, ids equal except
    at exact ties;
  * the int8 candidate scan against cosine_topk_quant: scores within
    1e-6 relative on every row both lists hold, and the final top-k
    equal (the reference's CPU candidate list is approx_max_k's per-bin
    maxima, so the lists are not held to each other);
  * the scan + exact re-rank against cosine_topk_quant_exact: final
    top-k ids equal except at near-ties of 1e-6, scores within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cortex_tpu.ops import similarity as jsim
from cortex_tpu.vector.shard import _build_bias
from cortex_tpu_torch.ops import similarity as tsim
from cortex_tpu_torch.vector.shard import (MAX_EXCLUDE, MAX_FILTER_KINDS,
                                           NO_FILTER, PAD_CODE, build_bias)

EXACT_ATOL = 1e-6
RERANK_ATOL = 1e-5
NEAR_TIE = 1e-6


def unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def masked_bias(n, kind):
    bias = np.zeros(n, np.float32)
    if kind == "half":
        bias[: n // 2] = -1e30
    elif kind == "odd":
        bias[::2] = -1e30
    return bias


def assert_topk_equal(tv, ti, jv, ji, atol, near=0.0):
    """Values within atol; an id may differ only where the reference's
    neighbouring values lie within `near` of each other."""
    jv, ji = np.asarray(jv), np.asarray(ji)
    np.testing.assert_allclose(tv, jv, atol=atol)
    for b in range(jv.shape[0]):
        for j in range(jv.shape[1]):
            if ti[b, j] != ji[b, j]:
                gaps = [abs(jv[b, j] - jv[b, t]) for t in (j - 1, j + 1)
                        if 0 <= t < jv.shape[1]]
                assert min(gaps) <= near, (b, j)


# ------------------------------------------------------------ exact path


@pytest.mark.parametrize("bias", ["none", "half"])
@pytest.mark.parametrize("n,d,b,k", [(300, 64, 5, 10), (130, 37, 3, 7),
                                     (2000, 384, 4, 16)])
def test_cosine_topk_xla_matches_jax(n, d, b, k, bias):
    rng = np.random.default_rng(n + d)
    corpus, q = unit(rng, n, d), unit(rng, b, d)
    bb = masked_bias(n, bias)
    jv, ji = jsim.cosine_topk_xla(jnp.asarray(corpus), jnp.asarray(q), k,
                                  jnp.asarray(bb)[None, :])
    tv, ti = tsim.cosine_topk_xla(torch.from_numpy(corpus),
                                  torch.from_numpy(q), k,
                                  torch.from_numpy(bb))
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    assert_topk_equal(tv.numpy(), ti.numpy(), jv, ji, EXACT_ATOL)
    if bias == "half":
        assert (ti.numpy() >= n // 2).all()


def test_self_similarity_is_one():
    rng = np.random.default_rng(1)
    corpus = torch.from_numpy(unit(rng, 20, 16))
    v, i = tsim.cosine_topk_xla(corpus, corpus, 1)
    np.testing.assert_allclose(v[:, 0].numpy(), 1.0, atol=1e-5)
    np.testing.assert_array_equal(i[:, 0].numpy(), np.arange(20))


def test_bf16_corpus_scores_accumulate_in_f32():
    """torch.matmul of two bf16 tensors returns bf16; the reference sums
    bf16 products into f32 (preferred_element_type). The port's scores
    are f32 and match the reference's to f32 rounding, far closer than
    a bf16 result could."""
    rng = np.random.default_rng(9)
    corpus, q = unit(rng, 512, 64), unit(rng, 4, 64)
    cb = torch.from_numpy(corpus).to(torch.bfloat16)
    qt = torch.from_numpy(q)
    s = tsim.cosine_scores(cb, qt)
    assert s.dtype == torch.float32
    want = np.asarray(jsim.cosine_scores(jnp.asarray(corpus, jnp.bfloat16),
                                         jnp.asarray(q, jnp.bfloat16)))
    assert want.dtype == np.float32
    np.testing.assert_allclose(s.numpy(), want, atol=EXACT_ATOL)
    plain_bf16 = (qt.to(torch.bfloat16) @ cb.T)
    assert plain_bf16.dtype == torch.bfloat16
    assert np.abs(plain_bf16.float().numpy() - want).max() > 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cosine_topk_approx_matches_jax(dtype):
    rng = np.random.default_rng(11)
    corpus, q = unit(rng, 2048, 64), unit(rng, 8, 64)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jv, ji = jsim.cosine_topk_approx(jnp.asarray(corpus, jdt),
                                     jnp.asarray(q), 10, over=256)
    tv, ti = tsim.cosine_topk_approx(torch.from_numpy(corpus).to(tdt),
                                     torch.from_numpy(q), 10)
    assert_topk_equal(tv.numpy(), ti.numpy(), jv, ji, EXACT_ATOL)


def test_cosine_topk_approx_respects_bias():
    rng = np.random.default_rng(12)
    corpus, q = unit(rng, 1024, 32), unit(rng, 2, 32)
    bias = torch.from_numpy(masked_bias(1024, "odd"))
    _, ti = tsim.cosine_topk_approx(torch.from_numpy(corpus),
                                    torch.from_numpy(q), 8, bias)
    assert (ti.numpy() % 2 == 1).all()


# ------------------------------------------------------- int8 scan (K1)


def test_quantize_queries_matches_jax_inline():
    rng = np.random.default_rng(4)
    q = unit(rng, 6, 37)
    qi8, qs = tsim.quantize_queries(torch.from_numpy(q))
    jq = jnp.asarray(q)
    jqs = 127.0 / jnp.maximum(jnp.max(jnp.abs(jq), axis=1), 1e-12)
    jqi8 = jnp.clip(jnp.round(jq * jqs[:, None]), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(qi8.numpy(), np.asarray(jqi8))
    # XLA on the CPU may divide through a reciprocal: one f32 ulp apart
    np.testing.assert_allclose(qs.numpy(), np.asarray(jqs), rtol=2.4e-7,
                               atol=0)


def quant_case(n, d, b, seed, centered=False):
    rng = np.random.default_rng(seed)
    corpus, q = unit(rng, n, d), unit(rng, b, d)
    if centered:
        i8, rinv, _ = tsim.quantize_rows_centered(corpus)
    else:
        i8, rinv = tsim.quantize_rows(corpus)
    return corpus, q, i8, rinv


@pytest.mark.parametrize("bias", ["none", "odd"])
@pytest.mark.parametrize("n,d,b,k", [(300, 64, 5, 10), (1024, 128, 3, 7),
                                     (130, 33, 1, 5), (3000, 384, 4, 16),
                                     (40, 37, 2, 50)])
def test_quant_candidates_matches_jax(n, d, b, k, bias):
    corpus, q, i8, rinv = quant_case(n, d, b, seed=42)
    bb = masked_bias(n, bias)
    cand = max(2 * k, k + 16, 32)
    jv, ji = jsim.cosine_topk_quant(jnp.asarray(i8), jnp.asarray(rinv),
                                    jnp.asarray(q), cand, jnp.asarray(bb))
    jv, ji = np.asarray(jv), np.asarray(ji)
    qi8, qs = tsim.quantize_queries(torch.from_numpy(q))
    before = tsim.quant_candidates.launches
    tv, ti = tsim.quant_candidates(torch.from_numpy(i8),
                                   torch.from_numpy(rinv), qi8, qs,
                                   torch.from_numpy(bb), cand)
    assert tsim.quant_candidates.launches == before    # plain on the CPU
    tv, ti = tv.numpy(), ti.numpy()
    assert tv.shape == (b, cand) and ti.dtype == np.int32
    xv, xi = jsim.cosine_topk_xla(jnp.asarray(corpus), jnp.asarray(q),
                                  min(k, n), jnp.asarray(bb)[None, :])
    for r in range(b):
        tmap = {int(i): float(v) for v, i in zip(tv[r], ti[r]) if v > -1e29}
        jmap = {int(i): float(v) for v, i in zip(jv[r], ji[r]) if v > -1e29}
        for row in tmap.keys() & jmap.keys():
            assert tmap[row] == pytest.approx(jmap[row], rel=1e-6, abs=0)
        live = {int(i) for i, v in zip(np.asarray(xi)[r],
                                       np.asarray(xv)[r]) if v > -1e29}
        assert live <= tmap.keys()           # the exact top-k survives
        if bias == "odd":
            assert all(row % 2 == 1 for row in tmap)
    if n < cand:                             # padded with (NEG_INF, 0)
        assert (tv[:, n:] <= -1e29).all() and (ti[:, n:] == 0).all()


def test_centered_quant_candidates_survive_anisotropy():
    """The reference's anisotropy case: every row is a shared component
    plus a small residual; the centered int8 scan keeps the true
    top-k."""
    rng = np.random.default_rng(21)
    d, n, b, k = 96, 4096, 8, 10
    common = unit(rng, 1, d)
    corpus = common + rng.standard_normal((n, d)).astype(np.float32) * .02
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    q = common + rng.standard_normal((b, d)).astype(np.float32) * .02
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    _, xi = tsim.cosine_topk_xla(torch.from_numpy(corpus),
                                 torch.from_numpy(q), k)
    i8, rinv, _ = tsim.quantize_rows_centered(corpus)
    qi8, qs = tsim.quantize_queries(torch.from_numpy(q))
    _, ti = tsim.quant_candidates(torch.from_numpy(i8),
                                  torch.from_numpy(rinv), qi8, qs,
                                  torch.zeros(n), max(2 * k, k + 16, 32))
    for r in range(b):
        assert set(xi[r].tolist()) <= set(ti[r].tolist())


def test_int8_dot_is_exact_on_cpu():
    rng = np.random.default_rng(2)
    qi8 = rng.integers(-127, 128, (3, 1536)).astype(np.int8)
    emb = rng.integers(-127, 128, (1000, 1536)).astype(np.int8)
    got = tsim.int8_dot(torch.from_numpy(qi8), torch.from_numpy(emb))
    want = qi8.astype(np.int64) @ emb.astype(np.int64).T
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


# ---------------------------------------------------- exact re-rank (K2)


@pytest.mark.parametrize("bias", ["none", "half"])
@pytest.mark.parametrize("n,d,b,k", [(600, 64, 5, 10), (3000, 384, 3, 16),
                                     (1500, 37, 4, 8), (50, 64, 2, 60)])
def test_cosine_topk_quant_exact_matches_jax(n, d, b, k, bias):
    corpus, q, i8, rinv = quant_case(n, d, b, seed=7, centered=True)
    bb = masked_bias(n, bias)
    cand = min(n, max(2 * k, k + 16, 64))
    jv, ji = jsim.cosine_topk_quant_exact(
        jnp.asarray(i8), jnp.asarray(rinv), jnp.asarray(corpus),
        jnp.asarray(q), k, cand, jnp.asarray(bb), over=512)
    before = tsim.quant_rerank.launches
    tv, ti = tsim.cosine_topk_quant_exact(
        torch.from_numpy(i8), torch.from_numpy(rinv),
        torch.from_numpy(corpus), torch.from_numpy(q), k, cand,
        torch.from_numpy(bb))
    assert tsim.quant_rerank.launches == before        # plain on the CPU
    assert tv.shape == (b, k) and ti.dtype == torch.int32
    jv, ji = np.asarray(jv), np.asarray(ji)
    live = jv > -1e29
    np.testing.assert_array_equal(tv.numpy() > -1e29, live)
    assert_topk_equal(np.where(live, tv.numpy(), 0), np.where(live,
                      ti.numpy(), 0), np.where(live, jv, 0),
                      np.where(live, ji, 0), RERANK_ATOL, NEAR_TIE)


def test_quant_rerank_plain_masks_invalid_and_pads():
    rng = np.random.default_rng(3)
    emb = torch.from_numpy(unit(rng, 40, 16))
    q = torch.from_numpy(unit(rng, 2, 16))
    ci = torch.arange(20, dtype=torch.int32).reshape(2, 10)
    cv = torch.zeros(2, 10)
    cv[:, 5:] = -1e30
    v, i = tsim.quant_rerank(emb, q, cv, ci, 12)
    assert v.shape == (2, 12)
    assert (v[:, :5] > -1e29).all() and (v[:, 5:] <= -1e29).all()
    assert set(i[0, :5].tolist()) == set(range(5))
    assert (i[:, 10:] == 0).all()
    want = (emb[ci[0, :5].long()] @ q[0]).sort(descending=True).values
    torch.testing.assert_close(v[0, :5], want)


# ------------------------------------------------------------- the bias


FILTERS = {
    "none": dict(),
    "kinds": dict(kinds=[1, 3]),
    "agent": dict(agent=2),
    "exclude": dict(exclude=[0, 5, 17, 99]),
    "all": dict(kinds=[0], agent=1, exclude=list(range(0, 200, 3))[:64]),
}


@pytest.mark.parametrize("case", list(FILTERS))
def test_build_bias_matches_jax(case):
    rng = np.random.default_rng(5)
    n = 300
    live = rng.random(n) < 0.8
    kind = np.where(live, rng.integers(0, 5, n), PAD_CODE).astype(np.int32)
    agent = np.where(live, rng.integers(0, 3, n), PAD_CODE).astype(np.int32)
    f = FILTERS[case]
    ak = np.full(MAX_FILTER_KINDS, PAD_CODE, np.int32)
    if "kinds" in f:
        ak[:len(f["kinds"])] = f["kinds"]
    else:
        ak[0] = NO_FILTER
    aa = np.int32(f.get("agent", NO_FILTER))
    ex = np.full(MAX_EXCLUDE, NO_FILTER, np.int32)
    ex[:len(f.get("exclude", []))] = f.get("exclude", [])
    want = np.asarray(_build_bias(jnp.asarray(live), jnp.asarray(kind),
                                  jnp.asarray(agent), jnp.asarray(ak),
                                  jnp.asarray(aa), jnp.asarray(ex)))
    got = build_bias(torch.from_numpy(live), torch.from_numpy(kind),
                     torch.from_numpy(agent), ak, aa, ex)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
