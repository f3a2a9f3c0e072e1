"""The port's probed-block scan (cortex_tpu_torch/ops/ivf_gather.py)
against the JAX package.

On the CPU, `probed_scores` runs `probed_scores_plain`, the plain torch
version the CUDA kernel is held to on the card. Here it is held to:

  * the Pallas kernel (cortex_tpu/ops/ivf_gather.py, interpret mode):
    bit-equal scores on unmasked entries, equal rows and masks — both
    sum exact int8 products in f32 and multiply once by rinv;
  * the XLA formulation (_ivf_candidates + _ivf_bias): equal rows and
    masks, scores to rtol 1e-6 after the query descale — the XLA form
    multiplies by rinv/qs in one step, so its rounding differs by ulps;
  * the fused Pallas searches (filtered, unfiltered, hostbias): the
    port's ivf_search returns the same candidates and values.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cortex_tpu.ops import ivf_gather as jax_gather
from cortex_tpu.vector.ivf import (_ivf_bias, _ivf_candidates,
                                   _ivf_search_pallas,
                                   _ivf_search_pallas_hostbias)
from cortex_tpu_torch.ops import ivf_gather
from cortex_tpu_torch.vector.ivf import ivf_search

NO_FILTER, PAD_CODE = -1, -2
CASES = ["none", "kind", "agent", "excl", "all"]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jax_gather, "INTERPRET", True)
    yield
    jax_gather.probed_scores.clear_cache()
    _ivf_search_pallas.clear_cache()
    _ivf_search_pallas_hostbias.clear_cache()


def _layout(seed=0, c=16, l=24, d=64):
    rng = np.random.default_rng(seed)
    emb = rng.integers(-127, 128, (c, l, d)).astype(np.int8)
    sr = rng.permutation(c * l).astype(np.int32).reshape(c, l)
    sr[rng.random((c, l)) < 0.2] = -1            # empty slots
    emb[sr < 0] = 0
    kc = rng.integers(0, 5, (c, l)).astype(np.int32)
    ac = rng.integers(0, 3, (c, l)).astype(np.int32)
    kc[sr < 0] = PAD_CODE
    ac[sr < 0] = PAD_CODE
    ri = (rng.random((c, l)) * 0.01 + 0.001).astype(np.float32)
    return emb, ri, sr, kc, ac


def _meta(ri, sr, kc, ac):
    c, l = sr.shape
    meta = np.zeros((c, 8, l), np.float32)
    meta[:, 0], meta[:, 1], meta[:, 2], meta[:, 3] = sr, kc, ac, ri
    return meta


def _filters(case):
    ak = np.full(16, PAD_CODE, np.int32)
    if case in ("kind", "all"):
        ak[0], ak[1] = 1, 3
    else:
        ak[0] = NO_FILTER
    aa = np.array([1 if case in ("agent", "all") else NO_FILTER], np.int32)
    ex = np.full(64, NO_FILTER, np.int32)
    if case in ("excl", "all"):
        ex[:3] = [5, 9, 100]
    return ak, aa, ex


def _quantize(q):
    qs = (127.0 / np.maximum(np.abs(q).max(axis=1), 1e-12)
          ).astype(np.float32)
    return np.clip(np.round(q * qs[:, None]), -127, 127).astype(np.int8), qs


def _plain(emb, ri, sr, kc, ac, probe, qi8, ak, aa, ex, filtered):
    t = torch.from_numpy
    s, r = ivf_gather.probed_scores(
        t(emb), t(ri), t(sr), t(kc), t(ac), t(probe), t(qi8), t(ak),
        t(aa), t(ex), filtered=filtered)
    return s.numpy(), r.numpy()


# odd p / L / d next to the layout the JAX tests use
SHAPES = [(16, 24, 64, 5, 6), (11, 37, 100, 3, 3), (7, 13, 37, 4, 5)]


def _probes(pattern, rng, c, b, p):
    """[B, p] probe ids: random, or the patterns the CUDA kernel groups
    by list: every query probing the same lists, every pair on one list,
    lists probed twice in a row by the same query."""
    probe = rng.integers(0, c, (b, p)).astype(np.int32)
    if pattern == "same_lists":
        probe[:] = probe[0]
    elif pattern == "one_list":
        probe[:] = c - 1
    elif pattern == "repeats":
        probe[:, 1::2] = probe[:, 0::2][:, :p // 2]
    return probe


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("case", CASES)
def test_plain_bit_equal_to_pallas_kernel(case, shape, pattern="random"):
    c, l, d, b, p = shape
    emb, ri, sr, kc, ac = _layout(seed=c + d, c=c, l=l, d=d)
    rng = np.random.default_rng(1)
    probe = _probes(pattern, rng, c, b, p)
    qi8, _ = _quantize(rng.standard_normal((b, d)).astype(np.float32))
    ak, aa, ex = _filters(case)
    filtered = case != "none"
    got, rows = _plain(emb, ri, sr, kc, ac, probe, qi8, ak, aa, ex,
                       filtered)
    want, want_rows = jax_gather.probed_scores(
        jnp.asarray(emb), jnp.asarray(_meta(ri, sr, kc, ac)),
        jnp.asarray(probe), jnp.asarray(qi8), jnp.asarray(ak),
        jnp.asarray(aa), jnp.asarray(ex), filtered=filtered)
    want = np.asarray(want)[:, :p * l]        # drop the p -> 8k pad
    want_rows = np.asarray(want_rows)[:, :p * l]
    mask = want > -1e29
    assert mask.any() and (~mask).any()
    np.testing.assert_array_equal(got > -1e29, mask)
    np.testing.assert_array_equal(got[mask], want[mask])
    np.testing.assert_array_equal(rows[mask], want_rows[mask])


@pytest.mark.parametrize("pattern", ["same_lists", "one_list", "repeats"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("case", ["none", "all"])
def test_plain_bit_equal_to_pallas_kernel_skewed_probes(case, shape,
                                                        pattern):
    test_plain_bit_equal_to_pallas_kernel(case, shape, pattern)


def _unit_layout(seed, c, l, d):
    """_layout's planes with rows as an index holds them: unit Gaussian
    rows quantized per row (int8, max |x| at 127), rinv their scale."""
    emb, ri, sr, kc, ac = _layout(seed=seed, c=c, l=l, d=d)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((c * l, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q8, ri8 = _quantize(x)
    emb = q8.reshape(c, l, d)
    ri = (1.0 / ri8).astype(np.float32).reshape(c, l)
    emb[sr < 0] = 0
    return emb, ri, sr, kc, ac


@pytest.mark.parametrize("d", [1041, 1536])
@pytest.mark.parametrize("case", ["none", "all"])
def test_plain_past_f32_exact_dim(case, d):
    """Past d 1040 an f32 sum of int8 products is no longer exact. The
    plain version (and the kernel, held to it bit for bit on the card)
    sums exactly in int32 and rounds once; the reference's Pallas
    kernel sums in f32. Criterion against the reference: equal masks and
    rows, scores / qs (cosine units) within 1e-5. Against the exact sum:
    bit-equal, also for uniform int8 rows whose f32 sums round."""
    c, l, b, p = 6, 20, 4, 3
    emb, ri, sr, kc, ac = _unit_layout(d, c, l, d)
    rng = np.random.default_rng(d)
    probe = rng.integers(0, c, (b, p)).astype(np.int32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    qi8, qs = _quantize(q)
    ak, aa, ex = _filters(case)
    filtered = case != "none"
    got, rows = _plain(emb, ri, sr, kc, ac, probe, qi8, ak, aa, ex,
                       filtered)
    want, want_rows = jax_gather.probed_scores(
        jnp.asarray(emb), jnp.asarray(_meta(ri, sr, kc, ac)),
        jnp.asarray(probe), jnp.asarray(qi8), jnp.asarray(ak),
        jnp.asarray(aa), jnp.asarray(ex), filtered=filtered)
    want = np.asarray(want)[:, :p * l]
    want_rows = np.asarray(want_rows)[:, :p * l]
    mask = want > -1e29
    assert mask.any()
    np.testing.assert_array_equal(got > -1e29, mask)
    np.testing.assert_array_equal(rows[mask], want_rows[mask])
    scale = np.broadcast_to(qs[:, None], got.shape)[mask]
    np.testing.assert_allclose(got[mask] / scale, want[mask] / scale,
                               rtol=0, atol=1e-5)
    # rows of +-127 and queries matching a probed row's signs: sums past
    # 2^24, so f32 sums would round; the exact int64 sum, rounded to f32
    # once, times rinv
    emb_u = (rng.integers(0, 2, (c, l, d)) * 254 - 127).astype(np.int8)
    emb_u[sr < 0] = 0
    qi8_u = emb_u[probe[:, 0], 2].copy()
    got_u, _ = _plain(emb_u, ri, sr, kc, ac, probe, qi8_u, ak, aa, ex,
                      filtered)
    blk = emb_u[probe].reshape(b, p * l, d).astype(np.int64)
    exact = np.einsum("bkd,bd->bk", blk, qi8_u.astype(np.int64))
    assert np.abs(exact).max() > 2 ** 24
    want_u = exact.astype(np.float32) * ri[probe].reshape(b, p * l)
    np.testing.assert_array_equal(got_u[mask], want_u[mask])


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_xla_reference(case):
    emb, ri, sr, kc, ac = _layout()
    rng = np.random.default_rng(1)
    b, p = 5, 6
    probe = rng.integers(0, emb.shape[0], (b, p)).astype(np.int32)
    q = rng.standard_normal((b, emb.shape[2])).astype(np.float32)
    qi8, qs = _quantize(q)
    ak, aa, ex = _filters(case)
    s, sr2 = _ivf_candidates(jnp.asarray(emb), jnp.asarray(ri),
                             jnp.asarray(sr), jnp.asarray(probe),
                             jnp.asarray(q))
    kc2 = jnp.asarray(kc)[jnp.asarray(probe)].reshape(b, -1)
    ac2 = jnp.asarray(ac)[jnp.asarray(probe)].reshape(b, -1)
    want = np.asarray(s + _ivf_bias(sr2, kc2, ac2, jnp.asarray(ak),
                                    jnp.asarray(aa[0]), jnp.asarray(ex)))
    want_rows = np.asarray(sr2)
    got, rows = _plain(emb, ri, sr, kc, ac, probe, qi8, ak, aa, ex,
                       case != "none")
    mask = want > -1e29
    np.testing.assert_array_equal(got > -1e29, mask)
    np.testing.assert_allclose(got[mask] / np.broadcast_to(
        qs[:, None], got.shape)[mask], want[mask], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(rows[mask], want_rows[mask])


def test_plain_invalid_probe_scores_as_empty():
    """An id outside [0, C) scores its segment as empty (NEG_INF, row
    -1), as the CUDA kernel does; the other segments are unchanged."""
    emb, ri, sr, kc, ac = _layout()
    c, l = sr.shape
    rng = np.random.default_rng(4)
    probe = rng.integers(0, c, (4, 5)).astype(np.int32)
    qi8, _ = _quantize(rng.standard_normal((4, emb.shape[2])
                                           ).astype(np.float32))
    bad = probe.copy()
    bad[0, 1], bad[2, 3] = c, -1
    args = (emb, ri, sr, kc, ac)
    want, want_rows = _plain(*args, probe, qi8, *_filters("all"), True)
    got, rows = _plain(*args, bad, qi8, *_filters("all"), True)
    empty = np.zeros_like(got, dtype=bool)
    empty[0, l:2 * l] = empty[2, 3 * l:4 * l] = True
    assert (got[empty] <= -1e29).all() and (rows[empty] == -1).all()
    np.testing.assert_array_equal(got[~empty], want[~empty])
    np.testing.assert_array_equal(rows[~empty], want_rows[~empty])


def test_empty_batch():
    emb, ri, sr, kc, ac = _layout()
    ak, aa, ex = _filters("none")
    s, r = _plain(emb, ri, sr, kc, ac, np.zeros((0, 3), np.int32),
                  np.zeros((0, emb.shape[2]), np.int8), ak, aa, ex, False)
    assert s.shape == (0, 3 * emb.shape[1]) and r.shape == s.shape


def _search_args(seed=2, c=12, l=16, d=48, b=5):
    rng = np.random.default_rng(seed)
    emb, ri, sr, kc, ac = _layout(seed=seed, c=c, l=l, d=d)
    cent = rng.standard_normal((c, d)).astype(np.float32)
    cent /= np.linalg.norm(cent, axis=1, keepdims=True)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return cent, emb, ri, sr, kc, ac, q


def _assert_same(want_v, want_r, got_v, got_r):
    want_v, want_r = np.asarray(want_v), np.asarray(want_r)
    mask = want_v > -1e29
    np.testing.assert_array_equal(got_v > -1e29, mask)
    np.testing.assert_array_equal(got_v[mask], want_v[mask])
    np.testing.assert_array_equal(np.where(mask, got_r, 0),
                                  np.where(mask, want_r, 0))


@pytest.mark.parametrize("case", ["none", "all", "hostbias"])
def test_search_matches_jax_pallas_search(case):
    """Probe + scan + top-cand + descale + dedup, against the fused
    Pallas searches of cortex_tpu/vector/ivf.py."""
    cent, emb, ri, sr, kc, ac, q = _search_args()
    p, cand = 5, 10
    t = torch.from_numpy
    layout = tuple(t(a) for a in (cent, emb, ri, sr, kc, ac))
    meta = jnp.asarray(_meta(ri, sr, kc, ac))
    if case == "hostbias":
        cap = int(sr.max()) + 1
        bias = np.where(np.random.default_rng(3).random(cap) < 0.3,
                        -1e30, 0.0).astype(np.float32)
        want_v, want_r = _ivf_search_pallas_hostbias(
            jnp.asarray(cent), jnp.asarray(emb), meta, jnp.asarray(bias),
            jnp.asarray(q), p=p, cand=cand, dedup=True)
        ak, aa, ex = _filters("none")
        got_v, got_r = ivf_search(layout, t(q), t(ak), t(aa), t(ex), p=p,
                                  cand=cand, filtered=False, dedup=True,
                                  host_bias=t(bias))
    else:
        ak, aa, ex = _filters(case)
        want_v, want_r = _ivf_search_pallas(
            jnp.asarray(cent), jnp.asarray(emb), meta, ak, aa, ex,
            jnp.asarray(q), p=p, cand=cand, filtered=case != "none",
            dedup=True)
        got_v, got_r = ivf_search(layout, t(q), t(ak), t(aa), t(ex), p=p,
                                  cand=cand, filtered=case != "none",
                                  dedup=True)
    _assert_same(want_v, want_r, got_v.numpy(), got_r.numpy())


def test_cpu_tensors_never_count_kernel_launches():
    emb, ri, sr, kc, ac = _layout()
    ak, aa, ex = _filters("all")
    before = ivf_gather.probed_scores.launches
    _plain(emb, ri, sr, kc, ac, np.zeros((2, 3), np.int32),
           np.ones((2, emb.shape[2]), np.int8), ak, aa, ex, True)
    assert ivf_gather.probed_scores.launches == before
