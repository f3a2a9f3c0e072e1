"""The CUDA kernels against their plain torch versions, on the card:
the IVF probed-block scan, the flat index's int8 candidate scan (K1)
and exact re-rank (K2), the graph mirror's frontier walk (G1) and
min-plus relaxation (G2), the edge decay sweep (D1), retention
eligibility (R1), and the text
encoder's residual + LayerNorm (E1) and masked attention (E2), with the
encoder's forward against the CPU's, and the IVF graph build's block
kernel (N1) with K1 at the nprobe tuner's shape; then the flat and IVF
snapshot round trips and Cortex.warmup on the card, and the mesh indexes
and the engine step on a virtual mesh of the card. Marked `cuda`:
skipped without a GPU.
This file imports no jax (the card's machine has none); run it there
with

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py

Criterion for the probed-block scan: scores and rows equal bit for bit
on unmasked entries, and equal masks (the kernel's int32 dot converts
to the same f32 value as the plain version's exact f32 sum, then the
same single * rinv). K1's and K2's criteria head their section below.
"""

import numpy as np
import pytest
import torch

from cortex_tpu_torch.models.encoder import (BertEncoder, BertEncoderConfig,
                                             bert_encode, init_params)
from cortex_tpu_torch.ops import decay, graph_bfs, ivf_gather, knn_graph
from cortex_tpu_torch.ops import encoder as enc
from cortex_tpu_torch.ops import similarity as sim
from cortex_tpu_torch.vector.shard import build_bias

pytestmark = pytest.mark.cuda

CASES = ["none", "kind", "agent", "excl", "all"]
# (C, L, d, B, p): odd shapes, d not a multiple of 4, the 384-d default
SHAPES = [(16, 37, 100, 5, 3), (12, 24, 37, 4, 5), (64, 96, 384, 8, 8),
          (8, 1, 3, 2, 8)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(dev, c, l, d, b, p, case, seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.integers(-127, 128, (c, l, d)).astype(np.int8)
    sr = rng.permutation(c * l).astype(np.int32).reshape(c, l)
    sr[rng.random((c, l)) < 0.2] = -1
    emb[sr < 0] = 0
    kc = rng.integers(0, 5, (c, l)).astype(np.int32)
    ac = rng.integers(0, 3, (c, l)).astype(np.int32)
    kc[sr < 0] = -2
    ac[sr < 0] = -2
    ri = (rng.random((c, l)) * 0.01 + 0.001).astype(np.float32)
    probe = rng.integers(0, c, (b, p)).astype(np.int32)
    qi8 = rng.integers(-127, 128, (b, d)).astype(np.int8)
    ak = np.full(16, -2, np.int32)
    ak[0] = -1
    aa = np.array([-1], np.int32)
    ex = np.full(64, -1, np.int32)
    if case in ("kind", "all"):
        ak[0], ak[1] = 1, 3
    if case in ("agent", "all"):
        aa[0] = 1
    if case in ("excl", "all"):
        live = sr[probe[0]].ravel()
        ex[:3] = live[live >= 0][:3]
    return [torch.from_numpy(a).to(dev)
            for a in (emb, ri, sr, kc, ac, probe, qi8, ak, aa, ex)]


def _assert_equal(a, b):
    (s1, r1), (s2, r2) = a, b
    m1, m2 = s1 > -1e29, s2 > -1e29
    assert torch.equal(m1, m2)
    assert torch.equal(s1[m1], s2[m2])
    assert torch.equal(r1[m1], r2[m2])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("case", CASES)
def test_kernel_equals_plain(dev, shape, case):
    args = _inputs(dev, *shape, case)
    filtered = case != "none"
    before = ivf_gather.probed_scores.launches
    got = ivf_gather.probed_scores(*args, filtered=filtered)
    torch.cuda.synchronize()
    assert ivf_gather.probed_scores.launches == before + 1
    _assert_equal(got, ivf_gather.probed_scores_plain(*args,
                                                      filtered=filtered))


def test_invalid_probe_scores_as_empty(dev):
    args = _inputs(dev, 8, 16, 64, 2, 3, "none")
    args[5][0, 1] = 99                        # out-of-range cluster
    s, r = ivf_gather.probed_scores(*args, filtered=False)
    torch.cuda.synchronize()
    assert (s[0, 16:32] <= -1e29).all() and (r[0, 16:32] == -1).all()
    _check_probed(args, filtered=False)


def _check_probed(args, filtered):
    """The kernel against the plain version, bit for bit, with the same
    empty slots (row -1: an empty slot, or an invalid probe id's
    segment)."""
    before = ivf_gather.probed_scores.launches
    s, r = ivf_gather.probed_scores(*args, filtered=filtered)
    torch.cuda.synchronize()
    assert ivf_gather.probed_scores.launches == before + 1
    ps, pr = ivf_gather.probed_scores_plain(*args, filtered=filtered)
    assert torch.equal(r == -1, pr == -1)
    _assert_equal((s, r), (ps, pr))


# The kernel groups the (query, probe) pairs by list, up to 64 queries a
# chunk: every query probing the same lists, 130 queries (1,040 pairs) on
# one list, a list probed twice by one query, and invalid ids
@pytest.mark.parametrize("pattern", ["same_lists", "one_list", "repeats",
                                     "invalid"])
def test_probed_scores_probe_patterns(dev, pattern):
    args = _inputs(dev, 32, 200, 768, 130, 8, "all", seed=7)
    probe = args[5]
    if pattern == "same_lists":
        probe[:] = probe[0].clone()
    elif pattern == "one_list":
        probe[:] = 5
    elif pattern == "repeats":
        probe[:, 1::2] = probe[:, ::2].clone()
    else:
        probe[::3, 2] = 32                    # == C
        probe[1::3, 4] = -1
    _check_probed(args, filtered=True)


@pytest.mark.parametrize("b", [1, 65, 130, 512])
def test_probed_scores_batches(dev, b):
    _check_probed(_inputs(dev, 64, 150, 768, b, 16, "all", seed=b),
                  filtered=True)


def test_probed_scores_batch_past_old_grid_limit(dev):
    # the batch has no grid dimension: 70,000 queries > 65,535
    _check_probed(_inputs(dev, 8, 4, 16, 70000, 2, "none", seed=3),
                  filtered=False)


@pytest.mark.parametrize("l", [1, 127, 128, 129, 1280])
def test_probed_scores_list_lengths(dev, l):
    _check_probed(_inputs(dev, 12, l, 384, 9, 5, "excl", seed=l),
                  filtered=True)


# d not a multiple of 16 (bytes assembled), 1040 (the last width whose
# f32 sums are exact: 9 slices, 64 queries a chunk in 72 KiB), 1536 and
# 4096 (the limit: 32 queries a chunk in 128 KiB of shared memory, so the
# batch of 64 makes two chunks a list)
@pytest.mark.parametrize("d", [37, 100, 384, 768, 1040, 1536, 4096])
def test_probed_scores_widths(dev, d):
    _check_probed(_inputs(dev, 10, 70, d, 64, 4, "kind", seed=d),
                  filtered=True)


@pytest.mark.parametrize("d", [1536, 4096])
def test_probed_scores_sums_past_f32_exact(dev, d):
    """Rows of +-127 and each query a probed row's copy: dots of d * 127^2
    > 2^24, which an f32 sum would round. Kernel and plain version both
    sum exactly and round once, so they stay bit-equal."""
    args = _inputs(dev, 10, 70, d, 40, 4, "none", seed=d + 1)
    emb = args[0]
    emb.copy_(torch.where(emb >= 0, 127, -127).to(torch.int8))
    emb[args[2] < 0] = 0
    probe = args[5]
    rows = torch.arange(40, device=dev) % 70
    args[6].copy_(emb[probe[:, 0].long(), rows])
    exact = (emb[probe[:, 0].long(), rows].long() ** 2).sum(1)
    assert int(exact.max()) > 2 ** 24
    _check_probed(args, filtered=False)


# the plan counts each list's probes in shared memory up to 32,768 lists,
# past that in its scratch buffer
@pytest.mark.parametrize("c", [32768, 32769, 100000])
def test_probed_scores_many_lists(dev, c):
    args = _inputs(dev, c, 3, 32, 70, 64, "excl", seed=c)
    args[5][0, :8] = c - 1                   # the last list, 8 times
    _check_probed(args, filtered=True)


@pytest.mark.parametrize("bad", ["dtype", "noncontig", "device", "shape",
                                 "dim"])
def test_argument_checks_raise(dev, bad):
    args = _inputs(dev, 8, 16, 4097 if bad == "dim" else 64, 2, 3, "none")
    if bad == "dtype":
        args[1] = args[1].double()
    elif bad == "noncontig":
        args[0] = args[0].transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "device":
        args[6] = args[6].cpu()
    elif bad == "shape":
        args[7] = args[7][:8]
    with pytest.raises(RuntimeError):
        ivf_gather.probed_scores(*args, filtered=False)


# ------------------------------------------------ flat kernels: K1, K2
#
# K1 (quant_candidates) against quant_candidates_plain: every returned
# row's score is bit-equal to the plain score of that row (the same
# int32 sum, rounded to f32 once, then the same division, multiply and
# add, each rounded once), the cand-th value is equal, and the row sets
# are equal except for exact ties at the boundary. K2 (quant_rerank)
# against quant_rerank_plain: scores within 1e-5 (f32 summation order),
# ids equal except at near-ties of 1e-6.

# (cap, d, B): odd d and cap, d % 4 != 0, 384 and 768, cap below cand
FLAT_SHAPES = [(3001, 37, 5), (5000, 384, 8), (8192, 768, 64),
               (100, 16, 1), (4100, 20, 3)]
BIAS_CASES = ["none", "filtered", "host"]
RERANK_ATOL = 1e-5
NEAR_TIE = 1e-6


def _flat_inputs(dev, cap, d, b, case, seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.integers(-127, 128, (cap, d)).astype(np.int8)
    rinv = (rng.random(cap) * 0.01 + 0.001).astype(np.float32)
    qi8 = rng.integers(-127, 128, (b, d)).astype(np.int8)
    qs = (127.0 / (rng.random(b) * 0.5 + 0.05)).astype(np.float32)
    t = [torch.from_numpy(a).to(dev) for a in (emb, rinv, qi8, qs)]
    if case == "none":
        bias = torch.zeros(cap, dtype=torch.float32, device=dev)
    elif case == "filtered":
        live = torch.from_numpy(rng.random(cap) < 0.9).to(dev)
        kinds = torch.from_numpy(rng.integers(0, 5, cap).astype(np.int32)
                                 ).to(dev)
        agents = torch.from_numpy(rng.integers(0, 3, cap).astype(np.int32)
                                  ).to(dev)
        ak = np.full(16, -2, np.int32)
        ak[:2] = (1, 3)
        ex = np.full(64, -1, np.int32)
        ex[:10] = np.arange(10)
        bias = build_bias(live, kinds, agents, ak, np.int32(1), ex)
    else:
        bias = torch.from_numpy(np.where(rng.random(cap) < 0.3, -1e30, 0.0)
                                .astype(np.float32)).to(dev)
    return (*t, bias)


def _plain_scores(emb, rinv, qi8, qs, bias):
    return sim.int8_dot(qi8, emb) * (rinv[None, :] / qs[:, None]) + bias


def _check_k1(args, cand):
    """K1 against its plain version on `args` (see the criteria above)."""
    b = args[2].shape[0]
    before = sim.quant_candidates.launches
    v, i = sim.quant_candidates(*args, cand)
    torch.cuda.synchronize()
    assert sim.quant_candidates.launches == before + 1
    pv, pi = sim.quant_candidates_plain(*args, cand)
    assert v.shape == pv.shape == (b, cand)
    assert i.dtype == pi.dtype == torch.int32
    full = _plain_scores(*args)
    kk = min(cand, args[0].shape[0])
    # every returned row's score is the plain score of that row, bit for bit
    assert torch.equal(v[:, :kk], torch.gather(full, 1, i[:, :kk].long()))
    assert torch.equal(v[:, kk - 1], pv[:, kk - 1])        # the cand-th value
    assert (v[:, kk:] <= -1e29).all() and (i[:, kk:] == 0).all()
    ih, ph = i[:, :kk].cpu().numpy(), pi[:, :kk].cpu().numpy()
    edge, fh = pv[:, kk - 1].cpu().numpy(), None
    for r in range(b):
        diff = set(ih[r].tolist()) ^ set(ph[r].tolist())
        if diff:
            fh = full.cpu().numpy() if fh is None else fh
            assert all(fh[r, x] == edge[r] for x in diff)
    assert all(len(set(row.tolist())) == kk for row in ih)  # no row twice


@pytest.mark.parametrize("cand", [64, 2048])
@pytest.mark.parametrize("case", BIAS_CASES)
@pytest.mark.parametrize("shape", FLAT_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_quant_candidates_equals_plain(dev, shape, case, cand):
    _check_k1(_flat_inputs(dev, *shape, case), cand)


# K1's query groups (64 a block), widths that shrink the group or move
# its candidate buffers to device memory, row counts at a tile's edge
# (128 rows), an all-masked bias and inputs full of exact ties
@pytest.mark.parametrize("cand", [1, 64, 2048])
@pytest.mark.parametrize("b", [1, 65, 130, 512])
def test_quant_candidates_batches(dev, b, cand):
    _check_k1(_flat_inputs(dev, 20000, 768, b, "filtered", seed=b), cand)


@pytest.mark.parametrize("cand", [1, 64, 2048])
@pytest.mark.parametrize("d", [37, 1536, 4096])
def test_quant_candidates_widths(dev, d, cand):
    _check_k1(_flat_inputs(dev, 4096, d, 40, "host", seed=d), cand)


@pytest.mark.parametrize("cand", [1, 64, 2048])
@pytest.mark.parametrize("cap", [127, 128, 129])
def test_quant_candidates_tile_edges(dev, cap, cand):
    _check_k1(_flat_inputs(dev, cap, 64, 5, "none", seed=cap), cand)


@pytest.mark.parametrize("cand", [1, 64, 2048])
def test_quant_candidates_all_masked(dev, cand):
    emb, rinv, qi8, qs, bias = _flat_inputs(dev, 5000, 384, 9, "none")
    _check_k1((emb, rinv, qi8, qs, torch.full_like(bias, -1e30)), cand)


@pytest.mark.parametrize("cand", [1, 64, 2048])
@pytest.mark.parametrize("b", [3, 64])
def test_quant_candidates_exact_ties(dev, b, cand):
    # 30 distinct rows repeated over 9,000, one rinv: every score is
    # shared by ~300 rows, so the boundary falls inside a tie
    emb, rinv, qi8, qs, bias = _flat_inputs(dev, 9000, 256, b, "none")
    emb = emb[:30].repeat(300, 1).contiguous()
    rinv = torch.full_like(rinv, 0.004)
    _check_k1((emb, rinv, qi8, qs, bias), cand)


def _rerank_inputs(dev, cap, d, b, cand, seed):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((cap, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    ci = rng.integers(0, cap, (b, cand)).astype(np.int32)
    cv = rng.standard_normal((b, cand)).astype(np.float32)
    cv[rng.random((b, cand)) < 0.2] = -1e30            # invalid candidates
    return [torch.from_numpy(a).to(dev) for a in (emb, q, cv, ci)]


def _check_k2(args, k):
    """K2 against its plain version: scores within RERANK_ATOL, ids equal
    but at near-ties; returns the kernel's (values, ids)."""
    b = args[1].shape[0]
    before = sim.quant_rerank.launches
    v, i = sim.quant_rerank(*args, k)
    torch.cuda.synchronize()
    assert sim.quant_rerank.launches == before + 1
    pv, pi = sim.quant_rerank_plain(*args, k)
    assert v.shape == (b, k) and i.dtype == torch.int32
    torch.testing.assert_close(v, pv, atol=RERANK_ATOL, rtol=0)
    vh, ih, ph = pv.cpu().numpy(), i.cpu().numpy(), pi.cpu().numpy()
    for r, j in zip(*np.nonzero(ih != ph)):
        near = [abs(vh[r, j] - vh[r, t]) for t in (j - 1, j + 1)
                if 0 <= t < k]
        assert min(near) <= NEAR_TIE
    return v, i


@pytest.mark.parametrize("k", [10, 16, 100])
@pytest.mark.parametrize("cand", [64, 2048])
@pytest.mark.parametrize("d", [37, 384, 768])
def test_quant_rerank_equals_plain(dev, d, cand, k):
    _check_k2(_rerank_inputs(dev, 6000, d, 9, cand, d + cand), k)


# each sort of K2 (a warp's registers up to 1,024 candidates, shared
# memory beyond), a cluster of fewer than 8 blocks (cand < 64), k above
# cand
@pytest.mark.parametrize("cand", [1, 63, 64, 65, 1024, 1025, 2048, 16384])
@pytest.mark.parametrize("b", [1, 64, 130])
def test_quant_rerank_sizes(dev, b, cand):
    args = _rerank_inputs(dev, 20000, 384, b, cand, b * cand)
    for k in (16, cand + 5):
        _check_k2(args, k)


@pytest.mark.parametrize("cand", [64, 1024, 2048])
def test_quant_rerank_exact_ties(dev, cand):
    # 16 distinct rows behind every id: scores tie exactly, and tied
    # candidates come out in candidate order
    rng = np.random.default_rng(cand)
    cap, d, b = 4 * cand, 128, 3
    base = rng.standard_normal((16, d)).astype(np.float32)
    emb = torch.from_numpy(base[np.arange(cap) % 16]).to(dev)
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)
                         ).to(dev)
    ci_h = np.stack([rng.permutation(cap)[:cand] for _ in range(b)]
                    ).astype(np.int32)
    ci = torch.from_numpy(ci_h).to(dev)
    cv = torch.zeros((b, cand), device=dev)
    k = min(cand, 100)
    v, i = _check_k2([emb, q, cv, ci], k)
    vh, ih = v.cpu().numpy(), i.cpu().numpy()
    for r in range(b):
        at = {int(x): j for j, x in enumerate(ci_h[r])}
        assert (np.diff(vh[r]) <= 0).all()
        for j in range(k - 1):
            if vh[r, j] == vh[r, j + 1]:
                assert at[int(ih[r, j])] < at[int(ih[r, j + 1])]


def test_quant_rerank_pads_past_cand(dev):
    emb = torch.randn(50, 16, device=dev)
    q = torch.randn(2, 16, device=dev)
    cv = torch.zeros(2, 8, device=dev)
    ci = torch.arange(16, dtype=torch.int32, device=dev).reshape(2, 8)
    v, i = sim.quant_rerank(emb, q, cv, ci, 12)
    assert (v[:, 8:] <= -1e29).all() and (i[:, 8:] == 0).all()
    assert (v[:, :8] > -1e29).all()


@pytest.mark.parametrize("b", [1, 17, 64])
@pytest.mark.parametrize("d", [37, 768])
def test_int8_dot_is_exact(dev, b, d):
    rng = np.random.default_rng(b * d)
    qi8 = rng.integers(-127, 128, (b, d)).astype(np.int8)
    emb = rng.integers(-127, 128, (4096, d)).astype(np.int8)
    want = qi8.astype(np.int64) @ emb.astype(np.int64).T
    got = sim.int8_dot(torch.from_numpy(qi8).to(dev),
                       torch.from_numpy(emb).to(dev))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.cpu().numpy().astype(np.int64), want)


@pytest.mark.parametrize("bad", ["dtype", "noncontig", "device", "shape",
                                 "cand", "dim", "batch"])
def test_quant_candidates_argument_checks_raise(dev, bad):
    emb, rinv, qi8, qs, bias = _flat_inputs(
        dev, 300, 4097 if bad == "dim" else 64, 2, "none")
    cand = 0 if bad == "cand" else 64
    if bad == "batch":                     # more query groups than grid.y
        qi8 = torch.zeros(65535 * 16 + 1, 64, dtype=torch.int8, device=dev)
        qs = torch.ones(qi8.shape[0], device=dev)
    if bad == "dtype":
        rinv = rinv.double()
    elif bad == "noncontig":
        emb = emb.t().contiguous().t()
    elif bad == "device":
        qi8 = qi8.cpu()
    elif bad == "shape":
        bias = bias[:100]
    with pytest.raises(RuntimeError):
        sim.quant_candidates(emb, rinv, qi8, qs, bias, cand)


@pytest.mark.parametrize("bad", ["dtype", "noncontig", "device", "shape",
                                 "cand", "k"])
def test_quant_rerank_argument_checks_raise(dev, bad):
    emb = torch.randn(100, 32, device=dev)
    q = torch.randn(3, 32, device=dev)
    cv = torch.zeros(3, 64, device=dev)
    ci = torch.zeros(3, 64, dtype=torch.int32, device=dev)
    k = 0 if bad == "k" else 10
    if bad == "dtype":
        emb = emb.half()
    elif bad == "noncontig":
        q = torch.randn(32, 3, device=dev).t()
    elif bad == "device":
        cv = cv.cpu()
    elif bad == "shape":
        ci = ci[:, :32]
    elif bad == "cand":
        cv = torch.zeros(3, 16385, device=dev)
        ci = torch.zeros(3, 16385, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError):
        sim.quant_rerank(emb, q, cv, ci, k)


# ------------------------------------------- G1 and G2: graph hop depths
#
# frontier_bfs (G1) against frontier_bfs_plain: the overflow flag always
# equal, and dist equal whenever it is false (after an overflow only the
# order of the truncated frontier differs, and every caller discards
# that dist). bfs_relax (G2) against bfs_relax_plain: equal int32 depths.
# The fused compact walk's criterion heads its own part below.


def _graph_table(dev, n, d, seed, pad=0.6, hubs=0.01):
    """[n, d] int32 table on the card: random rows, -1 anywhere, hub rows
    with every column set."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    nb = torch.randint(0, n, (n, d), dtype=torch.int32, device=dev,
                       generator=g)
    nb[torch.rand((n, d), device=dev, generator=g) < pad] = -1
    hub = torch.rand(n, device=dev, generator=g) < hubs
    nb[hub] = torch.randint(0, n, (int(hub.sum()), d), dtype=torch.int32,
                            device=dev, generator=g)
    return nb


def _anchors(dev, n, a, seed):
    """a anchors: duplicates and -1 pads among them (a >= 3)."""
    rng = np.random.default_rng(seed)
    out = rng.integers(0, n, a).astype(np.int32)
    if a >= 3:
        out[1] = out[0]
        out[-1] = -1
    return torch.from_numpy(out).to(dev)


def _check_walk(nb, anchors, hops, cap):
    before = graph_bfs.frontier_bfs.launches
    dist, over = graph_bfs.frontier_bfs(nb, anchors, hops, cap)
    torch.cuda.synchronize()
    assert graph_bfs.frontier_bfs.launches == before + 1
    pdist, pover = graph_bfs.frontier_bfs_plain(nb, anchors, hops, cap)
    assert bool(over) == bool(pover)
    if not bool(over):
        assert torch.equal(dist, pdist)
    return bool(over)


@pytest.mark.parametrize("n,d,a", [(1, 8, 1), (5, 8, 3), (1000, 16, 8),
                                   (100_000, 64, 8), (100_000, 8, 64),
                                   (10_000_000, 64, 8)])
def test_frontier_bfs_equals_plain(dev, n, d, a):
    nb = _graph_table(dev, n, d, seed=n + d)
    anchors = _anchors(dev, n, a, seed=a)
    seen = set()
    for cap in (1, 16, 256, 8192):
        if cap < a:
            continue
        for hops in (0, 1, 3, 8):
            seen.add(_check_walk(nb, anchors, hops, cap))
    if n >= 1000:
        assert seen == {False, True}


def test_frontier_bfs_isolated_and_padded_anchors(dev):
    nb = torch.full((1000, 64), -1, dtype=torch.int32, device=dev)
    nb[:10, :3] = torch.arange(10, 40, device=dev,
                               dtype=torch.int32).reshape(10, 3)
    for a in ([500], [-1, -1, -1], [], [3, 3, 500, -1]):
        anchors = torch.tensor(a, dtype=torch.int32, device=dev)
        for hops in (0, 2, 8):
            assert not _check_walk(nb, anchors, hops, 8)


@pytest.mark.parametrize("cap", [1, 2, 7, 64, 1000, 8192])
def test_frontier_bfs_caps(dev, cap):
    nb = _graph_table(dev, 50_000, 16, seed=cap, pad=0.5, hubs=0.0)
    _check_walk(nb, _anchors(dev, 50_000, 1, seed=cap), 6, cap)


def test_frontier_bfs_compact_equals_plain_set(dev):
    nb = _graph_table(dev, 1_000_000, 64, seed=3, pad=0.85, hubs=0.0)
    anchors = torch.tensor([17], dtype=torch.int32, device=dev)
    packed = graph_bfs.frontier_bfs_compact(nb, anchors, 3, 8192, 16384)
    rows, depth, count, over = graph_bfs.unpack_compact(packed.cpu())
    dist, pover = graph_bfs.frontier_bfs_plain(nb, anchors, 3, 8192)
    assert not over and not bool(pover)
    reached = torch.nonzero(dist <= 3).flatten()
    assert count == rows.numel() == reached.numel() < 16384
    got = sorted(zip(rows.tolist(), depth.tolist()))
    assert got == sorted(zip(reached.tolist(), dist[reached].tolist()))


# frontier_bfs_compact (the fused walk) against frontier_bfs_compact_plain:
# the overflow flag always equal; without an overflow the reached count
# equal, and the (row, depth) pairs equal as a set when they all fit the
# width (each kept pair a true one when they do not); rows listed once;
# the scratch all INF_DEPTH again after every call.


def _inf(dev, n):
    return torch.full((n,), graph_bfs.INF_DEPTH, dtype=torch.int32,
                      device=dev)


def _same_compact(packed, nb, anchors, hops, cap, out_cap):
    rows, dep, count, over = graph_bfs.unpack_compact(packed.cpu())
    want = graph_bfs.frontier_bfs_compact_plain(nb, anchors, hops, cap,
                                                out_cap).cpu()
    prows, pdep, pcount, pover = graph_bfs.unpack_compact(want)
    assert over == pover
    pairs = set(zip(rows.tolist(), dep.tolist()))
    assert len(pairs) == rows.numel() == min(count, out_cap)
    if not over:
        assert count == pcount
        if count <= out_cap:
            assert pairs == set(zip(prows.tolist(), pdep.tolist()))
        else:
            dist, _ = graph_bfs.frontier_bfs_plain(nb, anchors, hops, cap)
            dist = dist.cpu()
            assert all(int(dist[r]) == d for r, d in pairs)
    return over


def _check_compact(nb, anchors, hops, cap, out_cap, scratch=None):
    before = graph_bfs.frontier_bfs_compact.launches
    packed = graph_bfs.frontier_bfs_compact(nb, anchors, hops, cap, out_cap,
                                            scratch)
    torch.cuda.synchronize()
    assert graph_bfs.frontier_bfs_compact.launches == before + 1
    assert packed.shape == (2 + 2 * out_cap,)
    over = _same_compact(packed, nb, anchors, hops, cap, out_cap)
    if scratch is not None:
        assert torch.equal(scratch, _inf(nb.device, nb.shape[0]))
    return over


@pytest.mark.parametrize("n,d,a", [(1, 8, 1), (5, 3, 3), (1000, 16, 8),
                                   (100_000, 64, 8), (100_000, 8, 64),
                                   (1_000_000, 64, 1), (1_000_000, 5, 4)])
def test_frontier_bfs_compact_equals_plain(dev, n, d, a):
    nb = _graph_table(dev, n, d, seed=n + d + 1)
    anchors = _anchors(dev, n, a, seed=a + 1)
    scratch = _inf(dev, n)
    seen = set()
    for cap in (1, 16, 256, 8192):
        if cap < a:
            continue
        for hops in (0, 1, 3, 8):
            for out_cap in (1, 64, 16384):
                seen.add(_check_compact(nb, anchors, hops, cap, out_cap,
                                        scratch))
    if n >= 1000:
        assert seen == {False, True}


def test_frontier_bfs_compact_isolated_and_padded_anchors(dev):
    nb = torch.full((1000, 64), -1, dtype=torch.int32, device=dev)
    nb[:10, :3] = torch.arange(10, 40, device=dev,
                               dtype=torch.int32).reshape(10, 3)
    scratch = _inf(dev, 1000)
    for a in ([500], [-1, -1, -1], [], [3, 3, 500, -1]):
        anchors = torch.tensor(a, dtype=torch.int32, device=dev)
        for hops in (0, 2, 8):
            assert not _check_compact(nb, anchors, hops, 8, 16, scratch)
    # without a scratch the wrapper fills a fresh one
    assert not _check_compact(nb, torch.tensor([3], dtype=torch.int32,
                                               device=dev), 2, 8, 16)


def test_frontier_bfs_compact_back_to_back_on_one_scratch(dev):
    """50 walks from different anchors enqueued without a sync on one
    scratch: a row a walk failed to reset would show in a later walk."""
    n = 200_000
    nb = _graph_table(dev, n, 64, seed=9, pad=0.9, hubs=0.0)
    scratch = _inf(dev, n)
    rng = np.random.default_rng(9)
    calls = []
    for i in range(50):
        anchors = torch.from_numpy(rng.integers(
            0, n, 1 + i % 3).astype(np.int32)).to(dev)
        cap, out_cap = (8192, 16384) if i % 5 else (64, 256)
        calls.append((graph_bfs.frontier_bfs_compact(
            nb, anchors, 3, cap, out_cap, scratch), anchors, cap, out_cap))
    torch.cuda.synchronize()
    for packed, anchors, cap, out_cap in calls:
        _same_compact(packed, nb, anchors, 3, cap, out_cap)
    assert torch.equal(scratch, _inf(dev, n))


def test_walks_take_host_anchors(dev):
    """Anchors on the host (as the mirror passes them) give the results
    of the same anchors on the card; 50 compact walks enqueued from host
    anchors that go out of scope at once leave the scratch clean."""
    n = 200_000
    nb = _graph_table(dev, n, 64, seed=11, pad=0.9, hubs=0.0)
    scratch = _inf(dev, n)
    rng = np.random.default_rng(11)
    calls = []
    for i in range(50):
        rows = rng.integers(0, n, 1 + i % 3).astype(np.int32)
        before = graph_bfs.frontier_bfs_compact.launches
        calls.append((graph_bfs.frontier_bfs_compact(
            nb, torch.from_numpy(rows), 3, 8192, 16384, scratch), rows))
        assert graph_bfs.frontier_bfs_compact.launches == before + 1
    torch.cuda.synchronize()
    for packed, rows in calls:
        _same_compact(packed, nb, torch.from_numpy(rows).to(dev), 3, 8192,
                      16384)
    assert torch.equal(scratch, _inf(dev, n))
    anchors = torch.from_numpy(rng.integers(0, n, 4).astype(np.int32))
    got = graph_bfs.frontier_bfs(nb, anchors, 3, 8192)
    want = graph_bfs.frontier_bfs(nb, anchors.to(dev), 3, 8192)
    assert torch.equal(got[0], want[0]) and bool(got[1]) == bool(want[1])
    with pytest.raises(ValueError):
        graph_bfs.frontier_bfs_compact(
            nb, torch.tensor([n], dtype=torch.int32), 3, 8192, 16, scratch)


def test_frontier_bfs_compact_two_threads_one_scratch(dev):
    import threading
    n = 200_000
    nb = _graph_table(dev, n, 64, seed=10, pad=0.9, hubs=0.0)
    scratch = _inf(dev, n)
    results, errors = {}, []

    def walk(t):
        try:
            rng = np.random.default_rng(t)
            for i in range(20):
                anchors = torch.from_numpy(rng.integers(
                    0, n, 2).astype(np.int32)).to(dev)
                results[(t, i)] = (graph_bfs.frontier_bfs_compact(
                    nb, anchors, 3, 8192, 16384, scratch), anchors)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=walk, args=(t,)) for t in (1, 2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    assert not errors and len(results) == 40
    for packed, anchors in results.values():
        _same_compact(packed, nb, anchors, 3, 8192, 16384)
    assert torch.equal(scratch, _inf(dev, n))


def test_frontier_bfs_compact_overflow_then_normal(dev):
    """A walk that overflows (and fills its width, so it refills the
    whole scratch), then a normal one on the same scratch."""
    n = 100_000
    nb = _graph_table(dev, n, 64, seed=12, pad=0.5, hubs=0.0)
    scratch = _inf(dev, n)
    anchors = torch.tensor([5], dtype=torch.int32, device=dev)
    assert _check_compact(nb, anchors, 4, 2, 8, scratch)
    sparse = _graph_table(dev, n, 64, seed=13, pad=0.95, hubs=0.0)
    assert not _check_compact(sparse, anchors, 3, 8192, 16384, scratch)


@pytest.mark.parametrize("bad", ["scratch_dtype", "scratch_shape",
                                 "scratch_device", "out_cap", "cpu_op"])
def test_frontier_bfs_compact_argument_checks_raise(dev, bad):
    nb = _graph_table(dev, 100, 8, seed=1)
    anchors = torch.tensor([1, 2], dtype=torch.int32, device=dev)
    scratch, out_cap = _inf(dev, 100), 16
    if bad == "scratch_dtype":
        scratch = scratch.long()
    elif bad == "scratch_shape":
        scratch = scratch[:50]
    elif bad == "scratch_device":
        scratch = scratch.cpu()
    elif bad == "out_cap":
        out_cap = 0
    if bad == "cpu_op":
        with pytest.raises((RuntimeError, NotImplementedError)):
            graph_bfs.load_ops().frontier_bfs_compact(
                nb.cpu(), anchors.cpu(), 3, 16, 16, scratch.cpu())
        return
    with pytest.raises((RuntimeError, ValueError)):
        graph_bfs.frontier_bfs_compact(nb, anchors, 3, 16, out_cap, scratch)


def _check_relax(nb, dist0, hops):
    before = graph_bfs.bfs_relax.launches
    got = graph_bfs.bfs_relax(nb, dist0, hops)
    torch.cuda.synchronize()
    assert graph_bfs.bfs_relax.launches == before + 1
    assert torch.equal(got, graph_bfs.bfs_relax_plain(nb, dist0, hops))


def _sources(dev, a, n, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    dist0 = torch.full((a, n), graph_bfs.INF_DEPTH, dtype=torch.int32,
                       device=dev)
    rows = torch.randint(0, n, (a, 3), device=dev, generator=g)
    dist0.scatter_(1, rows, 0)
    return dist0


@pytest.mark.parametrize("n,d,a", [(1, 8, 1), (7, 3, 2), (1000, 16, 5),
                                   (1000, 8, 64), (100_000, 64, 8),
                                   (10_000_000, 64, 1),
                                   (10_000_000, 64, 8)])
def test_bfs_relax_equals_plain(dev, n, d, a):
    nb = _graph_table(dev, n, d, seed=n * 7 + d, pad=0.8)
    dist0 = _sources(dev, a, n, seed=a)
    for hops in ((-1, 0, 1, 2, 3, 8, 9) if n < 10_000_000 else (3, 8)):
        _check_relax(nb, dist0, hops)


@pytest.mark.parametrize("a", [1, 3, 8, 9, 17])
@pytest.mark.parametrize("layout", ["aligned64", "unaligned16", "odd5"])
def test_bfs_relax_anchor_tiles(dev, a, layout):
    """Anchor counts around the 8-wide anchor-minor tiles, on rows that
    take int4 loads, rows that are not 16-byte aligned and an odd width."""
    n, d = 50_000, {"aligned64": 64, "unaligned16": 16, "odd5": 5}[layout]
    nb = _graph_table(dev, n, d, seed=a + d, pad=0.7)
    if layout == "unaligned16":
        flat = torch.empty(n * d + 1, dtype=torch.int32, device=dev)
        flat[1:].copy_(nb.reshape(-1))
        nb = flat[1:].view(n, d)
    dist0 = _sources(dev, a, n, seed=a)
    for hops in (1, 3, 8):
        _check_relax(nb, dist0, hops)


def test_bfs_relax_past_2_31_depths(dev):
    """513 anchors over 4,194,304 rows (A x N > 2^31): runs in chunks of
    anchors (a launch each); anchors 0, 256 and 512 equal the plain
    relaxation run on those anchors alone."""
    n, a = 4_194_304, 513
    assert a * n > 2 ** 31
    nb = _graph_table(dev, n, 16, seed=21, pad=0.8, hubs=0.0)
    dist0 = torch.full((a, n), graph_bfs.INF_DEPTH, dtype=torch.int32,
                       device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(21)
    src = torch.randint(0, n, (a,), device=dev, generator=g)
    dist0[torch.arange(a, device=dev), src] = 0
    before = graph_bfs.bfs_relax.launches
    got = graph_bfs.bfs_relax(nb, dist0, 3)
    torch.cuda.synchronize()
    step = graph_bfs.RELAX_MAX_ENTRIES // n
    assert graph_bfs.bfs_relax.launches == before + -(-a // step)
    cols = [0, 256, 512]
    del dist0
    alone = torch.full((3, n), graph_bfs.INF_DEPTH, dtype=torch.int32,
                       device=dev)
    alone[torch.arange(3, device=dev), src[cols]] = 0
    assert torch.equal(got[cols], graph_bfs.bfs_relax_plain(nb, alone, 3))


def test_bfs_relax_unaligned_rows(dev):
    """A table whose rows are not 16-byte aligned takes the scalar loads."""
    flat = torch.empty(1000 * 16 + 1, dtype=torch.int32, device=dev)
    nb = flat[1:].view(1000, 16)
    nb.copy_(_graph_table(dev, 1000, 16, seed=5))
    _check_relax(nb, _sources(dev, 3, 1000, seed=5), 4)


@pytest.mark.parametrize("bad", ["dtype", "noncontig", "device", "hops",
                                 "anchor", "cap", "cpu_op"])
def test_frontier_bfs_argument_checks_raise(dev, bad):
    nb = _graph_table(dev, 100, 8, seed=1)
    anchors = torch.tensor([1, 2], dtype=torch.int32, device=dev)
    hops, cap = 3, 16
    if bad == "dtype":
        nb = nb.long()
    elif bad == "noncontig":
        nb = nb.t().contiguous().t()
    elif bad == "device":             # neither the host nor the table's
        anchors = anchors.to("meta")
    elif bad == "hops":
        hops = 9
    elif bad == "anchor":
        anchors[1] = 100
    elif bad == "cap":
        cap = 1
    if bad == "cpu_op":
        with pytest.raises((RuntimeError, NotImplementedError)):
            graph_bfs.load_ops().frontier_bfs(nb.cpu(), anchors.cpu(), 3,
                                              16)
        return
    with pytest.raises((RuntimeError, ValueError)):
        graph_bfs.frontier_bfs(nb, anchors, hops, cap)


@pytest.mark.parametrize("bad", ["dtype", "noncontig", "device", "shape",
                                 "cpu_op"])
def test_bfs_relax_argument_checks_raise(dev, bad):
    nb = _graph_table(dev, 100, 8, seed=1)
    dist0 = _sources(dev, 2, 100, seed=1)
    if bad == "dtype":
        dist0 = dist0.long()
    elif bad == "noncontig":
        dist0 = dist0.t().contiguous().t()
    elif bad == "device":
        dist0 = dist0.cpu()
    elif bad == "shape":
        dist0 = dist0[:, :50].contiguous()
    if bad == "cpu_op":
        with pytest.raises((RuntimeError, NotImplementedError)):
            graph_bfs.load_ops().bfs_relax(nb.cpu(), dist0.cpu(), 3)
        return
    with pytest.raises((RuntimeError, ValueError)):
        graph_bfs.bfs_relax(nb, dist0, 3)


# ------------------------------------------- the linker's K1 / K2 shapes
#
# The auto-linker's candidate search (k = candidate_k 100: k bucket 128,
# cand 256, chunks of 128 queries) and dedup's (256 queries at k 64:
# cand 128), at the 768-d width, against the plain versions.


@pytest.mark.parametrize("b,cand,k", [(128, 256, 128), (256, 128, 64)],
                         ids=["linker", "dedup"])
@pytest.mark.parametrize("case", BIAS_CASES)
def test_linker_shapes_equal_plain(dev, b, cand, k, case):
    args = _flat_inputs(dev, 50000, 768, b, case, seed=b + cand)
    _check_k1(args, cand)
    cv, ci = sim.quant_candidates(*args, cand)
    emb = torch.nn.functional.normalize(
        torch.randn(args[0].shape, device=dev,
                    generator=torch.Generator(dev).manual_seed(cand)), dim=1)
    q = torch.nn.functional.normalize(
        torch.randn((b, 768), device=dev,
                    generator=torch.Generator(dev).manual_seed(b)), dim=1)
    _check_k2((emb, q, cv, ci), k)


# ------------------------------------------------------- D1: the sweep
#
# Criterion: new_w and the three masks bit-equal to decay_sweep_plain on
# the same card. The kernel spells the plain version's operations with
# __fmul_rn / __fsub_rn (no FMA contraction) and calls expf, as torch's
# elementwise exp does on the card.

DECAY_ARGS = dict(daily_rate=0.01, shield=0.8, delete_threshold=0.05,
                  prune_threshold=0.1)


def _decay_inputs(dev, n, seed):
    """Seeded edges with days <= 0, exempt rows, importance * shield = 1
    (importance 1.25 at shield 0.8), rows exactly on each threshold and
    rows decayed to just around them."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.0, 1.0, n).astype(np.float32)
    days = rng.uniform(-5.0, 400.0, n).astype(np.float32)
    imp = rng.uniform(0.0, 1.0, n).astype(np.float32)
    exempt = rng.random(n) < 0.1
    days[::97] = 0.0
    imp[3::13] = 1.25
    for j, thr in enumerate((0.05, 0.1)):
        w[j::11] = np.float32(thr)
        days[j::11] = 1e-6
    w[5::17] = np.float32(0.05) * (1 + rng.uniform(-1e-5, 1e-5,
                                                   len(w[5::17])))
    days[5::17] = rng.uniform(0.0, 0.01, len(days[5::17]))
    return [torch.from_numpy(a).to(dev) for a in (w, days, imp, exempt)]


def _check_d1(args):
    before = decay.decay_sweep.launches
    got = decay.decay_sweep(*args, **DECAY_ARGS)
    torch.cuda.synchronize()
    assert decay.decay_sweep.launches == before + 1
    want = decay.decay_sweep_plain(*args, *(
        float(np.float32(v)) for v in DECAY_ARGS.values()))
    assert [t.dtype for t in got] == [torch.float32] + [torch.bool] * 3
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)
    return got


@pytest.mark.parametrize("n", [1, 31, 65537, 1000003])
def test_decay_sweep_equals_plain(dev, n):
    got = _check_d1(_decay_inputs(dev, n, seed=n))
    if n > 1000:
        assert got[1].any() and got[2].any() and got[3].any()


def test_decay_sweep_unaligned(dev):
    # offset views: the 16-byte loads give way to the scalar path
    args = _decay_inputs(dev, 4099, seed=1)
    _check_d1([t[1:] for t in args])
    _check_d1([t[3:4000] for t in args])


def test_decay_sweep_empty(dev):
    got = decay.decay_sweep(*[t[:0] for t in _decay_inputs(dev, 8, 0)],
                            **DECAY_ARGS)
    assert all(t.numel() == 0 for t in got)


@pytest.mark.parametrize("bad", ["dtype", "length", "device"])
def test_decay_sweep_argument_checks(dev, bad):
    w, days, imp, exempt = _decay_inputs(dev, 64, 2)
    if bad == "dtype":
        exempt = exempt.to(torch.uint8)
    elif bad == "length":
        days = days[:-1]
    else:
        imp = imp.cpu()
    with pytest.raises(ValueError):
        decay.decay_sweep(w, days, imp, exempt, **DECAY_ARGS)


# ------------------------------------------- R1: retention eligibility
#
# Criterion: the mask bit-equal to retention_eligibility_plain on the same
# card. The kernel spells the plain version's float32 subtract and
# multiply by float32(1 / 86400) with __fsub_rn / __fmul_rn, then the
# same comparisons.

R1_NOW = 1.76e9
R1_DAY = 86400.0


def _r1_inputs(dev, n, seed, per_node=False):
    """Seeded nodes with rows exactly on the TTL, grace and score
    boundaries; the parameters one value each, or one a node (ttl 0 and
    min_score < 0 on some rows)."""
    rng = np.random.default_rng(seed)
    now = np.float32(R1_NOW)
    created = (now - rng.uniform(0, 80, n) * R1_DAY).astype(np.float32)
    last = (now - rng.uniform(0, 40, n) * R1_DAY).astype(np.float32)
    score = rng.uniform(0, 1, n).astype(np.float32)
    inbound = rng.random(n) < 0.3
    created[::7] = now - np.float32(30 * R1_DAY)
    last[::5] = now - np.float32(10 * R1_DAY)
    score[::3] = np.float32(0.4)
    nodes = [torch.from_numpy(a).to(dev)
             for a in (created, last, score, inbound)]
    if not per_node:
        return nodes, [float(now), 30.0, 10.0, 0.4, True]
    params = [np.full(n, now, np.float32),
              rng.choice(np.array([0, 20, 30], np.float32), n),
              rng.choice(np.array([0, 10], np.float32), n),
              rng.choice(np.array([-1, 0.2, 0.4], np.float32), n),
              rng.random(n) < 0.5]
    return nodes, [torch.from_numpy(a).to(dev) for a in params]


def _check_r1(nodes, params):
    before = decay.retention_eligibility.launches
    got = decay.retention_eligibility(*nodes, *params)
    torch.cuda.synchronize()
    assert decay.retention_eligibility.launches == before + 1
    want = decay.retention_eligibility_plain(
        *decay._retention_args(*nodes, *params))
    assert got.dtype == torch.bool and got.shape == want.shape
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("n", [1, 3, 31, 65537, 1000003])
@pytest.mark.parametrize("per_node", [False, True])
def test_retention_eligibility_equals_plain(dev, n, per_node):
    got = _check_r1(*_r1_inputs(dev, n, seed=n, per_node=per_node))
    if n > 1000:
        assert 0 < int(got.sum()) < n


def test_retention_eligibility_unaligned(dev):
    nodes, params = _r1_inputs(dev, 4099, seed=1, per_node=True)
    _check_r1([t[1:] for t in nodes], [t[1:] for t in params])
    _check_r1([t[3:4000] for t in nodes], [t[3:4000] for t in params])
    scalar = _r1_inputs(dev, 4099, seed=2)
    _check_r1([t[1:] for t in scalar[0]], scalar[1])


def test_retention_eligibility_mixed_params(dev):
    nodes, per = _r1_inputs(dev, 10007, seed=3, per_node=True)
    _, one = _r1_inputs(dev, 10007, seed=3)
    for k in range(5):
        _check_r1(nodes, [per[j] if j == k else one[j] for j in range(5)])


def test_retention_eligibility_empty(dev):
    nodes, params = _r1_inputs(dev, 0, seed=0)
    got = decay.retention_eligibility(*nodes, *params)
    assert got.shape == (0,) and got.dtype == torch.bool


@pytest.mark.parametrize("bad", ["length", "device", "shape"])
def test_retention_eligibility_argument_checks(dev, bad):
    nodes, params = _r1_inputs(dev, 64, seed=2)
    if bad == "length":
        nodes[1] = nodes[1][:-1]
    elif bad == "device":
        nodes[2] = nodes[2].cpu()
    else:
        params[1] = torch.zeros(1, device=dev)
    with pytest.raises(ValueError):
        decay.retention_eligibility(*nodes, *params)


# ------------------------------------------------------------ encoder
# E1 (add_layer_norm) and E2 (masked_attention) against their plain
# versions. E1: within LN_ATOL (the mean's and variance's sums are added
# in another order; outputs are ~N(0, 1) * g + b). E2: within ATTN_ATOL
# (3xTF32 products and an online softmax with exp2 against torch's fp32
# einsums and softmax; outputs are averages of N(0, 1) values); an
# unmasked row's output is bit-equal whatever the masked keys hold. With
# |q| and |k| 10x larger (scores of std ~100) the plain fp32 version is
# itself ~1e-4 from the float64 answer; there E2 may be no further from
# that answer than the plain version plus ATTN_ATOL.

LN_ATOL = 1e-5
ATTN_ATOL = 1e-5
ENCODER_ATOL = 1e-4      # the forward against the CPU's, BGE-small width


def _ln_inputs(dev, t, h, p, seed):
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(0.5, 3.0, (t, h)), rng.normal(0.0, 1.0, (p, h)),
              rng.normal(1.0, 0.1, h), rng.normal(0.0, 0.1, h))
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrays]


def _check_e1(x, r, g, b, eps=1e-12):
    before = enc.add_layer_norm.launches
    got = enc.add_layer_norm(x, r, g, b, eps)
    torch.cuda.synchronize()
    assert enc.add_layer_norm.launches == before + 1
    want = enc.add_layer_norm_plain(x, r, g, b, eps)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= LN_ATOL
    return got


@pytest.mark.parametrize("t,h,p", [(1, 384, 1), (31, 384, 31),
                                   (8192, 384, 8192), (8192, 384, 512),
                                   (1000, 768, 1000), (7, 36, 7),
                                   (5, 1024, 5), (3, 4, 3), (65, 100, 13)])
def test_add_layer_norm_equals_plain(dev, t, h, p):
    _check_e1(*_ln_inputs(dev, t, h, p, seed=t + h))


def test_add_layer_norm_unaligned_rows(dev):
    # x one float off 16 bytes: the wrapper hands the kernel an aligned
    # copy, so the result is the aligned call's, bit for bit
    x, r, g, b = _ln_inputs(dev, 65, 384, 65, seed=3)
    buf = torch.empty(65 * 384 + 1, device=dev)
    xs = buf[1:].view(65, 384)
    xs.copy_(x)
    assert torch.equal(_check_e1(xs, r, g, b), _check_e1(x, r, g, b))


@pytest.mark.parametrize("eps", [1e-12, 1e-5])
def test_add_layer_norm_constant_rows(dev, eps):
    x, r, g, b = _ln_inputs(dev, 16, 384, 16, seed=4)
    x[:] = 2.5
    r[:] = 0.0
    _check_e1(x, r, g, b, eps)


def test_add_layer_norm_limits(dev):
    x, r, g, b = _ln_inputs(dev, 4, 1025, 4, seed=5)
    with pytest.raises(ValueError, match="h <= 1024"):
        enc.add_layer_norm(x, r, g, b, 1e-12)
    x, r, g, b = _ln_inputs(dev, 4, 37, 4, seed=5)
    with pytest.raises(ValueError, match="h % 4 == 0"):
        enc.add_layer_norm(x, r, g, b, 1e-12)
    x, r, g, b = _ln_inputs(dev, 6, 64, 4, seed=5)
    with pytest.raises(ValueError, match="divide"):
        enc.add_layer_norm(x, r, g, b, 1e-12)
    with pytest.raises(ValueError, match="float32"):
        enc.add_layer_norm(x.double(), r[:3].double(), g, b, 1e-12)


# E1's launch shape: blocks of 1, 2, then 4 warps, switching at 2 and 4 x
# the SM count; a row a warp while the card holds every warp at once
# (up to 132 SMs x 16 blocks x 4 warps), then rows strided over a capped
# grid (E1 up to 8 rounds, then a row a warp again; the embedding form
# at any T). T on both sides of the block switches, and in each form at
# every width (20,480 rows: strided; 102,400: past 8 rounds)
LN_WIDTHS = (4, 36, 384, 768, 1024)
LN_POINTS = ("one", "below_2x", "at_2x", "below_4x", "at_4x", "strided",
             "past_strided")


def _ln_rows(point):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"one": 1, "below_2x": 2 * sms - 1, "at_2x": 2 * sms,
            "below_4x": 4 * sms - 1, "at_4x": 4 * sms,
            "strided": 40 * 512, "past_strided": 200 * 512}[point]


@pytest.mark.parametrize("point", LN_POINTS)
@pytest.mark.parametrize("h", LN_WIDTHS)
def test_add_layer_norm_launch_shapes(dev, h, point):
    t = _ln_rows(point)
    _check_e1(*_ln_inputs(dev, t, h, t, seed=t + h))
    if t % 512 == 0:                        # an [S, h] residual
        _check_e1(*_ln_inputs(dev, t, h, 512, seed=h))


def _embed_inputs(dev, b, s, h, vocab, positions, dtype, seed):
    """ids [b, s] (0, vocab - 1 and ids past both ends among them),
    word [vocab, h], pos [positions, h], type row, gain and bias."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s))
    flat = ids.reshape(-1)
    flat[:6] = [0, vocab - 1, vocab, vocab + 7, -1, -vocab - 2][:flat.size]
    tables = (rng.normal(0.0, 0.5, (vocab, h)),
              rng.normal(0.0, 0.5, (positions, h)),
              rng.normal(0.0, 0.5, h), rng.normal(1.0, 0.1, h),
              rng.normal(0.0, 0.1, h))
    return [torch.from_numpy(ids.astype(dtype)).to(dev)] + [
        torch.from_numpy(a.astype(np.float32)).to(dev) for a in tables]


def _check_embed(args, eps=1e-12):
    before = enc.embed_layer_norm.launches
    got = enc.embed_layer_norm(*args, eps)
    torch.cuda.synchronize()
    assert enc.embed_layer_norm.launches == before + 1
    want = enc.embed_layer_norm_plain(*args, eps)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= LN_ATOL
    return got


@pytest.mark.parametrize("point", LN_POINTS)
@pytest.mark.parametrize("h", LN_WIDTHS)
def test_embed_layer_norm_equals_plain(dev, h, point):
    t = _ln_rows(point)
    s = 512 if t % 512 == 0 else t          # B 40 or 200 at S 512, else B 1
    _check_embed(_embed_inputs(dev, t // s, s, h, 1000, 512, np.int32,
                               seed=t + h))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("b,s,positions", [(3, 31, 512), (2, 100, 64),
                                           (64, 128, 512), (1, 1, 1)])
def test_embed_layer_norm_ids_and_positions(dev, dtype, b, s, positions):
    # BGE-small's vocabulary; P 64 < S 100: positions past P clamp
    _check_embed(_embed_inputs(dev, b, s, 384, 30522, positions, dtype,
                               seed=b * s))


def test_embed_layer_norm_limits(dev):
    ids, word, pos, typ, g, b = _embed_inputs(dev, 2, 8, 36, 50, 16,
                                              np.int32, seed=1)
    with pytest.raises(ValueError, match="h % 4 == 0"):
        enc.embed_layer_norm(ids, word[:, :35], pos[:, :35], typ[:35],
                             g[:35], b[:35], 1e-12)
    with pytest.raises(ValueError, match="int32 or int64"):
        enc.embed_layer_norm(ids.float(), word, pos, typ, g, b, 1e-12)
    with pytest.raises(ValueError, match="float32"):
        enc.embed_layer_norm(ids, word.double(), pos, typ, g, b, 1e-12)
    with pytest.raises(ValueError, match="type_row"):
        enc.embed_layer_norm(ids, word, pos, typ[:4], g, b, 1e-12)
    with pytest.raises(ValueError, match="is on"):
        enc.embed_layer_norm(ids, word.cpu(), pos, typ, g, b, 1e-12)
    wide = _embed_inputs(dev, 1, 4, 1028, 10, 4, np.int32, seed=2)
    with pytest.raises(ValueError, match="h <= 1024"):
        enc.embed_layer_norm(*wide, 1e-12)


def _kept_patterns(b, s):
    """[b, s] bool: row i keeps the keys of pattern i % 9: all; the first
    64, 65, 128 or 129 (ending on and one past E2's tile edges, 32 keys
    a tile); all but the first third; all but the keys from S / 4 to
    S / 2; keys 0-63 and 128 onwards, with 64-127 (two tiles) wholly
    masked; only the last key."""
    kept = np.zeros((b, s), bool)
    for i in range(b):
        p, row = i % 9, kept[i]
        if p == 0:
            row[:] = True
        elif p in (1, 2, 3, 4):
            row[:(64, 65, 128, 129)[p - 1]] = True
        elif p == 5:
            row[s // 3:] = True
        elif p == 6:
            row[:max(1, s // 4)] = True
            row[s // 2:] = True
        elif p == 7:
            row[:64] = True
            row[128:] = True
        else:
            row[s - 1] = True
    return kept


def _attn_inputs(dev, b, h, s, dh, seed, mask="tail", scale=1.0):
    """q, k, v [B, H, S, dh] as views of one [B, S, 3, H, dh] buffer (the
    encoder's Q|K|V product; q and k times `scale`), a mask bias and its
    kept keys [B, S] (numpy bool). mask "tail": the first row keeps all
    S keys and the others their first 1..S; "patterns": _kept_patterns."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(0.0, 1.0, (b, s, 3, h, dh)).astype(
        np.float32)).to(dev)
    if mask == "tail":
        lengths = rng.integers(1, s + 1, b)
        lengths[0] = s
        kept = np.arange(s)[None, :] < lengths[:, None]
    else:
        kept = _kept_patterns(b, s)
    bias = np.where(kept, 0.0, -1e30)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    if scale != 1.0:
        q, k = q * scale, k * scale
    return q, k, v, torch.from_numpy(bias.astype(np.float32)).to(dev), kept


def _check_e2(q, k, v, bias, scale=1.0):
    before = enc.masked_attention.launches
    got = enc.masked_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert enc.masked_attention.launches == before + 1
    want = enc.masked_attention_plain(q, k, v, bias)
    assert got.shape == want.shape and got.dtype == torch.float32
    if scale == 1.0:
        assert float((got - want).abs().max()) <= ATTN_ATOL
    else:
        exact = enc.masked_attention_plain(
            *(t.double() for t in (q, k, v, bias)))
        plain_err = float((want.double() - exact).abs().max())
        assert float((got.double() - exact).abs().max()) <= (
            plain_err + ATTN_ATOL)
    return got


@pytest.mark.parametrize("b,h,s,dh,mask,scale", [
    (1, 12, 1, 32, "tail", 1.0), (2, 12, 31, 32, "tail", 1.0),
    (4, 12, 128, 32, "tail", 1.0), (2, 12, 512, 32, "tail", 1.0),
    (3, 2, 31, 64, "tail", 1.0), (2, 12, 512, 64, "tail", 1.0),
    (5, 3, 77, 64, "tail", 1.0), (64, 12, 128, 32, "tail", 1.0),
    # about the tile edges (32 keys a tile)
    (4, 12, 63, 32, "tail", 1.0), (4, 12, 64, 32, "tail", 1.0),
    (4, 12, 65, 64, "tail", 1.0), (4, 12, 127, 32, "tail", 1.0),
    (4, 12, 129, 64, "tail", 1.0),
    # masks that are not a tail: tile edges, front, middle, a masked
    # tile between kept ones, only the last key
    (9, 4, 31, 32, "patterns", 1.0), (9, 4, 129, 32, "patterns", 1.0),
    (9, 4, 200, 64, "patterns", 1.0), (9, 12, 512, 32, "patterns", 1.0),
    (18, 3, 512, 64, "patterns", 1.0),
    # dh 64 at S 512, B * H 3,072
    (256, 12, 512, 64, "tail", 1.0),
    # |q| and |k| 10x: held to the float64 answer
    (4, 12, 128, 32, "tail", 10.0), (9, 12, 512, 64, "patterns", 10.0),
    (9, 4, 200, 32, "patterns", 10.0)])
def test_masked_attention_equals_plain(dev, b, h, s, dh, mask, scale):
    q, k, v, bias, _ = _attn_inputs(dev, b, h, s, dh, seed=b * s + dh,
                                    mask=mask, scale=scale)
    got = _check_e2(q, k, v, bias, scale)
    # written as [B, S, H, dh]: back to [B * S, H * dh] without a copy
    assert got.transpose(1, 2).is_contiguous()
    # strided views and contiguous copies give the same bits
    assert torch.equal(got, enc.masked_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), bias))


@pytest.mark.parametrize("b,s,dh,mask", [
    (4, 31, 32, "tail"), (4, 128, 32, "tail"), (4, 512, 32, "tail"),
    (4, 200, 64, "tail"), (4, 65, 32, "tail"), (9, 129, 32, "patterns"),
    (9, 200, 64, "patterns"), (9, 512, 32, "patterns")])
def test_masked_attention_padding_invariance(dev, b, s, dh, mask):
    q, k, v, bias, kept = _attn_inputs(dev, b, 12, s, dh, seed=s,
                                       mask=mask)
    got = enc.masked_attention(q, k, v, bias)
    masked = bias < -1e29                              # [B, S] keys
    q2, k2, v2 = (t.clone() for t in (q, k, v))
    for t in (q2, k2, v2):
        noise = torch.randn_like(t) * 7.0
        t.copy_(torch.where(masked[:, None, :, None], noise, t))
    again = enc.masked_attention(q2, k2, v2, bias)
    torch.cuda.synchronize()
    for row in range(b):
        rows = torch.from_numpy(np.flatnonzero(kept[row])).to(dev)
        assert torch.equal(got[row][:, rows], again[row][:, rows])


@pytest.mark.parametrize("s", [40, 200])
def test_masked_attention_every_key_masked(dev, s):
    # the reference's softmax over equal scores: the mean of v (the
    # kernel walks every key tile of such a row, with its real values)
    q, k, v, bias, _ = _attn_inputs(dev, 3, 4, s, 32, seed=9)
    bias[1] = -1e30
    got = _check_e2(q, k, v, bias)
    want = v[1].mean(dim=1, keepdim=True).expand_as(got[1])
    assert float((got[1] - want).abs().max()) <= ATTN_ATOL


def test_masked_attention_limits(dev):
    for s, dh in ((16, 16), (16, 128), (513, 32)):
        q, k, v, bias, _ = _attn_inputs(dev, 1, 2, s, dh, seed=1)
        with pytest.raises(ValueError, match="dh in"):
            enc.masked_attention(q, k, v, bias)
    q, k, v, bias, _ = _attn_inputs(dev, 1, 2, 8, 32, seed=1)
    with pytest.raises(ValueError, match="float32"):
        enc.masked_attention(q.double(), k.double(), v.double(), bias)
    with pytest.raises(ValueError, match="mask_bias"):
        enc.masked_attention(q, k, v, bias[:, :4])


def _texts_ids(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)
    lengths = rng.integers(2, s + 1, b)
    lengths[0] = s
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    return ids * mask, mask


@pytest.mark.parametrize("cfg", [
    BertEncoderConfig(vocab_size=500, hidden=64, layers=2, heads=2,
                      intermediate=128, max_position=128),
    BertEncoderConfig(vocab_size=500, hidden=128, layers=2, heads=2,
                      intermediate=256, max_position=128, pooling="mean"),
    BertEncoderConfig()], ids=["h64", "h128-mean", "bge-small"])
def test_encoder_forward_equals_cpu(dev, cfg):
    params = init_params(cfg, seed=5)
    ids, mask = _texts_ids(cfg, 6, 45, seed=6)
    card = BertEncoder.from_params(params, cfg, device=dev)
    cpu = BertEncoder.from_params(params, cfg, device="cpu")
    e1, e2 = enc.add_layer_norm.launches, enc.masked_attention.launches
    emb = enc.embed_layer_norm.launches
    got = bert_encode(card, ids, mask)
    # each layer's two E1s, and the embedding's gather, sums and
    # LayerNorm in one launch of E1's embedding form
    assert enc.add_layer_norm.launches - e1 == 2 * cfg.layers
    assert enc.embed_layer_norm.launches - emb == 1
    assert enc.masked_attention.launches - e2 == cfg.layers
    want = bert_encode(cpu, ids, mask)
    assert float(np.abs(got - want).max()) <= ENCODER_ATOL
    # a row alone equals it inside the padded batch
    alone = bert_encode(card, ids[3:4, :mask[3].sum()],
                        mask[3:4, :mask[3].sum()])
    assert float(np.abs(alone[0] - got[3]).max()) <= ENCODER_ATOL


# ------------------------------------------------------------------ N1
# block_knn against block_knn_plain, bit for bit: the int8 self-product
# is exact in both (int32 on the tensor cores; an f32 product with TF32
# off, exact for d <= 1040), the descale runs in the same order with
# single roundings, and both order by (score desc, slot asc).


def _knn_inputs(dev, ch, l, d, seed=0, dead=0.2, dup=False):
    rng = np.random.default_rng(seed)
    emb = rng.integers(-127, 128, (ch, l, d)).astype(np.int8)
    sr = rng.permutation(ch * l).astype(np.int32).reshape(ch, l)
    sr[rng.random((ch, l)) < dead] = -1
    if ch > 1:
        sr[-1, 3:] = -1                   # a cluster with 3 live slots
    if dup:
        emb[:, 1::2] = emb[:, 0::2][:, :l // 2]   # exact score ties
    emb[sr < 0] = 0
    ri = (rng.random((ch, l)) * 0.01 + 0.001).astype(np.float32)
    if dup:
        ri[:, 1::2] = ri[:, 0::2][:, :l // 2]
    ri[sr < 0] = 0.0
    t = [torch.from_numpy(a).to(dev) for a in (emb, ri, sr)]
    mu = torch.from_numpy(rng.normal(size=d).astype(np.float32) * 0.01)
    return (*t, knn_graph.slot_mu_dot(t[0], t[1], mu.to(dev)))


def _check_knn(args, r):
    before = knn_graph.block_knn.launches
    got = knn_graph.block_knn(*args, r)
    torch.cuda.synchronize()
    assert knn_graph.block_knn.launches == before + 1
    want = knn_graph.block_knn_plain(*args, r)
    assert got.dtype == want.dtype == torch.int32
    assert got.shape == want.shape == (args[0].shape[0], args[0].shape[1], r)
    assert torch.equal(got, want)


# (ch, L, d, r): odd L and d (the byte-assembled stages), r past a
# cluster's live count, L not a multiple of the 64-row or 128-slot tile,
# phase 4's 384-d layout, the 1M layout's 1,280 x 768 at r 32 and L - 1,
# d 1040 (a partial last K slice), the 10M auto layout's L 4,096 at d 768
# at r 32 and the largest degree, 1,024, L 4,001 (not a multiple of 16),
# and past the old shared-memory strip's limit (L 6,224 at d 768): L
# 8,192 at r 32 (lists in shared memory), 1,024 and L - 1 (lists in the
# device scratch)
KNN_SHAPES = [(3, 37, 100, 12), (2, 13, 37, 12), (4, 65, 16, 64),
              (3, 100, 128, 32), (4, 192, 384, 32), (2, 1280, 768, 32),
              (2, 1280, 768, 1279), (2, 2000, 384, 32), (2, 200, 1040, 40),
              (1, 2, 8, 1), (2, 4096, 768, 32), (1, 4096, 768, 1024),
              (1, 4001, 100, 33), (1, 8192, 768, 32), (1, 8192, 768, 1024),
              (1, 8192, 768, 8191)]


@pytest.mark.parametrize("shape", KNN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_block_knn_equals_plain(dev, shape):
    ch, l, d, r = shape
    _check_knn(_knn_inputs(dev, ch, l, d), r)


@pytest.mark.parametrize("r", [1, 8, 31])
def test_block_knn_exact_ties_go_to_the_lower_slot(dev, r):
    _check_knn(_knn_inputs(dev, 3, 64, 96, seed=3, dup=True), r)


def test_block_knn_every_slot_dead(dev):
    args = _knn_inputs(dev, 2, 40, 64, dead=1.0)
    _check_knn(args, 16)
    assert (knn_graph.block_knn(*args, 16) == -1).all()


def test_block_knn_chunk_views(dev):
    """A chunk sliced from a larger layout (as build_knn_graph passes it)
    gives the same lists as the chunk alone."""
    emb, ri, sr, mud = _knn_inputs(dev, 6, 96, 128, seed=4)
    whole = knn_graph.block_knn(emb, ri, sr, mud, 24)
    part = knn_graph.block_knn(emb[2:5], ri[2:5], sr[2:5], mud[2:5], 24)
    torch.cuda.synchronize()
    assert torch.equal(part, whole[2:5])


@pytest.mark.parametrize("bad", ["r_zero", "r_past", "dtype", "shape"])
def test_block_knn_limits_raise_value_error(dev, bad):
    """Outside its limits the kernel refuses with ValueError: r in
    [1, L - 1], planes of the right type and shape. L itself has no
    limit (test_block_knn_takes_any_l)."""
    emb, ri, sr, mud = _knn_inputs(dev, 1, 64, 32)
    r = 8
    if bad == "r_zero":
        r = 0
    elif bad == "r_past":
        r = 64
    elif bad == "dtype":
        ri = ri.double()
    else:
        mud = mud[:, :10].contiguous()
    with pytest.raises(ValueError):
        knn_graph.block_knn(emb, ri, sr, mud, r)


def test_block_knn_takes_any_l(dev):
    """L 8,192 at d 768, which the shared-memory score strip of the first
    design refused with ValueError, runs and equals plain: two lists, so
    that a block's running lists are reused across clusters."""
    _check_knn(_knn_inputs(dev, 2, 8192, 768, seed=5), 32)


def test_ivf_index_at_d_1536_stores_and_searches(dev):
    """IVF past d 1040 on the card (before, the scan refused the width at
    the first search): the index builds (its kNN graph through N1), each
    stored row finds itself first at nprobe = nlist, and the search went
    through the scan kernel."""
    from cortex_tpu_torch.vector.ivf import TorchIvfIndex
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2000, 1536)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    ids = [f"n{i}" for i in range(len(x))]
    idx = TorchIvfIndex(1536, nlist=16, nprobe=16, device=dev)
    idx.insert_batch(ids, x)
    before = ivf_gather.probed_scores.launches
    got = idx.search_batch(x[:64], 5)
    assert ivf_gather.probed_scores.launches > before
    assert [h[0][0] for h in got] == ids[:64]


def test_build_knn_graph_on_the_card_equals_the_cpu(dev):
    """The host side through N1 on the card: device planes and uploaded
    host planes give the same [cap, degree] table, spilled rows merged;
    against the plain version on the CPU the tables agree but where mud
    (an f32 matrix-vector product, summed in another order on the CPU)
    swaps a near-tie."""
    from cortex_tpu_torch.vector.ivf import TorchIvfIndex
    from cortex_tpu_torch.vector.knn_graph import build_knn_graph
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3000, 64)).astype(np.float32)
    idx = TorchIvfIndex(64, nlist=16, graph_degree=16, device="cpu")
    idx.insert_batch([f"n{i}" for i in range(len(x))], x)
    idx._corpus.sync()
    co = idx._corpus
    _, emb, ri, sr, _, _ = co._ivf_dev
    live = np.where(co._live_h)[0].astype(np.int32)
    kw = dict(degree=16, cap=co._cap, rows=live, cluster_of=co._cluster_of,
              slot_of=co._slot_of, cluster_of2=co._cluster_of2,
              slot_of2=co._slot_of2)
    want = build_knn_graph(emb, ri, sr, co._quant_mu, **kw)
    got = build_knn_graph(emb.to(dev), ri.to(dev), sr.to(dev),
                          co._quant_mu, **kw)
    host = build_knn_graph(emb.numpy(), ri.numpy(), sr.numpy(),
                           co._quant_mu, device=dev, **kw)
    np.testing.assert_array_equal(host, got)
    assert (got[live] == want[live]).all(axis=1).mean() > 0.99


def test_quant_candidates_at_the_tuner_shape(dev):
    """K1 as the nprobe tuner runs it: 256 sampled queries, cand 32, over
    a chunk of the flattened [C * L, d] layout with dead slots biased to
    NEG_INF."""
    rng = np.random.default_rng(7)
    c, l, d = 40, 128, 768
    emb = torch.from_numpy(rng.integers(-127, 128, (c * l, d)).astype(
        np.int8)).to(dev)
    sr = torch.from_numpy(rng.permutation(c * l).astype(np.int32)).to(dev)
    sr[torch.rand(c * l, device=dev) < 0.25] = -1
    rinv = (torch.rand(c * l, device=dev) * 0.01 + 0.001)
    q = torch.randn((256, d), device=dev)
    q /= q.norm(dim=1, keepdim=True)
    qi8, qs = sim.quantize_queries(q)
    bias = torch.where(sr >= 0, 0.0, sim.NEG_INF).to(torch.float32)
    _check_k1((emb, rinv, qi8, qs, bias), 32)


def _clustered_rows(n, d, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(max(1, n // 64), d)).astype(np.float32)
    x = (centers[rng.integers(0, len(centers), n)]
         + 0.5 * rng.normal(size=(n, d)).astype(np.float32))
    return [f"n{i}" for i in range(n)], x / np.linalg.norm(
        x, axis=1, keepdims=True)


def test_flat_snapshot_round_trip_on_the_card(dev, tmp_path):
    """A flat index on the quant path (K1 + K2): its snapshot, then a
    delta link of 300 mutated rows, loaded into a fresh index on the
    card: the same rows and the same top-10 as the index that wrote
    them, through the kernels."""
    from cortex_tpu_torch.vector.index import TorchFlatIndex
    ids, x = _clustered_rows(20_000, 128, 3)
    idx = TorchFlatIndex(128, device=dev)
    idx.insert_batch(ids, x)
    base = str(tmp_path / "flat.npz")
    idx.save(base)
    idx.begin_snapshot_base()
    _, y = _clustered_rows(200, 128, 4)
    idx.insert_batch([f"x{i}" for i in range(200)], y)
    for nid in ids[:100]:
        idx.remove(nid)
    idx.write_delta(str(tmp_path / "link"), idx.delta_state())
    boot = TorchFlatIndex(128, device=dev)
    boot.load(base)
    boot.apply_delta(str(tmp_path / "link.npz"))
    assert set(boot._corpus._row_of) == set(idx._corpus._row_of)
    q = x[100:164]
    before = sim.quant_candidates.launches
    want, got = idx.search_batch(q, 10), boot.search_batch(q, 10)
    assert sim.quant_candidates.launches > before
    _assert_same_top(want, got)


def _assert_same_top(want, got, near_tie=1e-6):
    """Scores within 1e-6 at every rank; ids equal at every rank whose
    score lies further than near_tie from the others' (a loaded index
    holds its rows on other rows, and exact ties then fall apart in
    another order)."""
    for w, g in zip(want, got):
        ws = np.asarray([s for _, s in w])
        np.testing.assert_allclose([s for _, s in g], ws, atol=1e-6)
        for j in range(len(w)):
            gap = np.abs(ws - ws[j])
            gap[j] = np.inf
            if gap.min() > near_tie:
                assert g[j][0] == w[j][0]


def test_ivf_snapshot_round_trip_on_the_card(dev, tmp_path, monkeypatch):
    """An IVF index with its kNN graph (N1) and the tuner's pick: its
    snapshot loaded into a fresh index on the card packs the same lists
    (the same ids in each) with no k-means, no tuning pass and no N1
    launch, carries the graph and the pick, and returns the same top-10
    through the scan kernel."""
    from cortex_tpu_torch.vector import ivf as port_ivf
    ids, x = _clustered_rows(30_000, 128, 5)
    kw = dict(nlist=64, graph_degree=16, target_recall=0.9)
    idx = port_ivf.TorchIvfIndex(128, device=dev, **kw)
    idx.insert_batch(ids, x)
    idx._corpus.sync()                        # C x L < WARM_MIN_SLOTS:
    assert idx._corpus._nbrs_h is not None    # the graph builds inline
    path = str(tmp_path / "ivf.npz")
    idx.write_snapshot(path, idx.snapshot_state())

    def refuse(*a, **k):
        raise AssertionError("a snapshot boot trained or tuned")
    monkeypatch.setattr(port_ivf, "kmeans", refuse)
    monkeypatch.setattr(port_ivf.IvfCorpus, "_tune_nprobe", refuse)
    knn_before = knn_graph.block_knn.launches
    boot = port_ivf.TorchIvfIndex(128, device=dev, **kw)
    boot.load(path)
    q = x[:64]
    before = ivf_gather.probed_scores.launches
    got = boot.search_batch(q, 10)
    assert ivf_gather.probed_scores.launches > before
    assert knn_graph.block_knn.launches == knn_before
    co, oco = boot._corpus, idx._corpus
    assert co._nprobe_tuned == oco._nprobe_tuned > 0
    np.testing.assert_array_equal(co._centroids_h, oco._centroids_h)

    def members(c):
        rows = c._ivf_dev[3].cpu().numpy()
        cs, ss = np.nonzero(rows >= 0)
        return {(int(a), c._id_of[int(rows[a, b])]) for a, b in zip(cs, ss)}
    assert members(co) == members(oco)
    for nid in ids[:500]:
        a = co._nbrs_h[co._row_of[nid]]
        b = oco._nbrs_h[oco._row_of[nid]]
        assert ([co._id_of[r] for r in a[a >= 0]]
                == [oco._id_of[r] for r in b[b >= 0]])
    _assert_same_top(idx.search_batch(q, 10), got)


def test_warmup_builds_the_library_and_returns_true(dev):
    """Cortex.warmup on the card: the kernel library loads, every serving
    search shape runs (through K1 and K2 on a store past QUANT_MIN_CAP)
    and it returns True."""
    from cortex_tpu_torch.api import Cortex
    from cortex_tpu_torch.config import CortexConfig
    from cortex_tpu_torch.types import Node, Source
    cfg = CortexConfig()
    cfg.embedding.model = "hash-128"
    cfg.embedding.dimension = 128
    cx = Cortex.in_memory(cfg, device=dev)
    _, x = _clustered_rows(5000, 128, 8)
    nodes = [Node.new("fact", f"warm node {i}", "body", Source(agent="a"))
             for i in range(len(x))]
    for n, v in zip(nodes, x):
        n.embedding = v.tolist()
    cx.store_batch(nodes)
    lines = []
    before = sim.quant_rerank.launches
    assert cx.warmup(deadline_s=600, progress=lines.append) is True
    assert sim.quant_rerank.launches > before
    assert any("kernel library" in line for line in lines)
    assert any("serving batch B=64" in line for line in lines)
    cx.close()


# ------------------------------------------------------------- the mesh
# parallel/ on a virtual mesh of the card (a device repeated): every
# shard launches its kernel on the card, and the merged results equal
# the same mesh on the CPU (the kernels' plain versions) and the
# single-device index on the card.

MESH_LAYOUTS = [(4, 1), (4, 2)]


def _mesh_pair(dev, n, replicas):
    from cortex_tpu_torch.parallel import build_mesh
    return (build_mesh(n, replicas=replicas, devices=[dev] * n),
            build_mesh(n, replicas=replicas, devices=["cpu"] * n))


@pytest.mark.parametrize("n,replicas", MESH_LAYOUTS)
@pytest.mark.parametrize("path", ["quant", "exact"])
def test_mesh_flat_matches_the_cpu_mesh(dev, n, replicas, path):
    """ShardedFlatIndex on the card (K1 on each shard, host re-rank; or
    the exact product) against the same mesh on the CPU and the
    single-device index on the card, with filters and > 64 exclusions;
    K1 launches once a shard."""
    from cortex_tpu_torch.parallel import ShardedFlatIndex
    from cortex_tpu_torch.vector import TorchFlatIndex, VectorFilter
    ids, x = _clustered_rows(9000, 96, 3)
    kinds = [("fact", "event")[i % 2] for i in range(len(ids))]
    card_mesh, cpu_mesh = _mesh_pair(dev, n, replicas)
    idx = ShardedFlatIndex(96, card_mesh, search_path=path)
    ref = ShardedFlatIndex(96, cpu_mesh, search_path=path)
    one = TorchFlatIndex(96, device=dev, search_path=path)
    for i in (idx, ref, one):
        i.insert_batch(ids, x, kinds=kinds)
    q = x[::701][:7] + 0.05
    for flt in (None, VectorFilter(kinds=["event"]),
                VectorFilter(exclude_ids=ids[:100])):
        before = sim.quant_candidates.launches
        got = idx.search_batch(q, 10, flt)
        if path == "quant":
            assert sim.quant_candidates.launches - before == n
        _assert_same_top(ref.search_batch(q, 10, flt), got)
        _assert_same_top(one.search_batch(q, 10, flt), got)


@pytest.mark.parametrize("n,replicas", MESH_LAYOUTS)
def test_mesh_ivf_matches_the_cpu_mesh(dev, n, replicas):
    """ShardedIvfIndex on the card (probed_scores on each shard) with the
    CPU mesh's clustering carried over (the same lists): the same top-10
    at full and partial probe, with filters; N1 builds its graph."""
    from cortex_tpu_torch.parallel import ShardedIvfIndex
    from cortex_tpu_torch.vector import VectorFilter
    ids, x = _clustered_rows(6000, 64, 4)
    kinds = [("fact", "event")[i % 2] for i in range(len(ids))]
    card_mesh, cpu_mesh = _mesh_pair(dev, n, replicas)
    trained = ShardedIvfIndex(64, cpu_mesh, nlist=32, nprobe=4)
    trained.insert_batch(ids, x, kinds=kinds)
    trained._corpus.sync()
    st = trained._corpus.state()
    ref = ShardedIvfIndex(64, cpu_mesh, nlist=32, nprobe=4)
    idx = ShardedIvfIndex(64, card_mesh, nlist=32, nprobe=4)
    before = knn_graph.block_knn.launches
    for i in (ref, idx):                  # both pack the carried lists
        i._corpus.load_jax_state(st)
        i._corpus.sync()
    assert knn_graph.block_knn.launches == before   # graph carried over
    q = x[::557][:9] + 0.05
    for nprobe in (4, 32):
        idx._corpus._nprobe_cfg = ref._corpus._nprobe_cfg = nprobe
        for flt in (None, VectorFilter(kinds=["event"])):
            before = ivf_gather.probed_scores.launches
            got = idx.search_batch(q, 10, flt)
            assert ivf_gather.probed_scores.launches - before == n
            _assert_same_top(ref.search_batch(q, 10, flt), got)
    fresh = ShardedIvfIndex(64, card_mesh, nlist=32, nprobe=4)
    before = knn_graph.block_knn.launches
    fresh.insert_batch(ids, x, kinds=kinds)
    fresh._corpus.sync()
    assert knn_graph.block_knn.launches > before
    assert fresh._corpus._nbrs_h is not None


def test_mesh_engine_step_decay_matches_plain(dev):
    """sharded_engine_step's decay on the card: D1 on each of the four
    parts, bit-equal to D1's plain version over the whole array, with
    the step's mark for idle light edges."""
    from cortex_tpu_torch.parallel import (build_mesh, shard_corpus,
                                           sharded_engine_step)
    mesh = build_mesh(4, devices=[dev] * 4)
    rng = np.random.default_rng(9)
    e = 100_003
    w = torch.from_numpy(rng.uniform(0, 1, e).astype(np.float32)).to(dev)
    days = torch.from_numpy(rng.uniform(-5, 400, e).astype(np.float32)
                            ).to(dev)
    imp = torch.from_numpy(rng.uniform(0, 1, e).astype(np.float32)).to(dev)
    _, c = _clustered_rows(512, 32, 5)
    corpus, bias = shard_corpus(mesh, c, np.zeros(512, np.float32))
    before = decay.decay_sweep.launches
    out = sharded_engine_step(mesh, corpus, bias, c[:5], c[5:10], w, days,
                              imp, k=4)
    assert decay.decay_sweep.launches - before == 4
    want = decay.decay_sweep_plain(w, days, imp,
                                   torch.zeros_like(w, dtype=torch.bool),
                                   *(float(np.float32(v))
                                     for v in (0.01, 0.8, 0.05, 0.05)))
    assert torch.equal(out[5], want[0])
    assert torch.equal(out[6], torch.where(days > 0, want[1],
                                           want[0] < float(np.float32(0.05))))
    assert out[1][:, 0].tolist() == list(range(5))
