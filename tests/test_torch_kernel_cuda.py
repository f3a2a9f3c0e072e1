"""The CUDA probed-block kernel against its plain torch version, on the
card. Marked `cuda`: skipped without a GPU. This file imports no jax
(the card's machine has none); run it there with

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py

Criterion: scores and rows equal bit for bit on unmasked entries, and
equal masks (the kernel's int32 dot converts to the same f32 value as
the plain version's exact f32 sum, then the same single * rinv).
"""

import numpy as np
import pytest
import torch

from cortex_tpu_torch.ops import ivf_gather

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


@pytest.mark.parametrize("bad", ["dtype", "noncontig", "device", "shape",
                                 "dim"])
def test_argument_checks_raise(dev, bad):
    args = _inputs(dev, 8, 16, 1041 if bad == "dim" else 64, 2, 3, "none")
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
