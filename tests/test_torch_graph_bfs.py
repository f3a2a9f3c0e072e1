"""The plain versions of the graph kernels against the reference's XLA
programs (cortex_tpu/graph/csr.py), on the same seeded tables.

  * frontier_bfs_plain (G1) against _frontier_bfs_device: the overflow
    flag always equal, dist equal (the plain version repeats the
    reference's frontier order, so even after an overflow);
    frontier_bfs_compact (its plain version) against
    _frontier_bfs_device_compact: the same set of (row, depth) within
    `hops`, the same reached count and overflow flag, and the same
    decision of the caller's fall-back to the host BFS (overflow, or the
    width filled); row order is not compared.
  * bfs_relax_plain (G2) against _bfs_hops vmapped over anchors
    (csr.py:509) and at A = 1: exactly equal int32 depths, also when
    bfs_relax cuts the anchors into chunks.

Tables hold -1 anywhere in a row, hub rows full to the width, and rows
that point at themselves; anchors come duplicated, padded with -1 and
isolated; caps run from 1 (overflow at hop 1) to no overflow at all.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cortex_tpu.graph import csr as ref
from cortex_tpu_torch.ops import graph_bfs as g

INF = int(ref.INF_DEPTH)


def table(rng, n, d, *, hub_share=0.05, pad_share=0.4):
    """[n, d] int32 neighbor table: random rows, -1 anywhere, a few hub
    rows with every column set, and some self loops."""
    nb = rng.integers(0, n, (n, d)).astype(np.int32)
    nb[rng.random((n, d)) < pad_share] = -1
    hubs = rng.random(n) < hub_share
    nb[hubs] = rng.integers(0, n, (int(hubs.sum()), d))
    loops = rng.random(n) < 0.05
    nb[loops, 0] = np.nonzero(loops)[0]
    return nb


def anchors_for(rng, n, a, kind):
    if kind == "plain":
        return rng.choice(n, a, replace=a > n).astype(np.int32)
    if kind == "dup":
        base = rng.integers(0, n, max(1, a // 2))
        return np.resize(base, a).astype(np.int32)
    if kind == "padded":
        out = np.full(a, -1, np.int32)
        out[:max(1, a // 2)] = rng.integers(0, n, max(1, a // 2))
        return out
    raise ValueError(kind)


def walk_ref(nb, anchors, hops, cap):
    d, o = ref._frontier_bfs_device(jnp.asarray(nb), jnp.asarray(anchors),
                                    hops, cap)
    return np.asarray(d), bool(o)


def walk_port(nb, anchors, hops, cap):
    d, o = g.frontier_bfs(torch.from_numpy(nb), torch.from_numpy(anchors),
                          hops, cap)
    return d.numpy(), bool(o)


# (n, d, a, anchors, caps): caps include one that overflows at hop 1 and
# one the walk never fills
WALK_CASES = [
    (1, 8, 1, "plain"), (7, 3, 2, "dup"), (40, 8, 4, "padded"),
    (200, 16, 8, "dup"), (500, 64, 3, "plain"), (97, 5, 16, "padded"),
]


@pytest.mark.parametrize("case", WALK_CASES,
                         ids=lambda c: "n{}d{}a{}{}".format(*c))
@pytest.mark.parametrize("seed", [0, 1])
def test_frontier_walk_equals_reference(case, seed):
    n, d, a, kind = case
    rng = np.random.default_rng(seed * 100 + n)
    nb = table(rng, n, d)
    anc = anchors_for(rng, n, a, kind)
    for cap in sorted({a, max(a, 3), max(a, n * d)}):
        for hops in (0, 3, 8):
            want, wo = walk_ref(nb, anc, hops, cap)
            got, go = walk_port(nb, anc, hops, cap)
            assert go == wo, (cap, hops)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_frontier_walk_overflow_at_each_hop(seed):
    """A cap just under each hop's count of new pairs flags overflow
    exactly when the reference does."""
    rng = np.random.default_rng(seed)
    nb = table(rng, 300, 8, pad_share=0.6, hub_share=0.0)
    anc = anchors_for(rng, 300, 2, "dup")
    counted = []
    for cap in (2, 5, 11, 23, 47, 95, 191, 2400):
        want, wo = walk_ref(nb, anc, 4, cap)
        got, go = walk_port(nb, anc, 4, cap)
        assert go == wo
        np.testing.assert_array_equal(got, want)
        counted.append(go)
    assert counted[0] and not counted[-1]


def test_isolated_and_empty_anchors():
    nb = np.full((10, 8), -1, np.int32)
    nb[0, :2] = (1, 2)
    for anc in (np.array([5], np.int32), np.array([-1, -1], np.int32),
                np.zeros(0, np.int32), np.array([5, 5, 0], np.int32)):
        for hops in (0, 2):
            want, wo = walk_ref(nb, anc, hops, 8)
            got, go = walk_port(nb, anc, hops, 8)
            assert go == wo
            np.testing.assert_array_equal(got, want)


def compact_ref(nb, anchors, hops, cap, out_cap):
    """The reference's compact walk as ({(row, depth)} within hops,
    reached count among the kept, overflow, the caller's fall-back)."""
    rows, dep, over = (np.asarray(x) for x in
                       ref._frontier_bfs_device_compact(
                           jnp.asarray(nb), jnp.asarray(anchors), hops, cap,
                           out_cap))
    keep = dep <= hops
    pairs = set(zip(rows[keep].tolist(), dep[keep].tolist()))
    count = int(keep.sum())
    # csr.py:320-322: overflow, or the compaction's width filled
    return pairs, count, bool(over), bool(over) or count >= min(
        out_cap, rows.shape[0])


def compact_port(nb, anchors, hops, cap, out_cap):
    packed = g.frontier_bfs_compact(torch.from_numpy(nb),
                                    torch.from_numpy(anchors), hops, cap,
                                    out_cap)
    assert packed.dtype == torch.int32 and packed.shape == (2 + 2 * out_cap,)
    rows, dep, count, over = g.unpack_compact(packed.numpy())
    pairs = set(zip(rows.tolist(), dep.tolist()))
    assert len(pairs) == len(rows) == min(count, out_cap)   # deduplicated
    return pairs, count, over, over or count >= min(out_cap, nb.shape[0])


@pytest.mark.parametrize("seed", range(3))
def test_compact_walk_equals_reference_as_a_set(seed):
    rng = np.random.default_rng(seed)
    n, hops = 400, 3
    nb = table(rng, n, 8, hub_share=0.0)
    anc = np.array([int(rng.integers(0, n))], np.int32)
    for out_cap in (4, 64, 4096):
        want = compact_ref(nb, anc, hops, 8192, out_cap)
        got = compact_port(nb, anc, hops, 8192, out_cap)
        assert got[2:] == want[2:]                  # overflow, fall-back
        if not want[3]:                             # the width did not fill
            assert got[:2] == want[:2]
        else:                                       # every kept pair is true
            dist = walk_ref(nb, anc, hops, 8192)[0]
            hit = np.nonzero(dist <= hops)[0]
            assert got[0] <= set(zip(hit.tolist(), dist[hit].tolist()))


@pytest.mark.parametrize("case", WALK_CASES,
                         ids=lambda c: "n{}d{}a{}{}".format(*c))
@pytest.mark.parametrize("seed", [0, 1])
def test_compact_walk_plain_equals_reference(case, seed):
    """The plain compact walk against _frontier_bfs_device_compact with a
    width that holds every row: the same (row, depth) set within hops,
    the same count and the same overflow flag, at every cap and hops."""
    n, d, a, kind = case
    rng = np.random.default_rng(seed * 100 + n + 7)
    nb = table(rng, n, d)
    anc = anchors_for(rng, n, a, kind)
    for cap in sorted({a, max(a, 3), max(a, n * d)}):
        for hops in (0, 3, 8):
            want = compact_ref(nb, anc, hops, cap, n + 1)
            got = compact_port(nb, anc, hops, cap, n + 1)
            assert got[:3] == want[:3], (cap, hops)


def star(k, n=50):
    """[n, 8] table (k <= 8): row 0 linked to rows 1..k both ways, the
    rest isolated; from row 0, one hop reaches k + 1 rows."""
    nb = np.full((n, 8), -1, np.int32)
    nb[0, :k] = np.arange(1, k + 1)
    nb[1:k + 1, 0] = 0
    return nb


@pytest.mark.parametrize("out_cap,falls_back", [(9, False), (8, True),
                                                (5, True)])
def test_compact_walk_width_edges(out_cap, falls_back):
    """A walk that reaches fewer rows than the width, exactly the width
    and more: the count stays exact, the kept pairs are true ones, and
    the caller's fall-back rule decides as the reference's does."""
    nb, anc = star(7), np.array([0], np.int32)        # reaches 8 rows
    want = compact_ref(nb, anc, 1, 64, out_cap)
    got = compact_port(nb, anc, 1, 64, out_cap)
    assert got[1] == 8 and got[2] is False
    assert got[3] == want[3] == falls_back
    truth = {(0, 0)} | {(i, 1) for i in range(1, 8)}
    assert got[0] <= truth and len(got[0]) == min(8, out_cap)
    if not falls_back:
        assert got[0] == want[0] == truth


def relax_ref(nb, dist0, hops):
    return np.asarray(jax.vmap(ref._bfs_hops, in_axes=(None, 0, None))(
        jnp.asarray(nb), jnp.asarray(dist0), jnp.int32(hops)))


@pytest.mark.parametrize("n,d,a", [(1, 8, 1), (9, 3, 2), (64, 16, 5),
                                   (300, 64, 8), (150, 8, 11)])
@pytest.mark.parametrize("hops", [-1, 0, 1, 3, 8, 12])
def test_relaxation_equals_reference(n, d, a, hops):
    rng = np.random.default_rng(n * 31 + a)
    nb = table(rng, n, d)
    dist0 = np.full((a, n), INF, np.int32)
    for j in range(a):
        dist0[j, rng.integers(0, n, 1 + j % 3)] = 0
    got = g.bfs_relax(torch.from_numpy(nb), torch.from_numpy(dist0),
                      hops).numpy()
    np.testing.assert_array_equal(got, relax_ref(nb, dist0, hops))
    # A = 1, as _device_dist calls it (csr.py:611)
    one = np.asarray(ref._bfs_hops(jnp.asarray(nb), jnp.asarray(dist0[0]),
                                   jnp.int32(hops)))
    np.testing.assert_array_equal(
        g.bfs_relax_plain(torch.from_numpy(nb),
                          torch.from_numpy(dist0[:1]), hops).numpy()[0], one)


def test_relaxation_chunks_rows(monkeypatch):
    """The plain relaxation gathers RELAX_CHUNK_ROWS rows at a time: a
    chunk smaller than the table gives the same depths."""
    rng = np.random.default_rng(7)
    nb = table(rng, 100, 8)
    dist0 = np.full((3, 100), INF, np.int32)
    dist0[:, [0, 50, 99]] = np.eye(3, dtype=np.int32) * -INF + INF
    want = relax_ref(nb, dist0, 4)
    monkeypatch.setattr(g, "RELAX_CHUNK_ROWS", 7)
    got = g.bfs_relax(torch.from_numpy(nb), torch.from_numpy(dist0), 4)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("limit", [1, 2, 300, 1 << 30])
def test_relaxation_chunks_anchors(monkeypatch, limit):
    """More than RELAX_MAX_ENTRIES depths run as chunks of whole anchors:
    any chunking gives the unchunked (and the reference's) depths."""
    rng = np.random.default_rng(11)
    nb = table(rng, 100, 8)
    dist0 = np.full((7, 100), INF, np.int32)
    for j in range(7):
        dist0[j, rng.integers(0, 100, 1 + j % 2)] = 0
    want = relax_ref(nb, dist0, 3)
    monkeypatch.setattr(g, "RELAX_MAX_ENTRIES", limit)
    got = g.bfs_relax(torch.from_numpy(nb), torch.from_numpy(dist0), 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_relaxation_is_jacobi():
    """Each round reads the previous round's depths: on a chain, hops
    rounds reach exactly hops rows (in place would reach further)."""
    n = 12
    nb = np.full((n, 8), -1, np.int32)
    for i in range(n):
        nb[i, :2] = (i - 1 if i else -1, i + 1 if i + 1 < n else -1)
    dist0 = np.full((1, n), INF, np.int32)
    dist0[0, 0] = 0
    got = g.bfs_relax(torch.from_numpy(nb), torch.from_numpy(dist0), 3)
    assert got.numpy()[0].tolist() == [0, 1, 2, 3] + [INF] * (n - 4)


@pytest.mark.parametrize("call", [
    lambda nb, a: g.frontier_bfs(nb, a, 9, 8),                # hops > 8
    lambda nb, a: g.frontier_bfs(nb, a, -1, 8),
    lambda nb, a: g.frontier_bfs(nb, a, 2, 1),                # A > cap
    lambda nb, a: g.frontier_bfs(nb, a.long(), 2, 8),         # dtype
    lambda nb, a: g.frontier_bfs(nb.long(), a, 2, 8),
    lambda nb, a: g.frontier_bfs(nb, a + 10, 2, 8),           # outside
    lambda nb, a: g.frontier_bfs(nb, a.to("meta"), 2, 8),     # device
    lambda nb, a: g.frontier_bfs_compact(nb, a.to("meta"), 2, 8, 16),
    lambda nb, a: g.bfs_relax(nb, a[None, :].long(), 2),
    lambda nb, a: g.bfs_relax(nb, torch.zeros((1, 3), dtype=torch.int32),
                              2),                             # wrong N
])
def test_arguments_are_checked(call):
    nb = torch.full((5, 8), -1, dtype=torch.int32)
    with pytest.raises(ValueError):
        call(nb, torch.tensor([0, 4], dtype=torch.int32))
