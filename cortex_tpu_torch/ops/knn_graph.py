"""The kNN-graph block program of the IVF index's graph build (N1).

`block_knn` is the counterpart of cortex_tpu/vector/knn_graph.py::
_block_knn (the XLA program at :105), for a chunk of clusters handed
over as its own tensors (the reference slices them from the layout
inside its program). It dispatches on the tensors' device with exactly
two branches:

  * CUDA tensors run the hand-written kernel in csrc/block_knn.cu, bound
    as torch.ops.cortex_tpu_torch.block_knn and built at first use with
    every other kernel of csrc/ (ops/build.py): a wgmma product fed by
    TMA, each row's top r merged as the column tiles stream by, so any
    L and d are taken (r in [1, L - 1], ch * L < 2^31; the binding
    raises ValueError outside). The binding allocates a device scratch
    for the running lists when r is too large for shared memory. A
    failed build or launch raises.
  * CPU tensors run `block_knn_plain`, the same function in plain torch
    (the CPU tests use it, and chip_smoke.py holds the kernel against it
    on the card, bit for bit).

`mud` = (emb . mu) * rinv, the dequantized y . mu term, is computed once
by the caller (`slot_mu_dot`, a matrix-vector product the reference
leaves to XLA) and handed to both, so the kernel and its plain version
see the same values.
"""

from __future__ import annotations

import torch

from .build import load_ops
from .similarity import F32_EXACT_DIM, NEG_INF, int8_dot, require_exact_f32


def slot_mu_dot(emb_i8: torch.Tensor, rinv: torch.Tensor,
                mu: torch.Tensor) -> torch.Tensor:
    """[ch, L] f32: each slot's dequantized dot with mu,
    (float(emb) @ mu) * rinv, as the reference's _block_knn computes it."""
    return torch.matmul(emb_i8.float(), mu) * rinv


def block_knn(emb_i8: torch.Tensor, rinv: torch.Tensor,
              slot_rows: torch.Tensor, mud: torch.Tensor, r: int
              ) -> torch.Tensor:
    """Within-cluster top-r neighbour lists of a chunk of clusters.

    emb_i8 [ch, L, d] int8; rinv [ch, L] f32; slot_rows [ch, L] int32
    (-1 for an empty slot); mud [ch, L] f32 (`slot_mu_dot`); 1 <= r < L.
    Scores s[i, j] = (float(emb_i . emb_j) * rinv_i) * rinv_j + mud_j,
    with j == i and empty slots j at NEG_INF; returns [ch, L, r] int32:
    each slot's top r by score, ties to the lower slot, as global rows
    (slot_rows[j]), -1 where the score is <= -1e29."""
    dev = emb_i8.device
    if dev.type == "cuda":
        out = load_ops().block_knn(emb_i8, rinv, slot_rows, mud, int(r))
        block_knn.launches += 1
        return out
    if dev.type == "cpu":
        return block_knn_plain(emb_i8, rinv, slot_rows, mud, r)
    raise RuntimeError(f"block_knn has no kernel for device {dev}")


#: kernel launches since the last reset (chip_smoke.py reads it to show
#: the main path went through the kernel)
block_knn.launches = 0


def block_self_dot(emb_i8: torch.Tensor) -> torch.Tensor:
    """[ch, L, L] f32: every within-cluster int8 dot product, exact. An f32
    batched product (TF32 off) is exact while d <= F32_EXACT_DIM; past it
    each cluster goes through int8_dot, whose rule decides the route."""
    d = emb_i8.shape[2]
    if d <= F32_EXACT_DIM:
        require_exact_f32(emb_i8, "block_self_dot")
        f = emb_i8.float()
        return torch.bmm(f, f.transpose(1, 2))
    return torch.stack([int8_dot(b, b) for b in emb_i8])


def block_knn_plain(emb_i8, rinv, slot_rows, mud, r) -> torch.Tensor:
    """`block_knn` in plain torch, in the reference's order: the exact
    int8 self-product, times rinv_i, times rinv_j, plus mud_j, the masks,
    then a stable descending sort (torch.topk's tie order is unspecified;
    lax.top_k keeps the lower index first). Adding 0.0 turns -0.0 into
    +0.0, so the two tie here as they do under the reference's compare.
    Materializes [ch, L, L] planes, as the reference does."""
    ch, lcap, _ = emb_i8.shape
    s = block_self_dot(emb_i8)
    s = s * rinv[:, :, None] * rinv[:, None, :]
    s = s + mud[:, None, :]
    live = slot_rows >= 0
    eye = torch.eye(lcap, dtype=torch.bool, device=emb_i8.device)
    s = torch.where(live[:, None, :] & ~eye[None], s,
                    torch.full_like(s, NEG_INF)) + 0.0
    v, idx = torch.sort(s, dim=2, descending=True, stable=True)
    v, idx = v[:, :, :r], idx[:, :, :r]
    rows = torch.gather(slot_rows[:, None, :].expand(ch, lcap, lcap), 2, idx)
    return torch.where(v > -1e29, rows, torch.full_like(rows, -1))
