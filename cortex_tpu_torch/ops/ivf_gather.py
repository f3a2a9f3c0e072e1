"""IVF gather-score: the probed-block scan of the IVF search.

`probed_scores` is the counterpart of cortex_tpu/ops/ivf_gather.py::
probed_scores (the Pallas kernel). It dispatches on the tensors'
device and has exactly two branches:

  * CUDA tensors run the hand-written kernel in csrc/ivf_gather.cu,
    bound as torch.ops.cortex_tpu_torch.probed_scores and built at first
    use with every other kernel of csrc/ (ops/build.py). A failed build
    or launch raises.
  * CPU tensors run `probed_scores_plain`, the same function in plain
    torch (the CPU tests use it, and chip_smoke.py holds the kernel
    against it on the card).

The layout is the port's: the metadata the Pallas kernel packed into a
[C, 8, L] f32 plane arrives as separate [C, L] planes (rinv f32;
slot_rows, kind_sl, agent_sl int32), and p is not padded to a multiple
of 8. Scores carry no 1/qs query descale, exactly as in the reference.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .build import load_ops
from .similarity import F32_EXACT_DIM, NEG_INF, int8_dot, require_exact_f32

#: filter list entry: filter off (ak[0], aa) / pad (ex)
NO_FILTER = -1
PLAIN_BUDGET_BYTES = 1 << 30    # f32 gather per query chunk, plain version


def probed_scores(emb_i8, rinv_sl, slot_rows, kind_sl, agent_sl, probe,
                  qi8, ak, aa, ex, *, filtered: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused gather + score + filter pass over the probed blocks.

    emb_i8 [C, L, d] int8; rinv_sl [C, L] f32; slot_rows / kind_sl /
    agent_sl [C, L] int32; probe [B, p] int32; qi8 [B, d] int8; ak [16] /
    aa [1] / ex [64] int32 filter lists (ak[0] or aa NO_FILTER: that
    filter off; ex padded with NO_FILTER, which matches only empty
    slots). filtered=False drops the kind/agent/exclusion tests and
    REQUIRES the lists to be all NO_FILTER. Returns (scores [B, p*L] f32: q_i8 . row_i8 * rinv,
    NEG_INF where masked; rows [B, p*L] int32: the raw slot rows)."""
    dev = emb_i8.device
    if dev.type == "cuda":
        out = load_ops().probed_scores(emb_i8, rinv_sl, slot_rows,
                                       kind_sl, agent_sl, probe, qi8, ak,
                                       aa, ex, bool(filtered))
        probed_scores.launches += 1
        return out
    if dev.type == "cpu":
        return probed_scores_plain(emb_i8, rinv_sl, slot_rows, kind_sl,
                                   agent_sl, probe, qi8, ak, aa, ex,
                                   filtered=filtered)
    raise RuntimeError(f"probed_scores has no kernel for device {dev}")


#: kernel launches since the last reset (chip_smoke.py reads it to show
#: the main path went through the kernel)
probed_scores.launches = 0


def probed_scores_plain(emb_i8, rinv_sl, slot_rows, kind_sl, agent_sl,
                        probe, qi8, ak, aa, ex, *, filtered: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`probed_scores` in plain torch: gather the probed blocks, the
    exact int8 dots (an f32 batched matmul while d <= F32_EXACT_DIM, the
    int8 products summed below 2^24; past it int8_dot a query at a time,
    an int32 sum rounded once, as the kernel rounds it), times rinv,
    then the masks. A probe id outside [0, C) scores its segment as
    empty (NEG_INF, row -1), as the kernel does. Materializes the
    [n, p*L, d] f32 gather, so queries run in chunks of at most
    PLAIN_BUDGET_BYTES each."""
    b, p = probe.shape
    c, l, d = emb_i8.shape
    exact_f32 = d <= F32_EXACT_DIM
    if exact_f32:
        require_exact_f32(emb_i8, "probed_scores_plain")
    if b == 0:
        return (torch.empty((0, p * l), dtype=torch.float32,
                            device=emb_i8.device),
                torch.empty((0, p * l), dtype=torch.int32,
                            device=emb_i8.device))
    qc = max(1, min(b, PLAIN_BUDGET_BYTES // max(1, p * l * d * 4)))
    s_parts, r_parts = [], []
    for s0 in range(0, b, qc):
        pr = probe[s0:s0 + qc].long()
        bad = ((pr < 0) | (pr >= c)).repeat_interleave(l, dim=1)
        pr = pr.clamp(0, max(c - 1, 0))
        n = pr.shape[0]
        blk = emb_i8[pr].reshape(n, p * l, d)
        if exact_f32:
            dots = torch.bmm(blk.float(), qi8[s0:s0 + qc].float()
                             .unsqueeze(2)).squeeze(2)
        else:
            dots = torch.cat([int8_dot(qi8[s0 + i:s0 + i + 1], blk[i])
                              for i in range(n)])
        s = dots * rinv_sl[pr].reshape(n, p * l)
        rows = torch.where(bad, -1, slot_rows[pr].reshape(n, p * l))
        ok = rows >= 0
        if filtered:
            kc = kind_sl[pr].reshape(n, p * l)
            ac = agent_sl[pr].reshape(n, p * l)
            kind_on = ak[0] != NO_FILTER
            ok &= ~kind_on | torch.isin(kc, ak)
            agent_on = aa[0] != NO_FILTER
            ok &= ~agent_on | (ac == aa[0])
            ok &= ~torch.isin(rows, ex)
        s_parts.append(torch.where(ok, s, torch.full_like(s, NEG_INF)))
        r_parts.append(rows)
    return torch.cat(s_parts), torch.cat(r_parts)
