"""The plain reference of a vector search: exact cosine top-k in float32.

Plain PyTorch over the rows and queries the benchmark generated (never
anything the program made from them), computed in blocks of rows so
that it fits beside nothing else on the card. Products run with TF32
off. `tf32=True` gives the control: the same search one precision
lower, TF32 on the card, its operand rounding emulated elsewhere.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

ROW_BLOCK = 1 << 16


def unit(t: torch.Tensor) -> torch.Tensor:
    """Rows scaled to unit length (cosine), float32."""
    t = t.to(torch.float32)
    return t / t.norm(dim=-1, keepdim=True)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa, to nearest
    even: the operand rounding of a TF32 product."""
    i = t.contiguous().view(torch.int32).to(torch.int64)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.to(torch.int32).view(torch.float32)


@contextlib.contextmanager
def precision(dev: torch.device, tf32: bool):
    """Products inside run in float32 (tf32=False) or in TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32 and dev.type == "cuda"
    torch.backends.cudnn.allow_tf32 = tf32 and dev.type == "cuda"
    try:
        yield (round_tf32 if tf32 and dev.type != "cuda"
               else (lambda t: t))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def exact_topk(rows: np.ndarray, queries: np.ndarray, k: int,
               dev: torch.device, *, tf32: bool = False):
    """Top-k cosine scores and row numbers of every query over every row.
    Returns (scores [P, k] float32, rows [P, k] int64), best first."""
    dev = torch.device(dev)
    with precision(dev, tf32) as rnd:
        q = rnd(unit(torch.from_numpy(queries).to(dev)))
        best_v = best_i = None
        for s in range(0, rows.shape[0], ROW_BLOCK):
            blk = rnd(unit(torch.from_numpy(rows[s:s + ROW_BLOCK]).to(dev)))
            v, i = torch.topk(q @ blk.T, min(k, blk.shape[0]), dim=1)
            i = i + s
            if best_v is not None:
                v = torch.cat([best_v, v], 1)
                i = torch.cat([best_i, i], 1)
                v, sel = torch.topk(v, min(k, v.shape[1]), dim=1)
                i = torch.gather(i, 1, sel)
            best_v, best_i = v, i
    return best_v.cpu().numpy(), best_i.cpu().numpy()


def pair_scores(rows: np.ndarray, queries: np.ndarray, qidx: np.ndarray,
                ridx: np.ndarray, dev: torch.device) -> np.ndarray:
    """Cosine of query qidx[u] with each row ridx[u, j], float32 with TF32
    off: [U, k]."""
    dev = torch.device(dev)
    out = np.empty(ridx.shape, np.float32)
    step = max(1, ROW_BLOCK // max(1, ridx.shape[1]))
    with precision(dev, False):
        for s in range(0, len(qidx), step):
            g = unit(torch.from_numpy(rows[ridx[s:s + step]]).to(dev))
            q = unit(torch.from_numpy(queries[qidx[s:s + step]]).to(dev))
            out[s:s + step] = torch.bmm(g, q[:, :, None])[:, :, 0].cpu(
            ).numpy()
    return out
