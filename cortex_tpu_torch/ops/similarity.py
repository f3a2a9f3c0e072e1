"""Similarity search of the flat index: exact and storage-dtype scans,
the int8 candidate scan (K1) and the exact fp32 candidate re-rank (K2),
plus the host helpers every index shares (the NEG_INF mask sentinel,
row normalization, the int8 row and query quantizers).

Counterpart of cortex_tpu/ops/similarity.py:

  * `cosine_topk_xla` (reference line 81): the exact oracle, fp32
    matmul + bias + torch.topk. The reference leaves this plain product
    to XLA, so the port leaves it to torch.matmul, with TF32 off.
  * `cosine_topk_approx` (line 95): the product in the corpus's storage
    dtype (bf16 products summed in f32), then an exact top-k: a superset
    of what approx_max_k returns.
  * `quant_candidates` (the counterpart of `_quant_candidates`, lines
    167-192): K1, csrc/flat_scan.cu on the card.
  * `cosine_topk_quant_exact` (lines 214-253): K1, then K2
    (`quant_rerank`, csrc/flat_scan.cu on the card).

Each kernel wrapper dispatches on its tensors' device with exactly two
branches: CUDA tensors launch the hand-written kernel (built at first
use, ops/build.py) and count the launch; CPU tensors run the plain
torch version beside it (`quant_candidates_plain`,
`quant_rerank_plain`), which the CPU tests use and chip_smoke.py holds
each kernel against on the card. A CUDA launch never falls back.

The quantizers are the reference's numpy code, so both packages build
bit-identical int8 rows from the same fp32 rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .build import load_ops

NEG_INF = -1e30  # python float; the mask sentinel of every score plane
#: corpus rows per step where a scan upcasts the corpus to f32
SCORE_CHUNK_ROWS = 1 << 18
#: d * 127^2 < 2^24 up to here: an f32 sum of int8 products is exact
F32_EXACT_DIM = 1040


def normalize_rows(x: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """L2-normalize rows (f32) so dot products are cosine similarities."""
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return (x / np.maximum(n, eps)).astype(np.float32)


def quantize_rows(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8 quantization of [N, d] (host side).
    Returns (int8 values [N, d], per-row dequant factors rinv [N]).
    row = values * rinv[row] up to rounding."""
    x = np.asarray(x, np.float32)
    rmax = np.max(np.abs(x), axis=-1)
    scale = 127.0 / np.maximum(rmax, 1e-12)
    q = np.clip(np.rint(x * scale[..., None]), -127, 127).astype(np.int8)
    return q, (1.0 / scale).astype(np.float32)


def quantize_rows_centered(x: np.ndarray, mu: Optional[np.ndarray] = None
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Ranking-invariant centered int8 quantization: q.(x - mu) orders
    exactly like q.x for every query (q.mu is a per-query constant), and
    the int8 range then covers only the part of each row that tells
    corpus items apart. Any fixed mu is ranking-correct, so incremental
    updates may reuse a stale one. Returns (q, rinv, mu)."""
    x = np.asarray(x, np.float32)
    if mu is None:
        mu = x.mean(axis=0).astype(np.float32)
    q, rinv = quantize_rows(x - mu[None, :])
    return q, rinv, mu


def quantize_queries(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query symmetric int8 quantization. Returns (qi8, qs) with qs
    the positive per-query scale — ranking-invariant, divided back out
    of reported values."""
    qs = 127.0 / q.abs().amax(dim=1).clamp_min(1e-12)
    qi8 = torch.clamp(torch.round(q * qs[:, None]), -127, 127
                      ).to(torch.int8)
    return qi8, qs


def require_exact_f32(t: torch.Tensor, what: str) -> None:
    """Raise when an f32 product on t's CUDA device would run in TF32."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(f"{what} needs TF32 off: the f32 product must "
                           f"be exact")


def _pad_topk(v: torch.Tensor, i: torch.Tensor, k: int):
    """Pad [B, kk] values / rows to k columns with (NEG_INF, row 0)."""
    pad = k - v.shape[1]
    if pad > 0:
        v = torch.nn.functional.pad(v, (0, pad), value=NEG_INF)
        i = torch.nn.functional.pad(i, (0, pad))
    return v, i


# ------------------------------------------------------- exact / approx


def cosine_scores(corpus: torch.Tensor, queries: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, N] f32 scores of queries [B, d] against corpus [N, d] in the
    corpus's dtype: the queries are rounded to it, the products summed
    in f32 (the reference's preferred_element_type). A bf16 product in
    torch would return bf16, so a bf16 corpus is upcast a chunk of rows
    at a time; bf16 products are exact in f32."""
    require_exact_f32(corpus, "cosine_scores")
    q = queries.to(corpus.dtype)
    if corpus.dtype == torch.float32:
        s = q @ corpus.T
    else:
        qf = q.float()
        s = torch.cat([qf @ corpus[r:r + SCORE_CHUNK_ROWS].float().T
                       for r in range(0, corpus.shape[0],
                                      SCORE_CHUNK_ROWS)], dim=1)
    if bias is not None:
        s = s + bias.reshape(1, -1)
    return s


def cosine_topk_xla(corpus: torch.Tensor, queries: torch.Tensor, k: int,
                    bias: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k: (scores [B, k] f32, rows [B, k] int32); k <= N."""
    v, i = torch.topk(cosine_scores(corpus, queries, bias), k, dim=1)
    return v, i.to(torch.int32)


def cosine_topk_approx(corpus: torch.Tensor, queries: torch.Tensor, k: int,
                       bias: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's near-exact path: product in the storage dtype,
    then the exact top-min(k, N) (which contains whatever the
    reference's approx_max_k over-fetch keeps)."""
    return cosine_topk_xla(corpus, queries, min(k, corpus.shape[0]), bias)


# ----------------------------------------------------------- K1: scan


def quant_candidates(emb_i8: torch.Tensor, rinv: torch.Tensor,
                     qi8: torch.Tensor, qs: torch.Tensor,
                     bias: torch.Tensor, cand: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: the int8 candidate scan. emb_i8 [cap, d] int8 and rinv [cap]
    f32 (the centered int8 shadow); qi8 [B, d] int8 and qs [B] f32
    (quantize_queries); bias [cap] f32 (0, or <= NEG_INF per row).
    Scores float(qi8 . row_i8) * (rinv / qs) + bias; returns their exact
    top-`cand` (values [B, cand] f32, rows [B, cand] int32), padded with
    (NEG_INF, row 0) when cap < cand. On the card the kernel (int8
    tensor cores, csrc/flat_scan.cu) writes each row partition's top
    candidates and torch.topk merges them: no [B, cap] score plane."""
    dev = emb_i8.device
    if dev.type == "cuda":
        pv, pi = load_ops().quant_scan(emb_i8, rinv, qi8, qs, bias,
                                       int(cand))
        quant_candidates.launches += 1
        v, sel = torch.topk(pv, min(cand, emb_i8.shape[0]), dim=1)
        return _pad_topk(v, torch.gather(pi, 1, sel), cand)
    if dev.type == "cpu":
        return quant_candidates_plain(emb_i8, rinv, qi8, qs, bias, cand)
    raise RuntimeError(f"quant_candidates has no kernel for device {dev}")


#: kernel launches since the last reset (chip_smoke.py reads it to show
#: the main path went through the kernel)
quant_candidates.launches = 0


def int8_dot(qi8: torch.Tensor, emb_i8: torch.Tensor) -> torch.Tensor:
    """Exact [B, cap] int8 dot products as f32 values: torch._int_mm
    (int32) on the CPU and, where cuBLASLt's shape rules allow (more than
    16 query rows, so queries pad to 32; d and cap multiples of 8), on
    the card; elsewhere on the card an f32 product with TF32 off, exact
    while d <= F32_EXACT_DIM."""
    b, d = qi8.shape
    cap = emb_i8.shape[0]
    if not qi8.is_cuda:
        return torch._int_mm(qi8, emb_i8.T).float()
    if d % 8 == 0 and cap % 8 == 0:
        qp = qi8
        if b <= 16:
            qp = torch.nn.functional.pad(qi8, (0, 0, 0, 32 - b))
        return torch._int_mm(qp, emb_i8.T)[:b].float()
    if d > F32_EXACT_DIM:
        raise RuntimeError(f"int8_dot: d={d} is neither a multiple of 8 "
                           f"nor <= {F32_EXACT_DIM}")
    require_exact_f32(qi8, "int8_dot")
    q = qi8.float()
    return torch.cat([q @ emb_i8[r:r + SCORE_CHUNK_ROWS].float().T
                      for r in range(0, cap, SCORE_CHUNK_ROWS)], dim=1)


def quant_candidates_plain(emb_i8, rinv, qi8, qs, bias, cand
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`quant_candidates` in plain torch: the exact int8 product, the
    same descale and bias in the same order, then torch.topk."""
    s = int8_dot(qi8, emb_i8) * (rinv[None, :] / qs[:, None])
    s = s + bias[None, :]
    v, i = torch.topk(s, min(cand, emb_i8.shape[0]), dim=1)
    return _pad_topk(v, i.to(torch.int32), cand)


# --------------------------------------------------------- K2: re-rank


def quant_rerank(emb_f32: torch.Tensor, q: torch.Tensor, cv: torch.Tensor,
                 ci: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: the exact fp32 re-rank of K1's candidates. emb_f32 [cap, d]
    f32; q [B, d] f32 (normalized queries); cv / ci [B, cand] the
    candidates. Valid candidates (cv > NEG_INF / 2) get the exact f32
    dot with their query, invalid ones NEG_INF; returns the top-min(k,
    cand) (values [B, k] f32, rows [B, k] int32), padded with (NEG_INF,
    row 0) to k."""
    dev = emb_f32.device
    if dev.type == "cuda":
        out = load_ops().quant_rerank(emb_f32, q, cv, ci, int(k))
        quant_rerank.launches += 1
        return out
    if dev.type == "cpu":
        return quant_rerank_plain(emb_f32, q, cv, ci, k)
    raise RuntimeError(f"quant_rerank has no kernel for device {dev}")


#: kernel launches since the last reset
quant_rerank.launches = 0


def quant_rerank_plain(emb_f32, q, cv, ci, k
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`quant_rerank` in plain torch: gather, f32 bmm (TF32 off), mask,
    torch.topk."""
    require_exact_f32(emb_f32, "quant_rerank_plain")
    valid = cv > NEG_INF / 2
    rows = torch.where(valid, ci, torch.zeros_like(ci)).long()
    g = emb_f32[rows]                                    # [B, cand, d]
    exact = torch.bmm(g, q[:, :, None])[:, :, 0]
    exact = torch.where(valid, exact, torch.full_like(exact, NEG_INF))
    v, sel = torch.topk(exact, min(k, cv.shape[1]), dim=1)
    return _pad_topk(v, torch.gather(ci, 1, sel), k)


def cosine_topk_quant_exact(emb_i8: torch.Tensor, rinv: torch.Tensor,
                            emb_f32: torch.Tensor, q: torch.Tensor, k: int,
                            cand: int, bias: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 candidate scan (K1) + exact fp32 device re-rank (K2):
    (values [B, k], rows [B, k] int32). Candidate membership comes from
    the int8 scan; scores and order are exact fp32."""
    qi8, qs = quantize_queries(q)
    cv, ci = quant_candidates(emb_i8, rinv, qi8, qs, bias, cand)
    return quant_rerank(emb_f32, q, cv, ci, k)
