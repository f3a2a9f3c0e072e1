"""Host-side similarity helpers shared by the index: the NEG_INF mask
sentinel, row normalization and the int8 row quantizers.

Counterpart of the host part of cortex_tpu/ops/similarity.py; the
quantizers are the same numpy code, so both packages build
bit-identical int8 layouts from the same rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

NEG_INF = -1e30  # python float; the mask sentinel of every score plane


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
