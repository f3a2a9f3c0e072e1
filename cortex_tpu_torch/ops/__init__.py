"""Plain torch and CUDA-kernel operations of the port."""

from .similarity import (cosine_scores, cosine_topk, cosine_topk_quant,
                         cosine_topk_xla, normalize_rows)

__all__ = [
    "cosine_scores", "cosine_topk", "cosine_topk_quant", "cosine_topk_xla",
    "normalize_rows",
]
