"""Vector search of the port: embedders, the device corpus and the flat
and IVF indexes."""

from .embedding import (EmbeddingService, HashingEmbedder,
                        default_embedder, embedding_input)
from .index import SearchHit, TorchFlatIndex, VectorFilter, VectorIndex
from .ivf import IvfCorpus, TorchIvfIndex
from .scoring import ScoreDecayConfig, apply_score_decay_batch

__all__ = [
    "EmbeddingService", "HashingEmbedder", "default_embedder",
    "embedding_input", "SearchHit", "TorchFlatIndex", "VectorFilter",
    "VectorIndex", "IvfCorpus", "TorchIvfIndex", "ScoreDecayConfig",
    "apply_score_decay_batch",
]
