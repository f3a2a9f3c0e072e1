"""Vector search of the port: embedders, the device corpus and the flat
and IVF indexes, and the exact numpy oracle (BruteForceIndex)."""

from .config import SimilarityConfig
from .embedding import (EmbeddingService, HashingEmbedder, STEmbedder,
                        default_embedder, embedding_input)
from .index import (BruteForceIndex, SearchHit, TorchFlatIndex, VectorFilter,
                    VectorIndex)
from .ivf import IvfCorpus, TorchIvfIndex
from .scoring import (ScoreDecayConfig, apply_score_decay,
                      apply_score_decay_batch)
from .shard import DeviceCorpus

__all__ = [
    "SimilarityConfig",
    "EmbeddingService", "HashingEmbedder", "STEmbedder", "default_embedder",
    "embedding_input",
    "BruteForceIndex", "SearchHit", "TorchFlatIndex", "TorchIvfIndex",
    "IvfCorpus", "VectorFilter", "VectorIndex", "DeviceCorpus",
    "ScoreDecayConfig", "apply_score_decay", "apply_score_decay_batch",
]
