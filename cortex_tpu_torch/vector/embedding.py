"""Embedding services of the port: the canonical node text and the
deterministic hashing embedder.

Counterpart of cortex_tpu/vector/embedding.py. `default_embedder` keeps
the reference's fallback order for model names without local weights
(embedding.py:316-343): such a name falls back to HashingEmbedder, as
it does there. A model whose weights exist on disk would be served by
the reference's device encoder, which this slice does not port; asking
for one raises ConfigError instead of silently hashing.
"""

from __future__ import annotations

import abc
import hashlib
import os
import re
from typing import List, Optional, Sequence

import numpy as np

from ..errors import ConfigError, EmbeddingError
from ..types import Node, kind_display

_WORD_RE = re.compile(r"[a-z0-9]+")

#: the ROADMAP item that ports the text encoder
ENCODER_ITEM = "ROADMAP queue A, 'Text encoder'"


def embedding_input(node: Node) -> str:
    """Canonical node -> text mapping; keep byte-for-byte stable."""
    return (f"{kind_display(node.kind)}: {node.title}\n"
            f"{node.body}\n"
            f"tags: {', '.join(node.tags)}")


class EmbeddingService(abc.ABC):
    @abc.abstractmethod
    def embed(self, text: str) -> np.ndarray: ...

    @abc.abstractmethod
    def embed_batch(self, texts: Sequence[str]) -> np.ndarray: ...

    @property
    @abc.abstractmethod
    def dimension(self) -> int: ...

    @property
    @abc.abstractmethod
    def model_name(self) -> str: ...

    def embed_node(self, node: Node) -> np.ndarray:
        return self.embed(embedding_input(node))

    def embed_nodes(self, nodes: Sequence[Node]) -> np.ndarray:
        return self.embed_batch([embedding_input(n) for n in nodes])


class HashingEmbedder(EmbeddingService):
    """Feature-hashed unigram+bigram embedding with signed buckets.

    Deterministic across processes (blake2b-seeded), cosine similarity
    tracks lexical overlap, orthogonal-ish for unrelated text. The same
    function as the reference's, so both packages embed a text alike.
    """

    def __init__(self, dim: int = 384, name: Optional[str] = None):
        if dim <= 0:
            raise EmbeddingError("dim must be positive")
        self._dim = dim
        self._name = name or f"hash-{dim}"

    @property
    def dimension(self) -> int:
        return self._dim

    @property
    def model_name(self) -> str:
        return self._name

    def _tokens(self, text: str) -> List[str]:
        words = _WORD_RE.findall(text.lower())
        bigrams = [f"{a}_{b}" for a, b in zip(words, words[1:])]
        return words + bigrams

    def embed(self, text: str) -> np.ndarray:
        v = np.zeros(self._dim, dtype=np.float32)
        for tok in self._tokens(text):
            h = hashlib.blake2b(tok.encode(), digest_size=8).digest()
            x = int.from_bytes(h, "little")
            idx = x % self._dim
            sign = 1.0 if (x >> 63) & 1 else -1.0
            v[idx] += sign
        n = np.linalg.norm(v)
        if n < 1e-12:
            # empty text: deterministic unit vector
            v[0] = 1.0
            return v
        return v / n

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self._dim), dtype=np.float32)
        return np.stack([self.embed(t) for t in texts])


def resolve_local_model(name_or_path: str) -> Optional[str]:
    """A local directory for an HF model without any network access:
    the path itself, or a cached hub snapshot. None if absent (the
    reference's models/convert.py::resolve_local_model)."""
    if os.path.isdir(name_or_path):
        return name_or_path
    try:
        from huggingface_hub import snapshot_download
        return snapshot_download(name_or_path, local_files_only=True)
    except Exception:  # noqa: BLE001 — any miss means "not local"
        return None


def default_embedder(model: str = "", dim: int = 384) -> EmbeddingService:
    """The configured embedder. "hash"/"hash-<dim>" and any model whose
    weights are not on disk give HashingEmbedder, as in the reference.
    "flax:<weights.npz>" with an existing file, or an HF model with
    local weights, raises ConfigError: the encoder is not ported yet."""
    if model.startswith("flax:"):
        weights = model[len("flax:"):].partition("::")[0]
        if os.path.exists(weights):
            raise ConfigError(
                f"[embedding] model={model!r}: the device text encoder is "
                f"not ported yet ({ENCODER_ITEM})")
    elif model and not model.startswith("hash"):
        if resolve_local_model(model) is not None:
            raise ConfigError(
                f"[embedding] model={model!r} has local weights, but the "
                f"text encoder is not ported yet ({ENCODER_ITEM})")
    if model.startswith("hash-"):
        dim = int(model.split("-", 1)[1])
    return HashingEmbedder(dim=dim)
