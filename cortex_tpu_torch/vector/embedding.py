"""Embedding services of the port: the canonical node text, the
deterministic hashing embedder and the device text encoder.

Counterpart of cortex_tpu/vector/embedding.py. `TorchEncoderEmbedder`
takes the place of the reference's `JaxEncoderEmbedder`: the BERT tower
of models/encoder.py on a torch device, with the same constructor forms
and model name. `default_embedder` keeps the reference's order (flax npz
-> local HF model -> sentence-transformers -> hashing) and runs the
encoder on the device it is given.
"""

from __future__ import annotations

import abc
import hashlib
import os
import re
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..errors import EmbeddingError
from ..types import Node, kind_display
from ..utils.device import resolve_device

_WORD_RE = re.compile(r"[a-z0-9]+")


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


class STEmbedder(EmbeddingService):
    """sentence-transformers model (BGE/MiniLM class). Requires locally
    cached weights — this environment has zero egress, so construction
    fails with a clear error if the model isn't on disk. Runs on
    `device`: CUDA unless the caller names the CPU (asking for CUDA
    without it raises DeviceUnavailable once the weights are found)."""

    def __init__(self, model_name: str = "BAAI/bge-small-en-v1.5",
                 device="cuda"):
        try:
            # sentence_transformers silently RANDOM-INITIALIZES a model
            # when the name looks like a known architecture but no
            # weights are cached ("No modules.json found ...") — which
            # would mean garbage, per-process-different embeddings.
            # Require actual weights: a local model directory, or a
            # cached hub snapshot.
            if not os.path.isdir(model_name):
                from huggingface_hub import snapshot_download
                snapshot_download(model_name, local_files_only=True)
        except Exception as e:  # noqa: BLE001
            raise EmbeddingError(
                f"cannot load {model_name} (offline?): {e}") from e
        dev = resolve_device(device)
        try:
            from sentence_transformers import SentenceTransformer
            self._model = SentenceTransformer(model_name, device=str(dev),
                                              local_files_only=True)
        except Exception as e:  # noqa: BLE001
            raise EmbeddingError(
                f"cannot load {model_name} (offline?): {e}") from e
        self._name = model_name
        self._dim = int(self._model.get_sentence_embedding_dimension())

    @property
    def dimension(self) -> int:
        return self._dim

    @property
    def model_name(self) -> str:
        return self._name

    def embed(self, text: str) -> np.ndarray:
        return self.embed_batch([text])[0]

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self._dim), dtype=np.float32)
        out = self._model.encode(list(texts), normalize_embeddings=True,
                                 convert_to_numpy=True)
        return out.astype(np.float32)


#: bytes of activations one encoder forward may hold (see chunk_rows)
ACTIVATION_BUDGET_BYTES = 2 << 30


def chunk_rows(cfg, seq: int, *, plain_attention: bool) -> int:
    """Rows of length `seq` a forward of `cfg` takes at once: the
    activation budget over the bytes a token holds. On the card that is
    4 * (6h + 2 * intermediate), more than the forward holds at once (its
    peak is the FFN's two [T, intermediate] tensors beside x, or the
    [T, 3h] product beside x, the context and the residual): 21.5 KB at
    BGE-small, so 195 rows at S = 512 and 780 at S = 128. The plain
    attention (`plain_attention`, the CPU's) also holds [H, S, S] float32
    scores for each row, and their softmax: three such tensors are
    counted, 4 * 3 * heads * S bytes more a token, so 44 rows at S = 512
    and 420 at S = 128."""
    per_token = 4 * (6 * cfg.hidden + 2 * cfg.intermediate)
    if plain_attention:
        per_token += 4 * 3 * cfg.heads * seq
    return max(1, ACTIVATION_BUDGET_BYTES // (per_token * max(seq, 1)))


class TorchEncoderEmbedder(EmbeddingService):
    """The BERT-class encoder (models/encoder.py::BertEncoder) on a
    torch device: the counterpart of the reference's JaxEncoderEmbedder.

    `weights_npz` is a converted checkpoint (models.encoder.save_npz);
    `tokenizer` is a tokenizer dir (its vocab.txt through the in-repo
    WordPiece, else an HF tokenizer loaded offline-only) or a callable
    texts -> (input_ids, attention_mask); without one, the npz's embedded
    vocab. Rows are truncated to max_position, as in the reference.

    The reference pads S to a power-of-two bucket and B to a power of
    two so that XLA's compiled programs are reused; torch runs eagerly,
    so a batch is padded only to its longest row. A large batch runs in
    chunks of `chunk_rows(max_position)` rows, each padded to its own
    longest row: every row's embedding is the same (padding is masked),
    and the forward's activations stay within ACTIVATION_BUDGET_BYTES on
    either device.
    """

    def __init__(self, weights_npz: str, tokenizer=None,
                 name: Optional[str] = None, *, device="cuda"):
        from ..models.encoder import BertEncoder, load_npz, load_npz_tokenizer
        params, self._cfg = load_npz(weights_npz)
        self._name = name or f"flax:{weights_npz}"
        if callable(tokenizer):
            self._tok = tokenizer
        elif tokenizer is not None:
            self._tok = self._load_dir_tokenizer(tokenizer)
        else:
            wp = load_npz_tokenizer(weights_npz)
            if wp is None:
                raise EmbeddingError(
                    f"{weights_npz} has no embedded vocab — re-run "
                    "cortex_tpu_torch.models.convert or pass tokenizer= "
                    "explicitly")
            self._tok = self._wrap_wordpiece(wp)
        # one upload of the weights
        self._model = BertEncoder.from_params(params, self._cfg,
                                              device=device)

    def _wrap_wordpiece(self, wp):
        def _tok(texts):
            return wp.encode_batch(list(texts),
                                   max_length=self._cfg.max_position)
        return _tok

    def _load_dir_tokenizer(self, tokenizer):
        if (os.path.isdir(tokenizer)
                and os.path.exists(os.path.join(tokenizer, "vocab.txt"))):
            from ..models.tokenizer import WordPieceTokenizer
            return self._wrap_wordpiece(
                WordPieceTokenizer.from_model_dir(tokenizer))
        try:
            from transformers import AutoTokenizer
            hf = AutoTokenizer.from_pretrained(tokenizer,
                                               local_files_only=True)
        except Exception as e:  # noqa: BLE001
            raise EmbeddingError(
                f"cannot load tokenizer {tokenizer}: {e}") from e

        def _hf_tok(texts):
            enc = hf(list(texts), padding=True, truncation=True,
                     max_length=self._cfg.max_position,
                     return_tensors="np")
            return enc["input_ids"], enc["attention_mask"]
        return _hf_tok

    @property
    def dimension(self) -> int:
        return self._cfg.hidden

    @property
    def model_name(self) -> str:
        return self._name

    @property
    def model(self):
        """The BertEncoder module (its device is the embedder's)."""
        return self._model

    def chunk_rows(self, seq: int) -> int:
        """`chunk_rows` for this model on its device (the kernels on the
        card, the plain versions on the CPU)."""
        return chunk_rows(self._cfg, seq,
                          plain_attention=self._model.device.type != "cuda")

    def embed(self, text: str) -> np.ndarray:
        return self.embed_batch([text])[0]

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        """Texts in chunks of chunk_rows(max_position) rows, each
        tokenized on the host while the previous one's forward runs."""
        step = self.chunk_rows(self._cfg.max_position)
        return self._run(self._tok(texts[i:i + step])
                         for i in range(0, len(texts), step))

    def embed_tokens(self, ids, mask) -> np.ndarray:
        """[B, S] token ids and 0/1 mask -> [B, hidden] embeddings, in
        embed_batch's chunks."""
        ids, mask = np.asarray(ids), np.asarray(mask)
        step = self.chunk_rows(self._cfg.max_position)
        return self._run((ids[i:i + step], mask[i:i + step])
                         for i in range(0, len(ids), step))

    def _run(self, chunks) -> np.ndarray:
        """The forwards of an iterable of (ids, mask) chunks, each
        enqueued before the next chunk is made. The previous chunk is
        fetched before the next one is enqueued: a fetch after it would
        wait for its forward too."""
        out, pending = [], None
        for ids, mask in chunks:
            if pending is not None:
                out.append(pending.cpu().numpy())
            pending = self._forward(ids, mask)
        if pending is None:
            return np.zeros((0, self.dimension), dtype=np.float32)
        out.append(pending.cpu().numpy())
        return np.concatenate(out)

    def _forward(self, ids, mask) -> torch.Tensor:
        """The forward of [B, S] ids, truncated to max_position and cut
        to the longest row, enqueued on the model's device: [B, hidden]."""
        ids = np.asarray(ids, np.int32)[:, :self._cfg.max_position]
        mask = np.asarray(mask, np.int32)[:, :self._cfg.max_position]
        cols = np.flatnonzero(mask.any(axis=0))
        s = int(cols[-1]) + 1 if len(cols) else 1
        dev = self._model.device
        return self._model(
            torch.from_numpy(np.ascontiguousarray(ids[:, :s])).to(dev),
            torch.from_numpy(np.ascontiguousarray(mask[:, :s])).to(dev))


def _model_cache_dir() -> str:
    return os.environ.get(
        "CORTEX_MODEL_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "cortex_tpu"))


def _device_embedder_for(model: str,
                         device="cuda") -> Optional[EmbeddingService]:
    """Serve an HF model name from the DEVICE encoder when its weights
    exist locally: use a previously converted npz from the model cache,
    or auto-convert a local HF snapshot once (the reference's order: the
    encoder is the serving default whenever weights exist)."""
    from ..models.convert import convert, resolve_local_model
    src = resolve_local_model(model)
    slug = re.sub(r"[^a-zA-Z0-9_.-]+", "--", model)
    npz = os.path.join(_model_cache_dir(), f"{slug}.npz")
    try:
        if not os.path.exists(npz):
            if src is None:
                return None          # no weights anywhere on disk
            os.makedirs(_model_cache_dir(), exist_ok=True)
            convert(model, npz)
        if src is None:
            return None              # npz without tokenizer is unusable
        # name by the logical model, not the cache path, so linker
        # config-change detection stays stable across machines
        return TorchEncoderEmbedder(npz, tokenizer=src, name=f"flax:{model}",
                                    device=device)
    except (EmbeddingError, OSError):
        return None


def default_embedder(model: str = "", dim: int = 384, *,
                     device="cuda") -> EmbeddingService:
    """Build the configured embedder; fall back to hashing when model
    weights are unavailable (offline envs), as the reference does.

    Model schemes: "hash"/"hash-<dim>" (deterministic),
    "flax:<weights.npz>[::<tokenizer>]" (the device encoder). Any other
    name is treated as an HF model: if its weights exist locally they
    are converted once and served from the device encoder; otherwise
    sentence-transformers is tried; otherwise hashing. The encoder and
    sentence-transformers run on `device` (CUDA unless the caller names
    the CPU; asking for CUDA without it raises DeviceUnavailable).
    """
    if model.startswith("flax:"):
        spec = model[len("flax:"):]
        weights, _, tok = spec.partition("::")
        try:
            return TorchEncoderEmbedder(weights, tokenizer=tok or None,
                                        device=device)
        except EmbeddingError:
            pass
    elif model and not model.startswith("hash"):
        dev = _device_embedder_for(model, device)
        if dev is not None:
            return dev
        try:
            return STEmbedder(model, device=device)
        except EmbeddingError:
            pass
    if model.startswith("hash-"):
        dim = int(model.split("-", 1)[1])
    return HashingEmbedder(dim=dim)
