"""Pure-Python WordPiece tokenizer — zero-dependency serving path.

The reference's embedder ships with its own tokenizer inside fastembed
(crates/cortex-core/src/vector/embedding.rs:34-57: the ONNX pipeline
bundles tokenizer.json). The r2 device encoder had the weights offline
(models/convert.py npz) but still hard-required a HuggingFace tokenizer
at runtime, which cannot load in an offline image (VERDICT r2 #3). This
module implements the BERT tokenization algorithm directly — basic
tokenization (cleanup, CJK spacing, lowercase + accent strip,
punctuation split) followed by greedy longest-match WordPiece — so a
converted .npz (which now embeds the vocab, see convert.py) is a
COMPLETE embedder: tokenize -> encode -> search with no HF dependency.

Parity with `transformers.BertTokenizer` is locked by
tests/test_tokenizer.py over punctuation/accents/CJK/unknown/casing
batteries (transformers constructs from a local vocab file — no
network involved).
"""

from __future__ import annotations

import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
MAX_WORD_CHARS = 100      # transformers' max_input_chars_per_word


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges treated as punctuation even when unicode disagrees
    # ($, +, <, =, >, ^, `, |, ~) — matches transformers exactly
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


class WordPieceTokenizer:
    """BERT tokenizer: basic split + WordPiece, ids + attention mask."""

    def __init__(self, vocab: Dict[str, int] | Sequence[str], *,
                 do_lower_case: bool = True,
                 tokenize_chinese_chars: bool = True):
        if not isinstance(vocab, dict):
            vocab = {tok: i for i, tok in enumerate(vocab)}
        self.vocab: Dict[str, int] = dict(vocab)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.do_lower_case = do_lower_case
        self.tokenize_chinese_chars = tokenize_chinese_chars
        for tok in (PAD, UNK, CLS, SEP):
            if tok not in self.vocab:
                raise ValueError(f"vocab is missing required token {tok}")
        self.pad_id = self.vocab[PAD]
        self.unk_id = self.vocab[UNK]
        self.cls_id = self.vocab[CLS]
        self.sep_id = self.vocab[SEP]

    # ----------------------------------------------------------- basic split
    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _space_cjk(self, text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(token: str) -> str:
        return "".join(ch for ch in unicodedata.normalize("NFD", token)
                       if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _split_punct(token: str) -> List[str]:
        pieces: List[List[str]] = []
        start_new = True
        for ch in token:
            if _is_punctuation(ch):
                pieces.append([ch])
                start_new = True
            else:
                if start_new:
                    pieces.append([])
                    start_new = False
                pieces[-1].append(ch)
        return ["".join(p) for p in pieces]

    #: literal special tokens survive basic tokenization intact
    #: (transformers passes all_special_tokens as never_split) — text
    #: QUOTING one, e.g. 'see [SEP] above', must map to the special
    #: token id, not the pieces '[', 'sep', ']'
    NEVER_SPLIT = frozenset({PAD, UNK, CLS, SEP, MASK})

    def basic_tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        if self.tokenize_chinese_chars:
            text = self._space_cjk(text)
        tokens: List[str] = []
        for tok in text.split():
            if tok in self.NEVER_SPLIT:
                tokens.append(tok)
                continue
            if self.do_lower_case:
                tok = self._strip_accents(tok.lower())
            tokens.extend(t for t in self._split_punct(tok) if t)
        return tokens

    # ------------------------------------------------------------ wordpiece
    def wordpiece(self, token: str) -> List[str]:
        if len(token) > MAX_WORD_CHARS:
            return [UNK]
        pieces: List[str] = []
        start = 0
        while start < len(token):
            end = len(token)
            cur = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [UNK]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for tok in self.basic_tokenize(text):
            out.extend(self.wordpiece(tok))
        return out

    # -------------------------------------------------------------- encoding
    def encode(self, text: str, max_length: int = 512) -> List[int]:
        """[CLS] tokens [SEP], truncated to max_length."""
        ids = [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]
        ids = ids[:max_length - 2]
        return [self.cls_id] + ids + [self.sep_id]

    def encode_batch(self, texts: Iterable[str], max_length: int = 512,
                     pad_to: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(input_ids, attention_mask) int32 [B, L] padded to the
        longest sequence (or pad_to). Matches transformers'
        padding=True, truncation=True convention."""
        rows = [self.encode(t, max_length) for t in texts]
        ln = max((len(r) for r in rows), default=2)
        if pad_to is not None:
            ln = max(ln, pad_to)
        ids = np.full((len(rows), ln), self.pad_id, np.int32)
        mask = np.zeros((len(rows), ln), np.int32)
        for j, r in enumerate(rows):
            ids[j, :len(r)] = r
            mask[j, :len(r)] = 1
        return ids, mask

    def __call__(self, texts: Iterable[str], max_length: int = 512
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """The callable-tokenizer protocol JaxEncoderEmbedder accepts."""
        return self.encode_batch(texts, max_length)

    # ------------------------------------------------------------- load/save
    @property
    def vocab_list(self) -> List[str]:
        """Vocab as an id-ordered list (for npz embedding)."""
        return [self.ids_to_tokens[i] for i in range(len(self.vocab))]

    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        with open(path, encoding="utf-8") as f:
            toks = [line.rstrip("\n") for line in f if line.rstrip("\n")]
        return cls(toks, **kw)

    @classmethod
    def from_model_dir(cls, model_dir: str) -> "WordPieceTokenizer":
        """Load from an HF checkout: vocab.txt + tokenizer_config.json
        (for do_lower_case), no transformers import."""
        import json
        import os
        vocab_path = os.path.join(model_dir, "vocab.txt")
        lower = True
        cfg_path = os.path.join(model_dir, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            try:
                with open(cfg_path, encoding="utf-8") as f:
                    lower = bool(json.load(f).get("do_lower_case", True))
            except Exception:  # noqa: BLE001
                pass
        return cls.from_vocab_file(vocab_path, do_lower_case=lower)
