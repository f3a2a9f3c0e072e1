"""Text encoder of the port: the BERT-class tower (BGE-small /
MiniLM class) on torch.

Counterpart of cortex_tpu/models/encoder.py. The numpy side is the
reference's, copied as it is (`BertEncoderConfig`, `init_params`,
`convert_hf_state_dict`, `save_npz`, `load_npz`, `load_npz_tokenizer`;
tests/test_torch_encoder.py holds the copy), so an npz written by
either package opens in the other.

The torch side replaces the reference's jitted `_forward` (line 231):

    x = LN(word_emb[ids] + pos_emb[:S] + type_emb[0])
    per layer:  q, k, v = x @ Wq + bq, x @ Wk + bk, x @ Wv + bv
                ctx = softmax(q k^T / sqrt(dh) + mask_bias) v
                x = LN(x + ctx @ Wo + bo)
                x = LN(x + gelu(x @ W1 + b1) @ W2 + b2)      (exact erf)
    pooled = x[:, 0] (cls) or the masked mean; then L2 with a 1e-12 floor

`BertEncoder.from_params` uploads the reference's numpy pytree once (as
the reference's `device_params` does). The products are `F.linear` in
float32 (cuBLAS on the card, under torch's default full-fp32 matmul
precision; this module never changes it), with Q, K and V as one
[h, 3h] product. The other device programs are hand-written kernels
(ops/encoder.py): the embedding's gather, sums and LayerNorm in one
launch (`embed_layer_norm`, E1's embedding form), and in each layer the
residual + LayerNorm (E1) and the masked attention (E2), which reads Q,
K and V in place from the [T, 3h] product and writes the context as
[T, h], so no transpose runs between the products.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.encoder import (add_layer_norm, embed_layer_norm,
                           masked_attention)
from ..utils.device import resolve_device


@dataclass(frozen=True)
class BertEncoderConfig:
    vocab_size: int = 30522
    hidden: int = 384              # BGE-small-en-v1.5
    layers: int = 12
    heads: int = 12
    intermediate: int = 1536
    max_position: int = 512
    type_vocab: int = 2
    layernorm_eps: float = 1e-12
    pooling: str = "cls"           # 'cls' | 'mean'


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def init_params(cfg: BertEncoderConfig, seed: int = 0) -> Dict:
    """Random init (testing / from-scratch training)."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return rng.normal(0.0, 0.02, size=shape).astype(np.float32)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def ones(*shape):
        return np.ones(shape, np.float32)

    p = {
        "word_emb": w(cfg.vocab_size, cfg.hidden),
        "pos_emb": w(cfg.max_position, cfg.hidden),
        "type_emb": w(cfg.type_vocab, cfg.hidden),
        "emb_ln_g": ones(cfg.hidden), "emb_ln_b": zeros(cfg.hidden),
        "layers": [],
    }
    for _ in range(cfg.layers):
        p["layers"].append({
            "q_w": w(cfg.hidden, cfg.hidden), "q_b": zeros(cfg.hidden),
            "k_w": w(cfg.hidden, cfg.hidden), "k_b": zeros(cfg.hidden),
            "v_w": w(cfg.hidden, cfg.hidden), "v_b": zeros(cfg.hidden),
            "attn_out_w": w(cfg.hidden, cfg.hidden),
            "attn_out_b": zeros(cfg.hidden),
            "attn_ln_g": ones(cfg.hidden), "attn_ln_b": zeros(cfg.hidden),
            "ffn_in_w": w(cfg.hidden, cfg.intermediate),
            "ffn_in_b": zeros(cfg.intermediate),
            "ffn_out_w": w(cfg.intermediate, cfg.hidden),
            "ffn_out_b": zeros(cfg.hidden),
            "ffn_ln_g": ones(cfg.hidden), "ffn_ln_b": zeros(cfg.hidden),
        })
    return p


def convert_hf_state_dict(state_dict, cfg: BertEncoderConfig) -> Dict:
    """Map a HuggingFace `BertModel` (torch) state_dict to our pytree.
    torch Linear stores [out, in]; our forward does x @ W, so transpose.
    """
    def t(name):
        v = state_dict[name]
        try:
            v = v.detach().cpu().numpy()
        except AttributeError:
            v = np.asarray(v)
        return v.astype(np.float32)

    p = {
        "word_emb": t("embeddings.word_embeddings.weight"),
        "pos_emb": t("embeddings.position_embeddings.weight"),
        "type_emb": t("embeddings.token_type_embeddings.weight"),
        "emb_ln_g": t("embeddings.LayerNorm.weight"),
        "emb_ln_b": t("embeddings.LayerNorm.bias"),
        "layers": [],
    }
    for i in range(cfg.layers):
        pre = f"encoder.layer.{i}."
        p["layers"].append({
            "q_w": t(pre + "attention.self.query.weight").T,
            "q_b": t(pre + "attention.self.query.bias"),
            "k_w": t(pre + "attention.self.key.weight").T,
            "k_b": t(pre + "attention.self.key.bias"),
            "v_w": t(pre + "attention.self.value.weight").T,
            "v_b": t(pre + "attention.self.value.bias"),
            "attn_out_w": t(pre + "attention.output.dense.weight").T,
            "attn_out_b": t(pre + "attention.output.dense.bias"),
            "attn_ln_g": t(pre + "attention.output.LayerNorm.weight"),
            "attn_ln_b": t(pre + "attention.output.LayerNorm.bias"),
            "ffn_in_w": t(pre + "intermediate.dense.weight").T,
            "ffn_in_b": t(pre + "intermediate.dense.bias"),
            "ffn_out_w": t(pre + "output.dense.weight").T,
            "ffn_out_b": t(pre + "output.dense.bias"),
            "ffn_ln_g": t(pre + "output.LayerNorm.weight"),
            "ffn_ln_b": t(pre + "output.LayerNorm.bias"),
        })
    return p


def save_npz(path: str, params: Dict, cfg: BertEncoderConfig,
             vocab=None, do_lower_case: bool = True) -> None:
    """Serialize the encoder pytree (+ optionally the WordPiece vocab,
    making the npz a COMPLETE offline embedder — tokenizer included,
    see models.tokenizer)."""
    flat = {
        "_cfg": np.array([cfg.vocab_size, cfg.hidden, cfg.layers,
                          cfg.heads, cfg.intermediate, cfg.max_position,
                          cfg.type_vocab], np.int64),
        "_pooling": np.array([0 if cfg.pooling == "cls" else 1], np.int64),
        # eps must round-trip: checkpoints with layer_norm_eps=1e-5
        # would otherwise silently serve with the 1e-12 default and
        # diverge from the torch reference the conversion verified
        "_eps": np.array([cfg.layernorm_eps], np.float64),
    }
    if vocab is not None:
        flat["_vocab"] = np.array(list(vocab), dtype=np.str_)
        flat["_tok_lower"] = np.array([1 if do_lower_case else 0],
                                      np.int64)
    for k, v in params.items():
        if k == "layers":
            for i, lyr in enumerate(v):
                for lk, lv in lyr.items():
                    flat[f"layer{i}.{lk}"] = lv
        else:
            flat[k] = v
    np.savez_compressed(path, **flat)


def load_npz(path: str):
    z = np.load(path)
    c = z["_cfg"]
    cfg = BertEncoderConfig(
        vocab_size=int(c[0]), hidden=int(c[1]), layers=int(c[2]),
        heads=int(c[3]), intermediate=int(c[4]), max_position=int(c[5]),
        type_vocab=int(c[6]),
        pooling="cls" if int(z["_pooling"][0]) == 0 else "mean",
        # older checkpoints predate _eps: they were produced from the
        # 1e-12 default, so the fallback is faithful for them
        layernorm_eps=(float(z["_eps"][0]) if "_eps" in z.files
                       else 1e-12))
    params = {"layers": [dict() for _ in range(cfg.layers)]}
    for k in z.files:
        if k.startswith("_"):
            continue
        if k.startswith("layer"):
            idx, lk = k.split(".", 1)
            params["layers"][int(idx[5:])][lk] = z[k]
        else:
            params[k] = z[k]
    return params, cfg


def load_npz_tokenizer(path: str):
    """WordPieceTokenizer from the npz's embedded vocab, or None when
    the checkpoint predates vocab embedding."""
    z = np.load(path)
    if "_vocab" not in z.files:
        return None
    from .tokenizer import WordPieceTokenizer
    lower = bool(z["_tok_lower"][0]) if "_tok_lower" in z.files else True
    return WordPieceTokenizer([str(t) for t in z["_vocab"]],
                              do_lower_case=lower)


# ---------------------------------------------------------------------------
# forward (torch)
# ---------------------------------------------------------------------------


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


class _Layer(nn.Module):
    """One encoder layer's weights, in F.linear's [out, in] layout."""

    def __init__(self, lp: Dict, device):
        super().__init__()
        qkv_w = np.concatenate([lp["q_w"], lp["k_w"], lp["v_w"]], axis=1)
        qkv_b = np.concatenate([lp["q_b"], lp["k_b"], lp["v_b"]])
        for name, a in (("qkv_w", qkv_w.T), ("qkv_b", qkv_b),
                        ("out_w", lp["attn_out_w"].T),
                        ("out_b", lp["attn_out_b"]),
                        ("attn_ln_g", lp["attn_ln_g"]),
                        ("attn_ln_b", lp["attn_ln_b"]),
                        ("ffn_in_w", lp["ffn_in_w"].T),
                        ("ffn_in_b", lp["ffn_in_b"]),
                        ("ffn_out_w", lp["ffn_out_w"].T),
                        ("ffn_out_b", lp["ffn_out_b"]),
                        ("ffn_ln_g", lp["ffn_ln_g"]),
                        ("ffn_ln_b", lp["ffn_ln_b"])):
            self.register_buffer(name, _tensor(a, device))

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor, heads: int,
                eps: float) -> torch.Tensor:
        """x [B*S, h] -> [B*S, h] (`_encoder_layer`, reference line 206)."""
        b, s = mask_bias.shape
        h = x.shape[1]
        qkv = F.linear(x, self.qkv_w, self.qkv_b).view(b, s, 3, heads,
                                                       h // heads)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
        ctx = masked_attention(q, k, v, mask_bias)           # [B, H, S, dh]
        ctx = ctx.transpose(1, 2).reshape(b * s, h)
        x = add_layer_norm(x, F.linear(ctx, self.out_w, self.out_b),
                           self.attn_ln_g, self.attn_ln_b, eps)
        ffn = F.gelu(F.linear(x, self.ffn_in_w, self.ffn_in_b),
                     approximate="none")
        return add_layer_norm(x, F.linear(ffn, self.ffn_out_w,
                                          self.ffn_out_b),
                              self.ffn_ln_g, self.ffn_ln_b, eps)


class BertEncoder(nn.Module):
    """The encoder on one device: `forward(input_ids, attention_mask)`
    ([B, S] integer ids and 0/1 mask) -> [B, hidden] L2-normalized
    float32 embeddings, the reference's `_forward`."""

    def __init__(self, params: Dict, cfg: BertEncoderConfig, device):
        super().__init__()
        self.cfg = cfg
        for name in ("word_emb", "pos_emb", "type_emb", "emb_ln_g",
                     "emb_ln_b"):
            self.register_buffer(name, _tensor(params[name], device))
        self.layers = nn.ModuleList(_Layer(lp, device)
                                    for lp in params["layers"])

    @classmethod
    def from_params(cls, params: Dict, cfg: BertEncoderConfig, *,
                    device="cuda") -> "BertEncoder":
        """Upload the reference's numpy param pytree (init_params,
        load_npz, convert_hf_state_dict) to `device` once."""
        return cls(params, cfg, resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.word_emb.device

    @torch.no_grad()
    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, s = input_ids.shape
        if b == 0:
            return self.word_emb.new_zeros((0, cfg.hidden))
        x = embed_layer_norm(input_ids, self.word_emb, self.pos_emb,
                             self.type_emb[0], self.emb_ln_g, self.emb_ln_b,
                             cfg.layernorm_eps)
        mask_bias = torch.where(attention_mask > 0, 0.0, -1e30).to(
            torch.float32)
        for layer in self.layers:
            x = layer(x, mask_bias, cfg.heads, cfg.layernorm_eps)
        x = x.view(b, s, cfg.hidden)
        if cfg.pooling == "cls":
            pooled = x[:, 0, :]
        else:
            m = attention_mask[:, :, None].to(x.dtype)
            pooled = torch.sum(x * m, dim=1) / torch.clamp_min(
                torch.sum(m, dim=1), 1e-9)
        return pooled / torch.clamp_min(
            torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), 1e-12)


def bert_encode(module: BertEncoder, input_ids: np.ndarray,
                attention_mask: np.ndarray) -> np.ndarray:
    """[B, S] int ids + mask -> [B, hidden] L2-normalized float32
    embeddings (numpy), one forward on the module's device."""
    dev = module.device
    ids = torch.as_tensor(np.asarray(input_ids, np.int32)).to(dev)
    mask = torch.as_tensor(np.asarray(attention_mask, np.int32)).to(dev)
    return module(ids, mask).cpu().numpy()
