"""The text encoder's row programs besides its products: the residual +
LayerNorm (E1), its embedding form, and the masked attention (E2).

Counterpart of the XLA fusions of cortex_tpu/models/encoder.py, which
has no Pallas kernel:

  * `add_layer_norm` (E1) replaces `_layer_norm` (line 200) with the
    residual add before it (lines 222-223 and 226-227): LN(x + r) * g +
    b over the last dimension, mean and biased variance in float32. x is
    [T, h]; r is [T, h], or [P, h] with T % P == 0, row t then taking
    r[t % P].
  * `embed_layer_norm` (E1's embedding form) replaces the embedding sum
    and its LayerNorm (lines 236-239): LN((word_emb[id] + pos_emb[s]) +
    type_row) * g + b for each token (s its position in its sequence),
    the sums in the reference's order, in one launch: no [T, h]
    embedding tensor is written or read. Ids outside the vocabulary are
    taken as the reference's jnp gather takes them, with no host sync: a
    negative id is wrapped once (id + V), then every id is clamped into
    [0, V - 1]; positions past P clamp to P - 1.
  * `masked_attention` (E2) replaces the attention lines 216-221:
    softmax(q k^T / sqrt(dh) + mask_bias[:, None, None, :]) v for q, k,
    v [B, H, S, dh] and mask_bias [B, S] (0 or -1e30). A masked key
    contributes exactly 0 to every row that has an unmasked key, as
    exp's underflow does in the reference. The kernel runs on the tensor
    cores in 3xTF32 (each fp32 operand split into a TF32 high part and
    its rest, three products per fp32 product), walks only the 32-key
    tiles that hold a kept key, and sets masked keys' K and V to zeros,
    so that a kept row does not depend on them, bit for bit.

Each wrapper dispatches on the tensors' device with exactly two
branches: CUDA tensors launch the hand-written kernel (csrc/
encoder_rows.cu, csrc/encoder_attn.cu; built at first use by
ops/build.py) and count the launch; CPU tensors run the plain torch
version beside it (`add_layer_norm_plain`, `embed_layer_norm_plain`,
`masked_attention_plain`), which the CPU tests hold to the reference and
chip_smoke.py holds each kernel against on the card. A CUDA launch
never falls back. On a CUDA call E1's two forms leave every argument
check to their op (csrc/encoder_rows_op.cpp), which raises the
ValueErrors the CPU checks here raise, so a call on the encoder's own
tensors (contiguous, 16-byte aligned) is checked once and copies
nothing.

Limits of the kernels (the plain versions take any shape): E1's forms
hold a row in a warp's registers as float4s, so they take h <= 1024
with h % 4 == 0 (every BERT width: 384, 768, 1024; kMaxWidth in
csrc/encoder_rows_op.cpp); E2 takes dh in ATTN_HEAD_DIMS and 1 <= S <=
MAX_ATTN_SEQ. A CUDA call outside them raises ValueError.
"""

from __future__ import annotations

import math

import torch

from .build import load_ops

#: E2's tile shape: k-steps of 8 over dh, Q's fragments in registers
ATTN_HEAD_DIMS = (32, 64)
#: E2 stages a sequence's mask row in shared memory and walks its 32-key
#: tiles from a 32-bit mask; BERT's max_position
MAX_ATTN_SEQ = 512


def _check_rows(x, r, g, b) -> None:
    if x.dim() != 2 or r.dim() != 2 or r.shape[1] != x.shape[1]:
        raise ValueError(f"add_layer_norm: x must be [T, h] and r [P, h], "
                         f"got {tuple(x.shape)} and {tuple(r.shape)}")
    t, h = x.shape
    if r.shape[0] == 0 or t % r.shape[0] != 0:
        raise ValueError(f"add_layer_norm: r's {r.shape[0]} rows do not "
                         f"divide x's {t}")
    for name, v in (("g", g), ("b", b)):
        if tuple(v.shape) != (h,):
            raise ValueError(f"add_layer_norm: {name} must be [{h}], got "
                             f"{tuple(v.shape)}")
    for name, v in (("x", x), ("r", r), ("g", g), ("b", b)):
        if v.dtype != torch.float32:
            raise ValueError(f"add_layer_norm: {name} must be float32, got "
                             f"{v.dtype}")
        if v.device != x.device:
            raise ValueError(f"add_layer_norm: {name} is on {v.device}, x "
                             f"on {x.device}")


def _check_embed(ids, word_emb, pos_emb, type_row, g, b) -> None:
    if ids.dim() != 2 or ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"embed_layer_norm: ids must be int32 or int64 "
                         f"[B, S], got {ids.dtype} {tuple(ids.shape)}")
    if (word_emb.dim() != 2 or pos_emb.dim() != 2
            or pos_emb.shape[1] != word_emb.shape[1]
            or word_emb.shape[0] == 0 or pos_emb.shape[0] == 0):
        raise ValueError(f"embed_layer_norm: word_emb must be [V, h] and "
                         f"pos_emb [P, h] with V, P >= 1, got "
                         f"{tuple(word_emb.shape)} and "
                         f"{tuple(pos_emb.shape)}")
    h = word_emb.shape[1]
    for name, v in (("type_row", type_row), ("g", g), ("b", b)):
        if tuple(v.shape) != (h,):
            raise ValueError(f"embed_layer_norm: {name} must be [{h}], got "
                             f"{tuple(v.shape)}")
    for name, v in (("word_emb", word_emb), ("pos_emb", pos_emb),
                    ("type_row", type_row), ("g", g), ("b", b)):
        if v.dtype != torch.float32:
            raise ValueError(f"embed_layer_norm: {name} must be float32, "
                             f"got {v.dtype}")
        if v.device != ids.device:
            raise ValueError(f"embed_layer_norm: {name} is on {v.device}, "
                             f"ids on {ids.device}")


def add_layer_norm(x: torch.Tensor, r: torch.Tensor, g: torch.Tensor,
                   b: torch.Tensor, eps: float) -> torch.Tensor:
    """E1: LN(x + r) * g + b, a new [T, h] float32 tensor."""
    if x.is_cuda:
        out = load_ops().add_layer_norm(x, r, g, b, eps)
        add_layer_norm.launches += 1
        return out
    _check_rows(x, r, g, b)
    if x.device.type == "cpu":
        return add_layer_norm_plain(x, r, g, b, eps)
    raise RuntimeError(f"add_layer_norm has no kernel for device "
                       f"{x.device}")


#: kernel launches since the last reset (chip_smoke.py reads it to show
#: the main path went through the kernel)
add_layer_norm.launches = 0


def _layer_norm(v, g, b, eps):
    """The reference's `_layer_norm` over the last dimension: mean,
    biased variance, (v - mu) / sqrt(var + eps) * g + b."""
    mu = torch.mean(v, dim=-1, keepdim=True)
    var = torch.mean(torch.square(v - mu), dim=-1, keepdim=True)
    return (v - mu) / torch.sqrt(var + eps) * g + b


def add_layer_norm_plain(x, r, g, b, eps):
    """`add_layer_norm` in plain torch, spelled as the reference's
    `_layer_norm`."""
    t, h = x.shape
    return _layer_norm((x.view(-1, r.shape[0], h) + r).view(t, h), g, b,
                       eps)


def embed_layer_norm(ids: torch.Tensor, word_emb: torch.Tensor,
                     pos_emb: torch.Tensor, type_row: torch.Tensor,
                     g: torch.Tensor, b: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """E1's embedding form: ids [B, S] -> LN((word_emb[id] + pos_emb[s]) +
    type_row) * g + b, a new [B * S, h] float32 tensor."""
    if ids.is_cuda:
        out = load_ops().embed_layer_norm(ids, word_emb, pos_emb, type_row,
                                          g, b, eps)
        embed_layer_norm.launches += 1
        return out
    _check_embed(ids, word_emb, pos_emb, type_row, g, b)
    if ids.device.type == "cpu":
        return embed_layer_norm_plain(ids, word_emb, pos_emb, type_row, g,
                                      b, eps)
    raise RuntimeError(f"embed_layer_norm has no kernel for device "
                       f"{ids.device}")


#: kernel launches since the last reset
embed_layer_norm.launches = 0


def embed_layer_norm_plain(ids, word_emb, pos_emb, type_row, g, b, eps):
    """`embed_layer_norm` in plain torch: the reference's gather (ids and
    positions clamped as jnp indexing clamps them), its sum
    (word + pos) + type, then `_layer_norm`."""
    bsz, s = ids.shape
    vocab, h = word_emb.shape
    idx = ids.long()
    idx = torch.where(idx < 0, idx + vocab, idx).clamp_(0, vocab - 1)
    pos = torch.arange(s, device=ids.device).clamp_(max=pos_emb.shape[0] - 1)
    v = (word_emb[idx] + pos_emb[pos]) + type_row
    return _layer_norm(v.view(bsz * s, h), g, b, eps)


def _check_attention(q, k, v, mask_bias) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"masked_attention: q, k and v must be one "
                         f"[B, H, S, dh] shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    bsz, _, s, _ = q.shape
    if tuple(mask_bias.shape) != (bsz, s):
        raise ValueError(f"masked_attention: mask_bias must be [{bsz}, {s}],"
                         f" got {tuple(mask_bias.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("mask_bias", mask_bias)):
        if t.dtype != torch.float32:
            raise ValueError(f"masked_attention: {name} must be float32, "
                             f"got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"masked_attention: {name} is on {t.device}, "
                             f"q on {q.device}")


def _rows_aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself when each of its rows starts on 16 bytes and is dense
    (the kernel's float4 loads), else a contiguous copy."""
    ok = (t.stride(3) == 1 and t.data_ptr() % 16 == 0
          and all(t.stride(i) % 4 == 0 for i in range(3)))
    return t if ok else t.contiguous()


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask_bias: torch.Tensor) -> torch.Tensor:
    """E2: [B, H, S, dh] float32 context. q, k and v may be strided
    views (the encoder passes views of its [T, 3h] product); on the card
    the result is a view of a [B, S, H, dh] tensor, so that
    `.transpose(1, 2).reshape(B * S, H * dh)` copies nothing."""
    _check_attention(q, k, v, mask_bias)
    dev = q.device
    if dev.type == "cuda":
        _, _, s, dh = q.shape
        if dh not in ATTN_HEAD_DIMS or not 1 <= s <= MAX_ATTN_SEQ:
            raise ValueError(
                f"masked_attention: the kernel takes dh in {ATTN_HEAD_DIMS} "
                f"and 1 <= S <= {MAX_ATTN_SEQ}, got dh {dh}, S {s}")
        out = load_ops().masked_attention(
            _rows_aligned(q), _rows_aligned(k), _rows_aligned(v),
            mask_bias.contiguous())
        masked_attention.launches += 1
        return out
    if dev.type == "cpu":
        return masked_attention_plain(q, k, v, mask_bias)
    raise RuntimeError(f"masked_attention has no kernel for device {dev}")


#: kernel launches since the last reset
masked_attention.launches = 0


def masked_attention_plain(q, k, v, mask_bias):
    """`masked_attention` in plain torch, the reference's lines:
    einsum, / sqrt(dh), + mask bias, softmax, einsum."""
    dh = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(dh)
    scores = scores + mask_bias[:, None, None, :]
    attn = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", attn, v)
