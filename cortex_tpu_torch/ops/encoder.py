"""The text encoder's two row programs besides its products: the
residual + LayerNorm (E1) and the masked attention (E2).

Counterpart of the XLA fusions of cortex_tpu/models/encoder.py, which
has no Pallas kernel:

  * `add_layer_norm` (E1) replaces `_layer_norm` (line 200) with the
    residual add before it (lines 222-223 and 226-227, and the
    embedding sum at 244-247): LN(x + r) * g + b over the last
    dimension, mean and biased variance in float32. x is [T, h]; r is
    [T, h], or [P, h] with T % P == 0, row t then taking r[t % P] (the
    embedding's position + type rows, [S, h], serve every sequence).
  * `masked_attention` (E2) replaces the attention lines 216-221:
    softmax(q k^T / sqrt(dh) + mask_bias[:, None, None, :]) v for q, k,
    v [B, H, S, dh] and mask_bias [B, S] (0 or -1e30). A masked key
    contributes exactly 0 to every row that has an unmasked key, as
    exp's underflow does in the reference. The kernel runs on the tensor
    cores in 3xTF32 (each fp32 operand split into a TF32 high part and
    its rest, three products per fp32 product), walks only the 32-key
    tiles that hold a kept key, and sets masked keys' K and V to zeros,
    so that a kept row does not depend on them, bit for bit.

Each wrapper checks its arguments, then dispatches on the tensors'
device with exactly two branches: CUDA tensors launch the hand-written
kernel (csrc/encoder_rows.cu, csrc/encoder_attn.cu; built at first use
by ops/build.py) and count the launch; CPU tensors run the plain torch
version beside it (`add_layer_norm_plain`, `masked_attention_plain`),
which the CPU tests hold to the reference and chip_smoke.py holds each
kernel against on the card. A CUDA launch never falls back.

Limits of the kernels (the plain versions take any shape): E1 takes
h <= MAX_LN_WIDTH with h % 4 == 0; E2 takes dh in ATTN_HEAD_DIMS and
1 <= S <= MAX_ATTN_SEQ. A CUDA call outside them raises ValueError.
"""

from __future__ import annotations

import math

import torch

from .build import load_ops

#: E1 holds a row in a warp's registers, float4s: at most 32 floats a
#: lane, h % 4 == 0 (every BERT width: 384, 768, 1024)
MAX_LN_WIDTH = 1024
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


def _dense_aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself when it is contiguous and starts on 16 bytes (the
    kernel's float4 loads), else a contiguous copy, which does."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def add_layer_norm(x: torch.Tensor, r: torch.Tensor, g: torch.Tensor,
                   b: torch.Tensor, eps: float) -> torch.Tensor:
    """E1: LN(x + r) * g + b, a new [T, h] float32 tensor."""
    _check_rows(x, r, g, b)
    dev = x.device
    if dev.type == "cuda":
        h = x.shape[1]
        if h > MAX_LN_WIDTH or h % 4 != 0:
            raise ValueError(f"add_layer_norm: the kernel takes h <= "
                             f"{MAX_LN_WIDTH} with h % 4 == 0, got {h}")
        out = load_ops().add_layer_norm(_dense_aligned(x), _dense_aligned(r),
                                        _dense_aligned(g), _dense_aligned(b),
                                        float(eps))
        add_layer_norm.launches += 1
        return out
    if dev.type == "cpu":
        return add_layer_norm_plain(x, r, g, b, eps)
    raise RuntimeError(f"add_layer_norm has no kernel for device {dev}")


#: kernel launches since the last reset (chip_smoke.py reads it to show
#: the main path went through the kernel)
add_layer_norm.launches = 0


def add_layer_norm_plain(x, r, g, b, eps):
    """`add_layer_norm` in plain torch, spelled as the reference's
    `_layer_norm`: mean, biased variance, (v - mu) / sqrt(var + eps)."""
    t, h = x.shape
    v = (x.view(-1, r.shape[0], h) + r).view(t, h)
    mu = torch.mean(v, dim=-1, keepdim=True)
    var = torch.mean(torch.square(v - mu), dim=-1, keepdim=True)
    return (v - mu) / torch.sqrt(var + eps) * g + b


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
