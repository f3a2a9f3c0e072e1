"""Published peaks of one NVIDIA H100 and the least time they allow.

The peaks are NVIDIA's data sheet for the SXM part (dense rates, no
sparsity), at its full 700 W power limit; the run reports the card's
limit beside every share.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12       # HBM3
INT8_OPS_PER_S = 1.979e15       # dense int8 tensor cores


def bound_ms(nbytes, ops, peak):
    """(ms, "bytes" or "operations"): the least time the card could
    take for a function that moves nbytes (each input read once, each
    output written once) and does ops operations of a type whose peak
    rate is `peak`."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")
