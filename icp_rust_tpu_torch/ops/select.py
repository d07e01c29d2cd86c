"""Exact masked order statistics via radix select, no sort.

The reference computes its robust scale from medians via quickselect
(src/stats.rs:11-28).  Radix select maps floats to integer keys with the
same total order, then narrows the candidate set one 8-bit digit at a time
using masked 256-bin histograms (4 passes for float32, 8 for float64).
After the last pass the surviving candidates share one full key, whose
float value is the k-th order statistic, exact to the bit.

Keys are kept in int64 for both float widths: the float's bit pattern as
a signed integer, with every bit but the sign flipped for negatives, has
the float order; the top digit's sign bit is flipped so that every digit
orders as an unsigned byte.
"""

from __future__ import annotations

import torch
from torch import Tensor


def _order_keys(x: Tensor):
    """Monotone map float -> int64 with the same total order (-0 < +0,
    +inf above every finite value); returns (keys, nbits)."""
    if x.dtype == torch.float32:
        s = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(s < 0, s ^ 0x7FFFFFFF, s), 32
    if x.dtype == torch.float64:
        s = x.contiguous().view(torch.int64)
        return torch.where(s < 0, s ^ 0x7FFFFFFFFFFFFFFF, s), 64
    raise TypeError(f"radix select takes float32 or float64, got {x.dtype}")


def kth_smallest_masked(x: Tensor, mask: Tensor, k: Tensor,
                        digit_bits: int = 8) -> Tensor:
    """Exact k-th smallest (0-based) of the mask-true lanes of x.

    x: (..., N); mask: (..., N) bool; k: (...,) integer with
    0 <= k < count(mask).  Returns (...,) with x.dtype; undefined where
    the count is 0 or k is out of range (callers gate on validity).
    """
    keys, nbits = _order_keys(x)
    batch = x.shape[:-1]
    n = x.shape[-1]
    keys = keys.reshape(-1, n)
    cand = mask.reshape(-1, n)
    r = k.reshape(-1).to(torch.int64)
    nbins = 1 << digit_bits
    bmask = nbins - 1
    top_flip = 1 << (digit_bits - 1)
    for p in range(nbits // digit_bits):
        shift = nbits - digit_bits * (p + 1)
        digit = (keys >> shift) & bmask
        if p == 0:
            digit = digit ^ top_flip
        hist = torch.zeros(keys.shape[0], nbins, dtype=torch.int64,
                           device=x.device)
        hist.scatter_add_(1, digit, cand.to(torch.int64))
        cum = torch.cumsum(hist, dim=-1)
        # Selected bin: the first with cum > r.
        sel = torch.argmax((cum > r[:, None]).to(torch.int8), dim=-1)
        below = torch.where(
            sel > 0,
            torch.gather(cum, 1, torch.clamp(sel - 1, min=0)[:, None])[:, 0],
            torch.zeros_like(sel),
        )
        r = r - below
        cand = cand & (digit == sel[:, None])
    # All surviving candidates carry the identical key -> same value.
    big = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    out = torch.amin(torch.where(cand, x.reshape(-1, n), big), dim=-1)
    return out.reshape(batch)


def masked_median_radix(x: Tensor, mask: Tensor):
    """Median over the last axis counting only mask-true lanes; returns
    (median, valid).  Even counts average the two central order stats
    (reference src/stats.rs:18-27); the lower one is the max of the
    elements below the upper one when exactly h of them are below it,
    else a duplicate of it."""
    n = torch.sum(mask, dim=-1)
    valid = n > 0
    h = torch.div(n, 2, rounding_mode="floor")
    v_hi = kth_smallest_masked(x, mask, torch.clamp(h, min=0))
    less = mask & (x < v_hi[..., None])
    cnt_less = torch.sum(less, dim=-1)
    neg_inf = torch.tensor(float("-inf"), dtype=x.dtype, device=x.device)
    vmax_less = torch.amax(torch.where(less, x, neg_inf), dim=-1)
    v_lo = torch.where(cnt_less == h, vmax_less, v_hi)
    odd = (n % 2) == 1
    med = torch.where(odd, v_hi, 0.5 * (v_lo + v_hi))
    return torch.where(valid, med, torch.zeros_like(med)), valid
