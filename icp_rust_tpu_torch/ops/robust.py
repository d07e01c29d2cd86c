"""Masked order statistics: median, MAD, robust sigma.

Behavioral parity with reference src/stats.rs:

- the median of an even-length sample averages the two central order
  stats (src/stats.rs:23-27); odd-length takes element n/2;
- MAD = median(|x - median(x)|) (src/stats.rs:30-37);
- sigma = 1.482602218505602 * MAD (src/stats.rs:39-47);
- ``calc_stddevs`` computes sigma per residual dimension (src/stats.rs:49-60).

Medians are exact radix selects (ops/select.py).
"""

from __future__ import annotations

import torch
from torch import Tensor

from icp_rust_tpu_torch.ops.select import masked_median_radix

MAD_SCALE = 1.482602218505602  # 1 / PPF(0.75); reference src/stats.rs:42


def masked_median(x: Tensor, mask: Tensor):
    """Median over the last axis counting only ``mask``-true lanes;
    returns ``(median, valid)``, valid False iff no lane is true."""
    return masked_median_radix(x, mask)


def masked_mad(x: Tensor, mask: Tensor):
    """Median absolute deviation over the last axis."""
    med, valid = masked_median(x, mask)
    dev = torch.abs(x - med[..., None])
    mad, _ = masked_median(dev, mask)
    return mad, valid


def masked_stddev(x: Tensor, mask: Tensor):
    """Robust sigma = MAD_SCALE * MAD."""
    mad, valid = masked_mad(x, mask)
    return MAD_SCALE * mad, valid


def calc_stddevs(residuals: Tensor, mask: Tensor):
    """Per-dimension robust sigma of residuals.

    residuals: (..., N, D); mask: (..., N).  Returns (sigma (..., D),
    valid (...,)).
    """
    r = residuals.transpose(-1, -2)  # (..., D, N)
    m = mask[..., None, :].expand(r.shape)
    sigma, valid = masked_stddev(r, m)
    return sigma, valid[..., 0]
