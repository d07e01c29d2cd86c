"""Huber loss on *squared* errors, batched.

Behavioral parity with reference src/huber.rs:6-26; both functions take
the squared residual ``e``:

- ``rho(e, k) = e``                if e <= k^2, else ``2 k sqrt(e) - k^2``
- ``drho(e, k) = d rho / d e = 1`` if e <= k^2, else ``k / sqrt(e)``

``drho`` is the IRLS weight (reference src/lib.rs:250).
"""

from __future__ import annotations

import torch
from torch import Tensor


def rho(e: Tensor, k: float) -> Tensor:
    k2 = k * k
    safe_e = torch.clamp(e, min=0.0)
    return torch.where(e <= k2, e, 2.0 * k * torch.sqrt(safe_e) - k2)


def drho(e: Tensor, k: float) -> Tensor:
    k2 = k * k
    # Guard the unselected branch: for e < tiny the e <= k^2 branch wins,
    # but torch.where still evaluates k/sqrt(e).
    safe_e = torch.clamp(e, min=torch.finfo(e.dtype).tiny)
    return torch.where(e <= k2, torch.ones_like(e), k / torch.sqrt(safe_e))
