"""RMSNorm, computed in float32 whatever the activation dtype (bf16
accumulation of the mean-square visibly perturbs logits)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
             unit_offset: bool = False) -> torch.Tensor:
    """Root-mean-square layer norm (no mean-centering, no bias).

    Normalize in fp32, scale by ``weight``, cast back.  ``unit_offset``
    selects the Gemma convention: effective scale ``1 + weight``.
    """
    dtype = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    x32 = x32 * (1.0 / torch.sqrt(var + eps))
    w32 = weight.float()
    if unit_offset:
        w32 = 1.0 + w32
    return (x32 * w32).to(dtype)
