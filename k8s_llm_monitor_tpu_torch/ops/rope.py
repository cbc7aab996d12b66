"""Rotary position embeddings.

The "split-half" rotation (``rotate_half`` over concatenated halves), as
HuggingFace Llama/Qwen2 and the JAX package use it.  Angles are computed
and applied in float32, then cast back to the activation dtype.
"""

from __future__ import annotations

import functools
from typing import Mapping, Optional

import numpy as np
import torch


def _llama3_scale_inv_freq(
    inv_freq: np.ndarray, scaling: Mapping[str, float]
) -> np.ndarray:
    """Llama-3.1 ``rope_scaling`` (``rope_type: "llama3"``) frequency warp.

    Low frequencies (wavelength > low_freq_wavelen) are divided by
    ``factor``; high frequencies pass through; the band between
    interpolates smoothly.  Host-side numpy, like the JAX package, so the
    table is bit-identical to the reference's.
    """
    factor = float(scaling.get("factor", 8.0))
    low_freq_factor = float(scaling.get("low_freq_factor", 1.0))
    high_freq_factor = float(scaling.get("high_freq_factor", 4.0))
    old_ctx = float(scaling.get("original_max_position_embeddings", 8192))

    wavelen = 2.0 * np.pi / inv_freq
    low_freq_wavelen = old_ctx / low_freq_factor
    high_freq_wavelen = old_ctx / high_freq_factor

    smooth = (old_ctx / wavelen - low_freq_factor) / (
        high_freq_factor - low_freq_factor
    )
    smoothed = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
    out = np.where(wavelen > low_freq_wavelen, inv_freq / factor, inv_freq)
    mid = (wavelen <= low_freq_wavelen) & (wavelen >= high_freq_wavelen)
    return np.where(mid, smoothed, out).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _inv_freq(head_dim: int, theta: float, llama3: Optional[tuple],
              device: torch.device) -> torch.Tensor:
    """The [head_dim // 2] float32 frequency table on ``device`` (with the
    ``llama3`` scaling items, when given), computed in numpy once per
    table and device: a decode step captured into a CUDA graph may not
    copy from the host."""
    half = head_dim // 2
    inv_freq = 1.0 / (
        theta ** (np.arange(0, half, dtype=np.float32) / half)
    )
    if llama3 is not None:
        inv_freq = _llama3_scale_inv_freq(inv_freq, dict(llama3))
    return torch.from_numpy(np.asarray(inv_freq, np.float32)).to(device)


def rope_angles(
    positions: torch.Tensor,
    head_dim: int,
    theta: float,
    scaling: Optional[Mapping[str, float]] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for integer ``positions`` of any shape ``[...]``.

    ``scaling``: optional HF ``rope_scaling`` dict; ``"llama3"`` warps the
    frequencies, ``"linear"`` divides positions by ``factor``.

    Returns (cos, sin), float32 ``[..., head_dim]`` on ``positions``' device:
    the half-dim frequency table tiled twice (rotate_half convention).
    """
    pos = positions.to(torch.float32)
    kind = "default"
    if scaling:
        kind = scaling.get("rope_type", scaling.get("type", "default"))
        if kind == "linear":
            pos = pos / float(scaling.get("factor", 1.0))
        elif kind not in ("llama3", "default", None):
            raise NotImplementedError(f"rope_scaling type {kind!r}")
    freq = _inv_freq(head_dim, float(theta),
                     tuple(sorted(scaling.items())) if kind == "llama3"
                     else None, pos.device)
    ang = pos[..., None] * freq                       # [..., half]
    ang = torch.cat([ang, ang], dim=-1)               # [..., head_dim]
    return torch.cos(ang), torch.sin(ang)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> torch.Tensor:
    """Rotate ``x`` of shape ``[..., seq, heads, head_dim]``; cos/sin are
    ``[..., seq, head_dim]`` and broadcast over the heads axis."""
    dtype = x.dtype
    x32 = x.float()
    cos = cos[..., :, None, :]
    sin = sin[..., :, None, :]
    out = x32 * cos + _rotate_half(x32) * sin
    return out.to(dtype)
