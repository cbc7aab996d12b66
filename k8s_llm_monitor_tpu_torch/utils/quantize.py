"""Weight-only int8 quantization for the decoder LM (the JAX package's
``utils/quantize.py``).

Scheme: symmetric per-output-channel int8 in ``nn.Linear``'s layout,

    w_q[o, i] = round(w[o, i] / scale[o]),  scale[o] = max_i |w[o, i]| / 127

which is the JAX package's ``[in, out]`` scheme transposed.  The scale
commutes with the contraction, so ``models/llama.py:_linear`` multiplies
the [.., out] result by it and never builds a dequantized matrix.  The
embedding is quantized per vocab row.  Norms and biases stay in the model
dtype.  int8 halves the weight bytes decode streams per step, and under
``ModelConfig.act_quant`` (W8A8) the linears run s8 x s8 with int32 sums.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from k8s_llm_monitor_tpu_torch.models.config import ModelConfig
from k8s_llm_monitor_tpu_torch.models.llama import LlamaModel, QuantLinear

_EPS = 1e-12


def quantize_array(w: np.ndarray, axis: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric int8 quantization of ``w`` with scales over ``axis``.

    Host-side numpy (streaming checkpoint load must not touch the device).
    Returns (w_q int8 same shape, scale float32 with ``axis`` reduced).
    """
    w = np.asarray(w, np.float32)
    amax = np.max(np.abs(w), axis=axis)
    scale = np.maximum(amax / 127.0, _EPS).astype(np.float32)
    w_q = np.rint(w / np.expand_dims(scale, axis)).astype(np.int8)
    return w_q, scale


def _host_f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


@torch.no_grad()
def fill_quantized(codes: torch.Tensor, scale: torch.Tensor,
                   w: np.ndarray) -> None:
    """Quantize ``w`` [rows, cols] (float32, host) per row with
    ``quantize_array`` and copy the codes and scales into ``codes`` and
    ``scale`` (on any device)."""
    w_q, s = quantize_array(w, axis=1)
    codes.copy_(torch.from_numpy(w_q))
    scale.copy_(torch.from_numpy(s))


@torch.no_grad()
def quantize_params(model: LlamaModel) -> LlamaModel:
    """The int8 twin of ``model`` on its device: every linear and the
    embedding quantized on the host (``quantize_array``, so the codes and
    scales equal the JAX package's bit for bit); norms and biases copied
    in the model dtype."""
    q = LlamaModel(model.cfg, device=model.device, dtype=model.dtype,
                   seed=None, quantized=True)
    fill_quantized(q.embed.weight_q, q.embed.scale,
                   _host_f32(model.embed.weight))
    q.final_norm.copy_(model.final_norm)
    pairs = [(model.lm_head, q.lm_head)] if q.lm_head is not None else []
    for src, dst in zip(model.layers, q.layers, strict=True):
        dst.input_norm.copy_(src.input_norm)
        dst.post_norm.copy_(src.post_norm)
        pairs += [(getattr(src, n), getattr(dst, n))
                  for n in ("q", "k", "v", "o", "gate", "up", "down")]
    for src, dst in pairs:
        fill_quantized(dst.weight_q, dst.scale, _host_f32(src.weight))
        if src.bias is not None:
            dst.bias.copy_(src.bias)
    return q


@torch.no_grad()
def init_params_quantized(cfg: ModelConfig, seed: int = 0,
                          device=None) -> LlamaModel:
    """Random int8 weights drawn directly on ``device`` (default ``cuda``)
    from a seeded ``torch.Generator``, so an 8B-class model never exists in
    bf16 there.  Codes uniform in [-127, 127]; scales as the JAX package
    sets them, the magnitude ``LlamaModel``'s bf16 init would give (kernel
    std ``in**-0.5``, embed std 0.02, amax about 3 std): ``3 * in**-0.5 /
    127`` per linear and ``3 * 0.02 / 127`` for the embedding.  Unit norms,
    zero biases.  The draws differ from the JAX package's ``PRNGKey``."""
    model = LlamaModel(cfg, device=device, seed=None, quantized=True)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    model.embed.weight_q.random_(-127, 128, generator=gen)
    model.embed.scale.fill_(3.0 * 0.02 / 127.0)
    for lin in model.modules():
        if isinstance(lin, QuantLinear):
            lin.weight_q.random_(-127, 128, generator=gen)
            lin.scale.fill_(3.0 * (lin.in_features ** -0.5) / 127.0)
    return model


def param_bytes(model: nn.Module) -> int:
    """Total weight bytes as stored (int8 codes count 1 byte each)."""
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))
