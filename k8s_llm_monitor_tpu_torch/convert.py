"""Weights from the JAX package's parameter pytree.

``params_from_jax`` takes the tree ``models/llama.py:init_params`` builds
(``embed.weight``, ``layers[i][name]["kernel"|"bias"]``, ``final_norm``,
``lm_head.kernel``), or its int8 twin from ``utils/quantize.py``
(``embed.weight_q`` / ``scale``, ``layers[i][name]["kernel_q"|"scale"]``),
given as numpy arrays, and fills a ``LlamaModel``.  It is the one place
where the JAX ``[in, out]`` kernels become ``nn.Linear``'s ``[out, in]``
weights.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from k8s_llm_monitor_tpu_torch.models.config import ModelConfig
from k8s_llm_monitor_tpu_torch.models.llama import LlamaModel

_LINEARS = ("q", "k", "v", "o", "gate", "up", "down")


def _t(x, device, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(
        device=device, dtype=dtype)


def _exact(x) -> torch.Tensor:
    """int8 codes and float32 scales as they are (a writable copy)."""
    return torch.from_numpy(np.array(x))


def _linear(lin, src: dict[str, Any], dev, dt) -> None:
    if "kernel_q" in src:
        lin.weight_q.copy_(_exact(src["kernel_q"]).T)
        lin.scale.copy_(_exact(src["scale"]))
    else:
        lin.weight.copy_(_t(src["kernel"], dev, dt).T)
    if lin.bias is not None:
        lin.bias.copy_(_t(src["bias"], dev, dt))


@torch.no_grad()
def params_from_jax(tree: dict[str, Any], cfg: ModelConfig, device=None,
                    dtype: Optional[torch.dtype] = None) -> LlamaModel:
    """A ``LlamaModel`` on ``device`` holding the weights of ``tree`` (an
    int8 model when the tree is quantized)."""
    quantized = "weight_q" in tree["embed"]
    model = LlamaModel(cfg, device=device, dtype=dtype, seed=None,
                       quantized=quantized)
    dev, dt = model.device, model.dtype
    if quantized:
        model.embed.weight_q.copy_(_exact(tree["embed"]["weight_q"]))
        model.embed.scale.copy_(_exact(tree["embed"]["scale"]))
    else:
        model.embed.weight.copy_(_t(tree["embed"]["weight"], dev, dt))
    model.final_norm.copy_(_t(tree["final_norm"], dev, dt))
    if not cfg.tie_embeddings:
        _linear(model.lm_head, tree["lm_head"], dev, dt)
    for layer, src in zip(model.layers, tree["layers"], strict=True):
        layer.input_norm.copy_(_t(src["input_norm"], dev, dt))
        layer.post_norm.copy_(_t(src["post_norm"], dev, dt))
        for name in _LINEARS:
            _linear(getattr(layer, name), src[name], dev, dt)
    return model
