"""Weights from the JAX package's parameter pytree.

``params_from_jax`` takes the tree ``models/llama.py:init_params`` builds
(``embed.weight``, ``layers[i][name]["kernel"|"bias"]``, ``final_norm``,
``lm_head.kernel``), given as numpy arrays, and fills a ``LlamaModel``.  It
is the one place where the JAX ``[in, out]`` kernels become ``nn.Linear``'s
``[out, in]`` weights.
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


@torch.no_grad()
def params_from_jax(tree: dict[str, Any], cfg: ModelConfig, device=None,
                    dtype: Optional[torch.dtype] = None) -> LlamaModel:
    """A ``LlamaModel`` on ``device`` holding the weights of ``tree``."""
    model = LlamaModel(cfg, device=device, dtype=dtype, seed=None)
    dev, dt = model.device, model.embed.weight.dtype
    model.embed.weight.copy_(_t(tree["embed"]["weight"], dev, dt))
    model.final_norm.copy_(_t(tree["final_norm"], dev, dt))
    if not cfg.tie_embeddings:
        model.lm_head.weight.copy_(_t(tree["lm_head"]["kernel"], dev, dt).T)
    for layer, src in zip(model.layers, tree["layers"], strict=True):
        layer.input_norm.copy_(_t(src["input_norm"], dev, dt))
        layer.post_norm.copy_(_t(src["post_norm"], dev, dt))
        for name in _LINEARS:
            lin = getattr(layer, name)
            lin.weight.copy_(_t(src[name]["kernel"], dev, dt).T)
            if lin.bias is not None:
                lin.bias.copy_(_t(src[name]["bias"], dev, dt))
    return model
