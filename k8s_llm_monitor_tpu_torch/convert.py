"""Weights from the JAX package's parameter pytree.

``params_from_jax`` takes the tree ``models/llama.py:init_params`` builds
(``embed.weight``, ``layers[i][name]["kernel"|"bias"]``, ``final_norm``,
``lm_head.kernel``), or its int8 twin from ``utils/quantize.py``
(``embed.weight_q`` / ``scale``, ``layers[i][name]["kernel_q"|"scale"]``),
given as numpy arrays, and fills a ``LlamaModel``.  It is the one place
where the JAX ``[in, out]`` kernels become ``nn.Linear``'s ``[out, in]``
weights.  A mixture of experts' ``router`` kernel is transposed likewise;
its stacked expert kernels ``gate_e`` / ``up_e`` / ``down_e`` (``kernel``
or ``kernel_q`` + ``scale``) keep the JAX ``[E, in, out]`` layout
(``models/llama.py:ExpertStack``).  Gemma-2's sandwich norms
(``post_attn_norm``, ``post_mlp_norm``) are copied as the others.

Under a mesh (``mesh=``, parallel/mesh.py) each rank keeps its slice of
every full tensor (parallel/sharding.py), the shard the JAX package's
``NamedSharding`` puts on the device of the same index; rank 0 sends the
tree to the workers, which build theirs.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from k8s_llm_monitor_tpu_torch.models.config import ModelConfig
from k8s_llm_monitor_tpu_torch.models.llama import LlamaModel

_LINEARS = ("q", "k", "v", "o", "gate", "up", "down")
_EXPERTS = ("gate_e", "up_e", "down_e")


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


def _full(tree: dict[str, Any], name: str, dev, dt) -> torch.Tensor:
    """The TP-1 tensor of the port's parameter or buffer ``name`` from the
    JAX tree (kernels transposed to ``[out, in]``)."""
    parts = name.split(".")
    if parts[0] == "layers":
        src = tree["layers"][int(parts[1])]
        parts = parts[2:]
    else:
        src = tree
    leaf = parts[-1]
    node = src[parts[0]]
    if leaf.endswith("norm"):
        return _t(node, dev, dt)
    if parts[0] in _EXPERTS:
        # [E, in, out] as in the JAX tree; under a mesh the expert axis
        # is sliced (parallel/sharding.py).
        return (_t(node["kernel"], dev, dt) if leaf == "kernel"
                else _exact(node[leaf]))
    if leaf in ("weight_q", "scale"):
        key = leaf if parts[0] == "embed" else {
            "weight_q": "kernel_q", "scale": "scale"}[leaf]
        x = _exact(node[key])
        return x.T if key == "kernel_q" else x
    if leaf == "bias":
        return _t(node["bias"], dev, dt)
    if parts[0] == "embed":
        return _t(node["weight"], dev, dt)
    return _t(node["kernel"], dev, dt).T


@torch.no_grad()
def params_from_jax(tree: dict[str, Any], cfg: ModelConfig, device=None,
                    dtype: Optional[torch.dtype] = None,
                    mesh=None) -> LlamaModel:
    """A ``LlamaModel`` on ``device`` holding the weights of ``tree`` (an
    int8 model when the tree is quantized); under ``mesh`` the rank's
    shard of them."""
    quantized = "weight_q" in tree["embed"]
    model = LlamaModel(cfg, device=device, dtype=dtype, seed=None,
                       quantized=quantized, mesh=mesh)
    dev, dt = model.device, model.dtype
    if model.mesh is not None:
        model.fill_from_full(lambda name, _: _full(tree, name, dev, dt))
        if mesh.is_leader:
            model.mesh_token = mesh.build_on_workers("jax", tree, cfg,
                                                     dtype=dtype)
        return model
    if quantized:
        model.embed.weight_q.copy_(_exact(tree["embed"]["weight_q"]))
        model.embed.scale.copy_(_exact(tree["embed"]["scale"]))
    else:
        model.embed.weight.copy_(_t(tree["embed"]["weight"], dev, dt))
    model.final_norm.copy_(_t(tree["final_norm"], dev, dt))
    if not cfg.tie_embeddings:
        _linear(model.lm_head, tree["lm_head"], dev, dt)
    for layer, src in zip(model.layers, tree["layers"], strict=True):
        for name, p in layer.named_parameters():
            if name.endswith("norm"):
                p.copy_(_t(src[name], dev, dt))
        for name in _LINEARS + ("router",):
            if hasattr(layer, name):
                _linear(getattr(layer, name), src[name], dev, dt)
        for name in _EXPERTS if cfg.num_experts > 0 else ():
            stack = getattr(layer, name)
            if stack.quantized:
                stack.kernel_q.copy_(_exact(src[name]["kernel_q"]))
                stack.scale.copy_(_exact(src[name]["scale"]))
            else:
                stack.kernel.copy_(_t(src[name]["kernel"], dev, dt))
    return model
