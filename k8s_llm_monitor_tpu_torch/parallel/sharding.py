"""Partition specs for the Llama weights and the KV pool, and each rank's
slice of them (the JAX package's ``parallel/sharding.py``).

Megatron-style tensor parallelism over the ``model`` axis:
  - column-parallel (shard out_features): q/k/v, gate/up, lm_head
  - row-parallel    (shard in_features):  o, down
  - vocab-parallel embedding
  - expert-parallel MoE stacks (the expert axis), the router replicated
  - norms replicated
Where the JAX package lets XLA insert the collectives from these specs, the
port's forward passes run them by hand (models/llama.py: the all-reduce
after o and down, the masked embedding lookup, the all-gather of the
logits).

The specs are over the port's ``nn.Module`` names (``layers.0.q.weight``)
in ``nn.Linear``'s ``[out, in]`` layout, so a column kernel shards its
first dim here where the JAX ``[in, out]`` kernel shards its second
(``PartitionSpec.transposed`` maps one onto the other).  int8 per-out-
channel scales shard with the out dim of a column projection and stay
whole on a row projection (its out dim is not split).

KV pages [num_blocks, block_size, kv_heads * head_dim] shard their fused
lane dim on kv-head boundaries when the TP degree divides the kv-head
count, and replicate otherwise.  Page tables are never sharded: block ids
are global, so the allocator and the prefix cache know nothing of the
mesh, and every rank walks the same table over its own head slice.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Iterable, Optional

import torch


class PartitionSpec(tuple):
    """Per dim, the mesh axis it is split over, or None (replicated)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"

    def transposed(self) -> "PartitionSpec":
        """The spec of the transposed 2-D tensor (JAX ``[in, out]``)."""
        return PartitionSpec(*reversed(self))


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class SpecLayout:
    """Axis layout for tensor-parallel serving, one method per param role
    (``nn.Linear`` layout: kernels are [out, in])."""

    data_axis: str = "data"
    seq_axis: str = "seq"
    model_axis: str = "model"

    # -- parameter roles --------------------------------------------------
    def embedding(self) -> P:
        """Vocab-parallel embedding table [V, H]: shard V."""
        return P(self.model_axis, None)

    def embedding_scale(self) -> P:
        """Per-vocab-row int8 scales ride the sharded vocab axis."""
        return P(self.model_axis)

    def column_kernel(self) -> P:
        """q/k/v/gate/up/lm_head [out, in]: shard out_features."""
        return P(self.model_axis, None)

    def row_kernel(self) -> P:
        """o/down [out, in]: shard in_features; the forward all-reduces."""
        return P(None, self.model_axis)

    def column_bias(self) -> P:
        """Biases and per-out-channel int8 scales of column-parallel
        projections split with the out dim."""
        return P(self.model_axis)

    def expert_kernel(self) -> P:
        """Stacked MoE kernels [E, in, out] (the JAX layout): the expert
        axis rides ``model``, each rank holding whole experts."""
        return P(self.model_axis, None, None)

    def expert_scale(self) -> P:
        """MoE int8 scales [E, out] shard their expert axis the same."""
        return P(self.model_axis, None)

    def layer_norm(self) -> P:
        """Norms (and the MoE router) are O(H): replicate."""
        return P(None)

    def replicated(self) -> P:
        return P(None)

    # -- serving-state roles ----------------------------------------------
    def kv_pages(self, num_kv_heads: int, tp: int) -> P:
        """[num_blocks, block_size, kv_heads*head_dim]: shard the fused
        lane dim on kv-head boundaries when ``tp`` divides the head count,
        else replicate (a lane split that cuts a head mid-``head_dim``
        would need a reduction for every q.k dot)."""
        if tp <= 1 or tp > num_kv_heads or num_kv_heads % tp != 0:
            return P(None, None, None)
        return P(None, None, self.model_axis)

    def kv_scales(self, num_kv_heads: int, tp: int) -> P:
        """Scale planes [num_blocks, block_size, kv_heads] of a quantized
        pool shard exactly when the pages do."""
        return self.kv_pages(num_kv_heads, tp)

    def page_table(self) -> P:
        """Block tables and context lengths: replicated (global ids)."""
        return P(None, None)

    def batch(self) -> P:
        return P(self.data_axis)


#: The layout every entry point derives its slices from.
DEFAULT_LAYOUT = SpecLayout()


def partition_rules(layout: SpecLayout = DEFAULT_LAYOUT
                    ) -> tuple[tuple[str, P], ...]:
    """(name-regex, spec) pairs over ``named_parameters`` / ``named_buffers``
    names, first match wins; unmatched names (the router) replicate.
    Expert rules come first, as in the JAX package."""
    return (
        (r"(^|\.)embed\.(weight|weight_q)$", layout.embedding()),
        (r"(^|\.)embed\.scale$", layout.embedding_scale()),
        (r"(^|\.)(gate_e|up_e|down_e)\.scale$", layout.expert_scale()),
        (r"(^|\.)(gate_e|up_e|down_e)\.", layout.expert_kernel()),
        (r"(^|\.)(q|k|v|gate|up|lm_head)\.(weight|weight_q)$",
         layout.column_kernel()),
        (r"(^|\.)(o|down)\.(weight|weight_q)$", layout.row_kernel()),
        (r"(^|\.)(q|k|v|gate|up|lm_head)\.(bias|scale)$",
         layout.column_bias()),
        (r".*norm", layout.layer_norm()),
    )


def match_partition_rules(rules, names: Iterable[str]) -> dict[str, P]:
    """Map parameter names to specs by regex (first match wins); unmatched
    names replicate."""
    out = {}
    for name in names:
        for pattern, spec in rules:
            if re.search(pattern, name):
                out[name] = spec
                break
        else:
            out[name] = P(None)
    return out


def param_names(model: torch.nn.Module) -> list[str]:
    return ([n for n, _ in model.named_parameters()]
            + [n for n, _ in model.named_buffers()])


def param_partition_specs(model_or_names, layout: SpecLayout = DEFAULT_LAYOUT
                          ) -> dict[str, P]:
    """{name: PartitionSpec} for a ``LlamaModel`` (or a list of its
    parameter and buffer names)."""
    names = (param_names(model_or_names)
             if isinstance(model_or_names, torch.nn.Module)
             else list(model_or_names))
    return match_partition_rules(partition_rules(layout), names)


def shard_tensor(full: torch.Tensor, spec: P, rank: int, tp: int,
                 axis: str = "model") -> torch.Tensor:
    """Rank ``rank``'s contiguous slice of ``full`` under ``spec`` (the
    JAX ``NamedSharding`` shard on device index ``rank`` of a 1-D model
    mesh).  A split dim must divide by ``tp``."""
    out = full
    for dim, ax in enumerate(spec):
        if ax != axis or tp == 1:
            continue
        n = full.shape[dim]
        if n % tp:
            raise ValueError(f"dim {dim} of size {n} does not divide by "
                             f"tp {tp}")
        c = n // tp
        out = out.narrow(dim, rank * c, c)
    return out


def shard_params(state: dict[str, torch.Tensor], rank: int, tp: int,
                 layout: SpecLayout = DEFAULT_LAYOUT) -> dict[str, torch.Tensor]:
    """Rank ``rank``'s slice of every tensor of a full (TP-1) state dict."""
    specs = param_partition_specs(list(state), layout)
    return {k: shard_tensor(v, specs[k], rank, tp, layout.model_axis)
            for k, v in state.items()}


def kv_sharded(num_kv_heads: int, tp: int) -> bool:
    """Whether the KV pool splits on kv-head boundaries at degree ``tp``."""
    return DEFAULT_LAYOUT.kv_pages(num_kv_heads, tp) != P(None, None, None)


def local_kv_heads(num_kv_heads: int, tp: int) -> int:
    """kv heads one rank's pages hold: its slice, or all when replicated."""
    return num_kv_heads // tp if kv_sharded(num_kv_heads, tp) else num_kv_heads


def kv_pages_partition_specs(num_layers: int, mesh, num_kv_heads: int,
                             quantized: bool = False,
                             layout: SpecLayout = DEFAULT_LAYOUT) -> dict:
    """Per leaf list of the pool (``k``, ``v``, and on a quantized pool
    ``k_scale``, ``v_scale``), the spec of each layer's tensor."""
    tp = mesh.shape[layout.model_axis] if mesh is not None else 1
    spec = layout.kv_pages(num_kv_heads, tp)
    sspec = layout.kv_scales(num_kv_heads, tp)
    return {"k": [spec] * num_layers, "v": [spec] * num_layers,
            "k_scale": [sspec] * num_layers if quantized else [],
            "v_scale": [sspec] * num_layers if quantized else []}


def check_tp(cfg, tp: int) -> Optional[str]:
    """Why ``cfg`` cannot be served at TP ``tp`` (a split dim that does not
    divide), or None."""
    if tp <= 1:
        return None
    D = cfg.head_dim_
    # A mixture of experts splits its expert axis, not the FFN.
    split = (("experts", cfg.num_experts) if cfg.num_experts > 0 else
             ("intermediate size", cfg.intermediate_size))
    for what, n in (("query heads", cfg.num_heads), split,
                    ("vocab size", cfg.vocab_size),
                    ("kv lanes", cfg.num_kv_heads * D)):
        if n % tp:
            return f"TP={tp} does not divide the {what} ({n})"
    return None
