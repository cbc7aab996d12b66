"""The reduce-scatter / all-gather decode step under a mesh (the JAX
package's ``parallel/overlap.py``).

The reference decode step (models/llama.py:decode_step) all-reduces the
[B, 1, H] partials after o and down, twice per layer.  This schedule keeps
the residual stream reduce-scattered between the sub-blocks instead: each
rank holds its ``H / tp`` chunk of the residual, and an all-reduce becomes
a reduce-scatter (the partial's sum, the rank's chunk) plus an all-gather
where the next norm needs the whole row::

    per layer:
      x_full  = all_gather(x_scat)
      h       = rms_norm(x_full, input_norm)
      q, k, v = column-parallel projections (local heads) + RoPE
      pages   <- k, v scattered into the rank's kv-head slice
      attn    = paged attention over the local heads (no collective)
      x_scat += finish(reduce_scatter(o partial))
      h       = rms_norm(all_gather(x_scat), post_norm)
      x_scat += finish(reduce_scatter(down partial of SwiGLU(h)))
    final: all_gather(x_scat) -> replicated residual for the unembed

The bytes are the all-reduce's.  In the JAX package XLA may schedule the
next projection's weight reads under each half; here every collective is
a blocking ``torch.distributed`` call on the compute stream, and each next
op needs its output, so nothing overlaps: the schedule issues two
collectives where the reference issues one.  The result is the reference
step's: an all-gather is a concatenation, the residual adds are
elementwise, and the reductions go through ``row_parallel_partial``
(W8A8's int32 partials summed before the scales).
``EngineConfig.tp_overlap`` "on" (or ``K8SLLM_TP_OVERLAP=on``) selects it;
"auto" keeps the reference schedule.
"""

from __future__ import annotations

import torch

from k8s_llm_monitor_tpu_torch.models.config import ModelConfig
from k8s_llm_monitor_tpu_torch.models.llama import (
    KVPages,
    LlamaModel,
    _embed_lookup,
    _linear,
    _mlp_act,
    _unembed,
    decode_attention_split,
    row_parallel_partial,
)
from k8s_llm_monitor_tpu_torch.ops.norms import rms_norm
from k8s_llm_monitor_tpu_torch.ops.rope import rope_angles

#: The TP axis every collective of the schedule runs over.
MODEL_AXIS = "model"


def overlap_supported(cfg: ModelConfig, mesh, model=None) -> str:
    """"" when the staged schedule can serve ``(cfg, mesh)``; otherwise the
    reason (the JAX package's reasons and wording): the engine keeps the
    reference schedule on "auto" and raises it on "on".  ``mesh`` is a
    ``Mesh``, a ``MeshConfig`` or anything with a ``shape`` dict."""
    if mesh is None:
        return "no mesh"
    tp = mesh.shape.get(MODEL_AXIS, 1)
    if tp <= 1:
        return "model axis is 1"
    if (tp > cfg.num_kv_heads or cfg.num_kv_heads % tp != 0
            or cfg.num_heads % tp != 0):
        return (f"TP={tp} does not divide {cfg.num_heads} heads / "
                f"{cfg.num_kv_heads} KV heads (pages replicate)")
    if cfg.hidden_size % tp or cfg.intermediate_size % tp:
        return (f"TP={tp} does not divide hidden {cfg.hidden_size} / "
                f"intermediate {cfg.intermediate_size} (uneven scatter)")
    if cfg.num_experts > 0:
        return "MoE layers route through expert all-to-alls"
    if cfg.sandwich_norms:
        return "sandwich norms consume the full o projection pre-residual"
    if model is not None:
        layer0 = model.layers[0]
        if layer0.o.bias is not None or layer0.down.bias is not None:
            return "row-parallel projection carries a bias"
    return ""


@torch.no_grad()
def overlap_decode_step(model: LlamaModel, tokens, context_lens,
                        pages: KVPages, block_tables, *, attn_impl):
    """``llama.decode_step`` on the staged schedule (split path only: the
    fused kernels do not run under a mesh).  Returns (logits [B, V]
    float32, pages updated in place)."""
    cfg = model.cfg
    mesh = model.mesh
    aq = cfg.act_quant
    eps, uo = cfg.rms_norm_eps, cfg.rmsnorm_unit_offset
    Hc = cfg.hidden_size // model.tp
    positions = context_lens[:, None]
    active = (context_lens > 0)[:, None]
    new_lens = context_lens + 1
    cos, sin = rope_angles(positions, cfg.head_dim_, cfg.rope_theta,
                           scaling=cfg.rope_scaling)
    B = tokens.shape[0]
    x_full = _embed_lookup(model, tokens)[:, None, :]
    # The residual enters replicated; it stays reduce-scattered from here.
    x_scat = x_full.narrow(2, model.rank * Hc, Hc)
    for li, layer in enumerate(model.layers):
        h = rms_norm(mesh.all_gather(x_scat), layer.input_norm, eps, uo)
        attn = decode_attention_split(model, layer, li, h, cos, sin,
                                      positions, active, new_lens, pages,
                                      block_tables, attn_impl)
        part, fin = row_parallel_partial(layer.o, attn.reshape(B, 1, -1), aq,
                                         mesh)
        x_scat = x_scat + fin(mesh.reduce_scatter(part))
        h = rms_norm(mesh.all_gather(x_scat), layer.post_norm, eps, uo)
        act = (_mlp_act(cfg, _linear(layer.gate, h, aq))
               * _linear(layer.up, h, aq))
        part, fin = row_parallel_partial(layer.down, act, aq, mesh)
        x_scat = x_scat + fin(mesh.reduce_scatter(part))
    return _unembed(model, mesh.all_gather(x_scat))[:, 0, :], pages
