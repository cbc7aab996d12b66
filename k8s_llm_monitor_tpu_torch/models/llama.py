"""Llama-3 / Qwen2-family decoder LM in PyTorch.

``LlamaModel`` is an ``nn.Module`` holding the weights; the forward passes
are module-level functions named as in the JAX package
(``forward_full``, ``prefill``, ``prefill_chunk``, ``verify_step``,
``decode_step``) so each
has an obvious counterpart.  Weights follow ``nn.Linear``'s ``[out, in]``
convention; convert.py is the one place the JAX ``[in, out]`` kernels are
transposed.  An int8 model (``LlamaModel(quantized=True)``) holds
``QuantLinear`` / ``QuantEmbedding`` codes and scales in the same layout;
``_linear`` runs them weight-only or, under ``cfg.act_quant``, as W8A8.

The paged KV cache is one ``[num_blocks, block_size, kv_heads * head_dim]``
tensor per layer for K and for V (kv-head-major fused rows), block 0 the
null block that masked lanes write to.  Where the JAX package donates the
page arrays to a jitted program and gets new ones back, this port updates
them in place: ``_scatter_pages``, ``_scatter_pages_quant`` and the fused
decode kernels write into the tensors they are given (pages, and scale
planes of an int8/fp8 pool) and return the same tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from k8s_llm_monitor_tpu_torch.models.config import ModelConfig
from k8s_llm_monitor_tpu_torch.ops.attention import (
    causal_attention,
    gather_dequant,
    gather_pages,
    paged_decode_attention_quant,
    widen_pages,
)
from k8s_llm_monitor_tpu_torch.ops.norms import rms_norm
from k8s_llm_monitor_tpu_torch.ops.rope import apply_rope, rope_angles


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    one.  Without a GPU the caller must ask for the CPU explicitly."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass
class KVPages:
    """Paged KV cache: per-layer page tensors
    ``k[i], v[i]: [num_blocks, block_size, kv_heads * head_dim]``.

    A quantized pool (``kv_quant`` "int8"/"fp8") holds 1-byte codes in the
    pages plus per-(token, head) float32 scales
    ``k_scale[i], v_scale[i]: [num_blocks, block_size, kv_heads]``; an
    unquantized pool leaves the scale lists empty."""

    k: list[torch.Tensor]
    v: list[torch.Tensor]
    k_scale: list[torch.Tensor] = dataclasses.field(default_factory=list)
    v_scale: list[torch.Tensor] = dataclasses.field(default_factory=list)

    @property
    def num_blocks(self) -> int:
        return self.k[0].shape[0]

    @property
    def block_size(self) -> int:
        return self.k[0].shape[1]

    @property
    def quantized(self) -> bool:
        return len(self.k_scale) > 0

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in self.k + self.v + self.k_scale + self.v_scale)


# e4m3fn's largest finite value is 448; the next code up is NaN, so values
# past the midpoint 464 round to NaN.
_E4M3_ROUND_MAX = 464.0


def cast_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` as float8_e4m3fn with ``jnp.astype``'s semantics: round to
    nearest even from ``x``'s own dtype, and NaN (with ``x``'s sign) past
    +-464, for infinities and for NaN.  ``.to(torch.float8_e4m3fn)``
    saturates to +-448 there instead.  The codes are made through a uint8
    view, with no host round trip, so the cast can run inside a captured
    CUDA graph."""
    xf = x.float()
    ok = xf.abs() <= _E4M3_ROUND_MAX          # False for NaN
    codes = torch.where(ok, xf, 0.0).to(torch.float8_e4m3fn).view(torch.uint8)
    nan = (torch.signbit(xf).to(torch.uint8) << 7) | 0x7F
    return torch.where(ok, codes, nan).view(torch.float8_e4m3fn)


def kv_quant_spec(kv_quant: str) -> tuple[torch.dtype, float]:
    """(storage dtype, qmax) of a KV quantization mode: ``int8`` codes
    round and clip at 127, ``fp8`` (float8_e4m3fn) saturates at 448."""
    if kv_quant == "fp8":
        return torch.float8_e4m3fn, 448.0
    if kv_quant == "int8":
        return torch.int8, 127.0
    raise ValueError(f"unknown kv_quant {kv_quant!r} (int8 | fp8)")


def _qmax_for(dtype: torch.dtype) -> float:
    return 127.0 if dtype == torch.int8 else 448.0


def _quantize_heads(xf: torch.Tensor, qmax: float, is_int8: bool):
    """Symmetric per-head quantization of float32 ``xf [..., D]``: returns
    (codes as float32 before the storage cast, scale [...]).

    Division by the scale, not a reciprocal multiply, and round half to
    even, as the JAX package does: either change moves codes at ties.
    ``qmax`` divides as a tensor on ``amax``'s device: PyTorch on CUDA
    turns division by a Python number (or a CPU scalar) into a multiply by
    its reciprocal, one ulp off the quotient for some amax.  ``new_full``
    fills it on the device, with no host-to-device copy to wait for."""
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax / amax.new_full((), qmax), min=1e-8)
    xq = xf / scale[..., None]
    if is_int8:
        xq = torch.clamp(torch.round(xq), -qmax, qmax)
    return xq, scale


def quantize_kv(x: torch.Tensor, num_kv_heads: int, qdtype: torch.dtype,
                qmax: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric quantization of fused-lane KV rows.

    x [..., KVH*D] -> (x_q [..., KVH*D] qdtype, scale [..., KVH] float32).
    int8 rounds and clips; fp8 casts (torch's cast saturates).
    """
    shp = x.shape
    xr = x.float().reshape(*shp[:-1], num_kv_heads, shp[-1] // num_kv_heads)
    xq, scale = _quantize_heads(xr, qmax, qdtype == torch.int8)
    return xq.to(qdtype).reshape(shp), scale


def dequantize_kv(x_q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of ``quantize_kv``: x_q [..., KVH*D] + scale [..., KVH]
    -> float rows [..., KVH*D]."""
    shp = x_q.shape
    KVH = scale.shape[-1]
    xr = x_q.float().reshape(*shp[:-1], KVH, shp[-1] // KVH)
    return (xr * scale[..., None]).reshape(shp).to(dtype)


def init_kv_pages(cfg: ModelConfig, num_blocks: int, block_size: int,
                  device, dtype: Optional[torch.dtype] = None,
                  kv_quant: str = "") -> KVPages:
    """Allocate the paged KV pool.  ``kv_quant`` ("int8"/"fp8") selects the
    quantized tier: pages in the storage dtype plus float32 scale planes,
    whatever ``cfg.kv_dtype`` says.  "" keeps pages in ``cfg.kv_dtype``
    when it is set (float8_e4m3fn: the unscaled fp8 pool), else in
    ``dtype`` (default: the model's)."""
    shape = (num_blocks, block_size, cfg.num_kv_heads * cfg.head_dim_)

    def planes(shp, dt):
        return [torch.zeros(shp, dtype=dt, device=device)
                for _ in range(cfg.num_layers)]

    if kv_quant:
        qdtype, _ = kv_quant_spec(kv_quant)
        sshape = (num_blocks, block_size, cfg.num_kv_heads)
        return KVPages(k=planes(shape, qdtype), v=planes(shape, qdtype),
                       k_scale=planes(sshape, torch.float32),
                       v_scale=planes(sshape, torch.float32))
    dtype = cfg.torch_kv_dtype if cfg.kv_dtype else (dtype or cfg.torch_dtype)
    return KVPages(k=planes(shape, dtype), v=planes(shape, dtype))


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


class QuantLinear(nn.Module):
    """Weight-only int8 linear in ``nn.Linear``'s layout: codes ``weight_q``
    int8 [out, in] and float32 per-output-channel scales ``scale`` [out]
    (utils/quantize.py), with an optional ``bias`` [out] in the model
    dtype.  The counterpart of the JAX package's ``{"kernel_q", "scale"}``
    leaves, transposed."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 device, dtype):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("weight_q", torch.zeros(
            out_features, in_features, dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(
            out_features, dtype=torch.float32, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device,
                                              dtype=dtype))
                     if bias else None)


class QuantEmbedding(nn.Module):
    """int8 embedding table: codes ``weight_q`` [vocab, H] and float32
    per-row scales ``scale`` [vocab]."""

    def __init__(self, num_embeddings: int, embedding_dim: int, device):
        super().__init__()
        self.register_buffer("weight_q", torch.zeros(
            num_embeddings, embedding_dim, dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(
            num_embeddings, dtype=torch.float32, device=device))


def _linear_module(quantized: bool, in_f: int, out_f: int, bias: bool, kw):
    if quantized:
        return QuantLinear(in_f, out_f, bias, **kw)
    return nn.Linear(in_f, out_f, bias=bias, **kw)


class LlamaLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype,
                 quantized: bool = False):
        super().__init__()
        H, D = cfg.hidden_size, cfg.head_dim_
        nH, nKV, inter = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size
        kw = dict(device=device, dtype=dtype)
        self.input_norm = nn.Parameter(torch.ones(H, **kw))
        self.post_norm = nn.Parameter(torch.ones(H, **kw))

        def lin(in_f, out_f, bias=False):
            return _linear_module(quantized, in_f, out_f, bias, kw)

        self.q = lin(H, nH * D, cfg.qkv_bias)
        self.k = lin(H, nKV * D, cfg.qkv_bias)
        self.v = lin(H, nKV * D, cfg.qkv_bias)
        self.o = lin(nH * D, H)
        self.gate = lin(H, inter)
        self.up = lin(H, inter)
        self.down = lin(inter, H)


class LlamaModel(nn.Module):
    """Decoder weights on ``device`` (default ``cuda``; see
    ``resolve_device``) in ``dtype`` (default ``cfg.dtype``), the dtype of
    the activations.

    ``seed`` draws random weights from a ``torch.Generator`` on the device,
    with the JAX package's ``init_params`` distribution (normals scaled by
    ``in_features**-0.5``, embeddings by 0.02, unit norms, zero biases);
    ``seed=None`` leaves the weights for the caller to fill
    (convert.py:params_from_jax, utils/checkpoint.py).

    ``quantized=True`` builds the int8 twin: ``QuantLinear`` and
    ``QuantEmbedding`` in place of ``nn.Linear`` and ``nn.Embedding``,
    filled by utils/quantize.py (``quantize_params``,
    ``init_params_quantized``) or a checkpoint, never from ``seed``.
    ``cfg.act_quant`` (W8A8) needs it: where the JAX package warns and runs
    the bf16 matmuls, this raises.
    """

    def __init__(self, cfg: ModelConfig, device=None,
                 dtype: Optional[torch.dtype] = None, seed: Optional[int] = 0,
                 quantized: bool = False):
        super().__init__()
        if cfg.has_attn_extras:
            raise ValueError(f"{cfg.name}: Gemma-2 attention extras (query "
                             "scale, logit softcap, sliding window) are not "
                             "ported")
        if cfg.act_quant and not quantized:
            raise ValueError(f"{cfg.name}: act_quant (W8A8) needs int8 "
                             "weights (utils/quantize.py)")
        if quantized and seed is not None:
            raise ValueError("a quantized model is filled by "
                             "utils/quantize.py or a checkpoint: pass "
                             "seed=None")
        device = resolve_device(device)
        dtype = dtype or cfg.torch_dtype
        self.cfg = cfg
        self.dtype = dtype
        self.quantized = quantized
        kw = dict(device=device, dtype=dtype)
        self.embed = (QuantEmbedding(cfg.vocab_size, cfg.hidden_size, device)
                      if quantized else
                      nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw))
        self.layers = nn.ModuleList(
            LlamaLayer(cfg, device, dtype, quantized)
            for _ in range(cfg.num_layers))
        self.final_norm = nn.Parameter(torch.ones(cfg.hidden_size, **kw))
        self.lm_head = (None if cfg.tie_embeddings else _linear_module(
            quantized, cfg.hidden_size, cfg.vocab_size, False, kw))
        self.requires_grad_(False)
        if seed is not None:
            self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.embed.weight.normal_(0.0, 0.02, generator=gen)
        linears = [m for m in self.modules() if isinstance(m, nn.Linear)]
        for lin in linears:
            lin.weight.normal_(0.0, lin.in_features ** -0.5, generator=gen)
            if lin.bias is not None:
                lin.bias.zero_()
        for p in [self.final_norm] + [p for layer in self.layers
                                      for p in (layer.input_norm,
                                                layer.post_norm)]:
            p.fill_(1.0)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward_full(self, tokens)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


# cuBLASLt's int8 GEMM behind torch._int_mm on CUDA takes more than 16 rows.
_INT_MM_MIN_ROWS = 17


def _quant_act(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-token symmetric int8: (x_q int8, scale f32 [..., 1]).

    Division by the scale, and of amax by 127 as a tensor on its device
    (PyTorch on CUDA turns division by a Python number into a multiply by
    the reciprocal, see ``_quantize_heads``); round half to even, clip at
    127, as the JAX package's ``_quant_act``."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax / amax.new_full((), 127.0), min=1e-8)
    x_q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return x_q, scale


def _int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """x_q [..., in] int8 times w_q [out, in] int8 transposed, summed in
    int32 (exact): ``torch._int_mm``, the counterpart of the JAX package's
    ``dot_general(..., preferred_element_type=int32)``.  Calls of 16 rows
    or fewer (decode at small batch) are padded with zero rows to the 17
    the CUDA kernel takes, and sliced back."""
    lead, k = x_q.shape[:-1], x_q.shape[-1]
    rows = x_q.reshape(-1, k)
    m = rows.shape[0]
    if m < _INT_MM_MIN_ROWS:
        rows = F.pad(rows, (0, 0, 0, _INT_MM_MIN_ROWS - m))
    y = torch._int_mm(rows, w_q.t())
    return y[:m].reshape(*lead, w_q.shape[0])


def _linear(lin: nn.Module, x: torch.Tensor,
            act_quant: bool = False) -> torch.Tensor:
    """x @ W^T (+ bias) for an ``nn.Linear`` or a ``QuantLinear``.

    Weight-only int8: the per-output-channel scale commutes with the
    contraction, so it multiplies the [.., out] result, in x's dtype.  W8A8
    (``act_quant``, int8 weights only): per-token int8 activations, an
    int32 product, then ``(y32 * x_scale) * w_scale`` in float32, cast to
    x's dtype, the JAX package's order."""
    if isinstance(lin, nn.Linear):
        return F.linear(x, lin.weight, lin.bias)
    if act_quant:
        x_q, xs = _quant_act(x)
        y32 = _int8_matmul(x_q, lin.weight_q)
        y = ((y32.float() * xs) * lin.scale).to(x.dtype)
    else:
        y = F.linear(x, lin.weight_q.to(x.dtype)) * lin.scale.to(x.dtype)
    if lin.bias is not None:
        y = y + lin.bias
    return y


def _embed_lookup(model: LlamaModel, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup; an int8 table's rows are dequantized in the
    model dtype (codes, then times the row scale), as the JAX package
    does."""
    t = tokens.long()
    emb = model.embed
    if isinstance(emb, QuantEmbedding):
        dt = model.dtype
        return emb.weight_q[t].to(dt) * emb.scale[t][..., None].to(dt)
    return emb.weight[t]


def _qkv_proj(layer: LlamaLayer, cfg: ModelConfig, x: torch.Tensor):
    """Projections only (no rope).  x [B, S, H] -> q [B, S, nH, D],
    k/v [B, S, nKV, D].  The fused decode kernel ropes in-kernel."""
    B, S, _ = x.shape
    D = cfg.head_dim_
    aq = cfg.act_quant
    q = _linear(layer.q, x, aq).reshape(B, S, cfg.num_heads, D)
    k = _linear(layer.k, x, aq).reshape(B, S, cfg.num_kv_heads, D)
    v = _linear(layer.v, x, aq).reshape(B, S, cfg.num_kv_heads, D)
    return q, k, v


def _qkv(layer: LlamaLayer, cfg: ModelConfig, x: torch.Tensor, cos, sin):
    """Project + rope (ops/rope.py, f32)."""
    q, k, v = _qkv_proj(layer, cfg, x)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _mlp(layer: LlamaLayer, cfg: ModelConfig,
         x: torch.Tensor) -> torch.Tensor:
    """SwiGLU."""
    aq = cfg.act_quant
    return _linear(layer.down, F.silu(_linear(layer.gate, x, aq))
                   * _linear(layer.up, x, aq), aq)


def _residual_tail(layer: LlamaLayer, cfg: ModelConfig, x: torch.Tensor,
                   o: torch.Tensor) -> torch.Tensor:
    """Attention residual, pre-MLP norm, MLP, MLP residual: the one
    definition shared by layer_block, _prefill_impl and decode_step."""
    x = x + o
    h = rms_norm(x, layer.post_norm, cfg.rms_norm_eps, cfg.rmsnorm_unit_offset)
    return x + _mlp(layer, cfg, h)


def _unembed(model: LlamaModel, x: torch.Tensor) -> torch.Tensor:
    """Final norm and the vocab projection, float32 logits.  The projection
    stays weight-only under ``act_quant``, tied or not: int8 noise on the
    pre-logits hidden state flips near-tied argmax (the JAX package's
    rule)."""
    cfg = model.cfg
    x = rms_norm(x, model.final_norm, cfg.rms_norm_eps,
                 cfg.rmsnorm_unit_offset)
    if not cfg.tie_embeddings:
        return _linear(model.lm_head, x).float()
    emb = model.embed
    if isinstance(emb, QuantEmbedding):
        return (F.linear(x, emb.weight_q.to(x.dtype))
                * emb.scale.to(x.dtype)).float()
    return F.linear(x, emb.weight).float()


def is_fused_decode_impl(attn_impl) -> bool:
    """True for the fused decode calling convention (raw q/k/v + angles in,
    attention + updated pages out)."""
    return bool(getattr(attn_impl, "fused_decode", False))


def is_fused_quant_decode_impl(attn_impl) -> bool:
    """True for the quantized-pool fused decode kernel (takes and updates
    the scale planes).  A fused impl without this marker never touches a
    quantized pool: decode_step takes its gather/dequant branch instead."""
    return bool(getattr(attn_impl, "quant_kv", False))


def is_flash_prefill_impl(attn_impl) -> bool:
    """True for the flash paged-prefill calling convention."""
    return bool(getattr(attn_impl, "flash_prefill", False))


# ---------------------------------------------------------------------------
# Dense forward
# ---------------------------------------------------------------------------


def layer_block(layer: LlamaLayer, cfg: ModelConfig, x: torch.Tensor, cos,
                sin, positions: torch.Tensor) -> torch.Tensor:
    """One transformer layer with dense causal attention."""
    B, S = x.shape[:2]
    h = rms_norm(x, layer.input_norm, cfg.rms_norm_eps, cfg.rmsnorm_unit_offset)
    q, k, v = _qkv(layer, cfg, h, cos, sin)
    attn = causal_attention(q, k, v, q_positions=positions)
    o = _linear(layer.o, attn.reshape(B, S, -1), cfg.act_quant)
    return _residual_tail(layer, cfg, x, o)


@torch.no_grad()
def forward_full(model: LlamaModel, tokens: torch.Tensor, *,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense causal forward.  tokens [B, S] -> logits [B, S, V] float32."""
    cfg = model.cfg
    B, S = tokens.shape
    x = _embed_lookup(model, tokens)
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
    cos, sin = rope_angles(positions, cfg.head_dim_, cfg.rope_theta,
                           scaling=cfg.rope_scaling)
    for layer in model.layers:
        x = layer_block(layer, cfg, x, cos, sin, positions)
    return _unembed(model, x)


# ---------------------------------------------------------------------------
# Paged-cache scatter
# ---------------------------------------------------------------------------


def _scatter_pages(pages: torch.Tensor, vals: torch.Tensor,
                   block_table: torch.Tensor, positions: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """Write vals[b, s] to pages[block_table[b, pos//bs], pos%bs], in place.

    Invalid lanes, and positions past the table, are redirected to the null
    block 0 rather than clipped into the lane's last real block (a clip
    would overwrite live cache).  fp8 pages take ``cast_e4m3`` of ``vals``
    as they come (the model dtype on the XLA-scatter paths, as the JAX
    package rounds them), written through a byte view.

    pages [num_blocks, bs, KVH*D]; vals [B, S, KVH, D]; block_table
    [B, max_blocks]; positions/valid [B, S].  Returns ``pages``.
    """
    bs = pages.shape[1]
    B, S = positions.shape
    nb = block_table.shape[1]
    raw_blk = torch.div(positions, bs, rounding_mode="floor")
    blk_idx = raw_blk.clamp(0, nb - 1).long()
    block_ids = torch.gather(block_table, 1, blk_idx)
    block_ids = torch.where(valid & (raw_blk < nb), block_ids,
                            torch.zeros_like(block_ids))
    offs = positions % bs
    idx = (block_ids.reshape(-1).long(), offs.reshape(-1).long())
    rows = vals.reshape(B * S, -1)
    if pages.dtype == torch.float8_e4m3fn:
        pages.view(torch.uint8)[idx] = cast_e4m3(rows).view(torch.uint8)
    else:
        pages[idx] = rows.to(pages.dtype)
    return pages


def _scatter_pages_quant(pages: torch.Tensor, spages: torch.Tensor,
                         vals: torch.Tensor, block_table: torch.Tensor,
                         positions: torch.Tensor, valid: torch.Tensor):
    """Quantize-on-append twin of ``_scatter_pages``: per-(token, head)
    quantization of ``vals`` [B, S, KVH, D] into the 1-byte ``pages`` and a
    scatter of the float32 scales into ``spages`` [num_blocks, bs, KVH],
    both in place with the same null-block redirect.  Returns (pages,
    spages)."""
    xq, scale = _quantize_heads(vals.float(), _qmax_for(pages.dtype),
                                pages.dtype == torch.int8)
    return (_scatter_pages(pages, xq, block_table, positions, valid),
            _scatter_pages(spages, scale, block_table, positions, valid))


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def _prefill_impl(model: LlamaModel, tokens, positions, valid, lengths,
                  kv_len, pages: KVPages, block_tables, attend_to_pages: bool,
                  paged_attn_fn=None, on_layer=None,
                  return_all_logits: bool = False):
    """Shared prefill layer loop: embed, qkv+rope, scatter into the pages,
    attention, residual/MLP, last-valid-token unembed (every position's
    with ``return_all_logits``, for the verify pass).

    Attention source: the flash kernel reads the pages (the scatter above
    already wrote this chunk's K/V, so fresh prefill and continuation
    chunks are the same call); a paged multi-query impl (the verify path,
    ops/attention.py:select_verify_impl) reads them over a bf16 pool;
    otherwise ``attend_to_pages`` gathers the paged prefix (chunks) or uses
    the in-flight k/v (fresh prefill).

    A quantized pool quantizes on scatter; the flash kernel takes the
    scale planes and dequantizes inside, a chunk's gather dequantizes the
    gathered prefix, and fresh dense prefill attends to the unquantized
    in-flight k/v (so it differs from flash by quantization noise).

    ``on_layer``, when given, is called after each layer's launches: the
    host may act on earlier work the device has finished while it waits
    for room in the launch queue.
    """
    cfg = model.cfg
    B, S = tokens.shape
    cos, sin = rope_angles(positions, cfg.head_dim_, cfg.rope_theta,
                           scaling=cfg.rope_scaling)
    flash = paged_attn_fn is not None and is_flash_prefill_impl(paged_attn_fn)
    quant = pages.quantized
    x = _embed_lookup(model, tokens)
    uo = cfg.rmsnorm_unit_offset
    for li, layer in enumerate(model.layers):
        h = rms_norm(x, layer.input_norm, cfg.rms_norm_eps, uo)
        q, k, v = _qkv(layer, cfg, h, cos, sin)
        if quant:
            pk, psk = _scatter_pages_quant(pages.k[li], pages.k_scale[li], k,
                                           block_tables, positions, valid)
            pv, psv = _scatter_pages_quant(pages.v[li], pages.v_scale[li], v,
                                           block_tables, positions, valid)
        else:
            pk = _scatter_pages(pages.k[li], k, block_tables, positions, valid)
            pv = _scatter_pages(pages.v[li], v, block_tables, positions, valid)
        if flash:
            scales = dict(k_scale=psk, v_scale=psv) if quant else {}
            attn = paged_attn_fn(q, pk, pv, block_tables, positions[:, 0],
                                 lengths, **scales)
        elif attend_to_pages and paged_attn_fn is not None and not quant:
            # Queries are contiguous at positions[:, 0] + i (verify_step
            # and prefill_chunk guarantee it); a quantized pool takes the
            # gather/dequant branch below, as in the JAX package.
            attn = paged_attn_fn(q, pk, pv, block_tables, positions[:, 0],
                                 lengths)
        else:
            if attend_to_pages and quant:
                D = cfg.head_dim_
                kk = gather_dequant(pk, psk, block_tables, D).to(k.dtype)
                vv = gather_dequant(pv, psv, block_tables, D).to(v.dtype)
            elif attend_to_pages:
                kk = widen_pages(gather_pages(pk, block_tables)).reshape(
                    B, -1, cfg.num_kv_heads, cfg.head_dim_)
                vv = widen_pages(gather_pages(pv, block_tables)).reshape(
                    B, -1, cfg.num_kv_heads, cfg.head_dim_)
            else:
                kk, vv = k, v
            attn = causal_attention(q, kk, vv, q_positions=positions,
                                    kv_len=kv_len)
        o = _linear(layer.o, attn.reshape(B, S, -1), cfg.act_quant)
        x = _residual_tail(layer, cfg, x, o)
        if on_layer is not None:
            on_layer()
    if return_all_logits:
        return _unembed(model, x), pages
    last_idx = (lengths - 1).clamp(min=0).long()
    x_last = x[torch.arange(B, device=x.device), last_idx][:, None, :]
    return _unembed(model, x_last)[:, 0, :], pages


@torch.no_grad()
def prefill(model: LlamaModel, tokens, lengths, pages: KVPages, block_tables,
            *, attn_impl=None, on_layer=None):
    """Ingest right-padded prompts, writing K/V into the paged cache.

    tokens [B, S_pad]; lengths [B] (0 = inactive lane); ``attn_impl``: the
    flash paged-prefill wrapper (ops/attention.py:select_prefill_impl) or
    None for dense in-flight attention.  Returns (last-token logits [B, V]
    float32, pages updated in place).
    """
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    valid = positions < lengths[:, None]
    return _prefill_impl(model, tokens, positions, valid, lengths, lengths,
                         pages, block_tables, attend_to_pages=False,
                         paged_attn_fn=attn_impl, on_layer=on_layer)


@torch.no_grad()
def prefill_chunk(model: LlamaModel, tokens, start, lengths, pages: KVPages,
                  block_tables, *, attn_impl=None, on_layer=None):
    """Continuation prefill: a chunk of a prompt whose first ``start``
    tokens are already cached; attention runs against the paged prefix +
    the chunk, masked causally by absolute position.

    tokens [B, S]; start, lengths [B] (0 = inactive lane).  Returns
    (last-chunk-token logits [B, V] float32, pages updated in place).
    """
    B, S = tokens.shape
    offs = torch.arange(S, dtype=torch.int32, device=tokens.device)
    positions = start[:, None] + offs[None, :]
    valid = offs[None, :] < lengths[:, None]
    return _prefill_impl(model, tokens, positions, valid, lengths,
                         start + lengths, pages, block_tables,
                         attend_to_pages=True, paged_attn_fn=attn_impl,
                         on_layer=on_layer)


@torch.no_grad()
def verify_step(model: LlamaModel, tokens, start, lengths, pages: KVPages,
                block_tables, *, attn_impl=None):
    """Speculative-decode verify pass: score ``S`` candidate tokens at once.

    The cache semantics of ``prefill_chunk`` (tokens land at positions
    ``start .. start + lengths - 1`` and attend to the paged prefix and the
    chunk) with the logits of every position, [B, S, V] float32: position
    ``i``'s are the distribution of the token after ``tokens[:, i]``.  K/V
    written for rejected positions stays beyond the accepted context, is
    masked out of every later read and overwritten when real tokens
    arrive, so rejection needs no rollback.

    ``attn_impl``: the flash prefill wrapper (any pool; its scale planes
    ride as kwargs), a paged multi-query impl (ops/attention.py:
    select_verify_impl; a quantized pool then takes the gather/dequant
    branch) or None (the gather).  Pages are updated in place.
    """
    B, S = tokens.shape
    offs = torch.arange(S, dtype=torch.int32, device=tokens.device)
    positions = start[:, None] + offs[None, :]
    valid = offs[None, :] < lengths[:, None]
    return _prefill_impl(model, tokens, positions, valid, lengths,
                         start + lengths, pages, block_tables,
                         attend_to_pages=True, paged_attn_fn=attn_impl,
                         return_all_logits=True)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


@torch.no_grad()
def decode_step(model: LlamaModel, tokens, context_lens, pages: KVPages,
                block_tables, *, attn_impl):
    """One decode step for a batch of slots.

    tokens [B]: the token fed per slot.  context_lens [B]: tokens already
    cached, i.e. the new token's position; 0 marks an inactive slot whose
    writes go to the null block.  ``attn_impl``: a fused wrapper (RoPE +
    append + attention in one kernel; the ``quant_kv`` one for a quantized
    pool), the split paged-attention wrapper or ``paged_decode_attention``.
    A quantized pool without the fused quant wrapper runs the gather/
    dequant branch whatever impl is handed in.
    Returns (logits [B, V] float32, pages updated in place).
    """
    cfg = model.cfg
    B = tokens.shape[0]
    positions = context_lens[:, None]
    active = (context_lens > 0)[:, None]
    cos, sin = rope_angles(positions, cfg.head_dim_, cfg.rope_theta,
                           scaling=cfg.rope_scaling)
    quant = pages.quantized
    fused_q = quant and is_fused_quant_decode_impl(attn_impl)
    # A fused impl without scale support never touches a quantized pool.
    fused = is_fused_decode_impl(attn_impl) and (fused_q or not quant)
    x = _embed_lookup(model, tokens)[:, None, :]
    uo = cfg.rmsnorm_unit_offset
    new_lens = context_lens + 1
    for li, layer in enumerate(model.layers):
        h = rms_norm(x, layer.input_norm, cfg.rms_norm_eps, uo)
        if fused_q:
            q, k, v = _qkv_proj(layer, cfg, h)
            attn = attn_impl(q, k, v, cos, sin, pages.k[li], pages.v[li],
                             pages.k_scale[li], pages.v_scale[li],
                             block_tables, context_lens)[0]
        elif fused:
            q, k, v = _qkv_proj(layer, cfg, h)
            attn, _, _ = attn_impl(q, k, v, cos, sin, pages.k[li],
                                   pages.v[li], block_tables, context_lens)
        elif quant:
            q, k, v = _qkv(layer, cfg, h, cos, sin)
            pk, psk = _scatter_pages_quant(pages.k[li], pages.k_scale[li], k,
                                           block_tables, positions, active)
            pv, psv = _scatter_pages_quant(pages.v[li], pages.v_scale[li], v,
                                           block_tables, positions, active)
            attn = paged_decode_attention_quant(q, pk, pv, psk, psv,
                                                block_tables, new_lens)
        else:
            q, k, v = _qkv(layer, cfg, h, cos, sin)
            pk = _scatter_pages(pages.k[li], k, block_tables, positions, active)
            pv = _scatter_pages(pages.v[li], v, block_tables, positions, active)
            attn = attn_impl(q, pk, pv, block_tables, new_lens)
        o = _linear(layer.o, attn.reshape(B, 1, -1), cfg.act_quant)
        x = _residual_tail(layer, cfg, x, o)
    return _unembed(model, x)[:, 0, :], pages
