"""Llama-3 / Qwen2-family decoder LM in PyTorch.

``LlamaModel`` is an ``nn.Module`` holding the weights; the forward passes
are module-level functions named as in the JAX package
(``forward_full``, ``prefill``, ``prefill_chunk``, ``decode_step``) so each
has an obvious counterpart.  Weights follow ``nn.Linear``'s ``[out, in]``
convention; convert.py is the one place the JAX ``[in, out]`` kernels are
transposed.

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
    quantized tier: pages in the storage dtype plus float32 scale planes;
    "" keeps pages in ``dtype`` (default: the model's)."""
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
    dtype = dtype or cfg.torch_dtype
    return KVPages(k=planes(shape, dtype), v=planes(shape, dtype))


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


class LlamaLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        H, D = cfg.hidden_size, cfg.head_dim_
        nH, nKV, inter = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size
        kw = dict(device=device, dtype=dtype)
        self.input_norm = nn.Parameter(torch.ones(H, **kw))
        self.post_norm = nn.Parameter(torch.ones(H, **kw))
        self.q = nn.Linear(H, nH * D, bias=cfg.qkv_bias, **kw)
        self.k = nn.Linear(H, nKV * D, bias=cfg.qkv_bias, **kw)
        self.v = nn.Linear(H, nKV * D, bias=cfg.qkv_bias, **kw)
        self.o = nn.Linear(nH * D, H, bias=False, **kw)
        self.gate = nn.Linear(H, inter, bias=False, **kw)
        self.up = nn.Linear(H, inter, bias=False, **kw)
        self.down = nn.Linear(inter, H, bias=False, **kw)


class LlamaModel(nn.Module):
    """Decoder weights on ``device`` (default ``cuda``; see
    ``resolve_device``) in ``cfg.dtype``.

    ``seed`` draws random weights from a ``torch.Generator`` on the device,
    with the JAX package's ``init_params`` distribution (normals scaled by
    ``in_features**-0.5``, embeddings by 0.02, unit norms, zero biases);
    ``seed=None`` leaves the weights for the caller to fill
    (convert.py:params_from_jax).
    """

    def __init__(self, cfg: ModelConfig, device=None,
                 dtype: Optional[torch.dtype] = None, seed: Optional[int] = 0):
        super().__init__()
        if cfg.has_attn_extras:
            raise ValueError(f"{cfg.name}: Gemma-2 attention extras (query "
                             "scale, logit softcap, sliding window) are not "
                             "ported")
        device = resolve_device(device)
        dtype = dtype or cfg.torch_dtype
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.layers = nn.ModuleList(
            LlamaLayer(cfg, device, dtype) for _ in range(cfg.num_layers))
        self.final_norm = nn.Parameter(torch.ones(cfg.hidden_size, **kw))
        self.lm_head = (None if cfg.tie_embeddings else
                        nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                                  **kw))
        self.requires_grad_(False)
        if seed is not None:
            self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

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


def param_bytes(model: nn.Module) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def _linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, lin.weight, lin.bias)


def _embed_lookup(model: LlamaModel, tokens: torch.Tensor) -> torch.Tensor:
    return model.embed.weight[tokens.long()]


def _qkv_proj(layer: LlamaLayer, cfg: ModelConfig, x: torch.Tensor):
    """Projections only (no rope).  x [B, S, H] -> q [B, S, nH, D],
    k/v [B, S, nKV, D].  The fused decode kernel ropes in-kernel."""
    B, S, _ = x.shape
    D = cfg.head_dim_
    q = _linear(layer.q, x).reshape(B, S, cfg.num_heads, D)
    k = _linear(layer.k, x).reshape(B, S, cfg.num_kv_heads, D)
    v = _linear(layer.v, x).reshape(B, S, cfg.num_kv_heads, D)
    return q, k, v


def _qkv(layer: LlamaLayer, cfg: ModelConfig, x: torch.Tensor, cos, sin):
    """Project + rope (ops/rope.py, f32)."""
    q, k, v = _qkv_proj(layer, cfg, x)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _mlp(layer: LlamaLayer, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU."""
    return _linear(layer.down, F.silu(_linear(layer.gate, x))
                   * _linear(layer.up, x))


def _residual_tail(layer: LlamaLayer, cfg: ModelConfig, x: torch.Tensor,
                   o: torch.Tensor) -> torch.Tensor:
    """Attention residual, pre-MLP norm, MLP, MLP residual: the one
    definition shared by layer_block, _prefill_impl and decode_step."""
    x = x + o
    h = rms_norm(x, layer.post_norm, cfg.rms_norm_eps, cfg.rmsnorm_unit_offset)
    return x + _mlp(layer, h)


def _unembed(model: LlamaModel, x: torch.Tensor) -> torch.Tensor:
    cfg = model.cfg
    x = rms_norm(x, model.final_norm, cfg.rms_norm_eps,
                 cfg.rmsnorm_unit_offset)
    w = model.embed.weight if cfg.tie_embeddings else model.lm_head.weight
    return F.linear(x, w).float()


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
    o = _linear(layer.o, attn.reshape(B, S, -1))
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
    would overwrite live cache).

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
    pages[block_ids.reshape(-1).long(), offs.reshape(-1).long()] = (
        vals.reshape(B * S, -1).to(pages.dtype))
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
                  paged_attn_fn=None):
    """Shared prefill layer loop: embed, qkv+rope, scatter into the pages,
    attention, residual/MLP, last-valid-token unembed.

    Attention source: the flash kernel reads the pages (the scatter above
    already wrote this chunk's K/V, so fresh prefill and continuation
    chunks are the same call); otherwise ``attend_to_pages`` gathers the
    paged prefix (chunks) or uses the in-flight k/v (fresh prefill).

    A quantized pool quantizes on scatter; the flash kernel takes the
    scale planes and dequantizes inside, a chunk's gather dequantizes the
    gathered prefix, and fresh dense prefill attends to the unquantized
    in-flight k/v (so it differs from flash by quantization noise).
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
        else:
            if attend_to_pages and quant:
                D = cfg.head_dim_
                kk = gather_dequant(pk, psk, block_tables, D).to(k.dtype)
                vv = gather_dequant(pv, psv, block_tables, D).to(v.dtype)
            elif attend_to_pages:
                kk = gather_pages(pk, block_tables).reshape(
                    B, -1, cfg.num_kv_heads, cfg.head_dim_)
                vv = gather_pages(pv, block_tables).reshape(
                    B, -1, cfg.num_kv_heads, cfg.head_dim_)
            else:
                kk, vv = k, v
            attn = causal_attention(q, kk, vv, q_positions=positions,
                                    kv_len=kv_len)
        o = _linear(layer.o, attn.reshape(B, S, -1))
        x = _residual_tail(layer, cfg, x, o)
    last_idx = (lengths - 1).clamp(min=0).long()
    x_last = x[torch.arange(B, device=x.device), last_idx][:, None, :]
    return _unembed(model, x_last)[:, 0, :], pages


@torch.no_grad()
def prefill(model: LlamaModel, tokens, lengths, pages: KVPages, block_tables,
            *, attn_impl=None):
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
                         paged_attn_fn=attn_impl)


@torch.no_grad()
def prefill_chunk(model: LlamaModel, tokens, start, lengths, pages: KVPages,
                  block_tables, *, attn_impl=None):
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
                         attend_to_pages=True, paged_attn_fn=attn_impl)


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
        o = _linear(layer.o, attn.reshape(B, 1, -1))
        x = _residual_tail(layer, cfg, x, o)
    return _unembed(model, x)[:, 0, :], pages
