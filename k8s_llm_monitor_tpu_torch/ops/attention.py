"""Attention oracles (dense causal prefill, contiguous and paged decode,
paged multi-query) and the selection of the prefill/decode attention path.

Layouts follow the JAX package so the tests compare like with like:
  activations  [batch, seq, heads, head_dim]
  paged KV     [num_blocks, block_size, kv_heads * head_dim], kv-head-major
               fused rows (models/llama.py:KVPages)
  block table  [batch, max_blocks_per_seq] int32 (0 = the null block)

Every function here is plain PyTorch: the semantics reference and the CPU
path (``paged_decode_attention_quant`` and ``gather_dequant`` for int8/fp8
pools; an unscaled float8_e4m3fn / float8_e5m2 / float16 pool is widened
as it is gathered, ``widen_pages``).  The hand-written CUDA kernels live behind ops/paged_attention.py and
are picked by ``select_prefill_impl`` / ``select_decode_impl`` /
``select_verify_impl``.
"""

from __future__ import annotations

import logging

import torch

logger = logging.getLogger("k8s_llm_monitor_tpu_torch.ops")

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _repeat_kv(x: torch.Tensor, q_per_kv: int) -> torch.Tensor:
    """[..., kv_heads, d] -> [..., kv_heads * q_per_kv, d]."""
    if q_per_kv == 1:
        return x
    return torch.repeat_interleave(x, q_per_kv, dim=-2)


def causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_positions: torch.Tensor | None = None,
    kv_len: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Dense causal attention for prefill.

    q: [B, S, H, D]; k, v: [B, T, KVH, D] with T >= S.  ``q_positions``
    [B, S] are absolute query positions (default: the last S of T);
    ``kv_len`` [B] masks keys at index >= kv_len.  ``scale`` defaults to
    D**-0.5.  Returns [B, S, H, D] in q.dtype.  (The JAX oracle's Gemma-2
    logit cap and sliding window are not ported.)
    """
    B, S, H, D = q.shape
    T, KVH = k.shape[1], k.shape[2]
    k = _repeat_kv(k, H // KVH)
    v = _repeat_kv(v, H // KVH)
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if q_positions is None:
        q_positions = (torch.arange(S, dtype=torch.int32, device=q.device)
                       + (T - S)).expand(B, S)
    kv_positions = torch.arange(T, dtype=torch.int32, device=q.device)
    causal = q_positions[:, :, None] >= kv_positions[None, None, :]
    if kv_len is not None:
        causal = causal & (kv_positions[None, None, :] < kv_len[:, None, None])
    logits = torch.where(causal[:, None, :, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, v.float())
    return out.to(q.dtype)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Single-token decode against a contiguous cache.

    q: [B, 1, H, D]; k_cache, v_cache: [B, T, KVH, D]; ``lengths`` [B]
    valid entries per sequence (the new token already written at
    lengths-1).
    """
    B, _, H, D = q.shape
    T, KVH = k_cache.shape[1], k_cache.shape[2]
    k = _repeat_kv(k_cache, H // KVH)
    v = _repeat_kv(v_cache, H // KVH)
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    kv_positions = torch.arange(T, dtype=torch.int32, device=q.device)[None, :]
    valid = kv_positions < lengths[:, None]
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, v.float())
    return out.to(q.dtype)


def gather_pages(pages: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """Gather each sequence's pages into a contiguous view.

    pages [num_blocks, bs, F]; block_table [B, max_blocks] (negative
    entries read block 0) -> [B, max_blocks * bs, F].
    """
    B, max_blocks = block_table.shape
    bs = pages.shape[1]
    g = pages[block_table.clamp(min=0).long()]        # [B, max_blocks, bs, F]
    return g.reshape(B, max_blocks * bs, g.shape[3])


# Unscaled page dtypes the readers widen, and what to: each fp8 format
# into bf16, which holds every e4m3 and e5m2 value; float16 into float32,
# since bf16 has 7 mantissa bits to fp16's 10.
_WIDEN = {torch.float8_e4m3fn: torch.bfloat16,
          torch.float8_e5m2: torch.bfloat16,
          torch.float16: torch.float32}


def widen_pages(x: torch.Tensor) -> torch.Tensor:
    """Gathered rows of an unscaled fp8 or fp16 pool, widened exactly, as
    the JAX package's readers widen them before attention (they compute in
    float32); other page dtypes as they are."""
    to = _WIDEN.get(x.dtype)
    return x if to is None else x.to(to)


def paged_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Single-token decode against the paged cache: gather, then masked
    ``decode_attention``.  The gather path of ``decode_step``."""
    B = q.shape[0]
    D = q.shape[-1]
    k = widen_pages(gather_pages(k_pages, block_table)).reshape(
        B, -1, k_pages.shape[2] // D, D)
    v = widen_pages(gather_pages(v_pages, block_table)).reshape(
        B, -1, v_pages.shape[2] // D, D)
    return decode_attention(q, k, v, lengths, scale=scale)


def gather_dequant(pages: torch.Tensor, scales: torch.Tensor,
                   block_table: torch.Tensor, head_dim: int) -> torch.Tensor:
    """Gather a quantized pool's pages and scales and dequantize the
    gathered rows (never the resident pool): pages [num_blocks, bs,
    KVH*D] int8/fp8, scales [num_blocks, bs, KVH] float32 ->
    [B, max_blocks * bs, KVH, D] float32."""
    B = block_table.shape[0]
    s = gather_pages(scales, block_table)                 # [B, T, KVH]
    x = gather_pages(pages, block_table).float()
    return x.reshape(B, -1, s.shape[-1], head_dim) * s[..., None]


def paged_decode_attention_quant(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    block_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Quantized-pool twin of ``paged_decode_attention``: gather pages and
    per-(token, head) scales, dequantize, cast to q.dtype (as the JAX
    oracle does), then masked ``decode_attention``.  The gather/dequant
    branch of ``decode_step``."""
    D = q.shape[-1]
    k = gather_dequant(k_pages, k_scale, block_table, D).to(q.dtype)
    v = gather_dequant(v_pages, v_scale, block_table, D).to(q.dtype)
    return decode_attention(q, k, v, lengths, scale=scale)


def paged_verify_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_table: torch.Tensor,
    start: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Multi-query paged attention: query ``i`` of lane ``b`` sits at
    ``start[b] + i`` and attends causally through itself over the gathered
    pages; ``lengths`` counts valid queries (0 = inactive lane, rows
    garbage).  ``scale`` as in ``causal_attention``."""
    B, S, H, D = q.shape
    KVH = k_pages.shape[2] // D
    kk = widen_pages(gather_pages(k_pages, block_table)).reshape(B, -1, KVH, D)
    vv = widen_pages(gather_pages(v_pages, block_table)).reshape(B, -1, KVH, D)
    positions = start[:, None] + torch.arange(S, dtype=torch.int32,
                                              device=q.device)[None, :]
    return causal_attention(q, kk, vv, q_positions=positions,
                            kv_len=start + lengths, scale=scale)


def _decode_geometry_ok(cfg, device: torch.device) -> bool:
    """What the split-KV CUDA kernels (fused decode, split paged attention)
    take: bf16 activations over a bf16 pool, an unscaled float8_e4m3fn /
    float8_e5m2 / float16 pool (the pool does not enter, as in the JAX
    package) or an int8/fp8 pool with scales (the fused path), head_dim 64
    or 128, 1/2/4/7/8 query heads per kv group (csrc/split_kv.cuh template
    instances) -- the JAX package's ``_pallas_geometry_ok`` for every preset
    the port has.  On the CPU the wrappers run their plain versions, which
    take any geometry."""
    from k8s_llm_monitor_tpu_torch.ops.paged_attention import (
        QUERY_HEADS_PER_KV,
        SPLIT_KV_HEAD_DIMS,
    )

    if cfg is None or cfg.has_attn_extras or cfg.head_dim_ % 2:
        return False
    if device.type != "cuda":
        return True
    return (cfg.dtype == "bfloat16" and cfg.head_dim_ in SPLIT_KV_HEAD_DIMS
            and cfg.num_heads % cfg.num_kv_heads == 0
            and cfg.q_per_kv in QUERY_HEADS_PER_KV)


def _prefill_geometry_ok(cfg, device: torch.device) -> bool:
    """What the flash prefill kernel takes: the decode geometry at head_dim
    128 only, as the JAX package's ``_flash_ok`` gates its TPU kernel."""
    return _decode_geometry_ok(cfg, device) and (
        device.type != "cuda" or cfg.head_dim_ == 128)


def select_prefill_impl(device: torch.device, cfg=None, mode: str = "auto"):
    """Pick the prefill-family attention path (fresh prefill and chunks).

    ``mode`` (EngineConfig.prefill_path):
      * ``"auto"``  -- the flash paged-prefill CUDA kernel on a CUDA device
        when the model takes it; the dense path everywhere else;
      * ``"flash"`` -- the kernel wrapper (its plain version on CPU
        tensors); raises ``ValueError`` when the model cannot take it;
      * ``"dense"`` -- None: models/llama.py's dense branches.
    The pool's dtype does not enter: for an int8/fp8 pool models/llama.py
    hands the wrapper the scale planes and it dequantizes in the kernel.
    """
    if mode == "dense":
        return None
    if mode not in ("auto", "flash"):
        raise ValueError(f"unknown prefill_path {mode!r}; expected "
                         "'auto', 'flash', or 'dense'")
    ok = _prefill_geometry_ok(cfg, device)
    if mode == "flash" and not ok:
        raise ValueError(
            "prefill_path='flash' but the model can't take the flash kernel "
            "(attn extras, or on CUDA: not bf16 / head_dim != 128 / "
            "unsupported GQA ratio); use prefill_path='auto'")
    if mode == "auto" and (device.type != "cuda" or not ok):
        return None
    from k8s_llm_monitor_tpu_torch.ops.paged_attention import (
        flash_prefill_attention,
    )

    return flash_prefill_attention


def select_decode_impl(device: torch.device, cfg=None, mode: str = "auto",
                       kv_quant: str = ""):
    """Pick the decode-step attention path.

    ``mode`` (EngineConfig.decode_path):
      * ``"auto"``   -- the fused RoPE+append+attention CUDA kernel on a
        CUDA device when the model takes it; the gather path otherwise;
      * ``"fused"``  -- the fused kernel wrapper (its plain version on CPU
        tensors); raises ``ValueError`` when the model cannot take it;
      * ``"pallas"`` -- the split path: RoPE and the page scatter in
        PyTorch around the paged-attention kernel wrapper (the name of
        the JAX package's mode); raises like ``"fused"``;
      * ``"gather"`` -- ``paged_decode_attention`` (the numerics oracle).
    ``kv_quant`` ("int8"/"fp8", EngineConfig.kv_dtype) selects the
    quantized pool: the fused path becomes the fused quant kernel (marked
    ``quant_kv``); the split kernel takes no scales, so ``"pallas"`` gives
    way to the gather/dequant oracle with a logged warning.  On a
    quantized pool every non-fused return is a sentinel: decode_step runs
    its gather/dequant branch.
    Fused impls carry ``fused_decode = True`` and take the extended calling
    convention (raw q/k/v + angles in, attention + pages out).
    """
    from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa

    if mode == "gather":
        return paged_decode_attention
    if mode not in ("auto", "fused", "pallas"):
        raise ValueError(f"unknown decode_path {mode!r}; expected "
                         "'auto', 'fused', 'gather', or 'pallas'")
    if mode == "pallas" and kv_quant:
        logger.warning(
            "decode_path='pallas' has no quantized-KV support; the split "
            "kernel is bypassed for the gather/dequant reference")
        return paged_decode_attention
    ok = _decode_geometry_ok(cfg, device)
    if mode != "auto" and not ok:
        raise ValueError(
            f"decode_path={mode!r} but the model can't take the kernel "
            "(attn extras, odd head_dim, or on CUDA: not bf16 / head_dim "
            "not 64 or 128 / unsupported GQA ratio); use decode_path='auto'")
    if mode == "pallas":
        return pa.paged_decode_attention_pallas
    if mode == "auto" and (device.type != "cuda" or not ok):
        return paged_decode_attention
    if kv_quant:
        return pa.paged_decode_attention_fused_quant
    return pa.paged_decode_attention_fused


def select_verify_impl(device: torch.device, cfg=None):
    """Pick the verify (multi-query paged) attention path: None for
    attn-extras models; ``paged_verify_attention`` (the gather) off the
    card; on the card the split paged attention wrapper
    (``paged_verify_attention_pallas``), at every table width, and
    ``ValueError`` for a geometry it does not take.  The JAX package keeps
    the gather below a 2,048-token table (its TPU measurement); on the H100
    the kernel is the faster at 1,024 tokens as well (PERF.md, section 7),
    so the port has no threshold.  Returns a callable (q, k_pages, v_pages,
    table, start, lengths)."""
    if cfg is not None and cfg.has_attn_extras:
        return None
    if device.type != "cuda":
        return paged_verify_attention
    if cfg is not None and not _decode_geometry_ok(cfg, device):
        raise ValueError(
            f"speculative verify: {getattr(cfg, 'name', 'model')} can't take "
            "the split paged attention kernel (on CUDA: not bf16 / head_dim "
            "not 64 or 128 / unsupported GQA ratio); set spec_k=0")
    from k8s_llm_monitor_tpu_torch.ops.paged_attention import (
        paged_verify_attention_pallas,
    )

    return paged_verify_attention_pallas
