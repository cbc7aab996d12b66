"""Paged-attention kernel wrappers: flash paged prefill, fused decode and
split paged attention, over a bf16 pool, an unscaled float8_e4m3fn pool
(``ModelConfig.kv_dtype``) or an int8/fp8 pool with scale planes.

The counterpart of the JAX package's ``ops/pallas_attention.py``.  Each
wrapper launches a hand-written CUDA kernel (``csrc/flash_prefill.cu``,
``csrc/fused_decode.cu``, ``csrc/paged_attn.cu``) for CUDA tensors and
counts the launch in its ``launches`` attribute; for CPU tensors it runs its
plain PyTorch version (``*_plain``) beside it, built from the oracles of
ops/attention.py.  There is no fallback between the two: a CUDA tensor that
the kernel cannot take, a failed build or a refused launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from k8s_llm_monitor_tpu_torch.models.llama import (
    _qmax_for,
    _quantize_heads,
    _scatter_pages,
)
from k8s_llm_monitor_tpu_torch.ops import _build
from k8s_llm_monitor_tpu_torch.ops.attention import (
    NEG_INF,
    causal_attention,
    gather_dequant,
    gather_pages,
    paged_decode_attention,
    paged_verify_attention,
)
from k8s_llm_monitor_tpu_torch.ops.rope import apply_rope

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# symbol -> (library, argtypes); the int8/fp8 symbols add the two scale
# planes after the pages, the e4m3 ones (an unscaled fp8 pool) take none.
_FLASH = [_P] * 7 + [_I] * 6 + [_P]      # q, kp, vp, table, start, lengths,
#                                          out, B, S, H, KVH, bs, NB, stream
_FUSED = [_P] * 11 + [_I] * 8 + [_F, _P]  # q, k_new, v_new, cos, sin, kp, vp,
#             table, positions, out, workspace, B, H, KVH, D, bs, NB, nsplit,
#             chunk, scale, stream
_SIGNATURES = {
    "flash_prefill_bf16": ("flash_prefill", _FLASH),
    "flash_prefill_e4m3": ("flash_prefill", _FLASH),
    "flash_prefill_int8": ("flash_prefill", [_P] * 2 + _FLASH),
    "flash_prefill_fp8": ("flash_prefill", [_P] * 2 + _FLASH),
    "fused_decode_bf16": ("fused_decode", _FUSED),
    "fused_decode_e4m3": ("fused_decode", _FUSED),
    "fused_decode_int8": ("fused_decode", [_P] * 2 + _FUSED),
    "fused_decode_fp8": ("fused_decode", [_P] * 2 + _FUSED),
}
for _sfx in ("bf16", "e4m3"):
    # q, kp, vp, table, starts, qlens, out, workspace, B, QS, H, KVH, D,
    # bs, NB, nsplit, chunk, scale, stream
    _SIGNATURES[f"paged_attn_{_sfx}"] = ("paged_attn",
                                         [_P] * 8 + [_I] * 9 + [_F, _P])
    # q, kp, vp, table, lengths, out, workspace, B, H, KVH, D, bs, NB,
    # nsplit, chunk, scale, stream
    _SIGNATURES[f"paged_attn_decode_{_sfx}"] = ("paged_attn",
                                                [_P] * 7 + [_I] * 8 + [_F, _P])
_QUANT_SUFFIX = {torch.int8: "int8", torch.float8_e4m3fn: "fp8"}
# An unscaled pool: bf16, or float8_e4m3fn pages with no scale planes.
_PLAIN_SUFFIX = {torch.bfloat16: "bf16", torch.float8_e4m3fn: "e4m3"}
_fns: dict[str, object] = {}


def _kernel(sym: str):
    fn = _fns.get(sym)
    if fn is None:
        lib, argtypes = _SIGNATURES[sym]
        fn = getattr(_build.load(lib), sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[sym] = fn
    return fn


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def _int32(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.int32 and t.is_contiguous():
        return t
    return t.to(torch.int32).contiguous()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


# Split-KV kernels (csrc/fused_decode.cu, csrc/paged_attn.cu): each lane's
# context is cut into chunks of keys, one block each, at most
# DECODE_MAX_SPLITS per lane (the chunk grows past that); chunks are whole
# 32-key tiles.  Keys per chunk by page element bytes: chip_smoke.py phase
# 4's sweeps found 256 fastest on bf16 pages (fused decode, and split paged
# attention at 1 and at 8 query tokens per lane) and 128 on int8/fp8
# pages, whose tiles carry half the bytes for the same arithmetic.
DECODE_CHUNK = {2: 256, 1: 128}
DECODE_MAX_SPLITS = 64
DECODE_TILE = 32
# Head dims the split-KV templates are instantiated for (csrc/split_kv.cuh:
# a block of D threads): llama-1b's 64 and Llama-3-8B's 128.
SPLIT_KV_HEAD_DIMS = (64, 128)
# Query heads per kv head every kernel is instantiated for
# (csrc/split_kv.cuh:with_qpk, csrc/flash_prefill.cu:dispatch); 7 is
# Qwen2-7B's 28 over 4.
QUERY_HEADS_PER_KV = (1, 2, 4, 7, 8)


def decode_splits(max_blocks: int, block_size: int,
                  page_bytes: int) -> tuple[int, int]:
    """(nsplit, chunk) of a split-KV kernel for a block table of
    ``max_blocks`` x ``block_size`` keys on pages of ``page_bytes``-byte
    elements: host integers from the table width, never from the
    positions, so the grid is fixed for a table."""
    keys = max(max_blocks * block_size, 1)
    chunk = DECODE_CHUNK[page_bytes]
    if -(-keys // chunk) > DECODE_MAX_SPLITS:
        per = -(-keys // DECODE_MAX_SPLITS)
        chunk = -(-per // DECODE_TILE) * DECODE_TILE
    return -(-keys // chunk), chunk


def decode_workspace_floats(B: int, KVH: int, rows: int, nsplit: int,
                            D: int = 128) -> int:
    """float32 slots of a split kernel's workspace: a partial (m, l,
    acc[D]) per (lane, kv head, split, row of the group), where a group
    has ``rows`` = qpk query heads for one token per lane (fused decode)
    and QS * qpk for QS tokens (split paged attention)."""
    return B * KVH * nsplit * rows * (D + 2)


# ---------------------------------------------------------------------------
# Flash paged prefill
# ---------------------------------------------------------------------------


def flash_prefill_attention_plain(q, k_pages, v_pages, block_table, start,
                                  lengths, *, k_scale=None, v_scale=None):
    """Plain version of the flash kernel: gather + dense causal attention.

    The query scale is applied in q's dtype before attention, exactly where
    the kernel (and the TPU kernel, pallas_attention.py:1200) applies it;
    scaling the f32 logits instead drifts in bf16.  With scale planes the
    gathered pages are dequantized in float32, which is what the kernel's
    (q . codes) * k_scale and (p * v_scale) . codes compute; unscaled
    pages (bf16 or fp8) are widened to float32 by the attention oracle, as
    the TPU kernel casts them (pallas_attention.py:1099).
    """
    D = q.shape[-1]
    qs = q * (D ** -0.5)
    if k_scale is None:
        return paged_verify_attention(qs, k_pages, v_pages, block_table,
                                      start, lengths, scale=1.0)
    B, S = q.shape[:2]
    kk = gather_dequant(k_pages, k_scale, block_table, D)
    vv = gather_dequant(v_pages, v_scale, block_table, D)
    positions = start[:, None] + torch.arange(S, dtype=torch.int32,
                                              device=q.device)[None, :]
    return causal_attention(qs, kk, vv, q_positions=positions,
                            kv_len=start + lengths, scale=1.0)


def _check_pool(k_pages, v_pages, k_scale, v_scale, D, what):
    """The pool a kernel takes: contiguous bf16 or float8_e4m3fn pages with
    no scales, or contiguous int8/fp8 pages with float32 scale planes
    [num_blocks, bs, KVH].  Returns the symbol suffix ("bf16", "e4m3",
    "int8", "fp8")."""
    nb, bs, F = k_pages.shape
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()
            and v_pages.shape == k_pages.shape
            and v_pages.dtype == k_pages.dtype):
        raise ValueError(f"{what}: pages must be contiguous and alike")
    if k_scale is None:
        suffix = _PLAIN_SUFFIX.get(k_pages.dtype)
        if suffix is None or v_scale is not None:
            raise ValueError(f"{what}: an unscaled pool must be bf16 or "
                             f"float8_e4m3fn, got {k_pages.dtype}")
        return suffix
    suffix = _QUANT_SUFFIX.get(k_pages.dtype)
    if suffix is None:
        raise ValueError(f"{what}: a quantized pool must be int8 or "
                         f"float8_e4m3fn, got {k_pages.dtype}")
    planes = (nb, bs, F // D)
    if not (v_scale is not None
            and k_scale.dtype == v_scale.dtype == torch.float32
            and k_scale.is_contiguous() and v_scale.is_contiguous()
            and k_scale.shape == planes and v_scale.shape == planes):
        raise ValueError(f"{what}: scale planes must be contiguous float32 "
                         "[nb, bs, KVH]")
    return suffix


def flash_prefill_attention(q, k_pages, v_pages, block_table, start, lengths,
                            *, k_scale=None, v_scale=None):
    """Causal prefill attention reading K/V straight from the paged pool.

    Query ``i`` of lane ``b`` sits at ``start[b] + i`` and attends causally
    through itself; the chunk's own K/V must already be in the pages
    (models/llama.py scatters before attention), so one call serves fresh
    prefill (``start = 0``) and continuation chunks alike.

    q [B, S, H, D]; pages [num_blocks, bs, KVH*D]; block_table [B, NB];
    start, lengths [B] (0 = inactive lane: its rows come back as zeros on
    the card, garbage on the CPU -- callers never read them).
    ``k_scale``/``v_scale`` ([num_blocks, bs, KVH] float32) switch on
    dequantization of int8/fp8 pages inside the kernel: K scales multiply
    the scores, V scales the probabilities (the row sum stays unscaled).
    Returns [B, S, H, D] in q.dtype.
    """
    if not q.is_cuda:
        return flash_prefill_attention_plain(q, k_pages, v_pages, block_table,
                                             start, lengths, k_scale=k_scale,
                                             v_scale=v_scale)
    B, S, H, D = q.shape
    nb, bs, F = k_pages.shape
    KVH = F // D
    _check(q.dtype == torch.bfloat16, "flash prefill takes bf16 queries")
    _check(D == 128 and F == KVH * D and H % KVH == 0
           and H // KVH in QUERY_HEADS_PER_KV,
           f"flash prefill geometry unsupported (H={H}, F={F}, D={D})")
    suffix = _check_pool(k_pages, v_pages, k_scale, v_scale, D,
                         "flash prefill")
    # Trap: the scale is applied in q's dtype before the kernel, as the
    # plain version and the TPU kernel do.
    qs = (q * (D ** -0.5)).contiguous()
    table = _int32(block_table)
    st, ln = _int32(start), _int32(lengths)
    out = torch.empty_like(qs)
    scales = ([] if k_scale is None
              else [k_scale.data_ptr(), v_scale.data_ptr()])
    err = _kernel(f"flash_prefill_{suffix}")(
        qs.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), *scales,
        table.data_ptr(), st.data_ptr(), ln.data_ptr(), out.data_ptr(),
        B, S, H, KVH, bs, table.shape[1], _stream(q.device))
    _raise_on(err, f"flash_prefill_{suffix}")
    flash_prefill_attention.launches += 1
    return out


flash_prefill_attention.launches = 0
# Marker read by models/llama.py:is_flash_prefill_impl.
flash_prefill_attention.flash_prefill = True


# ---------------------------------------------------------------------------
# Fused decode: RoPE + KV append + paged attention
# ---------------------------------------------------------------------------


def paged_decode_attention_fused_plain(q, k_new, v_new, cos, sin, k_pages,
                                       v_pages, block_table, positions):
    """Plain version of the fused kernel: ``apply_rope`` ->
    ``_scatter_pages`` -> ``paged_decode_attention``.  Updates the pages in
    place and returns them, like the kernel.

    The query is scaled by D**-0.5 in its own dtype before RoPE, where the
    kernel (and pallas_attention.py:521) scales it.  An fp8 pool takes
    ``_fused_plain_f32``: its appended row rounds from the f32 roped k, as
    the kernels' does.
    """
    if k_pages.dtype == torch.float8_e4m3fn:
        return _fused_plain_f32(q, k_new, v_new, cos, sin, k_pages, v_pages,
                                None, None, block_table, positions)[:3]
    D = q.shape[-1]
    pos = positions[:, None]
    active = (positions > 0)[:, None]
    q_r = apply_rope(q * (D ** -0.5), cos, sin)
    k_r = apply_rope(k_new, cos, sin)
    _scatter_pages(k_pages, k_r, block_table, pos, active)
    _scatter_pages(v_pages, v_new, block_table, pos, active)
    attn = paged_decode_attention(q_r, k_pages, v_pages, block_table,
                                  positions + 1, scale=1.0)
    return attn, k_pages, v_pages


def _fused_decode(suffix, q, k_new, v_new, cos, sin, k_pages, v_pages,
                  block_table, positions, scales=()):
    """Launch csrc/fused_decode.cu (checks as the other wrappers): the
    split kernel and its merge, on the workspace of ``decode_splits``."""
    B, S, H, D = q.shape
    _, bs, F = k_pages.shape
    KVH = F // D
    # One test, and a message formatted only on failure: this runs once
    # per layer and decode step.
    if not (S == 1 and q.dtype == k_new.dtype == v_new.dtype == torch.bfloat16
            and D in SPLIT_KV_HEAD_DIMS and F == KVH * D and H % KVH == 0
            and H // KVH in QUERY_HEADS_PER_KV
            and k_new.shape == (B, 1, KVH, D) and v_new.shape == k_new.shape):
        raise ValueError(
            f"fused decode takes one bf16 query token per lane, head_dim "
            f"64 or 128 and 1, 2, 4, 7 or 8 query heads per kv head: got q "
            f"{tuple(q.shape)} {q.dtype}, k_new {tuple(k_new.shape)} "
            f"{k_new.dtype}, v_new {tuple(v_new.shape)} {v_new.dtype}, "
            f"pages {tuple(k_pages.shape)}")
    qc, kc, vc = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    # [B, 1, D] angles: the kernel reads B * D contiguous floats.
    cs, sn = (t if t.dtype == torch.float32 and t.is_contiguous()
              else t.float().contiguous() for t in (cos, sin))
    table = _int32(block_table)
    pos = _int32(positions)
    nsplit, chunk = decode_splits(table.shape[1], bs, k_pages.element_size())
    fn = _kernel(f"fused_decode_{suffix}")
    # Allocated per call (the caching allocator makes that cheap); only
    # the live splits touch it.
    ws = torch.empty(decode_workspace_floats(B, KVH, H // KVH, nsplit, D),
                     dtype=torch.float32, device=q.device)
    out = torch.empty_like(qc)
    err = fn(qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), cs.data_ptr(),
             sn.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             *(t.data_ptr() for t in scales), table.data_ptr(),
             pos.data_ptr(), out.data_ptr(), ws.data_ptr(),
             B, H, KVH, D, bs, table.shape[1], nsplit, chunk, D ** -0.5,
             _stream(q.device))
    _raise_on(err, f"fused_decode_{suffix}")
    return out


def paged_decode_attention_fused(q, k_new, v_new, cos, sin, k_pages, v_pages,
                                 block_table, positions):
    """One decode token per lane: RoPE on q and the new k, append the roped
    k and raw v row at ``positions`` (in place; inactive lanes,
    ``positions == 0``, and positions past the table write the null block
    0), attend over the cached positions and the current token.  The pages
    are bf16 or unscaled float8_e4m3fn (the row cast from f32 with
    ``cast_e4m3``'s semantics).

    q [B, 1, H, D] and k_new, v_new [B, 1, KVH, D] raw projections; cos,
    sin [B, 1, D] f32 angles at ``positions`` (ops/rope.py); pages
    [num_blocks, bs, KVH*D]; block_table [B, NB]; positions [B] = the new
    token's position.  Returns (attn [B, 1, H, D], k_pages, v_pages).
    """
    if not q.is_cuda:
        return paged_decode_attention_fused_plain(
            q, k_new, v_new, cos, sin, k_pages, v_pages, block_table,
            positions)
    suffix = _check_pool(k_pages, v_pages, None, None, q.shape[-1],
                         "fused decode")
    out = _fused_decode(suffix, q, k_new, v_new, cos, sin, k_pages, v_pages,
                        block_table, positions)
    paged_decode_attention_fused.launches += 1
    return out, k_pages, v_pages


paged_decode_attention_fused.launches = 0
# Marker read by models/llama.py:is_fused_decode_impl.
paged_decode_attention_fused.fused_decode = True

# ---------------------------------------------------------------------------
# Fused decode on a quantized pool: quantize-on-append + dequantize in-kernel
# ---------------------------------------------------------------------------


def _fused_plain_f32(q, k_new, v_new, cos, sin, k_pages, v_pages, k_scale,
                     v_scale, block_table, positions):
    """The fused kernels' function on a 1-byte pool, in float32 as the
    Pallas kernels compute it: RoPE in float32 on the bf16-pre-scaled q and
    on the new k; the new k/v row written in place at ``positions``
    (null-block redirect as ``_scatter_pages``); attention over the cached
    rows ``< positions`` widened to float32, plus the current token as one
    more key, unrounded.

    Without scale planes (an unscaled float8_e4m3fn pool) the row is cast
    from float32 (``cast_e4m3``, pallas_attention.py:390-391) and the
    current token folds in as the f32 row itself (:445-454).  With them,
    per-head quantization of the row, written with its scales, and the
    current token folded as ``codes * scale`` where int8 codes are rounded
    and fp8 ones are not (:657-660 -- the pages get the fp8 cast, the
    softmax the unrounded quotient).  Returns (attn [B, 1, H, D], k_pages,
    v_pages, k_scale, v_scale), the pool updated in place.
    """
    B, _, H, D = q.shape
    KVH = k_new.shape[2]
    pos = positions[:, None]
    active = (positions > 0)[:, None]
    qf = apply_rope((q * (D ** -0.5)).float(), cos, sin)     # [B, 1, H, D]
    kf = apply_rope(k_new.float(), cos, sin)                 # [B, 1, KVH, D]
    qmax, is_int8 = _qmax_for(k_pages.dtype), k_pages.dtype == torch.int8
    cur, cached = [], []
    for x, pages, spages in ((kf, k_pages, k_scale),
                             (v_new.float(), v_pages, v_scale)):
        if spages is None:
            _scatter_pages(pages, x, block_table, pos, active)
            cur.append(x)
            cached.append(gather_pages(pages, block_table).float()
                          .reshape(B, -1, KVH, D))
            continue
        xq, sc = _quantize_heads(x, qmax, is_int8)
        _scatter_pages(pages, xq, block_table, pos, active)
        _scatter_pages(spages, sc, block_table, pos, active)
        cur.append(xq * sc[..., None])                       # [B, 1, KVH, D]
        cached.append(gather_dequant(pages, spages, block_table, D))
    # Cached rows < positions, then the current token as one more key.
    kk = torch.cat([cached[0], cur[0]], dim=1).repeat_interleave(H // KVH,
                                                                 dim=2)
    vv = torch.cat([cached[1], cur[1]], dim=1).repeat_interleave(H // KVH,
                                                                 dim=2)
    T = kk.shape[1] - 1
    keys = torch.arange(T + 1, device=q.device)[None, :]
    valid = (keys < positions[:, None]) | (keys == T)        # [B, T + 1]
    logits = torch.einsum("bshd,bthd->bhst", qf, kk)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    # Rows the kernels never read (the row just appended, rows past it)
    # stay out of the sum even where an fp8 page holds NaN.
    vv = torch.where(valid[:, :, None, None], vv, 0.0)
    attn = torch.einsum("bhst,bthd->bshd", probs, vv).to(q.dtype)
    return attn, k_pages, v_pages, k_scale, v_scale


def paged_decode_attention_fused_quant_plain(q, k_new, v_new, cos, sin,
                                             k_pages, v_pages, k_scale,
                                             v_scale, block_table, positions):
    """Plain version of the fused quant kernel (not the gather path):
    ``_fused_plain_f32`` with the scale planes.  Returns (attn [B, 1, H,
    D], k_pages, v_pages, k_scale, v_scale), the pool updated in place.
    """
    return _fused_plain_f32(q, k_new, v_new, cos, sin, k_pages, v_pages,
                            k_scale, v_scale, block_table, positions)


def paged_decode_attention_fused_quant(q, k_new, v_new, cos, sin, k_pages,
                                       v_pages, k_scale, v_scale, block_table,
                                       positions):
    """``paged_decode_attention_fused`` on an int8/fp8 pool: the new k (roped)
    and v rows are quantized per head (amax / qmax, scale floor 1e-8; int8
    rounds half to even and clips at 127, fp8 saturates at 448) and
    appended with their scales in place; cached rows score as
    ``(q . codes) * k_scale`` and accumulate ``p * v_scale * codes``.

    As ``paged_decode_attention_fused`` plus k_scale, v_scale
    [num_blocks, bs, KVH] float32.  Returns (attn [B, 1, H, D], k_pages,
    v_pages, k_scale, v_scale), the four pool tensors updated in place.
    """
    if not q.is_cuda:
        return paged_decode_attention_fused_quant_plain(
            q, k_new, v_new, cos, sin, k_pages, v_pages, k_scale, v_scale,
            block_table, positions)
    if k_scale is None:
        raise ValueError("fused quant decode needs the scale planes")
    suffix = _check_pool(k_pages, v_pages, k_scale, v_scale, q.shape[-1],
                         "fused quant decode")
    out = _fused_decode(suffix, q, k_new, v_new, cos, sin, k_pages, v_pages,
                        block_table, positions, (k_scale, v_scale))
    paged_decode_attention_fused_quant.launches += 1
    return out, k_pages, v_pages, k_scale, v_scale


paged_decode_attention_fused_quant.launches = 0
# Markers read by models/llama.py:is_fused_decode_impl and
# is_fused_quant_decode_impl.
paged_decode_attention_fused_quant.fused_decode = True
paged_decode_attention_fused_quant.quant_kv = True


# ---------------------------------------------------------------------------
# Split paged attention: QS query tokens per lane, no append, no RoPE
# ---------------------------------------------------------------------------

MAX_QUERY_TOKENS = 8     # spec_k + 1 at the JAX package's largest spec_k

# The kernel computes the flash kernel's function (q scaled by D**-0.5 in
# its dtype, as pallas_attention.py:208 does, then causal attention over
# the pages), so its plain version is flash_prefill_attention_plain.


def _paged_attn(q, k_pages, v_pages, block_table, *, lengths=None,
                starts=None, qlens=None):
    """Launch csrc/paged_attn.cu for CUDA tensors (checks as the other
    wrappers): the split kernel and its merge, on the workspace of
    ``decode_splits``.  Decode passes ``lengths`` and the kernels derive
    starts and qlens from them; verify passes ``starts`` and ``qlens``.
    The callers count the launch."""
    B, QS, H, D = q.shape
    _, bs, F = k_pages.shape
    KVH = F // D
    # One test, and a message formatted only on failure: this runs once
    # per layer and decode step.
    if not (q.dtype == torch.bfloat16 and D in SPLIT_KV_HEAD_DIMS
            and F == KVH * D and H % KVH == 0
            and H // KVH in QUERY_HEADS_PER_KV
            and 1 <= QS <= MAX_QUERY_TOKENS):
        raise ValueError(
            f"paged attention takes 1..{MAX_QUERY_TOKENS} bf16 query tokens "
            f"per lane, head_dim 64 or 128 and 1, 2, 4, 7 or 8 query heads "
            f"per kv head: got q {tuple(q.shape)} {q.dtype}, pages "
            f"{tuple(k_pages.shape)}")
    suffix = _check_pool(k_pages, v_pages, None, None, D, "paged attention")
    qc = q.contiguous()
    table = _int32(block_table)
    out = torch.empty_like(qc)
    nsplit, chunk = decode_splits(table.shape[1], bs, k_pages.element_size())
    ws = torch.empty(decode_workspace_floats(B, KVH, QS * (H // KVH), nsplit,
                                             D),
                     dtype=torch.float32, device=q.device)
    if lengths is not None:
        sym, lanes, dims = (f"paged_attn_decode_{suffix}", (_int32(lengths),),
                            (B,))
    else:
        sym, lanes, dims = (f"paged_attn_{suffix}",
                            (_int32(starts), _int32(qlens)), (B, QS))
    err = _kernel(sym)(
        qc.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        table.data_ptr(), *(t.data_ptr() for t in lanes), out.data_ptr(),
        ws.data_ptr(), *dims, H, KVH, D, bs, table.shape[1], nsplit, chunk,
        D ** -0.5, _stream(q.device))
    _raise_on(err, sym)
    return out


def paged_verify_attention_pallas(q, k_pages, v_pages, block_table, start,
                                  lengths):
    """Multi-query paged attention (speculative verify, small chunks):
    query ``i`` of lane ``b`` sits at ``start[b] + i`` and attends causally
    through itself over the pages, which already hold the chunk's K/V.

    q [B, QS, H, D] with QS <= 8; start, lengths [B] (0 = inactive lane:
    its rows, and rows past ``lengths``, come back as zeros on the card and
    garbage on the CPU -- callers never read them).  Returns
    [B, QS, H, D] in q.dtype.
    """
    if not q.is_cuda:
        return flash_prefill_attention_plain(q, k_pages, v_pages, block_table,
                                             start, lengths)
    out = _paged_attn(q, k_pages, v_pages, block_table, starts=start,
                      qlens=lengths)
    paged_verify_attention_pallas.launches += 1
    return out


paged_verify_attention_pallas.launches = 0


def paged_decode_attention_pallas(q, k_pages, v_pages, block_table, lengths):
    """One decode token per lane over the pages, which already hold it (the
    split ``decode_path="pallas"``: RoPE and the scatter run before): the
    paged-attention kernel at ``starts = lengths - 1``, ``qlens =
    min(lengths, 1)`` (pallas_attention.py:281-282), which the kernel
    derives itself on the card.  The calling convention of
    ``paged_decode_attention``: q [B, 1, H, D], lengths [B] valid keys.
    Returns [B, 1, H, D]."""
    if not q.is_cuda:
        return flash_prefill_attention_plain(
            q, k_pages, v_pages, block_table, (lengths - 1).clamp(min=0),
            lengths.clamp(max=1))
    if q.shape[1] != 1:
        raise ValueError(f"paged decode takes one query token, got "
                         f"{q.shape[1]}")
    out = _paged_attn(q, k_pages, v_pages, block_table, lengths=lengths)
    paged_decode_attention_pallas.launches += 1
    return out


paged_decode_attention_pallas.launches = 0

KERNEL_WRAPPERS = (flash_prefill_attention, paged_decode_attention_fused,
                   paged_decode_attention_fused_quant,
                   paged_verify_attention_pallas,
                   paged_decode_attention_pallas)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
