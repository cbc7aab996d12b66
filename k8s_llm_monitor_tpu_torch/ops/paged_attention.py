"""Paged-attention kernel wrappers: flash paged prefill and fused decode.

The counterpart of the JAX package's ``ops/pallas_attention.py``.  Each
wrapper launches a hand-written CUDA kernel (``csrc/flash_prefill.cu``,
``csrc/fused_decode.cu``) for CUDA tensors and counts the launch in its
``launches`` attribute; for CPU tensors it runs its plain PyTorch version
(``*_plain``) beside it, built from the oracles of ops/attention.py.  There
is no fallback between the two: a CUDA tensor that the kernel cannot take,
a failed build or a refused launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from k8s_llm_monitor_tpu_torch.models.llama import _scatter_pages
from k8s_llm_monitor_tpu_torch.ops import _build
from k8s_llm_monitor_tpu_torch.ops.attention import (
    paged_decode_attention,
    paged_verify_attention,
)
from k8s_llm_monitor_tpu_torch.ops.rope import apply_rope

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # q, k_pages, v_pages, table, start, lengths, out,
    # B, S, H, KVH, bs, NB, stream
    "flash_prefill": ("flash_prefill_bf16", [_P] * 7 + [_I] * 6 + [_P]),
    # q, k_new, v_new, cos, sin, k_pages, v_pages, table, positions, out,
    # B, H, KVH, bs, NB, scale, stream
    "fused_decode": ("fused_decode_bf16",
                     [_P] * 10 + [_I] * 5 + [ctypes.c_float, _P]),
}
_fns: dict[str, object] = {}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        sym, argtypes = _SIGNATURES[name]
        fn = getattr(_build.load(name), sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def _int32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


# ---------------------------------------------------------------------------
# Flash paged prefill
# ---------------------------------------------------------------------------


def flash_prefill_attention_plain(q, k_pages, v_pages, block_table, start,
                                  lengths):
    """Plain version of the flash kernel: gather + dense causal attention.

    The query scale is applied in q's dtype before attention, exactly where
    the kernel (and the TPU kernel, pallas_attention.py:1200) applies it;
    scaling the f32 logits instead drifts in bf16.
    """
    D = q.shape[-1]
    return paged_verify_attention(q * (D ** -0.5), k_pages, v_pages,
                                  block_table, start, lengths, scale=1.0)


def flash_prefill_attention(q, k_pages, v_pages, block_table, start, lengths):
    """Causal prefill attention reading K/V straight from the paged pool.

    Query ``i`` of lane ``b`` sits at ``start[b] + i`` and attends causally
    through itself; the chunk's own K/V must already be in the pages
    (models/llama.py scatters before attention), so one call serves fresh
    prefill (``start = 0``) and continuation chunks alike.

    q [B, S, H, D]; pages [num_blocks, bs, KVH*D]; block_table [B, NB];
    start, lengths [B] (0 = inactive lane: its rows come back as zeros on
    the card, garbage on the CPU -- callers never read them).
    Returns [B, S, H, D] in q.dtype.
    """
    if not q.is_cuda:
        return flash_prefill_attention_plain(q, k_pages, v_pages, block_table,
                                             start, lengths)
    B, S, H, D = q.shape
    nb, bs, F = k_pages.shape
    KVH = F // D
    _check(q.dtype == torch.bfloat16 and k_pages.dtype == torch.bfloat16
           and v_pages.dtype == torch.bfloat16, "flash prefill takes bf16")
    _check(D == 128 and F == KVH * D and H % KVH == 0
           and H // KVH in (1, 2, 4, 8),
           f"flash prefill geometry unsupported (H={H}, F={F}, D={D})")
    _check(k_pages.is_contiguous() and v_pages.is_contiguous()
           and v_pages.shape == k_pages.shape, "pages must be contiguous")
    # Trap: the scale is applied in q's dtype before the kernel, as the
    # plain version and the TPU kernel do.
    qs = (q * (D ** -0.5)).contiguous()
    table = _int32(block_table)
    st, ln = _int32(start), _int32(lengths)
    out = torch.empty_like(qs)
    err = _kernel("flash_prefill")(
        qs.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        table.data_ptr(), st.data_ptr(), ln.data_ptr(), out.data_ptr(),
        B, S, H, KVH, bs, table.shape[1], _stream(q.device))
    _raise_on(err, "flash_prefill")
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
    kernel (and pallas_attention.py:521) scales it.
    """
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


def paged_decode_attention_fused(q, k_new, v_new, cos, sin, k_pages, v_pages,
                                 block_table, positions):
    """One decode token per lane: RoPE on q and the new k, append the roped
    k and raw v row at ``positions`` (in place; inactive lanes,
    ``positions == 0``, and positions past the table write the null block
    0), attend over the cached positions and the current token.

    q [B, 1, H, D] and k_new, v_new [B, 1, KVH, D] raw projections; cos,
    sin [B, 1, D] f32 angles at ``positions`` (ops/rope.py); pages
    [num_blocks, bs, KVH*D]; block_table [B, NB]; positions [B] = the new
    token's position.  Returns (attn [B, 1, H, D], k_pages, v_pages).
    """
    if not q.is_cuda:
        return paged_decode_attention_fused_plain(
            q, k_new, v_new, cos, sin, k_pages, v_pages, block_table,
            positions)
    B, S, H, D = q.shape
    nb, bs, F = k_pages.shape
    KVH = F // D
    _check(S == 1, f"fused decode takes one query token, got {S}")
    _check(all(t.dtype == torch.bfloat16
               for t in (q, k_new, v_new, k_pages, v_pages)),
           "fused decode takes bf16")
    _check(D == 128 and F == KVH * D and H % KVH == 0
           and H // KVH in (1, 2, 4, 8)
           and k_new.shape == (B, 1, KVH, D) and v_new.shape == k_new.shape,
           f"fused decode geometry unsupported (H={H}, F={F}, D={D})")
    _check(k_pages.is_contiguous() and v_pages.is_contiguous()
           and v_pages.shape == k_pages.shape, "pages must be contiguous")
    qc, kc, vc = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    cs = cos.to(torch.float32).reshape(B, D).contiguous()
    sn = sin.to(torch.float32).reshape(B, D).contiguous()
    table = _int32(block_table)
    pos = _int32(positions)
    out = torch.empty_like(qc)
    err = _kernel("fused_decode")(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), cs.data_ptr(),
        sn.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        table.data_ptr(), pos.data_ptr(), out.data_ptr(),
        B, H, KVH, bs, table.shape[1], D ** -0.5, _stream(q.device))
    _raise_on(err, "fused_decode")
    paged_decode_attention_fused.launches += 1
    return out, k_pages, v_pages


paged_decode_attention_fused.launches = 0
# Marker read by models/llama.py:is_fused_decode_impl.
paged_decode_attention_fused.fused_decode = True

KERNEL_WRAPPERS = (flash_prefill_attention, paged_decode_attention_fused)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
