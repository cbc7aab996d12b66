"""The split-KV algebra of the fused decode kernels (csrc/fused_decode.cu).

The kernel cuts each lane's context into chunks of keys, keeps an online
softmax state (m, l, acc) per chunk, folds the current token in once
(into chunk 0, from registers) and merges the chunks by log-sum-exp.
``split_merge_decode`` below writes that algebra out in plain PyTorch; on
the same inputs, made from a numpy seed, it must equal the fused wrappers'
plain versions and the JAX Pallas kernels (interpret mode) over a float32
pool (the unquantized kernel) and int8 / fp8 pools, with positions on the
chunk boundaries, a lane with one cached row and an inactive lane.
Tolerance: float32, atol = rtol = 2e-5 (the tolerance the JAX package holds
its kernels to against their oracles: the sums run in another order).

Also: the host helper that picks the split count, the chunk and the
workspace size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_monitor_tpu.ops.pallas_attention import (
    paged_decode_attention_fused as j_fused,
)
from k8s_llm_monitor_tpu.ops.pallas_attention import (
    paged_decode_attention_fused_quant as j_fused_quant,
)
from k8s_llm_monitor_tpu.ops.rope import rope_angles as j_rope_angles
from k8s_llm_monitor_tpu_torch.models import llama as tllama
from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa
from k8s_llm_monitor_tpu_torch.ops.rope import apply_rope
from k8s_llm_monitor_tpu_torch.ops.rope import rope_angles as t_rope_angles

TOL = dict(rtol=2e-5, atol=2e-5)
THETA = 10_000.0
D = 16
J_DTYPE = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}


def split_merge_decode(q, k_new, v_new, cos, sin, k_pages, v_pages, table,
                       positions, chunk, k_scale=None, v_scale=None):
    """The kernel's algebra: per chunk of ``chunk`` keys a partial (m, l,
    acc) over the cached rows ``< positions`` (scores (q . k) * k_scale,
    weights p * v_scale, l of the unscaled p), the current token folded
    into chunk 0 (int8 codes rounded, fp8 quotients not), chunks merged by
    log-sum-exp in order.  Reads the pages, writes nothing.  Returns
    [B, 1, H, D] float32."""
    B, _, H, Dh = q.shape
    _, bs, F = k_pages.shape
    KVH = F // Dh
    qpk = H // KVH
    NB = table.shape[1]
    nsplit = -(-NB * bs // chunk)
    qf = apply_rope((q * Dh ** -0.5).float(), cos, sin)[:, 0]   # [B, H, D]
    kc = apply_rope(k_new.float(), cos, sin)[:, 0]              # [B, KVH, D]
    vc = v_new.float()[:, 0]
    if k_scale is not None:
        qmax = tllama._qmax_for(k_pages.dtype)
        is_int8 = k_pages.dtype == torch.int8
        cur = []
        for x in (kc, vc):
            amax = x.abs().amax(-1, keepdim=True)
            sc = torch.clamp(amax / qmax, min=1e-8)
            xq = x / sc
            if is_int8:
                xq = torch.clamp(torch.round(xq), -qmax, qmax)
            cur.append(xq * sc)
        kc, vc = cur
    out = torch.zeros(B, H, Dh)
    for b in range(B):
        pos = int(positions[b])
        qg = qf[b].reshape(KVH, qpk, Dh)
        parts = []
        for s in range(nsplit):
            k0 = s * chunk
            if s > 0 and k0 >= pos:
                break
            t = torch.arange(k0, max(min(k0 + chunk, pos), k0))
            blk = table[b, torch.clamp(t // bs, max=NB - 1)].long()
            row = t % bs
            K = k_pages[blk, row].float().reshape(-1, KVH, Dh)
            V = v_pages[blk, row].float().reshape(-1, KVH, Dh)
            logits = torch.einsum("gjd,tgd->gjt", qg, K)
            w = torch.ones(len(t), KVH)
            if k_scale is not None:
                logits = logits * k_scale[blk, row].T[:, None, :]
                w = v_scale[blk, row]
            if s == 0:                   # the current token, once
                cur = torch.einsum("gjd,gd->gj", qg, kc[b])[..., None]
                logits = torch.cat([logits, cur], dim=-1)
            m = logits.amax(-1)
            p = torch.exp(logits - m[..., None])
            l = p.sum(-1)
            acc = torch.einsum("gjt,tgd->gjd", p[..., :len(t)]
                               * w.T[:, None, :], V)
            if s == 0:
                acc = acc + p[..., -1:] * vc[b][:, None, :]
            parts.append((m, l, acc))
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        L = sum(torch.exp(m - M) * l for m, l, _ in parts)
        O = sum(torch.exp(m - M)[..., None] * a for m, _, a in parts)
        out[b] = (O / L[..., None]).reshape(H, Dh)
    return out[:, None]


def _case(seed, kind, positions, H, KVH, bs, max_blocks):
    """Random decode state: queries, new rows, a pool (quantized by the
    port for int8 / fp8) and distinct non-null blocks per lane (an all-zero
    table row for an inactive lane)."""
    rng = np.random.default_rng(seed)
    B = len(positions)
    nb = B * max_blocks + 2
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k_new = (rng.standard_normal((B, 1, KVH, D)) * 2).astype(np.float32)
    v_new = (rng.standard_normal((B, 1, KVH, D)) * 2).astype(np.float32)
    kp = torch.from_numpy(rng.standard_normal((nb, bs, KVH * D))
                          .astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal((nb, bs, KVH * D))
                          .astype(np.float32))
    scales = ()
    if kind != "bf16":
        qdt, qmax = tllama.kv_quant_spec(kind)
        (kp, ks), (vp, vs) = (tllama.quantize_kv(x, KVH, qdt, qmax)
                              for x in (kp, vp))
        scales = (ks, vs)
    table = np.zeros((B, max_blocks), np.int32)
    nxt = 1
    for b, p in enumerate(positions):
        if p > 0:
            table[b] = np.arange(nxt, nxt + max_blocks)
            nxt += max_blocks
    pos = np.asarray(positions, np.int32)
    return q, k_new, v_new, kp, vp, scales, table, pos


def _jax(kind, q, k_new, v_new, kp, vp, scales, table, pos):
    jc, js = j_rope_angles(jnp.asarray(pos)[:, None], D, THETA)
    args = (jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), jc, js)
    if kind == "bf16":
        out = j_fused(*args, jnp.asarray(kp.numpy()), jnp.asarray(vp.numpy()),
                      jnp.asarray(table), jnp.asarray(pos), interpret=True)
    else:
        codes = [jnp.asarray(x.float().numpy()).astype(J_DTYPE[kind])
                 for x in (kp, vp)]
        out = j_fused_quant(*args, *codes,
                            *(jnp.asarray(s.numpy()) for s in scales),
                            jnp.asarray(table), jnp.asarray(pos),
                            interpret=True)
    return np.asarray(out[0])


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("chunk,H,KVH,bs,max_blocks,positions", [
    # chunks of 8 keys over 4-token blocks, qpk 4: both sides of the chunk
    # boundaries, one cached row, an inactive lane, the last row
    (8, 8, 2, 4, 6, [0, 1, 7, 8, 9, 16, 23]),
    # chunks of 16 over 4-token blocks, qpk 8 (one kv head)
    (16, 8, 1, 4, 10, [0, 1, 15, 16, 17, 32, 39]),
])
def test_split_merge_equals_plain_and_pallas(kind, chunk, H, KVH, bs,
                                             max_blocks, positions):
    case = _case(chunk + len(kind), kind, positions, H, KVH, bs, max_blocks)
    q, k_new, v_new, kp, vp, scales, table, pos = case
    tc, ts = t_rope_angles(torch.from_numpy(pos)[:, None], D, THETA)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k_new, v_new))
    ttab, tpos = torch.from_numpy(table), torch.from_numpy(pos)
    model = split_merge_decode(tq, tk, tv, tc, ts, kp, vp, ttab, tpos, chunk,
                               *scales).numpy()
    # The model reads the pool before the append; rows < pos do not change.
    pool = [t.clone() for t in (kp, vp, *scales)]
    if kind == "bf16":
        plain = pa.paged_decode_attention_fused(tq, tk, tv, tc, ts, *pool,
                                                ttab, tpos)[0].numpy()
    else:
        plain = pa.paged_decode_attention_fused_quant(
            tq, tk, tv, tc, ts, *pool, ttab, tpos)[0].numpy()
    want = _jax(kind, *case)
    act = pos > 0
    np.testing.assert_allclose(model[act], plain[act], **TOL)
    np.testing.assert_allclose(model[act], want[act], **TOL)
    # An inactive lane sees the current token alone: its v row, as folded.
    idle = ~act
    if kind == "bf16":
        np.testing.assert_allclose(
            model[idle], np.repeat(v_new[idle], H // KVH, axis=2), **TOL)
    else:
        np.testing.assert_allclose(model[idle], plain[idle], **TOL)


@pytest.mark.parametrize("max_blocks,bs,page_bytes,want", [
    (256, 16, 2, (16, 256)),    # the engine's table in chip_smoke.py phase 2
    (256, 16, 1, (32, 128)),    # ... on int8 / fp8 pages
    (128, 16, 2, (8, 256)),     # chip_smoke.py phase 1's table
    (128, 12, 2, (6, 256)),     # 12-token blocks
    (2048, 16, 2, (64, 512)),   # at the cap: the chunk doubles
    (1024, 16, 1, (64, 256)),   # ... and on 1-byte pages
    (1500, 12, 2, (63, 288)),   # past the cap, chunks of whole 32-key tiles
    (1, 1, 2, (1, 256)),
])
def test_decode_splits(max_blocks, bs, page_bytes, want):
    nsplit, chunk = pa.decode_splits(max_blocks, bs, page_bytes)
    assert (nsplit, chunk) == want
    assert chunk % pa.DECODE_TILE == 0
    assert nsplit <= pa.DECODE_MAX_SPLITS
    assert nsplit * chunk >= max_blocks * bs > (nsplit - 1) * chunk


def test_decode_workspace_at_the_engine_shape():
    # 32 lanes, 8 kv heads, qpk 4, 16 splits (bf16) or 32 (1-byte pages):
    # f32 (m, l, acc[128]) each.
    for page_bytes, splits, nbytes in ((2, 16, 8_519_680),
                                       (1, 32, 17_039_360)):
        nsplit, _ = pa.decode_splits(256, 16, page_bytes)
        floats = pa.decode_workspace_floats(32, 8, 4, nsplit)
        assert floats == 32 * 8 * splits * 4 * 130
        assert floats * 4 == nbytes
