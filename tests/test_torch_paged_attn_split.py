"""The split-KV algebra of the split paged-attention kernel (csrc/paged_attn.cu).

The kernel cuts each lane's keys [0, starts + qlens) into chunks, keeps an
online-softmax state (m, l, acc) per chunk and query row -- row i of a lane
sees the keys at positions <= starts + i -- and merges, for each query
token, the chunks whose first key it sees, by log-sum-exp in chunk order.
``split_merge_attn`` below writes that algebra out in plain PyTorch; on the
same inputs, made from a numpy seed, it must equal the wrappers' plain
versions and the JAX Pallas kernels (interpret mode) for QS = 1, 5 and 8
query tokens per lane at 1, 4 and 8 query heads per kv head, with
horizons on both sides of the chunk boundaries, a lane whose horizon ends
inside the first chunk, an inactive lane (qlens 0), rows past qlens and
12-token blocks.  Tolerance: float32, atol = rtol = 2e-5 (the tolerance
the JAX package holds its kernels to against their oracles: the sums run
in another order).

Also: the workspace size of the kernel at the engine's shape.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_monitor_tpu.ops.pallas_attention import (
    paged_decode_attention_pallas as j_paged_decode,
)
from k8s_llm_monitor_tpu.ops.pallas_attention import (
    paged_verify_attention_pallas as j_paged_verify,
)
from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa

TOL = dict(rtol=2e-5, atol=2e-5)
D = 16
CHUNK = 8


def split_merge_attn(q, k_pages, v_pages, table, starts, qlens, chunk):
    """The kernel's algebra: per chunk of ``chunk`` keys and per query row
    a partial (m, l, acc) over the keys the row sees in the chunk (none:
    l = 0, weight 0), merged per token over the chunks whose first key it
    sees, by log-sum-exp in chunk order.  Rows past ``qlens`` and inactive
    lanes are zeros.  Reads the pages; returns [B, QS, H, D] float32."""
    B, QS, H, Dh = q.shape
    _, bs, F = k_pages.shape
    KVH = F // Dh
    qpk = H // KVH
    NB = table.shape[1]
    nsplit = -(-NB * bs // chunk)
    # The scale in q's dtype before attention, as the kernel applies it.
    qf = (q * Dh ** -0.5).float()
    out = torch.zeros(B, QS, H, Dh)
    for b in range(B):
        start, qlen = int(starts[b]), int(qlens[b])
        if qlen <= 0:
            continue
        horizon = start + torch.arange(qlen)                  # [qlen]
        parts = []
        for s in range(nsplit):
            k0 = s * chunk
            if k0 >= start + qlen:                            # exits at once
                break
            t = torch.arange(k0, min(k0 + chunk, start + qlen))
            blk = table[b, torch.clamp(t // bs, max=NB - 1)].long()
            K = k_pages[blk, t % bs].float().reshape(-1, KVH, Dh)
            V = v_pages[blk, t % bs].float().reshape(-1, KVH, Dh)
            K, V = (x.repeat_interleave(qpk, dim=1) for x in (K, V))
            see = (t[None, :] <= horizon[:, None])[:, None, :]  # [qlen, 1, T]
            logits = torch.einsum("ihd,thd->iht", qf[b, :qlen], K)
            m = torch.where(see, logits, -torch.inf).amax(-1)  # [qlen, H]
            p = torch.where(see, torch.exp(logits - torch.where(
                torch.isfinite(m), m, 0.0)[..., None]), 0.0)
            parts.append((m, p.sum(-1), torch.einsum("iht,thd->ihd", p, V)))
        for i in range(qlen):
            # The chunks token i reads: those whose first key it sees.
            n = (start + i) // chunk + 1
            assert all(float(part[1][i].abs().max()) == 0.0
                       for part in parts[n:]), "a row saw a key past its chunks"
            ms = torch.stack([part[0][i] for part in parts[:n]])   # [n, H]
            M = ms.amax(0)
            w = torch.exp(ms - M)
            L = (w * torch.stack([part[1][i] for part in parts[:n]])).sum(0)
            O = (w[..., None]
                 * torch.stack([part[2][i] for part in parts[:n]])).sum(0)
            out[b, i] = O / L[..., None]
    return out


def _case(seed, QS, qpk, bs, starts, qlens):
    """Random queries, a float32 pool and distinct non-null blocks per lane
    (an all-zero table row for an inactive lane)."""
    rng = np.random.default_rng(seed)
    B = len(starts)
    KVH = 1 if qpk == 8 else 2
    H = KVH * qpk
    max_blocks = -(-max(s + n for s, n in zip(starts, qlens)) // bs) + 1
    nb = B * max_blocks + 1
    q = rng.standard_normal((B, QS, H, D)).astype(np.float32)
    kp = rng.standard_normal((nb, bs, KVH * D)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, KVH * D)).astype(np.float32)
    table = np.zeros((B, max_blocks), np.int32)
    perm = rng.permutation(np.arange(1, nb))
    for b, n in enumerate(qlens):
        if n > 0:
            table[b] = perm[b * max_blocks:(b + 1) * max_blocks]
    return (q, kp, vp, table, np.asarray(starts, np.int32),
            np.asarray(qlens, np.int32))


def _lanes(QS):
    """(starts, qlens): a lane inside the first chunk, horizons on both
    sides of the chunk boundaries at 8 and 16 (last token at 7, 8; first
    at 7, 8, 15), an inactive lane, rows past qlens.  Seven lanes: an odd
    batch keeps the Pallas kernel at one lane per program, which
    interprets several times faster than four."""
    starts = [0, 7 - (QS - 1) // 2, 7, 8, 5, 13, 15]
    qlens = [min(QS, 3), QS, QS, QS, 0, max(QS - 2, 1), QS]
    return starts, qlens


@pytest.mark.parametrize("qpk", [1, 4, 8])
@pytest.mark.parametrize("QS,bs", [(1, 4), (5, 4), (8, 4), (8, 12)])
def test_split_merge_equals_plain_and_pallas(QS, qpk, bs):
    starts, qlens = _lanes(QS)
    case = _case(QS * 10 + qpk + bs, QS, qpk, bs, starts, qlens)
    tq, tk, tv, ttab, tst, tql = (torch.from_numpy(x) for x in case)
    model = split_merge_attn(tq, tk, tv, ttab, tst, tql, CHUNK).numpy()
    plain = pa.paged_verify_attention_pallas(tq, tk, tv, ttab, tst,
                                             tql).numpy()
    want = np.asarray(j_paged_verify(*(jnp.asarray(x) for x in case),
                                     interpret=True))
    for b, n in enumerate(qlens):      # rows past qlens: zeros in the model
        np.testing.assert_allclose(model[b, :n], plain[b, :n], **TOL)
        np.testing.assert_allclose(model[b, :n], want[b, :n], **TOL)
        assert not model[b, n:].any()


@pytest.mark.parametrize("qpk,bs", [(4, 4), (8, 12)])
def test_split_merge_decode_equals_plain_and_pallas(qpk, bs):
    # Decode: starts = max(lengths - 1, 0), qlens = min(lengths, 1), which
    # the kernel derives from lengths itself; a lane of length 0 is empty.
    lengths = [1, 0, 8, 9, 16, 17, 23]
    starts = [max(n - 1, 0) for n in lengths]
    qlens = [min(n, 1) for n in lengths]
    q, kp, vp, table, _, _ = _case(qpk + bs, 1, qpk, bs, starts, qlens)
    tq, tk, tv, ttab = (torch.from_numpy(x) for x in (q, kp, vp, table))
    tlen = torch.tensor(lengths, dtype=torch.int32)
    model = split_merge_attn(tq, tk, tv, ttab, torch.tensor(starts),
                             torch.tensor(qlens), CHUNK).numpy()
    plain = pa.paged_decode_attention_pallas(tq, tk, tv, ttab, tlen).numpy()
    want = np.asarray(j_paged_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(np.asarray(lengths, np.int32)), interpret=True))
    live = np.asarray(lengths) > 0
    np.testing.assert_allclose(model[live], plain[live], **TOL)
    np.testing.assert_allclose(model[live], want[live], **TOL)
    assert not model[~live].any()


@pytest.mark.parametrize("QS,nbytes", [(1, 8_519_680), (8, 68_157_440)])
def test_workspace_at_the_engine_shape(QS, nbytes):
    # 32 lanes, 8 kv heads, qpk 4 over the engine's 256 x 16 table: 16
    # splits of 256 keys, an f32 (m, l, acc[128]) per row of a group, and
    # a group has QS * qpk rows.
    nsplit, chunk = pa.decode_splits(256, 16, 2)
    assert (nsplit, chunk) == (16, 256)
    floats = pa.decode_workspace_floats(32, 8, QS * 4, nsplit)
    assert floats == 32 * 8 * 16 * QS * 4 * 130
    assert floats * 4 == nbytes
