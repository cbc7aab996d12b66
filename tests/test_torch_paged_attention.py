"""Plain versions of the port's CUDA kernels against the JAX Pallas kernels.

The JAX side runs the Pallas kernels in interpret mode on the CPU, as the
JAX package's own tests do (tests/test_flash_prefill.py,
tests/test_fused_decode.py); the port's wrappers run their plain PyTorch
versions because the tensors lie on the CPU.  float32, atol=rtol=2e-5 (the
tolerance the JAX package holds its kernels to against the same oracles:
the online softmax sums in another order than the dense reference).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_monitor_tpu.ops.pallas_attention import (
    flash_prefill_attention as j_flash,
)
from k8s_llm_monitor_tpu.ops.pallas_attention import (
    paged_decode_attention_fused as j_fused,
)
from k8s_llm_monitor_tpu.ops.pallas_attention import (
    paged_decode_attention_pallas as j_paged_decode,
)
from k8s_llm_monitor_tpu.ops.pallas_attention import (
    paged_verify_attention_pallas as j_paged_verify,
)
from k8s_llm_monitor_tpu.ops.rope import rope_angles as j_rope_angles
from k8s_llm_monitor_tpu_torch.ops import _build
from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa
from k8s_llm_monitor_tpu_torch.ops.rope import rope_angles as t_rope_angles

TOL = dict(rtol=2e-5, atol=2e-5)
THETA = 10_000.0


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


# ----------------------------------------------------------- flash prefill


def _paged_case(seed, B, S, KVH, D, qpk, bs, max_blocks, num_blocks, starts,
                lengths):
    """Random pool, distinct-block tables and queries for one geometry
    (the case shape of tests/test_flash_prefill.py:_paged_case)."""
    rng = np.random.default_rng(seed)
    H = KVH * qpk
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((num_blocks, bs, KVH * D)).astype(np.float32)
    v = rng.standard_normal((num_blocks, bs, KVH * D)).astype(np.float32)
    tables = np.stack([rng.permutation(np.arange(1, num_blocks))[:max_blocks]
                       for _ in range(B)]).astype(np.int32)
    return (q, k, v, tables, np.asarray(starts, np.int32),
            np.asarray(lengths, np.int32))


def _assert_valid_rows_close(got, want, lengths):
    for b, n in enumerate(lengths):          # rows past lengths are garbage
        np.testing.assert_allclose(np.asarray(got)[b, :n],
                                   np.asarray(want)[b, :n], **TOL)


@pytest.mark.parametrize("S", [16, 32])
def test_flash_plain_matches_pallas_ragged(S):
    # Fresh prefill, a continuation chunk, an inactive lane, and a lane
    # ending one token below block alignment (15 + 16 = 31 = 4*8 - 1).
    starts, lengths = [0, 17, 33, 15], [S, S - 7, 0, 16]
    case = _paged_case(S, B=4, S=S, KVH=2, D=16, qpk=2, bs=8, max_blocks=12,
                       num_blocks=40, starts=starts, lengths=lengths)
    want = j_flash(*_j(*case), interpret=True)
    got = pa.flash_prefill_attention(*_t(*case))
    _assert_valid_rows_close(got, want, lengths)


def test_flash_plain_matches_pallas_llama3_8b_heads():
    # The Llama-3-8B head geometry: 32 query heads over 8 kv heads,
    # head_dim 128, block 16, at small B and S.
    starts, lengths = [0, 21], [16, 11]
    case = _paged_case(7, B=2, S=16, KVH=8, D=128, qpk=4, bs=16, max_blocks=3,
                       num_blocks=8, starts=starts, lengths=lengths)
    want = j_flash(*_j(*case), interpret=True)
    got = pa.flash_prefill_attention(*_t(*case))
    _assert_valid_rows_close(got, want, lengths)


# ------------------------------------------------------------ fused decode


def _fused_case(rng, B, H, KVH, D, bs, max_blocks, positions):
    """Random decode state (tests/test_fused_decode.py:_fused_case): position
    0 is an inactive lane with an all-zero table row; active lanes get
    distinct non-null blocks covering their append target."""
    num_blocks = B * max_blocks + 2
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k_new = rng.standard_normal((B, 1, KVH, D)).astype(np.float32)
    v_new = rng.standard_normal((B, 1, KVH, D)).astype(np.float32)
    k_pages = rng.standard_normal((num_blocks, bs, KVH * D)).astype(np.float32)
    v_pages = rng.standard_normal((num_blocks, bs, KVH * D)).astype(np.float32)
    table = np.zeros((B, max_blocks), np.int32)
    nxt = 1
    for b in range(B):
        if positions[b] > 0:
            used = min(int(positions[b]) // bs + 1, max_blocks)
            table[b, :used] = np.arange(nxt, nxt + used)
            nxt += used
    pos = np.asarray(positions, np.int32)
    return q, k_new, v_new, k_pages, v_pages, table, pos


def _run_both(case, D):
    q, k_new, v_new, k_pages, v_pages, table, pos = case
    jc, js = j_rope_angles(jnp.asarray(pos)[:, None], D, THETA)
    want = j_fused(*_j(q, k_new, v_new), jc, js, *_j(k_pages, v_pages, table,
                                                    pos), interpret=True)
    tc, ts = t_rope_angles(torch.from_numpy(pos)[:, None], D, THETA)
    tq, tk, tv, tkp, tvp, ttab, tpos = _t(*case)
    got = pa.paged_decode_attention_fused(tq, tk, tv, tc, ts, tkp, tvp, ttab,
                                          tpos)
    assert got[1] is tkp and got[2] is tvp, "pages must update in place"
    return got, want


@pytest.mark.parametrize("B,H,KVH,D,bs,max_blocks", [
    (4, 8, 2, 64, 16, 4),     # GQA 4:1
    (2, 32, 8, 128, 16, 3),   # Llama-3-8B heads
])
def test_fused_plain_matches_pallas(B, H, KVH, D, bs, max_blocks):
    rng = np.random.default_rng(B * 100 + H)
    positions = rng.integers(1, max_blocks * bs - 1, size=(B,))
    if B >= 4:
        positions[1] = 0                    # inactive lane
    case = _fused_case(rng, B, H, KVH, D, bs, max_blocks, positions)
    (out, kp, vp), (jout, jkp, jvp) = _run_both(case, D)
    act = positions > 0
    np.testing.assert_allclose(out.numpy()[act], np.asarray(jout)[act], **TOL)
    np.testing.assert_allclose(kp.numpy(), np.asarray(jkp), **TOL)
    np.testing.assert_allclose(vp.numpy(), np.asarray(jvp), **TOL)


def test_fused_plain_page_boundaries_inactive_and_past_table():
    B, H, KVH, D, bs, max_blocks = 8, 8, 4, 64, 8, 4
    rng = np.random.default_rng(7)
    # inactive | first | block edges | last row of the table | past the
    # table (+3 so its null-block write does not collide with the inactive
    # lane's row 0 of block 0)
    positions = np.array([0, 1, 7, 8, 15, 16, bs * max_blocks - 1,
                          bs * max_blocks + 3])
    case = _fused_case(rng, B, H, KVH, D, bs, max_blocks, positions)
    table = case[5]
    nb = case[3].shape[0]
    table[7, :] = np.arange(nb - max_blocks, nb)     # full table, overflowed
    (out, kp, vp), (jout, jkp, jvp) = _run_both(case, D)
    # Attention is defined for active lanes whose context the table covers;
    # the appends must land identically everywhere, null block included.
    cmp = (positions > 0) & (positions < bs * max_blocks)
    np.testing.assert_allclose(out.numpy()[cmp], np.asarray(jout)[cmp], **TOL)
    np.testing.assert_allclose(kp.numpy(), np.asarray(jkp), **TOL)
    np.testing.assert_allclose(vp.numpy(), np.asarray(jvp), **TOL)
    assert np.isfinite(out.numpy()).all()


# ------------------------------------------------- split paged attention


def test_paged_decode_plain_matches_pallas():
    # One query token per lane at lengths - 1: a lane at length 1, a page
    # boundary (length 9 = the first row of block 2), a full table.
    lengths = [1, 9, 16, 40, 23]
    case = _paged_case(5, B=5, S=1, KVH=2, D=16, qpk=2, bs=8, max_blocks=5,
                       num_blocks=30, starts=[0] * 5, lengths=lengths)
    q, k, v, tables = case[:4]
    ln = np.asarray(lengths, np.int32)
    want = j_paged_decode(*_j(q, k, v, tables, ln), interpret=True)
    got = pa.paged_decode_attention_pallas(*_t(q, k, v, tables, ln))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("qpk", [1, 4])
def test_paged_verify_plain_matches_pallas(qpk):
    # spec_k + 1 = 5 query tokens: fresh, mid-context, a short chunk, an
    # inactive lane, a chunk ending one token below block alignment.
    starts, lengths = [0, 9, 30, 4, 26], [5, 5, 2, 0, 5]
    case = _paged_case(6 + qpk, B=5, S=5, KVH=2, D=16, qpk=qpk, bs=8,
                       max_blocks=5, num_blocks=30, starts=starts,
                       lengths=lengths)
    want = j_paged_verify(*_j(*case), interpret=True)
    got = pa.paged_verify_attention_pallas(*_t(*case))
    _assert_valid_rows_close(got, want, lengths)


# --------------------------------------------------- dispatch, no fallback


def test_cpu_wrappers_count_no_launches():
    pa.reset_launch_counts()
    case = _paged_case(1, B=2, S=16, KVH=2, D=16, qpk=2, bs=8, max_blocks=4,
                       num_blocks=12, starts=[0, 3], lengths=[16, 5])
    pa.flash_prefill_attention(*_t(*case))
    rng = np.random.default_rng(2)
    fcase = _fused_case(rng, 2, 4, 2, 16, 8, 3, [5, 9])
    tc, ts = t_rope_angles(torch.tensor([[5], [9]]), 16, THETA)
    tq, tk, tv, tkp, tvp, ttab, tpos = _t(*fcase)
    pa.paged_decode_attention_fused(tq, tk, tv, tc, ts, tkp, tvp, ttab, tpos)
    pa.paged_decode_attention_pallas(*_t(case[0][:, :1], *case[1:4],
                                         case[5]))
    pa.paged_verify_attention_pallas(*_t(*case))
    assert all(fn.launches == 0 for fn in pa.KERNEL_WRAPPERS)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as lying on the card."""

    @property
    def is_cuda(self):
        return True


def test_cuda_path_raises_instead_of_falling_back(monkeypatch, tmp_path):
    # Pretend the query is on the card: the wrapper must go for its
    # kernel, and where that cannot be built (no nvcc here) it raises; it
    # never hands the call to the plain version.
    monkeypatch.setattr(pa, "_fns", {})
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(pa, "flash_prefill_attention_plain", None)
    monkeypatch.setattr(pa, "paged_decode_attention_fused_plain", None)
    pa.reset_launch_counts()
    bf = torch.bfloat16
    q = torch.zeros(1, 16, 4, 128, dtype=bf).as_subclass(_OnCard)
    pages = torch.zeros(4, 16, 256, dtype=bf)
    tab = torch.ones(1, 2, dtype=torch.int32)
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(_build.KernelBuildError):
        pa.flash_prefill_attention(q, pages, pages, tab, one * 0, one * 16)
    kn = torch.zeros(1, 1, 2, 128, dtype=bf)
    cs = torch.zeros(1, 1, 128)
    with pytest.raises(_build.KernelBuildError):
        pa.paged_decode_attention_fused(q[:, :1], kn, kn, cs, cs, pages,
                                        pages, tab, one)
    # A CUDA tensor the kernel cannot take raises too (float32 here).
    with pytest.raises(ValueError):
        pa.flash_prefill_attention(q.float(), pages, pages, tab, one, one)
    assert pa.flash_prefill_attention.launches == 0
    assert pa.paged_decode_attention_fused.launches == 0


def test_new_wrappers_raise_instead_of_falling_back(monkeypatch, tmp_path):
    # The wrappers of the quantized pool and of the split path: on a card
    # tensor each goes for its kernel and raises where it cannot be built;
    # an input the kernel cannot take raises ValueError first.
    monkeypatch.setattr(pa, "_fns", {})
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    for plain in ("flash_prefill_attention_plain",
                  "paged_decode_attention_fused_quant_plain"):
        monkeypatch.setattr(pa, plain, None)
    pa.reset_launch_counts()
    bf = torch.bfloat16
    q = torch.zeros(1, 5, 4, 128, dtype=bf).as_subclass(_OnCard)
    pages = torch.zeros(4, 16, 256, dtype=bf)
    codes = torch.zeros(4, 16, 256, dtype=torch.int8)
    scales = torch.zeros(4, 16, 2)
    tab = torch.ones(1, 2, dtype=torch.int32)
    one = torch.ones(1, dtype=torch.int32)
    kn = torch.zeros(1, 1, 2, 128, dtype=bf)
    cs = torch.zeros(1, 1, 128)
    with pytest.raises(_build.KernelBuildError):
        pa.flash_prefill_attention(q, codes, codes, tab, one * 0, one * 5,
                                   k_scale=scales, v_scale=scales)
    for fp8 in (False, True):
        c = codes.to(torch.float8_e4m3fn) if fp8 else codes
        with pytest.raises(_build.KernelBuildError):
            pa.paged_decode_attention_fused_quant(
                q[:, :1], kn, kn, cs, cs, c, c, scales, scales, tab, one)
    with pytest.raises(_build.KernelBuildError):
        pa.paged_decode_attention_pallas(q[:, :1], pages, pages, tab, one)
    with pytest.raises(_build.KernelBuildError):
        pa.paged_verify_attention_pallas(q, pages, pages, tab, one, one * 5)
    # Inputs the kernels cannot take: 1-byte pages without scales, a bf16
    # pool handed to the quant kernel, scales of the wrong shape, more than
    # 8 query tokens.
    with pytest.raises(ValueError):
        pa.flash_prefill_attention(q, codes, codes, tab, one, one)
    with pytest.raises(ValueError):
        pa.paged_decode_attention_fused_quant(
            q[:, :1], kn, kn, cs, cs, pages, pages, scales, scales, tab, one)
    with pytest.raises(ValueError):
        pa.flash_prefill_attention(q, codes, codes, tab, one, one,
                                   k_scale=scales[:, :, :1],
                                   v_scale=scales[:, :, :1])
    q9 = torch.zeros(1, 9, 4, 128, dtype=bf).as_subclass(_OnCard)
    with pytest.raises(ValueError):
        pa.paged_verify_attention_pallas(q9, pages, pages, tab, one, one)
    assert all(fn.launches == 0 for fn in pa.KERNEL_WRAPPERS)
