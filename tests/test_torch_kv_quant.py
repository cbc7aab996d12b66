"""The port's quantized KV pool (int8 / fp8) against the JAX package.

Inputs come from a numpy seed and go through both packages on the CPU; the
JAX Pallas kernels run in interpret mode, as the JAX package's own tests run
them.  Tolerances:

  * codes of ``quantize_kv`` / ``_scatter_pages_quant``: equal up to one
    step of the storage type (1 for int8, one e4m3 step for fp8) in at most
    0.1% of the entries -- the two packages compute the same float32 values
    with other instruction orders, which may land a quotient on the other
    side of a rounding tie; scales at rtol 1e-6;
  * attention outputs in float32: atol = rtol = 2e-5, the tolerance the JAX
    package holds its kernels to against their oracles (the online softmax
    sums in another order than the dense reference).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_monitor_tpu.models import llama as jllama
from k8s_llm_monitor_tpu.ops.pallas_attention import (
    flash_prefill_attention as j_flash,
)
from k8s_llm_monitor_tpu.ops.pallas_attention import (
    paged_decode_attention_fused_quant as j_fused_quant,
)
from k8s_llm_monitor_tpu.ops.rope import rope_angles as j_rope_angles
from k8s_llm_monitor_tpu_torch.models import llama as tllama
from k8s_llm_monitor_tpu_torch.models.config import ModelConfig
from k8s_llm_monitor_tpu_torch.ops import attention as tattn
from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa
from k8s_llm_monitor_tpu_torch.ops.rope import apply_rope
from k8s_llm_monitor_tpu_torch.ops.rope import rope_angles as t_rope_angles

TOL = dict(rtol=2e-5, atol=2e-5)
SCALE_TOL = dict(rtol=1e-6, atol=0)
THETA = 10_000.0
J_DTYPE = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}


def _np(x):
    """A torch or jax array as float32 numpy (codes widen exactly)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _to_jax_codes(codes: torch.Tensor, kv_quant: str):
    """Port codes as the JAX storage dtype (every value is representable)."""
    return jnp.asarray(codes.float().numpy()).astype(J_DTYPE[kv_quant])


def _assert_codes_close(got, want, kv_quant):
    g, w = _np(got), _np(want)
    if kv_quant == "int8":
        step = np.ones_like(w)
    else:
        mag = np.maximum(np.maximum(np.abs(g), np.abs(w)), 2.0 ** -6)
        step = np.exp2(np.floor(np.log2(mag)) - 3)
    diff = np.abs(g - w) / step
    assert diff.max() <= 1.0, f"codes differ by {diff.max()} steps"
    assert (diff > 0).mean() <= 1e-3, f"{(diff > 0).mean():.2%} codes differ"


# ------------------------------------------------- quantize / dequantize


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_quantize_dequantize_match_jax(kv_quant):
    rng = np.random.default_rng(0)
    KVH, D = 4, 32
    x = (rng.standard_normal((64, 16, KVH * D))
         * rng.uniform(0.01, 30.0, size=(64, 16, 1))).astype(np.float32)
    x[3, 5] = 0.0                                 # an all-zero row: scale floor
    jdt, jqmax = jllama.kv_quant_spec(kv_quant)
    tdt, tqmax = tllama.kv_quant_spec(kv_quant)
    assert jqmax == tqmax
    jq, js = jllama.quantize_kv(jnp.asarray(x), KVH, jdt, jqmax)
    tq, ts = tllama.quantize_kv(torch.from_numpy(x), KVH, tdt, tqmax)
    assert tq.dtype == tdt and ts.dtype == torch.float32
    _assert_codes_close(tq, jq, kv_quant)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **SCALE_TOL)
    # The same codes dequantize alike.
    np.testing.assert_allclose(
        tllama.dequantize_kv(tq, ts).numpy(),
        np.asarray(jllama.dequantize_kv(_to_jax_codes(tq, kv_quant),
                                        jnp.asarray(ts.numpy()))),
        **SCALE_TOL)


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_quantize_heads_divides_by_qmax(kv_quant):
    # Every bf16 amax mantissa at a few exponents: the scale is the float32
    # quotient amax / qmax, bit for bit, as the JAX package and the kernels
    # take it -- not amax times the float32 reciprocal of qmax, which
    # PyTorch on CUDA computes for a Python-number divisor and which is one
    # ulp off for some of these (moving codes at rounding ties).
    _, qmax = tllama.kv_quant_spec(kv_quant)
    mant = 1.0 + np.arange(128) / 128.0
    amax = np.concatenate([mant * 2.0 ** e for e in (-6, -1, 0, 3, 9)])
    amax = amax.astype(np.float32)
    D = 8
    x = np.zeros((amax.size, D), np.float32)
    x[:, 0] = amax
    x[:, 1:] = amax[:, None] * np.linspace(-0.9, 0.9, D - 1, dtype=np.float32)
    _, scale = tllama._quantize_heads(torch.from_numpy(x), qmax,
                                      kv_quant == "int8")
    want = amax / np.float32(qmax)
    assert scale.dtype == torch.float32
    np.testing.assert_array_equal(scale.numpy().view(np.uint32),
                                  want.view(np.uint32))
    # The test can see the fault: the reciprocal product differs for some.
    recip = amax * (np.float32(1.0) / np.float32(qmax))
    assert (recip.view(np.uint32) != want.view(np.uint32)).any()


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_scatter_pages_quant_matches_jax(kv_quant):
    rng = np.random.default_rng(1)
    B, S, KVH, D, bs, num_blocks = 3, 6, 2, 16, 4, 12
    vals = (rng.standard_normal((B, S, KVH, D)) * 3).astype(np.float32)
    table = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9]], np.int32)
    # lane 0 fresh, lane 1 crosses the table's end (positions >= 12 go to
    # the null block), lane 2 invalid past 2 tokens.
    positions = np.array([np.arange(S), np.arange(S) + 8, np.arange(S)],
                         np.int32)
    valid = np.ones((B, S), bool)
    valid[2, 2:] = False
    jdt, _ = jllama.kv_quant_spec(kv_quant)
    tdt, _ = tllama.kv_quant_spec(kv_quant)
    jp, jsp = jllama._scatter_pages_quant(
        jnp.zeros((num_blocks, bs, KVH * D), jdt),
        jnp.zeros((num_blocks, bs, KVH), jnp.float32), jnp.asarray(vals),
        jnp.asarray(table), jnp.asarray(positions), jnp.asarray(valid))
    tp = torch.zeros(num_blocks, bs, KVH * D, dtype=tdt)
    tsp = torch.zeros(num_blocks, bs, KVH)
    got = tllama._scatter_pages_quant(
        tp, tsp, torch.from_numpy(vals), torch.from_numpy(table),
        torch.from_numpy(positions), torch.from_numpy(valid))
    assert got[0] is tp and got[1] is tsp, "the scatter must be in place"
    # The null block collects colliding redirected rows in both packages
    # in an unspecified order; compare the live blocks.
    _assert_codes_close(tp[1:], jp[1:], kv_quant)
    np.testing.assert_allclose(tsp[1:].numpy(), np.asarray(jsp)[1:],
                               **SCALE_TOL)
    assert tsp[1:].count_nonzero() == int(np.count_nonzero(np.asarray(jsp)[1:]))


# ------------------------------------------------ B5: flash over 1-byte pages


def _quant_pool(rng, num_blocks, bs, KVH, D, kv_quant):
    """A random pool quantized by the port: (torch codes, torch scales,
    jax codes, jax scales)."""
    x = rng.standard_normal((num_blocks, bs, KVH * D)).astype(np.float32)
    tdt, qmax = tllama.kv_quant_spec(kv_quant)
    codes, scales = tllama.quantize_kv(torch.from_numpy(x), KVH, tdt, qmax)
    return (codes, scales, _to_jax_codes(codes, kv_quant),
            jnp.asarray(scales.numpy()))


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_flash_quant_plain_matches_pallas(kv_quant):
    # Fresh prefill, a continuation chunk at start > 0, an inactive lane,
    # and a lane ending one token below block alignment (the geometry of
    # tests/test_flash_prefill.py:152-166).
    rng = np.random.default_rng(3)
    B, S, KVH, D, qpk, bs, max_blocks, num_blocks = 4, 24, 2, 8, 2, 8, 8, 40
    starts, lengths = [0, 11, 27, 15], [24, 13, 0, 16]
    q = rng.standard_normal((B, S, KVH * qpk, D)).astype(np.float32)
    tables = np.stack([rng.permutation(np.arange(1, num_blocks))[:max_blocks]
                       for _ in range(B)]).astype(np.int32)
    kq, ks, jkq, jks = _quant_pool(rng, num_blocks, bs, KVH, D, kv_quant)
    vq, vs, jvq, jvs = _quant_pool(rng, num_blocks, bs, KVH, D, kv_quant)
    st, ln = np.asarray(starts, np.int32), np.asarray(lengths, np.int32)
    want = j_flash(jnp.asarray(q), jkq, jvq, jnp.asarray(tables),
                   jnp.asarray(st), jnp.asarray(ln), k_scale=jks, v_scale=jvs,
                   interpret=True)
    got = pa.flash_prefill_attention(
        torch.from_numpy(q), kq, vq, torch.from_numpy(tables),
        torch.from_numpy(st), torch.from_numpy(ln), k_scale=ks, v_scale=vs)
    for b, n in enumerate(lengths):          # rows past lengths are garbage
        np.testing.assert_allclose(got.numpy()[b, :n], np.asarray(want)[b, :n],
                                   **TOL)


# ---------------------------------- B4: fused decode with quantize-on-append


def _fused_quant_case(seed, kv_quant, positions, H=8, KVH=2, D=16, bs=8,
                      max_blocks=3):
    rng = np.random.default_rng(seed)
    B = len(positions)
    num_blocks = B * max_blocks + 2
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k_new = (rng.standard_normal((B, 1, KVH, D)) * 2).astype(np.float32)
    v_new = (rng.standard_normal((B, 1, KVH, D)) * 2).astype(np.float32)
    kq, ks, _, _ = _quant_pool(rng, num_blocks, bs, KVH, D, kv_quant)
    vq, vs, _, _ = _quant_pool(rng, num_blocks, bs, KVH, D, kv_quant)
    table = np.zeros((B, max_blocks), np.int32)
    nxt = 1
    for b, p in enumerate(positions):      # position 0: inactive, null row
        if p > 0:
            used = min(p // bs + 1, max_blocks)
            table[b, :used] = np.arange(nxt, nxt + used)
            nxt += used
    return (q, k_new, v_new, kq, vq, ks, vs, table,
            np.asarray(positions, np.int32))


def _run_fused_quant(case, kv_quant):
    q, k_new, v_new, kq, vq, ks, vs, table, pos = case
    D = q.shape[-1]
    jc, js = j_rope_angles(jnp.asarray(pos)[:, None], D, THETA)
    want = j_fused_quant(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), jc, js,
        _to_jax_codes(kq, kv_quant), _to_jax_codes(vq, kv_quant),
        jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy()), jnp.asarray(table),
        jnp.asarray(pos), interpret=True)
    tc, ts = t_rope_angles(torch.from_numpy(pos)[:, None], D, THETA)
    pool = [t.clone() for t in (kq, vq, ks, vs)]
    got = pa.paged_decode_attention_fused_quant(
        torch.from_numpy(q), torch.from_numpy(k_new), torch.from_numpy(v_new),
        tc, ts, *pool, torch.from_numpy(table), torch.from_numpy(pos))
    assert all(g is p for g, p in zip(got[1:], pool)), "pool not in place"
    return got, want, (tc, ts)


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_fused_quant_plain_matches_pallas(kv_quant):
    # An inactive lane (0), a page boundary (8 = the first row of block 2),
    # the last row of a block (15) and a mid-block position.
    positions = [0, 8, 15, 21]
    case = _fused_quant_case(11, kv_quant, positions)
    got, want, (tc, ts) = _run_fused_quant(case, kv_quant)
    act = np.asarray(positions) > 0
    np.testing.assert_allclose(got[0].numpy()[act], np.asarray(want[0])[act],
                               **TOL)
    for i in (1, 2):                          # codes, null block included
        _assert_codes_close(got[i], want[i], kv_quant)
    for i in (3, 4):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   **SCALE_TOL)

    # The current token is folded as codes * scale with int8 codes rounded
    # and fp8 ones not (pallas_attention.py:657-660).  So against the
    # gather path, which reads the stored row back, the kernel agrees for
    # int8 and departs for fp8; the port follows the kernel.
    q, _, _, kq, vq, ks, vs, table, pos = case
    D = q.shape[-1]
    qr = apply_rope(torch.from_numpy(q) * D ** -0.5, tc, ts)
    gather = tattn.paged_decode_attention_quant(
        qr, got[1], got[2], got[3], got[4], torch.from_numpy(table),
        torch.from_numpy(pos) + 1, scale=1.0).numpy()
    gap = np.abs(gather[act] - got[0].numpy()[act]).max()
    if kv_quant == "int8":
        assert gap <= 2e-5
    else:
        assert gap > 1e-3, f"fp8 current-token fold: gap {gap}"


# --------------------------------------------------------------- selection


CFG = ModelConfig(name="t", vocab_size=64, hidden_size=32,
                  intermediate_size=64, num_layers=2, num_heads=4,
                  num_kv_heads=2, dtype="float32", rope_theta=1e4)
CFG_8B_HEADS = ModelConfig(name="h", vocab_size=64, hidden_size=4096,
                           intermediate_size=64, num_layers=1, num_heads=32,
                           num_kv_heads=8)
CPU, CUDA = torch.device("cpu"), torch.device("cuda")


def test_select_quant_paths(caplog):
    # auto + quant: the fused quant wrapper where the model takes it on
    # CUDA; the gather/dequant sentinel on the CPU.
    assert (tattn.select_decode_impl(CUDA, CFG_8B_HEADS, "auto", "int8")
            is pa.paged_decode_attention_fused_quant)
    assert (tattn.select_decode_impl(CUDA, CFG_8B_HEADS, "auto", "")
            is pa.paged_decode_attention_fused)
    assert (tattn.select_decode_impl(CPU, CFG, "auto", "fp8")
            is tattn.paged_decode_attention)
    assert (tattn.select_decode_impl(CPU, CFG, "fused", "int8")
            is pa.paged_decode_attention_fused_quant)
    # "pallas" + quant: the split kernel takes no scales -> gather, warned.
    with caplog.at_level("WARNING", logger="k8s_llm_monitor_tpu_torch.ops"):
        impl = tattn.select_decode_impl(CUDA, CFG_8B_HEADS, "pallas", "int8")
    assert impl is tattn.paged_decode_attention
    assert "no quantized-KV support" in caplog.text
    assert (tattn.select_decode_impl(CUDA, CFG_8B_HEADS, "pallas", "")
            is pa.paged_decode_attention_pallas)


@pytest.mark.parametrize("mode", ["fused", "pallas"])
def test_forced_kernel_modes_raise_on_bad_geometry(mode):
    # float32 activations on CUDA: the kernels take bf16 only.
    with pytest.raises(ValueError):
        tattn.select_decode_impl(CUDA, CFG, mode, "")
    if mode == "fused":
        with pytest.raises(ValueError):
            tattn.select_decode_impl(CUDA, CFG, mode, "int8")
    odd = ModelConfig(name="o", hidden_size=36, num_heads=4, num_kv_heads=2)
    with pytest.raises(ValueError):              # odd head_dim, any device
        tattn.select_decode_impl(CPU, odd, mode, "")


def test_kv_pages_quantized_layout_and_bytes():
    pages = tllama.init_kv_pages(CFG, 10, 4, "cpu", kv_quant="int8")
    assert pages.quantized and len(pages.k_scale) == CFG.num_layers
    assert pages.k[0].dtype == torch.int8 and pages.k[0].shape == (10, 4, 16)
    assert pages.v_scale[0].shape == (10, 4, 2)
    # codes (1 byte) + scales (4 bytes per head) per K/V plane and layer
    assert pages.nbytes() == 2 * 2 * 10 * 4 * (16 + 2 * 4)
    fp = tllama.init_kv_pages(CFG, 10, 4, "cpu")
    assert not fp.quantized and fp.nbytes() == 2 * 2 * 10 * 4 * 16 * 4
    assert tllama.init_kv_pages(CFG, 10, 4, "cpu", kv_quant="fp8").k[0].dtype \
        == torch.float8_e4m3fn
    with pytest.raises(ValueError):
        tllama.kv_quant_spec("int4")
